"""Kernel K10's plain version (the integer NCO and its scalings,
``ops/packed_fir.py`` ``nco_derotate_plain``) against the JAX package's
``nco_rotate`` and the scalings around it, and the three paths rewired
through it against the chains they ran before.

Inputs are K5's raw sums as they come (int32 [rows, 2 * opr * C]), made
from a seed with numpy, at output indices near 0, just below 2^31 (JAX's
int32 index wraps inside the block) and past 2^32.

Tolerances:
- the NCO's angle EXACT against JAX's (the int32 phase wraps the same way
  at every index, and the float32 angle is one conversion and one
  product): checked by rotating (1, 0), which gives JAX's cos and sin of
  its angle exactly;
- the planes against JAX within 1e-6 (|y| <= 1.5 after the two 2^-14
  scalings of sums below 2^28; torch's and XLA's float32 cos and sin on
  the CPU differ by an ulp on some 5 % of angles), the int16 baseband
  within 1 LSB of JAX's on every sample and equal on >= 99.9 % (an ulp can
  flip a truncation);
- the plain version EXACTLY equal to a numpy float32 evaluation of the
  kernel's steps in its order, on torch's cos and sin of the same angles
  (clamp at full scale included);
- ``CostasChannelizer.step``, ``process_array_native`` and
  ``MultifmChain.step_debug`` EXACTLY equal, on the CPU, to the torch op
  chains they ran before K10.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tsl_sdr_tpu.ops import packed_fir as jpf
from tsl_sdr_tpu_torch.models import costas_channel
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.models.costas_channel import CostasChannelizer
from tsl_sdr_tpu_torch.ops import costas, fm, packed_fir, q14
from tsl_sdr_tpu_torch.ops.exact_fir import exact_fir
from tsl_sdr_tpu_torch.runtime.native import costas_native
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

K0S = [0, 3, 2**31 - 100, 2**32 + 5, 5 * 2**32 - 7]
SCALE = np.float32(1.0 / 16384.0)


def _sums(rows, c, opr, seed, amp=2**28):
    rng = np.random.default_rng(seed)
    p = rng.integers(-amp, amp, size=(rows, 2 * opr * c)).astype(np.int32)
    omega = packed_fir.omega_turns_i32(rng.uniform(-np.pi, np.pi, size=c))
    return p, omega


def _jax_k0(k0):
    """JAX's output index: a wrapping int32."""
    return jnp.int32(np.int64(k0).astype(np.int32))


def _jax_nco(p, omega, k0):
    """tsl_sdr_tpu/ops/packed_fir.py:474 on the float32 planes, then the
    runner's scalings (tsl_sdr_tpu/models/costas_channel.py:176-196) and
    int16 truncation (:123-140)."""
    c = omega.size
    half = p.shape[1] // 2
    pf = p.astype(np.float32)
    yr, yi = jpf.nco_rotate(jnp.asarray(pf[:, :half].reshape(-1, c)),
                            jnp.asarray(pf[:, half:].reshape(-1, c)),
                            jnp.asarray(omega), _jax_k0(k0))
    s = jnp.float32(1.0 / 16384.0)
    planes = (np.asarray(yr * s * s), np.asarray(yi * s * s))
    iq = np.stack([np.asarray(jnp.trunc(yr * s).astype(jnp.int16)),
                   np.asarray(jnp.trunc(yi * s).astype(jnp.int16))], -1)
    return planes, iq


def _angles(k, omega, k0):
    """float32 angle of each (k, c): (k0 + k) * omega mod 2^32 as int32,
    times float32(2 pi / 2^32)."""
    idx = k0 + np.arange(k, dtype=np.int64)
    ph = (idx[:, None] * omega.astype(np.int64)[None, :]) % 2**32
    ph = np.where(ph >= 2**31, ph - 2**32, ph).astype(np.int32)
    return ph.astype(np.float32) * np.float32(2.0 * np.pi / 2.0**32)


@pytest.mark.parametrize("k0", K0S)
def test_nco_angle_wraps_like_jax(k0):
    """Rotating (1, 0) returns cos and sin of the NCO's angle: JAX's and
    the port's equal their own cos and sin of the angle computed here in
    int64 mod 2^32, so both take the same angle at every index."""
    k, c = 600, 5
    omega = packed_fir.omega_turns_i32(
        np.random.default_rng(k0 % 97).uniform(-np.pi, np.pi, size=c))
    omega[0] = np.int32(2**31 - 1)     # the largest turn a step
    th = _angles(k, omega, k0)
    one, zero = np.ones((k, c), np.float32), np.zeros((k, c), np.float32)
    jr, ji = jpf.nco_rotate(jnp.asarray(one), jnp.asarray(zero),
                            jnp.asarray(omega), _jax_k0(k0))
    np.testing.assert_array_equal(np.asarray(jr), np.asarray(jnp.cos(th)))
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(jnp.sin(th)))
    tr, ti = packed_fir.nco_rotate(torch.from_numpy(one),
                                   torch.from_numpy(zero),
                                   torch.from_numpy(omega), k0)
    tth = torch.from_numpy(th)
    assert torch.equal(tr, torch.cos(tth)) and torch.equal(ti, torch.sin(tth))


@pytest.mark.parametrize("k0", K0S)
@pytest.mark.parametrize("rows,c,opr", [(300, 8, 4), (97, 3, 5)])
def test_nco_derotate_plain_matches_jax(k0, rows, c, opr):
    p, omega = _sums(rows, c, opr, seed=rows + k0 % 1000)
    (jr, ji), jiq = _jax_nco(p, omega, k0)
    tp, to = torch.from_numpy(p), torch.from_numpy(omega)
    yr, yi = packed_fir.nco_derotate_plain(tp, to, k0, "planes")
    iq = packed_fir.nco_derotate_plain(tp, to, k0, "int16")
    assert yr.shape == yi.shape == (rows * opr, c)
    assert yr.dtype == torch.float32
    np.testing.assert_allclose(yr.numpy(), jr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(yi.numpy(), ji, rtol=0, atol=1e-6)
    assert iq.shape == (rows * opr, c, 2) and iq.dtype == torch.int16
    d = np.abs(iq.numpy().astype(np.int32) - jiq)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def _emulate_nco(p, omega, k0):
    """csrc/nco.cu's steps in numpy float32, in its order, on torch's cos
    and sin of the angles: (planes, int16 baseband)."""
    c = omega.size
    half = p.shape[1] // 2
    ar = p[:, :half].reshape(-1, c).astype(np.float32)
    ai = p[:, half:].reshape(-1, c).astype(np.float32)
    th = torch.from_numpy(_angles(ar.shape[0], omega, k0))
    cs, sn = torch.cos(th).numpy(), torch.sin(th).numpy()
    yr = ar * cs - ai * sn
    yi = ar * sn + ai * cs
    planes = (yr * SCALE * SCALE, yi * SCALE * SCALE)
    iq = np.stack([np.clip(np.trunc(v * SCALE), -32768, 32767)
                   for v in (yr, yi)], -1).astype(np.int16)
    return planes, iq


@pytest.mark.parametrize("k0", [0, 2**31 - 100, 2**32 + 5])
@pytest.mark.parametrize("amp", [2**28, 2**31])
def test_nco_derotate_plain_is_the_kernels_arithmetic(k0, amp):
    """Bit for bit the kernel's order of float32 steps; at full-scale sums
    (amp 2^31) the int16 baseband saturates, as q14.to_int16 clamps."""
    p, omega = _sums(64, 8, 8, seed=5, amp=amp)
    (er, ei), eiq = _emulate_nco(p, omega, k0)
    tp, to = torch.from_numpy(p), torch.from_numpy(omega)
    yr, yi = packed_fir.nco_derotate_plain(tp, to, k0, "planes")
    iq = packed_fir.nco_derotate_plain(tp, to, k0, "int16").numpy()
    np.testing.assert_array_equal(yr.numpy(), er)
    np.testing.assert_array_equal(yi.numpy(), ei)
    np.testing.assert_array_equal(iq, eiq)
    if amp == 2**31:
        assert (np.abs(iq.astype(np.int32)) >= 32767).any()


def test_nco_derotate_wrapper_on_the_cpu():
    """A CPU tensor runs the plain version (no launch is counted); an
    unknown mode or device raises."""
    p, omega = _sums(16, 4, 2, seed=9)
    tp, to = torch.from_numpy(p), torch.from_numpy(omega)
    before = packed_fir.nco_derotate.launches
    for out in ("planes", "int16"):
        got = packed_fir.nco_derotate(tp, to, 77, out)
        want = packed_fir.nco_derotate_plain(tp, to, 77, out)
        for g, w in zip(got if out == "planes" else [got],
                        want if out == "planes" else [want]):
            assert torch.equal(g, w)
    assert packed_fir.nco_derotate.launches == before
    with pytest.raises(ValueError, match="planes"):
        packed_fir.nco_derotate(tp, to, 0, "f32")
    with pytest.raises(ValueError, match="cuda or cpu"):
        packed_fir.nco_derotate(tp.to("meta"), to, 0, "planes")


# -- the paths through K10, against the chains they ran before ---------------

FS, D = 256_000, 8
OFFSETS = [-45_000, 15_000, 75_000]


def _iq(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=(n, 2)).astype(np.int16)


def _costas_chain():
    return CostasChannelizer(firdes_low_pass(1.0, FS, 6_000, 4_000), OFFSETS,
                             FS, D, alpha=0.1, beta=0.005, device="cpu")


def _old_baseband(chain, carry, vals, k0):
    """The pre-K10 ``_baseband``: K5's raw sums as float32, nco_rotate."""
    c = chain.nr_channels
    p = exact_fir(chain.taps, carry, vals, "raw").to(torch.float32)
    half = chain.packed_plan.halfcols
    return packed_fir.nco_rotate(p[:, :half].reshape(-1, c),
                                 p[:, half:].reshape(-1, c),
                                 chain._omega_i32, k0)


def _count_k10(monkeypatch):
    calls = []
    real = packed_fir.nco_derotate

    def counted(*a):
        calls.append(a[-1])
        return real(*a)

    monkeypatch.setattr(packed_fir, "nco_derotate", counted)
    return calls


def test_costas_step_unchanged_by_k10(monkeypatch):
    """Three blocks through ``step``, state carried, one K10 call (planes)
    a block: output and state equal to the pre-K10 chain (two scalings of
    the rotated sums, then the loop)."""
    chain = _costas_chain()
    q = chain.block_quantum
    iq = _iq(chain.carry_len + 3 * 40 * q, 41)
    calls = _count_k10(monkeypatch)
    st = chain.init_state(prefix=iq[:chain.carry_len])
    old = chain.init_state(prefix=iq[:chain.carry_len])
    for b in range(3):
        blk = iq[chain.carry_len + b * 40 * q:chain.carry_len
                 + (b + 1) * 40 * q]
        st, out = chain.step(st, blk)
        vals = torch.from_numpy(blk.reshape(-1).copy())
        yr, yi = _old_baseband(chain, old.carry_vals, vals, old.out_index)
        s = costas_channel.packed_fir._SCALE
        yr, yi = yr * s, yi * s
        cst, o_re, o_im = costas.costas_block_planes(
            chain.params, old.costas, yr * s, yi * s)
        want = q14.to_int16(torch.trunc(torch.stack(
            [o_re.T * 16384.0, o_im.T * 16384.0], dim=-1)))
        old = costas_channel.CostasChainState(
            packed_fir.next_carry(old.carry_vals, vals,
                                  chain.packed_plan.carry_vals),
            old.out_index + yr.shape[0], cst)
        assert torch.equal(out, want)
        assert torch.equal(st.costas.last_phase, old.costas.last_phase)
        assert torch.equal(st.costas.f_dev, old.costas.f_dev)
        assert st.out_index == old.out_index
    assert calls == ["planes"] * 3


def test_costas_native_path_unchanged_by_k10(monkeypatch):
    """``process_array_native`` in three blocks, one K10 call (int16) a
    block: equal to the pre-K10 front end (rotated sums truncated to
    sample units) and the serial loop a channel."""
    chain = _costas_chain()
    q = chain.block_quantum
    block = 40 * q
    iq = _iq(chain.carry_len + 3 * block, 42)
    calls = _count_k10(monkeypatch)
    got = chain.process_array_native(iq, block_size=block)
    carry = packed_fir.init_packed_carry(chain.packed_plan,
                                         iq[:chain.carry_len], device="cpu")
    k0, parts = 0, []
    for b in range(3):
        vals = torch.from_numpy(iq[chain.carry_len + b * block:
                                   chain.carry_len + (b + 1) * block]
                                .reshape(-1).copy())
        yr, yi = _old_baseband(chain, carry, vals, k0)
        s = costas_channel.packed_fir._SCALE
        parts.append(q14.to_int16(torch.stack(
            [torch.trunc(yr * s), torch.trunc(yi * s)], dim=-1)))
        carry = packed_fir.next_carry(carry, vals,
                                      chain.packed_plan.carry_vals)
        k0 += yr.shape[0]
    rot = torch.cat(parts).numpy()
    want = np.stack([costas_native(np.ascontiguousarray(rot[:, c]),
                                   chain.params)[0]
                     for c in range(chain.nr_channels)])
    np.testing.assert_array_equal(got, want)
    assert calls == ["int16"] * 3


def test_step_debug_unchanged_by_k10(monkeypatch):
    """The production tier's debug tap over two blocks, one K10 call
    (int16) a block: PCM and IQ equal to the pre-K10 tap (the plain
    discriminator on K5's raw sums, nco_rotate, truncation to sample
    units), state carried."""
    chain = MultifmChain(firdes_low_pass(1.0, FS, 6_000, 4_000), OFFSETS,
                         FS, D, exact=False, device="cpu")
    q, c = chain.block_quantum, chain.nr_channels
    iq = _iq(chain.carry_len + 2 * 30 * q, 43)
    calls = _count_k10(monkeypatch)
    st = chain.init_state(prefix=iq[:chain.carry_len])
    old = chain.init_state(prefix=iq[:chain.carry_len])
    for b in range(2):
        blk = iq[chain.carry_len + b * 30 * q:chain.carry_len
                 + (b + 1) * 30 * q]
        st, pcm, dbg = chain.step_debug(st, blk)
        vals = torch.from_numpy(blk.reshape(-1).copy())
        p = exact_fir(chain.taps, old.carry_vals, vals, "raw").to(
            torch.float32)
        half = chain.packed_plan.halfcols
        ar, ai = p[:, :half], p[:, half:]
        want_pcm, pr, pi_ = fm.fm_from_baseband(
            ar, ai, old.prev_r, old.prev_i, chain.taps.omega_c)
        yr, yi = packed_fir.nco_rotate(ar.reshape(-1, c), ai.reshape(-1, c),
                                       chain._omega_i32, old.out_index)
        s = packed_fir._SCALE
        want_iq = q14.to_int16(torch.stack(
            [torch.trunc(yr * s), torch.trunc(yi * s)], dim=-1))
        old = old._replace(
            carry_vals=packed_fir.next_carry(old.carry_vals, vals,
                                             chain.packed_plan.carry_vals),
            prev_r=pr, prev_i=pi_, out_index=old.out_index + ar.numel() // c)
        np.testing.assert_array_equal(pcm, want_pcm.reshape(-1, c).T.numpy())
        np.testing.assert_array_equal(dbg, want_iq.transpose(0, 1).numpy())
        assert st.out_index == old.out_index
    assert calls == ["int16"] * 2
