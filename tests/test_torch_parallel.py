"""The port's meshes, sharded channelizer and sharded resampler against
the JAX package's, on the CPU.

JAX runs on the conftest's 8 virtual CPU devices; the port on meshes of
``["cpu"] * n`` (a device may repeat in a torch mesh).

Bars:
- ``make_mesh``: the same shapes, and the same ValueErrors;
- sharded channelizer vs JAX's (``tests/test_parallel.py:16-48``'s
  criterion, away from the discriminator's cold-start edge): >= 99.9 %
  within 1 LSB and >= 98 % exact;
- sharded channelizer vs the port's unsharded chain: bit-equal (from output
  1 against the primed streaming chain, whose output 0 starts the
  discriminator from a zero history; and entirely against one K1 call over
  the whole capture, the (1, 1) mesh);
- sharded resampler, both paths (packed-row K3, frame-form K4): bit-equal
  to the port's single-device streaming run, within JAX's ``atol`` of
  JAX's sharded output.
"""

import jax
import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models.channelizer import MultifmChain as JaxChain
from tsl_sdr_tpu.parallel import mesh as jmesh
from tsl_sdr_tpu.parallel.channelizer import make_sharded_multifm as jax_sharded
from tsl_sdr_tpu.parallel.resampler import make_sharded_resampler as jax_rs
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.ops import packed_fir, polyphase, q14
from tsl_sdr_tpu_torch.parallel import mesh as tmesh
from tsl_sdr_tpu_torch.parallel.channelizer import (make_sharded_multifm,
                                                    make_sharded_multifm_pallas)
from tsl_sdr_tpu_torch.parallel.resampler import make_sharded_resampler
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter, firdes_low_pass)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _cpu_mesh(time, channels):
    return tmesh.make_mesh(time=time, channels=channels,
                           devices=["cpu"] * (time * channels))


@pytest.mark.parametrize("time,channels,n", [
    (None, 1, 8), (None, 2, 8), (2, 4, 8), (4, 1, 8), (1, 8, 8),
    (None, 3, 8), (3, 3, 8), (5, 2, 8)])
def test_make_mesh_matches_jax(time, channels, n):
    try:
        want = jmesh.make_mesh(time=time, channels=channels,
                               devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(time=time, channels=channels,
                            devices=["cpu"] * n)
        assert str(got.value) == str(e)
        return
    got = tmesh.make_mesh(time=time, channels=channels, devices=["cpu"] * n)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert not got.multiprocess and got.local_rows == list(
        range(want.devices.shape[0]))


def test_make_mesh_default_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(time=2)


def _chains(nr_channels, taps, seed):
    fs, d = 128_000, 4
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)[:taps]
    rng = np.random.default_rng(seed)
    offsets = rng.integers(-fs // 3, fs // 3, size=nr_channels)
    return (JaxChain(lpf, offsets, fs, d, exact=False),
            MultifmChain(lpf, offsets, fs, d, exact=False, device="cpu"),
            rng)


@pytest.mark.parametrize("nr,time,channels,taps,seed", [
    (8, 4, 2, 33, 60), (8, 2, 4, 33, 60), (8, 8, 1, 33, 60),
    (8, 1, 8, 33, 60), (64, 2, 4, 17, 61), (64, 4, 2, 17, 62)],
    ids=["8ch-4x2", "8ch-2x4", "8ch-8x1", "8ch-1x8", "64ch-2x4",
         "64ch-4x2"])
def test_sharded_channelizer(nr, time, channels, taps, seed):
    jchain, chain, rng = _chains(nr, taps, seed)
    s = 512 * 4 * time
    iq = rng.integers(-12000, 12000, size=(s, 2),
                      dtype=np.int64).astype(np.int16)
    got = make_sharded_multifm(chain.packed_plan,
                               _cpu_mesh(time, channels))(iq).numpy()
    assert got.shape == (nr, s // 4) and got.dtype == np.int16

    # the port's unsharded chain, primed with the stream head
    c_len, q = chain.carry_len, chain.block_quantum
    _, single = chain.step(chain.init_state(prefix=iq[:c_len]),
                           iq[c_len:][: (s - c_len) // q * q])
    single = single.numpy()
    k = single.shape[1]
    np.testing.assert_array_equal(got[:, 1:k], single[:, 1:])
    # one K1 call over the whole capture (the (1, 1) mesh): every output
    whole = make_sharded_multifm_pallas(chain.packed_plan,
                                        _cpu_mesh(1, 1))(iq).numpy()
    np.testing.assert_array_equal(got, whole)

    # JAX's sharded channelizer, its own criterion
    jfn = jax_sharded(jchain.packed_plan, jmesh.make_mesh(
        time=time, channels=channels, devices=jax.devices()[:8]))
    want = np.asarray(jfn(iq)).astype(np.int32)
    diff = np.abs(got[:, 2:k - 2].astype(np.int32) - want[:, 2:k - 2])
    assert (diff <= 1).mean() > 0.999, (diff.max(), (diff > 1).mean())
    assert (diff == 0).mean() > 0.98


def test_sharded_channelizer_refuses_what_jax_refuses():
    _, chain, _ = _chains(8, 33, 60)
    with pytest.raises(ValueError, match="not divisible by 3"):
        make_sharded_multifm(chain.packed_plan, _cpu_mesh(1, 3))
    with pytest.raises(TypeError, match="PackedFirPlan"):
        make_sharded_multifm(object(), _cpu_mesh(1, 1))
    fn = make_sharded_multifm(chain.packed_plan, _cpu_mesh(4, 1))
    with pytest.raises(ValueError, match="split evenly"):
        fn(np.zeros(chain.packed_plan.row * 4 + 2, np.int16))


@pytest.mark.parametrize("lo,hi", [(0, 1), (7, 8), (2, 6)])
def test_sub_bank_plans_and_launch(lo, hi):
    """A shard's plan is the bank's columns for its channels (so its sums
    are the bank's), and K1 takes a one-channel sub-bank of the pager's
    577-tap bank: a tile launch whose block holds the channel."""
    plan = packed_fir.make_packed_fir_plan(
        pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS, pager.DECIMATION)
    sub = packed_fir.sub_plan(plan, lo, hi)
    ref = packed_fir.make_packed_fir_plan(
        pager.lpf_taps(), pager.OFFSETS_HZ[lo:hi], pager.FS,
        pager.DECIMATION)
    for a, b in zip(sub.w_chunks_i16, ref.w_chunks_i16):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sub.omega_d, ref.omega_d)
    np.testing.assert_array_equal(sub.rot_incr_i32, ref.rot_incr_i32)
    taps = k1.ChainTaps(sub, np.zeros(hi - lo, np.float32), device="cpu")
    assert taps.body == "tile" and taps.chans_per_block == hi - lo
    assert 16 <= taps.tile_rows + 1 <= 256


def _rs_plan():
    coeffs = design_rational_resampler_filter(16, 25, 0.4)
    return polyphase.make_resampler_plan(q14.quantize_q14(coeffs), 16, 25,
                                         block_out_target=1024)


def _rs_single(plan, x):
    """The port's single-device streaming run, primed with the stream head
    so that output 0 is the window at offset 0 (zeros past the end)."""
    taps = polyphase.plan_taps(plan, device="cpu")
    st = polyphase.init_resampler_carry(plan, 1, device="cpu",
                                        prefix=x[:plan.carry_len])
    xp = np.concatenate([x, np.zeros(plan.block_in, np.int16)])
    outs, pos = [], plan.carry_len
    while pos + plan.block_in <= len(xp):
        st, o = polyphase.resample_step(
            plan, st, torch.from_numpy(xp[pos:pos + plan.block_in])[None],
            taps)
        outs.append(o[0].numpy())
        pos += plan.block_in
    return np.concatenate(outs)


@pytest.mark.parametrize("path", ["row", "residue"])
def test_sharded_resampler(path):
    plan = _rs_plan()
    assert plan.k_row == 128 and plan.row_in == 200
    rng = np.random.default_rng(62)
    n = 8 * plan.row_in * 3 + (8 * plan.d_rep if path == "residue" else 0)
    x = rng.integers(-12000, 12000, size=n, dtype=np.int64).astype(np.int16)
    got = make_sharded_resampler(plan, _cpu_mesh(8, 1))(x).numpy()
    assert got.shape == (n * 16 // 25,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _rs_single(plan, x)[:got.shape[0]])
    want = np.asarray(jax_rs(plan, jmesh.make_mesh(
        time=8, channels=1, devices=jax.devices()[:8]))(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0)


def test_sharded_resampler_refuses_what_jax_refuses():
    plan = _rs_plan()
    fn = make_sharded_resampler(plan, _cpu_mesh(8, 1))
    with pytest.raises(ValueError, match="time_shards\\*D_rep = 200"):
        fn(np.zeros(8 * 25 + 8, np.int16))
    with pytest.raises(ValueError, match="phase0 == 0"):
        make_sharded_resampler(plan._replace(phase0=1), _cpu_mesh(8, 1))
