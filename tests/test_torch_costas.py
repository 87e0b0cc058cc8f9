"""The port's Costas coherent chain against the JAX package's.

``tsl_sdr_tpu_torch.ops.costas`` (the chunked loop's plain version, which
kernel K6 equals on the card), ``models.costas_channel.CostasChannelizer``
on the CPU, the native serial loop ``runtime.native.costas_native`` and
the ``MuellerMuller`` copy, each fed the same numpy inputs as its JAX
counterpart.

Tolerances:
- plain planes against JAX on short input (at most 4 chunks): atol 1e-5
  on ``o_re``/``o_im`` and the final state, the JAX package's own
  multichannel bound (``tests/test_costas_mm.py``): torch's and XLA's
  sin/cos differ by ulps, and so does XLA's order of the sums;
- the chain's int16 output against JAX on a locked BPSK capture: within
  1 LSB on at least 99.9 % of the post-lock samples, the same lock verdict;
- within the port (block-boundary invariance at chunk multiples, the tail
  of ``process_array_native``) and ``costas_native`` against the JAX
  binding (the same C source and flags): exactly equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tsl_sdr_tpu.models.costas_channel import CostasChannelizer as JaxChain
from tsl_sdr_tpu.ops import costas as jc
from tsl_sdr_tpu.ops.mueller_muller import MuellerMuller as JaxMM
from tsl_sdr_tpu.runtime.native import costas_native as jax_costas_native
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass
from tsl_sdr_tpu_torch import CostasChannelizer
from tsl_sdr_tpu_torch.ops import costas as tc
from tsl_sdr_tpu_torch.ops.mueller_muller import MuellerMuller
from tsl_sdr_tpu_torch.runtime.native import costas_native
from tsl_sdr_tpu_torch.testing import pocsag_gen
from tsl_sdr_tpu_torch.utils import convert

GAINS = [(0.05, 0.002, 8192, 0.0), (0.1, 0.005, 8192, 0.0),
         (0.03, 0.001, 4096, 0.0), (0.2, 0.0, 8192, 1e-4),
         (0.0, 0.0, 8192, 0.0), (0.01, 1e-5, 16384, -2e-3)]


def _bpsk(n, f_err, fs=48000.0, baud=1200, amp=12000, seed=0):
    """tests/test_costas_mm.py's BPSK baseband with a carrier error."""
    rng = np.random.default_rng(seed)
    spb = int(fs / baud)
    bits = rng.integers(0, 2, size=n // spb + 1)
    sym = np.repeat(np.where(bits > 0, 1.0, -1.0), spb)[:n]
    ph = 2 * np.pi * f_err / fs * np.arange(n) + 0.7
    iq = np.stack([sym * np.cos(ph), sym * np.sin(ph)], -1) * amp
    return iq.astype(np.int16)


def _bpsk_capture(n, offsets, carrier_err=35.0, fs=256_000, sym_rate=2_000,
                  seed=33, amp=9000):
    """tests/test_costas_channel.py's capture: BPSK at each offset (its
    own symbols, amplitude ``amp``), plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    iq = np.zeros((n, 2))
    for off in offsets:
        sym = rng.choice([-1.0, 1.0], size=int(n / fs * sym_rate) + 2)
        bb = np.repeat(sym, fs // sym_rate)[:n]
        ph = 2 * np.pi * (off + carrier_err) * t
        iq += np.stack([np.cos(ph) * bb, np.sin(ph) * bb], -1) * amp
    return (iq + rng.normal(scale=60, size=iq.shape)).astype(np.int16)


def _locked(out):
    """The lock assertions of tests/test_costas_channel.py on one
    channel's [K, 2] output: the tail's power on the real rail, bimodal
    real values."""
    tail = np.asarray(out, np.float64)[out.shape[0] // 2:]
    re_p, im_p = np.mean(tail[:, 0] ** 2), np.mean(tail[:, 1] ** 2)
    return bool(re_p > 20 * im_p and np.mean(np.abs(tail[:, 0])) > 1000)


@pytest.mark.parametrize("alpha,beta,e_max,shift", GAINS)
def test_params_and_stable_chunk_equal_jax(alpha, beta, e_max, shift):
    want = jc.make_costas_params(shift, alpha, beta, e_max)
    got = tc.make_costas_params(shift, alpha, beta, e_max)
    assert tuple(got) == tuple(want)
    for kw in ({}, {"amp2": 1.0}, {"target": 0.9, "max_chunk": 64}):
        assert tc.stable_chunk(got, **kw) == jc.stable_chunk(want, **kw)
    st = tc.init_costas_state(got, 3, "cpu")
    assert st.last_phase.dtype == torch.float32 and st.last_phase.shape == (3,)
    np.testing.assert_array_equal(st.f_dev.numpy(),
                                  np.float32(want.f_dev_nominal))


def test_stable_chunk_of_the_slice():
    """L = 22 at the chain's default gains, 12 at the lock test's."""
    assert tc.stable_chunk(tc.make_costas_params(0.0, 0.05, 0.002, 8192)) \
        == 22
    assert tc.stable_chunk(tc.make_costas_params(0.0, 0.1, 0.005, 8192)) \
        == 12


@pytest.mark.parametrize("chunk,k", [(32, 3 * 32 + 17), (32, 64),
                                     (512, 512 + 88), (None, 3 * 22 + 5),
                                     (None, 13), (32, 0)])
@pytest.mark.parametrize("c", [1, 4])
def test_planes_match_jax(chunk, k, c):
    """Plain planes against JAX's ``costas_block_planes`` on random input
    with nonzero starting state: a remainder chunk, a whole number of
    chunks, one short chunk, K = 0."""
    params = tc.make_costas_params(0.0, 0.05, 0.002, 8192)
    rng = np.random.default_rng(100 + k + c)
    xr = rng.normal(scale=0.4, size=(k, c)).astype(np.float32)
    xi = rng.normal(scale=0.4, size=(k, c)).astype(np.float32)
    ph0 = rng.uniform(0, 2 * np.pi, size=c).astype(np.float32)
    fd0 = rng.uniform(-0.05, 0.05, size=c).astype(np.float32)
    js, jr, ji = jc.costas_block_planes(
        params, jc.CostasState(jnp.asarray(ph0), jnp.asarray(fd0)),
        jnp.asarray(xr), jnp.asarray(xi), chunk=chunk)
    ts, tr, ti = tc.costas_block_planes(
        params, tc.CostasState(torch.from_numpy(ph0), torch.from_numpy(fd0)),
        torch.from_numpy(xr), torch.from_numpy(xi), chunk=chunk)
    assert tr.shape == ti.shape == (k, c)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.last_phase.numpy(),
                               np.asarray(js.last_phase), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.f_dev.numpy(), np.asarray(js.f_dev),
                               rtol=0, atol=1e-5)
    if k == 0:
        np.testing.assert_array_equal(ts.last_phase.numpy(), ph0)


def test_wide_chunks_from_jax_state_match_jax():
    """Four chunks of 512, each started from JAX's state after the one
    before: every chunk's outputs and state within 1e-5 of JAX's. (Run
    free, the loop on noise carries the ~1e-5 state differences of one
    chunk's 512-term sums (XLA's order against the port's tree) into the
    next chunks' phase, and they grow: up to 2.2e-3 after 4 chunks of 512
    on this input, 1e-6 at chunk 32; so the free-running comparison above
    stops at one chunk of 512 and its remainder.)"""
    params = tc.make_costas_params(0.0, 0.05, 0.002, 8192)
    rng = np.random.default_rng(12)
    k, c, chunk = 4 * 512, 4, 512
    xr = rng.normal(scale=0.4, size=(k, c)).astype(np.float32)
    xi = rng.normal(scale=0.4, size=(k, c)).astype(np.float32)
    js = jc.CostasState(
        jnp.asarray(rng.uniform(0, 2 * np.pi, size=c).astype(np.float32)),
        jnp.asarray(rng.uniform(-0.05, 0.05, size=c).astype(np.float32)))
    for lo in range(0, k, chunk):
        ts = tc.CostasState(torch.from_numpy(np.array(js.last_phase)),
                            torch.from_numpy(np.array(js.f_dev)))
        js, jr, ji = jc.costas_block_planes(
            params, js, jnp.asarray(xr[lo:lo + chunk]),
            jnp.asarray(xi[lo:lo + chunk]), chunk=chunk)
        ts, tr, ti = tc.costas_block_planes(
            params, ts, torch.from_numpy(xr[lo:lo + chunk]),
            torch.from_numpy(xi[lo:lo + chunk]), chunk=chunk)
        for got, want in ((tr, jr), (ti, ji), (ts.last_phase, js.last_phase),
                          (ts.f_dev, js.f_dev)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)


def test_planes_adversarial_match_jax():
    """Full-scale input that saturates the error clip and drives f_dev
    onto both clamps, with the phase through zero (the floor-mod's
    negative branch), at gains far past stable: four chunks of 32, each
    from JAX's state after the one before (run free, such a loop
    amplifies the ulps of one chunk into the next), held to JAX within
    1e-5."""
    params = tc.make_costas_params(0.0, 0.5, 0.05, 8192)
    k, c, chunk = 4 * 32, 4, 32
    t = np.arange(k, dtype=np.float64)[:, None]
    rot = np.array([0.9, -0.9, 2.5, -2.5])[None, :]
    xr = (1.9 * np.cos(rot * t)).astype(np.float32)
    xi = (1.9 * np.sin(rot * t)).astype(np.float32)
    js = jc.CostasState(jnp.asarray([0.01, 6.28, 0.0, 3.0], jnp.float32),
                        jnp.asarray([-0.3, 0.3, 0.0, -0.29], jnp.float32))
    phases, devs = [], []
    for lo in range(0, k, chunk):
        ts = tc.CostasState(torch.from_numpy(np.array(js.last_phase)),
                            torch.from_numpy(np.array(js.f_dev)))
        # the floor-mod's argument, which goes below zero somewhere
        phases.append(ts.last_phase + chunk * ts.f_dev)
        js, jr, ji = jc.costas_block_planes(
            params, js, jnp.asarray(xr[lo:lo + chunk]),
            jnp.asarray(xi[lo:lo + chunk]), chunk=chunk)
        ts, tr, ti = tc.costas_block_planes(
            params, ts, torch.from_numpy(xr[lo:lo + chunk]),
            torch.from_numpy(xi[lo:lo + chunk]), chunk=chunk)
        for got, want in ((tr, jr), (ti, ji), (ts.last_phase, js.last_phase),
                          (ts.f_dev, js.f_dev)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)
        devs.append(ts.f_dev)
        assert ((ts.last_phase >= 0)
                & (ts.last_phase <= float(tc.TWO_PI))).all()
    devs = torch.stack(devs)
    assert (devs == np.float32(params.f_dev_min)).any()
    assert (devs == np.float32(params.f_dev_max)).any()
    assert (torch.stack(phases) < 0).any()
    # the error clip saturates
    err = (ti * tr).abs()
    assert (err > params.e_max).any()


def test_floor_mod_equals_jnp_mod():
    """The plain version's wrap is ``jnp.mod``'s floor-mod, negative
    values, exact multiples and values just below zero included."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-200, 200, 4000),
                        [-1e-9, -0.0, 0.0, -6.2831855, 6.2831855, -12.566371,
                         1e-30, -1e-30]]).astype(np.float32)
    got = tc._floor_mod(torch.from_numpy(x), float(tc.TWO_PI)).numpy()
    want = np.asarray(jnp.mod(jnp.asarray(x), jc.TWO_PI))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [32, 7])
def test_block_boundary_invariance_at_chunk_multiples(chunk):
    """Blocks of multiples of the chunk give the same output and state as
    one block, exactly (tests/test_costas_mm.py's absolute chunk grid)."""
    iq = _bpsk(16384 // 32 * chunk, f_err=20.0, seed=3)
    params = tc.make_costas_params(0.0, 0.05, 0.002, 8192)

    def run(splits):
        st = tc.CostasState(torch.tensor(0.0), torch.tensor(0.0))
        outs, i = [], 0
        for ln in splits:
            st, o = tc.costas_block_step(params, st, iq[i:i + ln],
                                         chunk=chunk)
            outs.append(o.numpy())
            i += ln
        assert i == len(iq)
        return np.concatenate(outs), (float(st.last_phase), float(st.f_dev))

    a, sa = run([len(iq)])
    m = [1, 128, 16, 64, 3, 268, 32]
    b, sb = run([chunk * x for x in m])
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_multichannel_equals_per_channel():
    """[K, C] planes == C single-channel runs (atol 1e-5, the JAX
    package's bound: torch's vectorised sin/cos on the CPU takes another
    code path for a lone column than inside a row of 4)."""
    params = tc.make_costas_params(0.0, 0.05, 0.002, 8192)
    rng = np.random.default_rng(5)
    k, c = 2048, 4
    xr = torch.from_numpy(rng.normal(scale=0.4, size=(k, c)).astype(
        np.float32))
    xi = torch.from_numpy(rng.normal(scale=0.4, size=(k, c)).astype(
        np.float32))
    _, o_re, o_im = tc.costas_block_planes(
        params, tc.init_costas_state(params, c, "cpu"), xr, xi, chunk=512)
    for ci in range(c):
        _, r1, i1 = tc.costas_block_planes(
            params, tc.init_costas_state(params, 1, "cpu"),
            xr[:, ci:ci + 1], xi[:, ci:ci + 1], chunk=512)
        np.testing.assert_allclose(o_re[:, ci].numpy(), r1[:, 0].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(o_im[:, ci].numpy(), i1[:, 0].numpy(),
                                   rtol=0, atol=1e-5)


def test_block_step_locks_and_tracks_serial():
    """The same BPSK capture: the block tier locks, and after lock its
    real rail agrees sign for sign with JAX's serial costas_step away from
    symbol transitions (tests/test_costas_mm.py)."""
    iq = _bpsk(40960, f_err=30.0)
    params = tc.make_costas_params(0.0, alpha=0.05, beta=0.002,
                                   e_max_q14=8192)
    st = tc.CostasState(torch.tensor(0.0), torch.tensor(0.0))
    _, out_b = tc.costas_block_step(params, st, iq)
    jparams = jc.make_costas_params(0.0, 0.05, 0.002, 8192)
    _, out_s = jc.costas_step(jparams, jc.init_costas_state(jparams), iq)
    out_b = out_b.numpy().astype(np.float64)
    out_s = np.asarray(out_s, np.float64)
    tail_b = out_b[10000:]
    assert np.mean(tail_b[:, 0] ** 2) > 20 * np.mean(tail_b[:, 1] ** 2)
    strong = np.abs(out_s[10000:, 0]) > 4000
    agree = np.sign(tail_b[strong, 0]) == np.sign(out_s[10000:][strong, 0])
    assert agree.mean() > 0.999, agree.mean()
    # and with JAX's own block tier: 1 LSB
    _, out_j = jc.costas_block_step(jparams, jc.init_costas_state(jparams),
                                    iq)
    d = np.abs(out_b - np.asarray(out_j, np.float64))
    assert d.max() <= 1, d.max()


def test_chain_scan_tier_raises():
    chain = CostasChannelizer(firdes_low_pass(1.0, 256_000, 6_000, 4_000),
                              [40_000], 256_000, 8, device="cpu")
    st = chain.init_state()
    with pytest.raises(ValueError, match="costas_step"):
        chain.step(st, np.zeros((chain.block_quantum, 2), np.int16),
                   tier="scan")
    with pytest.raises(ValueError, match="multiple"):
        chain.step(st, np.zeros((chain.block_quantum + 1, 2), np.int16))


def _chains(lpf, offsets, fs, d, **kw):
    return (JaxChain(lpf, offsets, fs, d, **kw),
            CostasChannelizer(lpf, offsets, fs, d, device="cpu", **kw))


def _post_lock_agreement(got, want):
    """Share of the post-lock samples (second half) within 1 LSB."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return (d[:, d.shape[1] // 2:] <= 1).mean(), int(d.max())


def test_chain_locks_on_bpsk_like_jax():
    """tests/test_costas_channel.py's BPSK capture through both chains in
    three blocks, state carried: both lock, and the port's int16 output is
    within 1 LSB of JAX's on >= 99.9 % of the post-lock samples."""
    fs, d, n = 256_000, 8, 128_000
    lpf = firdes_low_pass(1.0, fs, 6_000, 4_000)
    iq = _bpsk_capture(n, [40_000])
    jch, tch = _chains(lpf, [40_000], fs, d, alpha=0.1, beta=0.005,
                       e_max_q14=8192)
    assert tch.nr_channels == 1 and tch.carry_len == jch.carry_len
    js = jch.init_state(prefix=iq[:jch.carry_len])
    ts = tch.init_state(prefix=iq[:tch.carry_len])
    q = tch.block_quantum
    n_blk = (n - tch.carry_len) // q * q
    bounds = [0, n_blk // 3 // q * q, 2 * n_blk // 3 // q * q, n_blk]
    outs_j, outs_t = [], []
    for lo, hi in zip(bounds, bounds[1:]):
        blk = iq[tch.carry_len + lo:tch.carry_len + hi]
        js, oj = jch.step(js, blk)
        ts, ot = tch.step(ts, blk)
        outs_j.append(np.asarray(oj))
        outs_t.append(ot.numpy())
    want, got = np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)
    assert got.shape == want.shape == (1, n_blk // d, 2)
    assert _locked(got[0]) and _locked(want[0])
    share, worst = _post_lock_agreement(got, want)
    assert share >= 0.999, (share, worst)
    assert ts.out_index == int(js.out_index) == n_blk // d


def test_chain_at_the_device_row_plan_matches_jax():
    """A random 8-channel capture at BENCH_SUITE's costas_chain_device
    plan (1 Msps, decimation 8, 64 taps, offsets within +-fs/3), cut to
    65,536 samples in two blocks: the plan as the slice's (128-value rows,
    one carry row, 8 outputs a row, quantum 64, carry 64) and the output
    within 1 LSB of JAX's on >= 99.9 % of samples; then the BPSK channels
    at 8 offsets lock in both."""
    fs, d, c = 1_000_000, 8, 8
    lpf = firdes_low_pass(1.0, fs, 40_000, 20_000)[:64]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=c)
    jch, tch = _chains(lpf, offsets, fs, d, alpha=0.05, beta=0.002,
                       e_max_q14=8192)
    plan = tch.packed_plan
    assert (plan.row, plan.cr_rows, plan.opr, tch.block_quantum,
            tch.carry_len, tch.taps.grouped) == (128, 1, 8, 64, 64, False)
    n = 65_536
    iq = rng.integers(-8000, 8000, size=(tch.carry_len + n, 2),
                      dtype=np.int64).astype(np.int16)
    js = jch.init_state(prefix=iq[:jch.carry_len])
    ts = tch.init_state(prefix=iq[:tch.carry_len])
    for half in range(2):
        blk = iq[tch.carry_len + half * n // 2:tch.carry_len
                 + (half + 1) * n // 2]
        js, oj = jch.step(js, blk)
        ts, ot = tch.step(ts, blk)
        assert ot.shape == (c, n // 2 // d, 2) and ot.dtype == torch.int16
        d_ = np.abs(ot.numpy().astype(np.int32) - np.asarray(oj, np.int32))
        assert (d_ <= 1).mean() >= 0.999, ((d_ <= 1).mean(), d_.max())
    np.testing.assert_allclose(ts.costas.f_dev.numpy(),
                               np.asarray(js.costas.f_dev), rtol=0,
                               atol=1e-5)


def test_chain_locks_on_8_bpsk_channels_like_jax():
    """The BPSK capture widened to 8 channels at distinct offsets (256
    ksps, decimation 8): every channel locks in both chains, and the
    port's output is within 1 LSB of JAX's on >= 99.9 % of post-lock
    samples."""
    fs, d = 256_000, 8
    offsets = [-105_000, -75_000, -45_000, -15_000, 15_000, 45_000, 75_000,
               105_000]
    lpf = firdes_low_pass(1.0, fs, 6_000, 4_000)
    n = 96_000
    iq = _bpsk_capture(n, offsets, seed=35, amp=3000)
    jch, tch = _chains(lpf, offsets, fs, d, alpha=0.1, beta=0.005,
                       e_max_q14=8192)
    q = tch.block_quantum
    n_blk = (n - tch.carry_len) // q * q
    blk = iq[tch.carry_len:tch.carry_len + n_blk]
    _, oj = jch.step(jch.init_state(prefix=iq[:jch.carry_len]), blk)
    _, ot = tch.step(tch.init_state(prefix=iq[:tch.carry_len]), blk)
    got, want = ot.numpy(), np.asarray(oj)
    assert all(_locked(got[ci]) for ci in range(8))
    assert all(_locked(want[ci]) for ci in range(8))
    share, worst = _post_lock_agreement(got, want)
    assert share >= 0.999, (share, worst)


def test_chain_resumes_from_a_jax_state():
    """A JAX chain state converts to the port's and back: the port,
    resumed from JAX's state after one block, gives JAX's next block
    (within 1 LSB), and its state converts back to a JAX state that JAX
    resumes from."""
    fs, d = 256_000, 8
    lpf = firdes_low_pass(1.0, fs, 6_000, 4_000)
    iq = _bpsk_capture(64_000, [40_000], seed=36)
    jch, tch = _chains(lpf, [40_000], fs, d, alpha=0.1, beta=0.005,
                       e_max_q14=8192)
    c_len, q = tch.carry_len, tch.block_quantum
    b1 = iq[c_len:c_len + 240 * q]
    b2 = iq[c_len + 240 * q:c_len + 480 * q]
    js1, _ = jch.step(jch.init_state(prefix=iq[:c_len]), b1)
    ts1 = convert.costas_state_from_jax(js1)
    assert ts1.out_index == int(js1.out_index)
    back = convert.costas_state_to_jax(ts1, js1)
    for a, b in ((back.carry_vals, js1.carry_vals),
                 (back.out_index, js1.out_index),
                 (back.costas.last_phase, js1.costas.last_phase),
                 (back.costas.f_dev, js1.costas.f_dev)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    js2, oj = jch.step(js1, b2)
    ts2, ot = tch.step(ts1, b2)
    d_ = np.abs(ot.numpy().astype(np.int32) - np.asarray(oj, np.int32))
    assert (d_ <= 1).mean() >= 0.999, d_.max()
    js3, oj3 = jch.step(convert.costas_state_to_jax(ts2, js1), b1)
    assert np.asarray(oj3).shape == np.asarray(oj).shape


@pytest.mark.parametrize("f_shift,state", [(0.0, None), (1e-3, (5.9, 0.02)),
                                           (-2e-3, (-0.5, -0.31))])
def test_costas_native_equals_jax_binding(f_shift, state):
    """The native serial loop: the port's binding and the JAX package's,
    on the same C source, bit for bit, output and state."""
    iq = _bpsk(20_000, f_err=30.0, seed=4)
    iq[::97] = (-32768, 32767)
    tp = tc.make_costas_params(f_shift, 0.05, 0.002, 8192)
    jp = jc.make_costas_params(f_shift, 0.05, 0.002, 8192)
    got, gst = costas_native(iq, tp, state)
    want, wst = jax_costas_native(iq, jp, state)
    np.testing.assert_array_equal(got, want)
    assert gst == wst
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        costas_native(iq.reshape(-1), tp)


def test_costas_native_tracks_the_serial_oracle():
    """The native loop locks on the BPSK baseband like JAX's serial scan
    (tests/test_costas_mm.py)."""
    iq = _bpsk(20_000, f_err=30.0)
    out, _ = costas_native(iq, tc.make_costas_params(0.0, 0.05, 0.002, 8192))
    tail = out[5000:].astype(np.float64)
    assert np.mean(tail[:, 0] ** 2) > 20 * np.mean(tail[:, 1] ** 2)


def test_process_array_native_tail_not_dropped():
    """A capture in 18,000-sample blocks plus its tail equals the capture
    as one block, exactly (tests/test_models.py's check, port against
    port)."""
    fs, d, offset = 200_000, 8, 25_000
    iq = _bpsk_capture(50_000, [offset], fs=fs, seed=11)
    lpf = firdes_low_pass(1.0, fs, 10_000, 5_000)
    chain = CostasChannelizer(lpf, [offset], fs, d, device="cpu")
    want = chain.process_array_native(iq, block_size=len(iq))
    got = chain.process_array_native(iq, block_size=18_000)
    assert got.shape == want.shape == (
        1, (len(iq) - chain.carry_len) // chain.block_quantum
        * chain.block_quantum // d, 2)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="shorter"):
        chain.process_array_native(iq[:chain.carry_len + 1])


def test_process_array_native_locks_like_jax():
    """tests/test_costas_channel.py's native-path capture: both packages'
    native paths lock, and agree within 1 LSB on >= 99.9 % of post-lock
    samples."""
    fs, d, n = 256_000, 8, 128_000
    rng = np.random.default_rng(34)
    sym = rng.choice([-1.0, 1.0], size=n // 128 + 2)
    bb = np.repeat(sym, 128)[:n]
    ph = 2 * np.pi * (40_000 + 35.0) * np.arange(n) / fs
    iq = (np.stack([np.cos(ph) * bb, np.sin(ph) * bb], -1) * 9000
          + rng.normal(scale=60, size=(n, 2))).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 6_000, 4_000)
    jch, tch = _chains(lpf, [40_000], fs, d, alpha=0.1, beta=0.005,
                       e_max_q14=8192)
    want = jch.process_array_native(iq, block_size=8_192)
    got = tch.process_array_native(iq, block_size=8_192)
    assert got.shape == want.shape
    tail = got[0, got.shape[1] // 2:].astype(np.float64)
    assert np.mean(tail[:, 0] ** 2) > 20 * np.mean(tail[:, 1] ** 2)
    share, worst = _post_lock_agreement(got, want)
    assert share >= 0.999, (share, worst)


def _pocsag_pcm(spb):
    """tests/test_costas_mm.py's 1200 bps POCSAG stream at a fractional
    samples-per-bit, nearest-sample modulated."""
    bursts = [pocsag_gen.PocsagBurst(capcode=1000 + i, function=0,
                                     kind="numeric", content="123")
              for i in range(5)]
    bits = pocsag_gen.words_to_bits(pocsag_gen.build_words(bursts))
    all_bits = np.concatenate([np.resize(np.asarray([1, 0], np.uint8), 576),
                               bits])
    edges = np.round(np.arange(len(all_bits) + 1) * spb).astype(int)
    pcm = np.zeros(edges[-1], dtype=np.int16)
    for i, b in enumerate(all_bits):
        pcm[edges[i]:edges[i + 1]] = -9000 if b else 9000
    return pcm, len(bits) // 544


def _sync_count(dec, max_bits):
    reg, sync = 0, 0
    for s in dec:
        reg = ((reg << 1) | (1 if s < 0 else 0)) & 0xFFFFFFFF
        if bin(reg ^ 0x7CD215D8).count("1") <= max_bits:
            sync += 1
    return sync


@pytest.mark.parametrize("block", [4096, 1000, None])
@pytest.mark.parametrize("noise", [0, 1500])
def test_mueller_muller_equals_jax(block, noise):
    """The copy gives JAX's decisions, decision for decision, fed in
    blocks (its fractional offset carried) or whole, clean or with noise;
    on the clean stream it recovers the POCSAG sync words after
    acquisition (tests/test_costas_mm.py)."""
    spb = 25000.0 / 1200
    pcm, n_batches = _pocsag_pcm(spb)
    pcm = pcm + np.random.default_rng(9).integers(
        -noise, noise + 1, size=pcm.shape).astype(np.int16)
    kw = dict(kw=1e-4, km=4e-6, samples_per_bit=spb, error_min=spb - 2,
              error_max=spb + 2)
    mine, theirs = MuellerMuller(**kw), JaxMM(**kw)
    step = block or len(pcm)
    got = np.concatenate([mine.process(pcm[i:i + step])
                          for i in range(0, len(pcm), step)])
    want = np.concatenate([theirs.process(pcm[i:i + step])
                           for i in range(0, len(pcm), step)])
    np.testing.assert_array_equal(got, want)
    assert (mine.next_offset, mine.w, mine.m, mine.last_sample) == (
        theirs.next_offset, theirs.w, theirs.m, theirs.last_sample)
    if not noise:
        assert _sync_count(got, 4) >= n_batches - 1


def test_mueller_muller_fixture_sync_count():
    """tests/test_replay_fixtures.py's anchor on the committed synthetic
    stand-in: exactly 9 sync words, the same decisions as JAX's copy."""
    from pathlib import Path

    path = (Path(__file__).resolve().parent / "fixtures" / "replay"
            / "synthetic_pocsag_25khz_9sync.raw")
    pcm = np.fromfile(path, dtype=np.int16)
    spb = np.float32(25000.0) / np.float32(1200.0)
    kw = dict(kw=1e-4, km=4e-6, samples_per_bit=spb, error_min=spb - 0.05,
              error_max=spb + 0.05)
    got = MuellerMuller(**kw).process(pcm)
    np.testing.assert_array_equal(got, JaxMM(**kw).process(pcm))
    word, count = 0, 0
    for s in got:
        word = ((word << 1) | (0 if s > 0 else 1)) & 0xFFFFFFFF
        if bin(word ^ 0x7CD215D8).count("1") < 4:
            count += 1
    assert count == 9


def test_costas_after_channel_then_mueller_muller():
    """The two together: a locked Costas channel's real rail, rounded to
    PCM, through Mueller-Muller in both packages gives the same
    decisions."""
    iq = _bpsk(48_000, f_err=30.0, seed=8)
    params = tc.make_costas_params(0.0, 0.05, 0.002, 8192)
    st = tc.CostasState(torch.tensor(0.0), torch.tensor(0.0))
    _, out = tc.costas_block_step(params, st, iq)
    rail = out.numpy()[:, 0]
    spb = 48000.0 / 1200
    kw = dict(kw=1e-4, km=4e-6, samples_per_bit=spb, error_min=spb - 2,
              error_max=spb + 2)
    got = MuellerMuller(**kw).process(rail)
    np.testing.assert_array_equal(got, JaxMM(**kw).process(rail))
    assert abs(len(got) - len(rail) / spb) <= 0.01 * len(rail) / spb
