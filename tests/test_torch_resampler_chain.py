"""The port's decoder front end (models/resampler.py ResamplerChain,
runtime/stream.py PushResampler, ops/dc_blocker.py exact tier) against the
JAX package.

Tolerances:
- ``process_array``, exact tier: BIT-EQUAL to the JAX ``process_array`` and
  to ``oracles.polyphase_oracle`` (the reference's arithmetic); fast tier:
  BIT-EQUAL (same int32 sums, same float32 epilogue). The captures are
  61,337 samples, so every case has a capture tail; at 16/25 the tail plans
  have no packed-row form (k_row == 0), at 147/160 no plan has one.
- with the DC blocker (``-b``): exact tier BIT-EQUAL (the same integer
  recurrence); fast tier within 2 LSB (float32 associative scan in JAX,
  float64 chunked scan here; tests/test_torch_stages.py holds the same).
- ``PushResampler`` at random push splits and ``dc_blocker_step_exact``
  across blocks: BIT-EQUAL; chain state converts both ways leaf for leaf.
"""

import numpy as np
import pytest
import torch

import oracles
from tsl_sdr_tpu.models import resampler as jres
from tsl_sdr_tpu.ops import dc_blocker as jdc
from tsl_sdr_tpu.ops import q14 as jq14
from tsl_sdr_tpu.runtime import stream as jstream
from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter
from tsl_sdr_tpu_torch.models import resampler as tres
from tsl_sdr_tpu_torch.ops import dc_blocker as tdc
from tsl_sdr_tpu_torch.runtime import stream as tstream
from tsl_sdr_tpu_torch.utils import convert

N_SAMPLES = 61_337


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(51)
    return rng.integers(-12000, 12000, size=N_SAMPLES,
                        dtype=np.int64).astype(np.int16)


def _chains(i_, d_, **kw):
    coeffs = design_rational_resampler_filter(i_, d_, 0.4)
    return (jres.ResamplerChain(coeffs, i_, d_, **kw),
            tres.ResamplerChain(coeffs, i_, d_, device="cpu", **kw))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("block_out", [256, 4096])
@pytest.mark.parametrize("i_,d_", [(16, 25), (147, 160)])
def test_process_array_matches_jax(pcm, i_, d_, block_out, exact):
    jc, tc = _chains(i_, d_, block_out=block_out, exact=exact)
    ref = jc.process_array(pcm)
    got = tc.process_array(pcm)
    assert got.dtype == ref.dtype == (np.int16 if exact else np.float32)
    np.testing.assert_array_equal(got, ref)
    tail = N_SAMPLES - tc.plan.carry_len
    tail = tail - tail // tc.plan.block_in * tc.plan.block_in
    assert tail >= tc.plan.d_rep      # the tail plan ran
    assert tc._tail_plan(tail // tc.plan.d_rep * tc.plan.d_rep).k_row == 0
    if exact:
        want = oracles.polyphase_oracle(pcm, jq14.quantize_q14(
            design_rational_resampler_filter(i_, d_, 0.4)), i_, d_)
        assert 0 < len(want) - len(got) < 2 * i_
        np.testing.assert_array_equal(got, want[:len(got)])
    dev = tc.process_array_device(torch.from_numpy(pcm))
    np.testing.assert_array_equal(dev.numpy(), got)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("i_,d_", [(192, 125), (147, 160)])
def test_process_array_dc_block_matches_jax(pcm, i_, d_, exact):
    jc, tc = _chains(i_, d_, exact=exact, dc_block_pole=0.9999)
    ref, got = jc.process_array(pcm), tc.process_array(pcm)
    assert got.dtype == ref.dtype == np.int16
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got.astype(np.int32) - ref).max() <= 2


@pytest.mark.parametrize("exact,pole", [(True, None), (False, None),
                                        (True, 0.9999), (False, 0.999)],
                         ids=["exact", "fast", "exact-dc", "fast-dc"])
@pytest.mark.parametrize("i_,d_", [(25, 16), (16, 25)])
def test_push_resampler_matches_jax(pcm, i_, d_, exact, pole):
    """Random push splits through both packages' PushResampler, flush
    included (frame form at 25/16, packed-row at 16/25)."""
    jc, tc = _chains(i_, d_, exact=exact, dc_block_pole=pole)
    rng = np.random.default_rng(i_ + d_)
    cuts = np.sort(rng.integers(0, 20_000, size=7))
    bounds = [0, *cuts, 20_000]
    outs = {}
    for name, pr in (("jax", jstream.PushResampler(jc)),
                     ("torch", tstream.PushResampler(tc))):
        parts = [pr.push(pcm[lo:hi]) for lo, hi in zip(bounds, bounds[1:])]
        parts.append(pr.flush())
        outs[name] = np.concatenate(parts)
    ref, got = outs["jax"], outs["torch"]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if exact or pole is None:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got.astype(np.int32) - ref).max() <= 2


def test_dc_blocker_exact_matches_jax_across_blocks():
    rng = np.random.default_rng(9)
    x = rng.integers(-32768, 32768, size=10_000).astype(np.int16)
    p = jdc.make_pole_coeff(0.99)
    js = jdc.init_dc_blocker_state()
    ts = tdc.init_dc_blocker_state(device="cpu")
    for lo, hi in [(0, 1), (1, 1024), (1024, 5555), (5555, 10_000)]:
        js, jo = jdc.dc_blocker_step_exact(js, x[lo:hi], p)
        ts, to = tdc.dc_blocker_step_exact(
            ts, torch.from_numpy(x[lo:hi].copy()), p)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert [int(v) for v in ts] == [int(v) for v in js]
    ref = oracles.dc_blocker_oracle(x, 0.99)
    st = torch.zeros((2, 3), dtype=torch.int32)
    out = tdc.dc_block_exact(st, torch.from_numpy(np.stack([x, x])), p)
    np.testing.assert_array_equal(out.numpy(), np.stack([ref, ref]))


def test_chain_state_round_trip_and_step_from_jax_state(pcm):
    """A mid-stream JAX chain state converts to the port's and back leaf
    for leaf, and one step from it gives the same output and state."""
    jc, tc = _chains(192, 125, exact=True, dc_block_pole=0.9999)
    c_len, n_in = jc.plan.carry_len, jc.plan.block_in
    jst = jc.init_state(prefix=pcm[:c_len])
    for b in range(3):
        jst, _ = jc.step(jst, pcm[c_len + b * n_in: c_len + (b + 1) * n_in])
    st = convert.chain_state_from_jax(jst)
    back = convert.chain_state_to_jax(st, like=jst)
    assert type(back) is type(jst)
    np.testing.assert_array_equal(back.resampler.carry,
                                  np.asarray(jst.resampler.carry))
    for a, b in zip(back.dc, jst.dc):
        np.testing.assert_array_equal(a, np.asarray(b))
    block = pcm[c_len + 3 * n_in: c_len + 4 * n_in]
    jst2, jout = jc.step(jst, block)
    st2, out = tc.step(st, torch.from_numpy(block.copy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(st2.resampler.numpy(),
                                  np.asarray(jst2.resampler.carry))
    assert [int(v) for v in st2.dc] == [int(v) for v in jst2.dc]


def test_stream_helpers_match_jax(tmp_path, capsys):
    """The jax-free copies of the CLIs' helpers: counters' summary, the
    stats line (its rate aside) and file blocks split at the item unit."""
    raw = np.random.default_rng(2).integers(0, 256, size=1001, dtype=np.uint8)
    src = tmp_path / "in.bin"
    raw.tofile(src)
    seen = {}
    for name, mod in (("jax", jstream), ("torch", tstream)):
        c = mod.StreamCounters(samples_in=10, samples_out=7, messages=2)
        ticker = mod.StatsTicker(1e-9, c, "tool")
        ticker.tick(" +x")
        line = capsys.readouterr().err
        blocks = [b.tolist() for b in mod.iter_file_blocks(
            src, block_bytes=64, unit_items=2)]
        seen[name] = (c.summary(), line.split("[")[0], line.endswith("+x\n"),
                      blocks)
    assert seen["torch"] == seen["jax"]
    assert sum(map(len, seen["torch"][3])) == 1000 // 4 * 2


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.ResamplerChain([1.0], 1, 1)
