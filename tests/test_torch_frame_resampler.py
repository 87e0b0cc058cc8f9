"""The port's frame-form resampler (ops/frame_resampler.py, kernel K4) and
the exact tier of both resampler forms, against the JAX package.

Tolerances:
- frame-form ``polyphase.resample_step`` vs the JAX ``resample_step`` (XLA
  transposed-residue tier), exact and fast: BIT-EQUAL. Both sum int16 x
  int16 products in wrapping int32 (order-free), then apply the same
  epilogue: Q.28 -> Q.14 rounding, or float32 conversion and a
  power-of-two scale.
- packed-row ``resample_step(exact=True)`` (K3's q14 mode) vs the JAX
  ``resample_step(exact=True)``: BIT-EQUAL, for the same reason.
- ``resample_capture`` vs ``resample_capture_pallas(interpret=True)``:
  atol 0.01 (its float32 HIGHEST dot rounds the sum;
  tests/test_polyphase.py:101).
- ``q14.round_q28_q14`` vs the JAX one: EQUAL on every int32 edge.
(The CUDA kernels against the plain versions: tests/test_torch_cuda.py.)
"""

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.ops import polyphase as jpp
from tsl_sdr_tpu.ops import q14 as jq14
from tsl_sdr_tpu.ops.pallas_resampler import resample_capture_pallas
from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter
from tsl_sdr_tpu_torch.ops import frame_resampler as k4
from tsl_sdr_tpu_torch.ops import polyphase, q14
from tsl_sdr_tpu_torch.utils import convert


def _plans(i_, d_, target=1024, align=True, coeffs=None):
    if coeffs is None:
        coeffs = jq14.quantize_q14(design_rational_resampler_filter(i_, d_,
                                                                    0.4))
    jplan = jpp.make_resampler_plan(coeffs, i_, d_, block_out_target=target,
                                    align_k_row=align)
    return jplan, convert.plan_from_jax(jplan)


def _streams(jplan, plan, x, nb, exact):
    """Both packages' outputs for ``nb`` blocks of each row of ``x``."""
    ref = []
    for row in x:
        st = jpp.init_resampler_state(jplan, prefix=row[:plan.carry_len])
        outs = []
        for b in range(nb):
            lo = plan.carry_len + b * plan.block_in
            st, o = jpp.resample_step(jplan, st, row[lo:lo + plan.block_in],
                                      exact=exact)
            outs.append(np.asarray(o))
        ref.append(np.concatenate(outs))
    taps = polyphase.plan_taps(plan, device="cpu")
    carry = polyphase.init_resampler_carry(plan, len(x), device="cpu",
                                           prefix=x[:, :plan.carry_len])
    got = []
    for b in range(nb):
        lo = plan.carry_len + b * plan.block_in
        carry, o = polyphase.resample_step(
            plan, carry, torch.from_numpy(x[:, lo:lo + plan.block_in].copy()),
            taps, exact=exact)
        got.append(o.numpy())
    np.testing.assert_array_equal(carry.numpy(), x[:, -plan.carry_len:])
    return np.concatenate(got, axis=1), np.stack(ref)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("i_,d_", [(147, 160), (25, 16), (25, 48), (64, 1),
                                   (64, 3), (32, 5)])
def test_frame_step_matches_jax(i_, d_, exact):
    """The plans of tests/test_polyphase.py:184-205 that have no packed-row
    form: lcm(I_rep, 128) > 1024, or a spill longer than a row."""
    jplan, plan = _plans(i_, d_)
    assert plan.k_row == 0
    rng = np.random.default_rng(i_ * 1000 + d_)
    nb = 3
    x = rng.integers(-32768, 32768, size=(2, plan.carry_len + nb
                                          * plan.block_in)).astype(np.int16)
    got, ref = _streams(jplan, plan, x, nb, exact)
    assert got.dtype == (np.int16 if exact else np.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_frame_step_int32_wrap_matches_jax(exact):
    """Random taps at full scale overflow int32: both packages wrap."""
    rng = np.random.default_rng(7)
    coeffs = jq14.quantize_q14(rng.normal(size=161) * 0.9)
    jplan, plan = _plans(25, 16, coeffs=coeffs)
    x = rng.choice(np.array([-32768, 32767], np.int16),
                   size=(1, plan.carry_len + 2 * plan.block_in))
    got, ref = _streams(jplan, plan, x, 2, exact)
    np.testing.assert_array_equal(got, ref)
    # some accumulators did wrap
    p = plan.taps_sel_i16.shape[1]
    acc = [int(x[0, off:off + p].astype(np.int64)
               @ plan.taps_sel_i16[k].astype(np.int64))
           for k, off in enumerate(plan.offsets)]
    assert max(map(abs, acc)) >= 2 ** 31


@pytest.mark.parametrize("i_,d_,target,align", [
    (16, 25, 1024, True),      # ResamplerChain's FLEX plan
    (192, 125, 1024, True),    # etc/pocsag_38400_from_25k.json
    (5, 12, 3 * 640, False),   # the pipeline's FLEX group
])
def test_row_step_exact_matches_jax(i_, d_, target, align):
    """K3's q14 mode: the packed-row exact tier."""
    jplan, plan = _plans(i_, d_, target, align)
    assert plan.k_row
    rng = np.random.default_rng(i_)
    nb = 3
    x = rng.integers(-32768, 32768, size=(3, plan.carry_len + nb
                                          * plan.block_in)).astype(np.int16)
    got, ref = _streams(jplan, plan, x, nb, exact=True)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("i_,d_", [(16, 25), (147, 160)])
def test_resample_capture_matches_pallas_interpret(i_, d_):
    jplan, plan = _plans(i_, d_)
    rng = np.random.default_rng(3)
    pcm = rng.integers(-12000, 12000, size=(37 * plan.d_rep,),
                       dtype=np.int64).astype(np.int16)
    ref = np.asarray(resample_capture_pallas(jplan, pcm, tile_frames=8,
                                             interpret=True))
    taps = k4.frame_taps(plan, device="cpu")
    got = k4.resample_capture(plan, torch.from_numpy(pcm), taps)
    assert got.shape == ref.shape == (37 * plan.i_rep,)
    np.testing.assert_allclose(got.numpy(), ref, atol=0.01)


def test_resample_capture_contract():
    """Output k is the window at k * D // I; the last frames read zeros."""
    _, plan = _plans(25, 16)
    taps = k4.frame_taps(plan, device="cpu")
    rng = np.random.default_rng(4)
    pcm = rng.integers(-9000, 9000, size=(20 * plan.d_rep,)).astype(np.int16)
    got = k4.resample_capture(plan, torch.from_numpy(pcm), taps,
                              out="q14").numpy()
    padded = np.concatenate([pcm, np.zeros(plan.frame_shifts * plan.d_rep,
                                           np.int16)]).astype(np.int64)
    p = plan.taps_sel_i16.shape[1]
    for k in range(got.shape[0]):
        off = k * plan.decimation // plan.interpolation
        w = plan.taps_sel_i16[k % plan.i_rep].astype(np.int64)
        acc = int((padded[off:off + p] * w).sum())
        acc = (acc + 2 ** 31) % 2 ** 32 - 2 ** 31
        want = ((acc >> 14) + ((acc >> 13) & 1) + 2 ** 15) % 2 ** 16 - 2 ** 15
        assert got[k] == want, k
    with pytest.raises(ValueError, match="multiple"):
        k4.resample_capture(plan, torch.from_numpy(pcm[:-1]), taps)


def test_round_q28_q14_matches_jax():
    edges = np.array([0, 1, -1, 8191, 8192, -8192, -8193, 16383, 16384,
                      2 ** 31 - 1, -2 ** 31, 2 ** 29 + 8192, -(2 ** 29) - 1,
                      536862720, -536862721], dtype=np.int32)
    rng = np.random.default_rng(5)
    a = np.concatenate([edges, rng.integers(-2 ** 31, 2 ** 31, size=10_000,
                                            dtype=np.int64).astype(np.int32)])
    got = q14.round_q28_q14(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq14.round_q28_q14(a)))
    with pytest.raises(ValueError, match="f32"):
        q14.from_acc(torch.from_numpy(a), "f16")
