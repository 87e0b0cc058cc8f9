"""The port's numpy plan builders against the JAX package's, and the plan
conversion helpers (tsl_sdr_tpu_torch/utils/convert.py).

Plans are static integer/float arrays built by the same arithmetic, so they
must be EXACTLY equal: any difference is a transcription error.
"""

import numpy as np
import pytest

from tsl_sdr_tpu.ops import packed_fir as jpf
from tsl_sdr_tpu.ops import polyphase as jpp
from tsl_sdr_tpu.ops import q14 as jq14
from tsl_sdr_tpu.utils.filter_design import (design_rational_resampler_filter,
                                             firdes_low_pass)
from tsl_sdr_tpu_torch.ops import packed_fir, polyphase, q14
from tsl_sdr_tpu_torch.utils import convert


def _assert_plans_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            assert len(x) == len(y), f
            for u, v in zip(x, y):
                assert np.asarray(u).dtype == np.asarray(v).dtype, f
                np.testing.assert_array_equal(u, v, err_msg=f)
        elif x is None or y is None:
            assert x is None and y is None, f
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


PACKED_CASES = [
    # (fs, decimation, lpf (cutoff, transition), channel offsets, gains)
    (1_228_800, 32, (9_600, 7_000),
     [-450_000, -190_000, 60_000, 320_000], None),          # pager widths
    (512_000, 16, (18_000, 9_000), [40_000, -100_000], [1.0, 0.5]),
    (1_000_000, 40, (12_500, 9_000), [138_000], None),
]


@pytest.mark.parametrize("fs,d,lpf,offs,gains", PACKED_CASES)
def test_packed_plan_matches_jax(fs, d, lpf, offs, gains):
    taps = firdes_low_pass(1.0, fs, *lpf)
    ref = jpf.make_packed_fir_plan(taps, offs, fs, d, gains)
    got = packed_fir.make_packed_fir_plan(taps, offs, fs, d, gains)
    _assert_plans_equal(ref, got)
    assert got.halfcols == ref.opr * ref.nr_channels


@pytest.mark.parametrize("i_,d_,target,align", [
    (5, 12, 54_400, False),   # FLEX from a 38.4 kHz channel (pipeline plan)
    (5, 4, 3 * 1_280, False),  # AIS from a 38.4 kHz channel
    (16, 25, 1 << 14, True),   # ResamplerChain's packed-row plan
    (2, 5, 1_000, True),
])
def test_resampler_plan_matches_jax(i_, d_, target, align):
    coeffs = design_rational_resampler_filter(i_, d_, 0.4)
    np.testing.assert_array_equal(q14.quantize_q14(coeffs),
                                  jq14.quantize_q14(coeffs))
    ref = jpp.make_resampler_plan(jq14.quantize_q14(coeffs), i_, d_,
                                  block_out_target=target, align_k_row=align)
    got = polyphase.make_resampler_plan(q14.quantize_q14(coeffs), i_, d_,
                                        block_out_target=target,
                                        align_k_row=align)
    _assert_plans_equal(ref, got)


def test_plan_conversion_round_trips():
    fs, d = 1_228_800, 32
    taps = firdes_low_pass(1.0, fs, 9_600, 7_000)
    jp = jpf.make_packed_fir_plan(taps, [60_000, -320_000], fs, d)
    tp = convert.plan_from_jax(jp)
    assert isinstance(tp, packed_fir.PackedFirPlan)
    _assert_plans_equal(tp, packed_fir.make_packed_fir_plan(
        taps, [60_000, -320_000], fs, d))
    _assert_plans_equal(convert.plan_to_jax(tp, jpf.PackedFirPlan), jp)

    coeffs = jq14.quantize_q14(design_rational_resampler_filter(5, 12, 0.4))
    jr = jpp.make_resampler_plan(coeffs, 5, 12, block_out_target=54_400,
                                 align_k_row=False)
    tr = convert.plan_from_jax(jr)
    assert isinstance(tr, polyphase.ResamplerPlan)
    _assert_plans_equal(convert.plan_to_jax(tr, jpp.ResamplerPlan), jr)
