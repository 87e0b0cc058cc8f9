"""The port's packed-row resampler (ops/polyphase.py + ops/row_resampler.py,
kernel K3) against the JAX package.

Tolerances:
- vs ``polyphase.resample_step(exact=False)`` (XLA int16 product): BIT-EQUAL.
  Both take the exact int32 accumulator, convert it to float32 and scale by
  1/16384 (a power of two, so exact).
- vs ``PallasResampler(precision="highest")`` in interpret mode: atol 0.01
  (its f32 matmul rounds the sum; tests/test_pallas_resampler.py:53).
(The CUDA kernel against the plain version: tests/test_torch_cuda.py.)
"""

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.ops import polyphase as jpp
from tsl_sdr_tpu.ops import q14 as jq14
from tsl_sdr_tpu.ops.pallas_resampler import PallasResampler
from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter
from tsl_sdr_tpu_torch.ops import polyphase
from tsl_sdr_tpu_torch.ops import row_resampler as k3
from tsl_sdr_tpu_torch.utils import convert


def _plan(i_, d_, target, align):
    coeffs = jq14.quantize_q14(design_rational_resampler_filter(i_, d_, 0.4))
    return jpp.make_resampler_plan(coeffs, i_, d_, block_out_target=target,
                                   align_k_row=align)


@pytest.mark.parametrize("i_,d_,target,align", [
    (5, 12, 3 * 640, False),   # the pipeline's FLEX ratio, 3 rows a block
    (16, 25, 1 << 12, True),   # ResamplerChain's plan
])
def test_plain_matches_xla_resample_step(i_, d_, target, align):
    jplan = _plan(i_, d_, target, align)
    plan = convert.plan_from_jax(jplan)
    assert plan.k_row
    rng = np.random.default_rng(0)
    g, nb = 3, 3
    x = rng.integers(-12000, 12000, size=(g, plan.carry_len + nb
                                          * plan.block_in)).astype(np.int16)
    ref = []
    for ch in range(g):
        st = jpp.init_resampler_state(jplan, prefix=x[ch, :plan.carry_len])
        outs = []
        for b in range(nb):
            lo = plan.carry_len + b * plan.block_in
            st, o = jpp.resample_step(jplan, st, x[ch, lo:lo + plan.block_in],
                                      exact=False)
            outs.append(np.asarray(o))
        ref.append(np.concatenate(outs))
    taps = polyphase.row_taps(plan, device="cpu")
    carry = torch.from_numpy(x[:, :plan.carry_len].copy())
    got = []
    for b in range(nb):
        lo = plan.carry_len + b * plan.block_in
        carry, o = polyphase.resample_step(
            plan, carry, torch.from_numpy(x[:, lo:lo + plan.block_in].copy()),
            taps)
        got.append(o.numpy())
    np.testing.assert_array_equal(np.concatenate(got, axis=1), np.stack(ref))
    np.testing.assert_array_equal(carry.numpy(), x[:, -plan.carry_len:])


def test_plain_matches_pallas_interpret():
    jplan = _plan(16, 25, 1 << 12, True)
    plan = convert.plan_from_jax(jplan)
    rng = np.random.default_rng(1)
    tr, m = 8, 32
    total = rng.integers(-12000, 12000, size=((m + 1) * plan.row_in,),
                         dtype=np.int64).astype(np.int16)
    pr = PallasResampler(jplan, tile_rows=tr, precision="highest",
                         interpret=True)
    _, ref = pr.step(pr.init_carry(total[:plan.row_in]), total[plan.row_in:])
    taps = polyphase.row_taps(plan, device="cpu")
    # the Pallas rows are the stream's rows 0..m-1 (its carry IS row 0)
    got = k3.row_resample(torch.zeros((1, 0), dtype=torch.int16),
                          torch.from_numpy(total[None].copy()), taps,
                          row_in=plan.row_in)[0, :m]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.01)


def test_ragged_stream_end_reads_zeros():
    """Rows whose spill reaches past the stream's end read zeros, as the
    XLA kernel's zero pad does."""
    plan = convert.plan_from_jax(_plan(5, 12, 3 * 640, False))
    taps = polyphase.row_taps(plan, device="cpu")
    rng = np.random.default_rng(2)
    block = rng.integers(-9000, 9000, size=(2, plan.block_in + 100)).astype(
        np.int16)
    carry = rng.integers(-9000, 9000, size=(2, plan.carry_len)).astype(
        np.int16)
    out = k3.row_resample(torch.from_numpy(carry), torch.from_numpy(block),
                          taps, row_in=plan.row_in)
    m = block.shape[1] // plan.row_in
    total = np.concatenate([carry, block], axis=1).astype(np.float64)
    total = np.pad(total, ((0, 0), (0, (m + 1) * plan.row_in
                                    - total.shape[1])))[:, :(m + 1)
                                                        * plan.row_in]
    rows = total.reshape(2, m + 1, plan.row_in)
    sp = plan.w_spill_i16.shape[0]
    ref = (rows[:, :m] @ plan.w_row_i16.astype(np.float64)
           + rows[:, 1:, :sp] @ plan.w_spill_i16.astype(np.float64)) / 16384
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.float32))
