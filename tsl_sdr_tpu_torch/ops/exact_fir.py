"""The bit-exact tier's packed FIR (kernel K5) behind one function on
tensors.

:func:`exact_fir` computes, over the ``[carry ++ block]`` rows of ``ROW =
lcm(2D, 128)`` values, the chunked product ``P[r] = sum_i rows[r+i] @ W_i``
of :mod:`tsl_sdr_tpu_torch.ops.packed_fir` as wrapped int32 sums, and
returns them as ``out="q14"``: ``a_re``/``a_im`` int16 ``[rows, opr*C]``,
each ``(P >> 14) + ((P >> 13) & 1)`` narrowed mod 2^16 (the exact tier's
FIR planes), or ``out="raw"``: ``P`` itself, int32 ``[rows, 2*opr*C]`` (the
fast tier's debug tap, which needs the baseband K1 never writes).

On a CUDA tensor it launches ``csrc/bank.cu`` in its K5 modes (a
persistent grid over (sub-block, row tile) units with the taps resident in
shared memory where they fit, int8 tensor cores, integer epilogues),
replacing the bit-exact tier's device stage
``tsl_sdr_tpu/ops/packed_fir.py`` ``packed_fir_step_exact`` (an XLA int16 x
int16 -> int32 ``jnp.dot``, or ``_grouped_matmul`` for wide banks; torch's
CUDA matmul takes no int16 operands). On a CPU tensor it runs
:func:`exact_fir_plain`. The operands and launch shape are K5's own,
``ChainTaps.exact`` (:class:`tsl_sdr_tpu_torch.ops.chain.ExactTaps`), in
either form of the product; the tile is cut for a short block
(``ExactTaps.launch_rows``).
"""

from __future__ import annotations

import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import imma_split, q14
from tsl_sdr_tpu_torch.ops.chain import ChainTaps, _check

OUT_MODES = {"q14": 1, "raw": 2}


def exact_fir(taps: ChainTaps, carry_vals: torch.Tensor,
              block: torch.Tensor, out: str = "q14"):
    """carry_vals [cr*ROW] int16, block [rows*ROW] int16 (flat interleaved
    IQ) -> (a_re, a_im) int16 ``[rows, halfcols]`` (``out="q14"``) or the
    int32 sums ``[rows, 2*halfcols]`` (``out="raw"``)."""
    if out not in OUT_MODES:
        raise ValueError(f"out must be 'q14' or 'raw', not {out!r}")
    if block.device.type == "cpu":
        return exact_fir_plain(taps, carry_vals, block, out)
    if block.device.type != "cuda":
        raise ValueError(f"exact_fir runs on cuda or cpu, not {block.device}")
    plan = taps.plan
    _check(block, torch.int16, (block.numel(),), "block")
    _check(carry_vals, torch.int16, (plan.carry_vals,), "carry_vals")
    for name, t in (("block", block), ("carry_vals", carry_vals)):
        if t.device != taps.w_hi.device:
            raise ValueError(f"{name} on {t.device}, taps on "
                             f"{taps.w_hi.device}")
        if t.data_ptr() % 16:   # the kernel stages rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    rows = block.numel() // plan.row
    if rows == 0 or block.numel() % plan.row:
        raise ValueError(f"block of {block.numel()} values is not a whole, "
                         f"nonzero number of {plan.row}-value rows")
    if plan.win > imma_split.MAX_DEPTH:
        raise ValueError(f"{plan.win} taps a row exceed the split's depth "
                         f"limit {imma_split.MAX_DEPTH}")
    hc = plan.halfcols
    if out == "q14":
        res = torch.empty((2, rows, hc), dtype=torch.int16,
                          device=block.device)
    else:
        res = torch.empty((rows, 2 * hc), dtype=torch.int32,
                          device=block.device)
    lib = build.load()
    xt = taps.exact
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = lib.tsl_exact_fir(
        carry_vals.data_ptr(), block.data_ptr(), xt.w_hi.data_ptr(),
        xt.w_lo.data_ptr(), xt.ktab.data_ptr(), res.data_ptr(), rows,
        plan.row, plan.cr_rows, plan.win, plan.nr_channels, plan.opr,
        xt.tiles_per_block,
        xt.launch_rows(rows, build.sm_count(block.get_device())), xt.stages,
        xt.tap_block_bytes if xt.staged else 0, OUT_MODES[out], stream)
    build.check(err, "tsl_exact_fir")
    exact_fir.launches += 1
    exact_fir.grouped_launches += taps.grouped
    return (res[0], res[1]) if out == "q14" else res



exact_fir.launches = 0
exact_fir.grouped_launches = 0   # launches with grouped operands


def exact_fir_plain(taps: ChainTaps, carry_vals: torch.Tensor,
                    block: torch.Tensor, out: str = "q14"):
    """Plain torch version of :func:`exact_fir` (float64 products in the
    taps' form, wrapped to int32, then the Q.14 rounding), on any
    device."""
    p = taps.fir_sums(carry_vals, block)
    if out == "raw":
        return p
    half = taps.plan.halfcols
    return q14.round_q28_q14(p[:, :half]), q14.round_q28_q14(p[:, half:])
