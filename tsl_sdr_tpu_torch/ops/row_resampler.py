"""Packed-row rational resampler (kernel K3) behind one function on tensors.

:func:`row_resample` computes, for every channel ``g`` of a ratio group, the
int32 accumulators

    acc[g, m, j] = (T[m] @ w0 + T[m+1, :sp] @ w1)[j]

over the rows of ``T = carry ++ block`` (``ROW_IN`` samples each, zeros past
the stream's end), summed in wrapping int32, and writes them as
``out="f32"`` (``float32(acc) / 16384``, the fast tier) or ``out="q14"``
(int16 ``round_q28_q14(acc)``, the exact tier; a float32 cannot carry it, as
``|acc|`` exceeds 2^24). On a CUDA tensor it launches
``csrc/row_resampler.cu`` (which replaces the TPU kernel
``tsl_sdr_tpu/ops/pallas_resampler.py`` ``_row_kernel_v2``/``_row_call_v2``
and the XLA product of ``tsl_sdr_tpu/ops/polyphase.py:304-345``; the
products run on the int8 tensor cores through the exact split of
:mod:`tsl_sdr_tpu_torch.ops.imma_split`); on a CPU tensor it runs
:func:`row_resample_plain`. See the source note in
``csrc/row_resampler.cu`` for what bounds the kernel and how its design
responds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import imma_split, q14

OUT_MODES = {"f32": (0, torch.float32), "q14": (1, torch.int16)}


class RowTaps(NamedTuple):
    """A packed-row plan's taps on the device (built by
    :func:`tsl_sdr_tpu_torch.ops.polyphase.row_taps`)."""

    w0: torch.Tensor          # [ROW_IN, K_ROW] int16 (the plain version's)
    w1: torch.Tensor | None   # [sp_pad, K_ROW] int16, or None
    # [w0; w1[:spill]] zero-padded to a multiple of 32 rows and split into
    # high/low byte planes [K_PAD/32, K_ROW/8, 32, 8] uint8 (the kernel's)
    w_hi: torch.Tensor
    w_lo: torch.Tensor


def row_resample(carry: torch.Tensor, block: torch.Tensor, taps: RowTaps, *,
                 row_in: int, out: str = "f32") -> torch.Tensor:
    """carry [G, n_carry] int16, block [G, n] int16, ``taps`` of the plan
    -> [G, n // row_in, k_row] float32 (``out="f32"``) or int16
    (``out="q14"``)."""
    if out not in OUT_MODES:
        raise ValueError(f"out must be 'f32' or 'q14', not {out!r}")
    if block.device.type == "cpu":
        return row_resample_plain(carry, block, taps, row_in=row_in, out=out)
    if block.device.type != "cuda":
        raise ValueError(f"row_resample runs on cuda or cpu, not "
                         f"{block.device}")
    g, n = block.shape
    k_tiles, n_tiles = taps.w_hi.shape[:2]
    k_row, k_pad = 8 * n_tiles, 32 * k_tiles
    m = n // row_in
    checks = [(block, torch.int16, (g, n), "block"),
              (carry, torch.int16, (g, carry.shape[1]), "carry"),
              (taps.w_hi, torch.uint8, (k_tiles, n_tiles, 32, 8), "w_hi"),
              (taps.w_lo, torch.uint8, (k_tiles, n_tiles, 32, 8), "w_lo")]
    for t, dtype, shape, name in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != block.device:
            raise ValueError(f"{name} on {t.device}, block on {block.device}")
    if m == 0:
        raise ValueError(f"block of {n} samples holds no {row_in}-sample row")
    if k_row % 32:
        raise ValueError(f"k_row {k_row} is not a multiple of 32")
    if k_pad > imma_split.MAX_DEPTH:
        raise ValueError(f"{k_pad} taps a row exceed the split's depth "
                         f"limit {imma_split.MAX_DEPTH}")
    mode, dtype = OUT_MODES[out]
    lib = build.load()
    res = torch.empty((g, m, k_row), dtype=dtype, device=block.device)
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = lib.tsl_row_resample(
        carry.data_ptr(), block.data_ptr(), taps.w_hi.data_ptr(),
        taps.w_lo.data_ptr(), res.data_ptr(), m, row_in, k_row, k_pad,
        carry.shape[1], n, g, mode, stream)
    build.check(err, "tsl_row_resample")
    if mode:
        row_resample.launches_q14 += 1
    else:
        row_resample.launches += 1
    return res


row_resample.launches = 0       # launches with out="f32"
row_resample.launches_q14 = 0   # launches with out="q14"


def row_resample_plain(carry: torch.Tensor, block: torch.Tensor,
                       taps: RowTaps, *, row_in: int,
                       out: str = "f32") -> torch.Tensor:
    """Plain torch version of :func:`row_resample` on the int16 taps
    ``w0``/``w1``: float64 products (exact for int16 x int16 sums of a few
    thousand terms), wrapped to int32, then the same epilogue."""
    w0, w1 = taps.w0, taps.w1
    g, n = block.shape
    m = n // row_in
    total = torch.cat([carry, block], dim=1)[:, :(m + 1) * row_in]
    pad = (m + 1) * row_in - total.shape[1]
    if pad > 0:
        total = torch.nn.functional.pad(total, (0, pad))
    rows = total.reshape(g, m + 1, row_in).to(torch.float64)
    acc = rows[:, :m] @ w0.to(torch.float64)
    if w1 is not None:
        acc += rows[:, 1:, :w1.shape[0]] @ w1.to(torch.float64)
    return q14.from_acc(acc.to(torch.int64).to(torch.int32), out)
