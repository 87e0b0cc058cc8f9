"""Fused channelizer + FM (kernel K1) behind one function on tensors.

:func:`chain_fm` runs one streaming block: the packed FIR of
:mod:`tsl_sdr_tpu_torch.ops.packed_fir` and the discriminator of
:mod:`tsl_sdr_tpu_torch.ops.fm`, fused. On a CUDA tensor it launches
``csrc/chain.cu`` (which replaces the TPU kernels
``tsl_sdr_tpu/ops/pallas_chain.py`` ``_chain_kernel_v2``/``_chain_call_v2``
and ``_chain_kernel``/``_chain_call``); on a CPU tensor it runs
:func:`chain_fm_plain`, the same arithmetic in plain torch. See the source
note in ``csrc/chain.cu`` for what bounds the kernel on the H100 and how its
design responds.

State layout (the JAX XLA tier's ``MultifmFastState``): ``cr`` rows of int16
stream history and the previous baseband sample of each channel as a
``[2, C]`` float32 (re, im) tensor, which the kernel reads for the first
output row and writes for the last.
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import fm, imma_split, packed_fir
from tsl_sdr_tpu_torch.ops.packed_fir import PackedFirPlan

_SMEM_CAP = 227 * 1024   # what a block may use (kSmemCap in chain.cu)
_PITCH_PAD = 16          # bytes past ROW per staged row (kPitchPad)


class ChainTaps:
    """Device-resident constants of one plan: the int16 tap matrix split
    into the high/low byte planes the kernel reads (B-fragment order, see
    :mod:`tsl_sdr_tpu_torch.ops.imma_split`), its float64 chunk stack for
    the plain version, and the per-column FM rotation."""

    def __init__(self, plan: PackedFirPlan, omega_reduced, *, device):
        self.plan = plan
        hi, lo = imma_split.fragment_planes(packed_fir.tap_matrix_i16(plan))
        self.w_hi = torch.from_numpy(hi).to(device)
        self.w_lo = torch.from_numpy(lo).to(device)
        self.w_f64 = torch.from_numpy(
            np.stack(plan.w_chunks_i16).astype(np.float64)).to(device)
        om = np.asarray(omega_reduced, np.float32)
        self.omega_c = torch.from_numpy(om.copy()).to(device)
        self.omega_row = torch.from_numpy(np.tile(om, plan.opr)).to(device)
        self.tile_rows = tile_rows(plan.row, plan.cr_rows, plan.halfcols,
                                   plan.win)


def smem_bytes(tr: int, row: int, cr: int, hc: int) -> int:
    """Shared memory of a kernel block without the taps: the staged rows'
    high and low byte planes and two f32 accumulator planes (``x_bytes +
    acc_bytes`` in chain.cu)."""
    return 2 * (tr + 1 + cr) * (row + _PITCH_PAD) + 2 * (tr + 1) * hc * 4


def tap_bytes(u_len: int, hc: int) -> int:
    """Both split tap planes (``tap_bytes`` in chain.cu)."""
    return 2 * -(-u_len // 32) * -(-2 * hc // 8) * 256


def tile_rows(row: int, cr: int, hc: int, u_len: int) -> int:
    """Rows per kernel block: ``tr + 1`` (the tile and its look-back row) a
    multiple of the 16 rows of an m-tile, at most 256 (16 m-tiles, two per
    warp), the largest that fits in shared memory beside the staged taps,
    else the largest that fits without them."""
    for with_taps in (True, False):
        for rows in range(256, 0, -16):
            need = smem_bytes(rows - 1, row, cr, hc)
            if with_taps:
                need += tap_bytes(u_len, hc)
            if need <= _SMEM_CAP:
                return rows - 1
    raise ValueError(f"no tile fits in shared memory at row={row}, "
                     f"cr={cr}, halfcols={hc}")


def chain_fm(taps: ChainTaps, carry_vals: torch.Tensor, prev: torch.Tensor,
             block: torch.Tensor):
    """One block of the fused chain.

    carry_vals [cr*ROW] int16, prev [2, C] float32, block [rows*ROW] int16
    (flat interleaved IQ). Returns (pcm [rows, halfcols] int16 in flat
    (k, c) order, new prev [2, C] float32)."""
    if block.device.type == "cpu":
        return chain_fm_plain(taps, carry_vals, prev, block)
    if block.device.type != "cuda":
        raise ValueError(f"chain_fm runs on cuda or cpu, not {block.device}")
    plan = taps.plan
    _check(block, torch.int16, (block.numel(),), "block")
    _check(carry_vals, torch.int16, (plan.carry_vals,), "carry_vals")
    _check(prev, torch.float32, (2, plan.nr_channels), "prev")
    for name, t in (("block", block), ("carry_vals", carry_vals),
                    ("prev", prev)):
        if t.device != taps.w_hi.device:
            raise ValueError(f"{name} on {t.device}, taps on "
                             f"{taps.w_hi.device}")
    for name, t in (("block", block), ("carry_vals", carry_vals)):
        if t.data_ptr() % 16:   # the kernel stages rows with 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    rows = block.numel() // plan.row
    if rows == 0 or block.numel() % plan.row:
        raise ValueError(f"block of {block.numel()} values is not a whole, "
                         f"nonzero number of {plan.row}-value rows")
    if plan.win > imma_split.MAX_DEPTH:
        raise ValueError(f"{plan.win} taps a row exceed the split's depth "
                         f"limit {imma_split.MAX_DEPTH}")
    lib = build.load()
    out = torch.empty((rows, plan.halfcols), dtype=torch.int16,
                      device=block.device)
    prev_out = torch.empty_like(prev)
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = lib.tsl_chain_fm(
        carry_vals.data_ptr(), block.data_ptr(), taps.w_hi.data_ptr(),
        taps.w_lo.data_ptr(), taps.omega_row.data_ptr(), prev.data_ptr(),
        out.data_ptr(),
        prev_out.data_ptr(), rows, plan.row, plan.cr_rows, plan.win,
        plan.halfcols, plan.nr_channels, taps.tile_rows, stream)
    build.check(err, "tsl_chain_fm")
    chain_fm.launches += 1
    return out, prev_out


chain_fm.launches = 0


def chain_fm_plain(taps: ChainTaps, carry_vals: torch.Tensor,
                   prev: torch.Tensor, block: torch.Tensor):
    """Plain torch version of :func:`chain_fm` (float64 FIR products, the
    same float32 discriminator), on any device."""
    _, ar, ai = packed_fir.packed_fir_step(taps.plan, carry_vals, block,
                                           taps.w_f64)
    pcm, pr, pi_ = fm.fm_from_baseband(ar, ai, prev[0], prev[1],
                                       taps.omega_c)
    return pcm, torch.stack([pr, pi_])


def _check(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
