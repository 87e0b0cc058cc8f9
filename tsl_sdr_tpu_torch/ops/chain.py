"""Fused channelizer + FM (kernel K1) behind one function on tensors.

:func:`chain_fm` runs one streaming block: the packed FIR of
:mod:`tsl_sdr_tpu_torch.ops.packed_fir` and the discriminator of
:mod:`tsl_sdr_tpu_torch.ops.fm`, fused. On a CUDA tensor it launches
``csrc/chain.cu`` (which replaces the TPU kernels
``tsl_sdr_tpu/ops/pallas_chain.py`` ``_chain_kernel_v2``/``_chain_call_v2``
and ``_chain_kernel``/``_chain_call``, in both forms of their FIR body
``_fir_acc``: chunked, and phase-grouped for wide banks); on a CPU tensor
it runs :func:`chain_fm_plain`, the same arithmetic in plain torch. See the
source note in ``csrc/chain.cu`` for what bounds the kernel on the H100 and
how its design responds.

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
_TILE_BYTES = 2 * 256    # one 32x8 k-step of a column tile, both planes
_GROUP = 4               # n8 tiles a warp multiplies together (kNtG)


class ChainTaps:
    """Device-resident constants of one plan, for K1 and K5.

    ``grouped`` picks the form of the product, as ``PallasChain(grouped=)``
    does (``None``: :func:`~tsl_sdr_tpu_torch.ops.packed_fir.
    grouped_fir_worthwhile`, the JAX package's choice). Grouped, the plain
    version runs :func:`~tsl_sdr_tpu_torch.ops.packed_fir.grouped_fir_sums`
    and the kernel gives each 8-column tile only the 32-value k-steps that
    hold its non-zero taps; chunked, the plain version runs
    :func:`~tsl_sdr_tpu_torch.ops.packed_fir.packed_fir_sums` and every
    tile all ``ceil(win / 32)`` k-steps. The sums are the same either way.

    The kernel's operands: the tap matrix's columns in channel blocks of
    ``chans_per_block`` channels (:func:`channel_block_columns`), split
    into high/low byte planes in B-fragment order
    (:mod:`tsl_sdr_tpu_torch.ops.imma_split`) that keep, for each group of 4
    tiles a warp multiplies together, the k-steps of their ranges, the 4
    side by side a step (``w_hi``/``w_lo`` ``[L, 32, 8]``,
    :func:`~tsl_sdr_tpu_torch.ops.imma_split.compact_groups`); ``ktab``
    int32 ``[tiles, 4]``: each tile's first and end k-step, its group's
    base (step ``ks`` of the group's tile ``j`` is fragment ``base + 4*ks +
    j``) and the end of its block's fragments; ``tile_rows`` and
    ``chans_per_block``, the launch shape (:func:`launch_shape`)."""

    def __init__(self, plan: PackedFirPlan, omega_reduced, *, device,
                 grouped: bool | None = None):
        self.plan = plan
        if grouped is None:
            grouped = packed_fir.grouped_fir_worthwhile(plan)
        self.grouped = bool(grouped)
        self.grouped_plan = (packed_fir.make_grouped_from_plan(plan)
                             if self.grouped else None)
        self.w_f64 = self.wg_f64 = None
        if self.grouped:
            self.wg_f64 = torch.from_numpy(
                self.grouped_plan.wg_i16.astype(np.float64)).to(device)
        else:
            self.w_f64 = torch.from_numpy(
                np.stack(plan.w_chunks_i16).astype(np.float64)).to(device)
        om = np.asarray(omega_reduced, np.float32)
        self.omega_c = torch.from_numpy(om.copy()).to(device)
        self.omega_row = torch.from_numpy(np.tile(om, plan.opr)).to(device)

        w = packed_fir.tap_matrix_i16(plan)
        layouts = {}

        def tap_bytes(cpb):
            cols = channel_block_columns(plan.opr, plan.nr_channels, cpb)
            ranges = tile_ranges(w, cols, self.grouped)
            layouts[cpb] = (cols, ranges,
                            block_tap_bytes(ranges, plan.nr_channels, cpb))
            return layouts[cpb][2]

        self.tile_rows, self.chans_per_block = launch_shape(
            plan.row, plan.cr_rows, plan.nr_channels, plan.opr, tap_bytes)
        cols, ranges, self.tap_block_bytes = layouts[self.chans_per_block]
        hi, lo = imma_split.fragment_planes(permuted_taps(w, cols))
        hi, lo, base, end = imma_split.compact_groups(
            hi, lo, ranges, self.tiles_per_block, _GROUP)
        self.w_hi = torch.from_numpy(hi).to(device)
        self.w_lo = torch.from_numpy(lo).to(device)
        self.ktab = torch.from_numpy(np.stack(
            [ranges[:, 0], ranges[:, 1], base, end],
            axis=1).astype(np.int32)).to(device)

    @property
    def tiles_per_block(self) -> int:
        """n8 tiles of one channel block's tap columns."""
        return -(-2 * self.plan.opr * self.chans_per_block // 8)

    def fir_sums(self, carry_vals: torch.Tensor,
                 block: torch.Tensor) -> torch.Tensor:
        """The product's wrapped int32 sums ``[rows, 2*halfcols]`` in plain
        torch, in the chosen form (the XLA tier's choice)."""
        if self.grouped:
            return packed_fir.grouped_fir_sums(
                self.plan, self.grouped_plan, carry_vals, block, self.wg_f64)
        return packed_fir.packed_fir_sums(self.plan, carry_vals, block,
                                          self.w_f64)


def channel_block_columns(opr: int, nr_ch: int, cpb: int) -> np.ndarray:
    """The kernel's tap columns: block ``b`` holds channels ``[b*cpb,
    (b+1)*cpb)`` as ``[re | im] x phase x channel``, padded to whole
    8-column tiles. Returns, per kernel column, the tap matrix column it
    holds (``[re/im, j, c]`` order), or -1 for padding. With one block
    (``cpb == nr_ch``) it is the tap matrix's own order."""
    nb = -(-nr_ch // cpb)
    width = -(-2 * opr * cpb // 8) * 8
    ri, j, cl = np.meshgrid(np.arange(2), np.arange(opr), np.arange(cpb),
                            indexing="ij")
    cols = np.full((nb, width), -1, np.int64)
    for b in range(nb):
        c = b * cpb + cl
        cols[b, :2 * opr * cpb] = np.where(
            c < nr_ch, (ri * opr + j) * nr_ch + c, -1).reshape(-1)
    return cols.reshape(-1)


def permuted_taps(w: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The ``[win, 2*halfcols]`` tap matrix in the kernel's column order
    (zeros in padding columns)."""
    out = np.zeros((w.shape[0], cols.size), np.int16)
    out[:, cols >= 0] = w[:, cols[cols >= 0]]
    return out


def tile_ranges(w: np.ndarray, cols: np.ndarray, grouped: bool) -> np.ndarray:
    """int64 ``[tiles, 2]``: the k-steps ``[first, end)`` each 8-column
    tile of the kernel's tap matrix runs. Grouped: from the 32-value step of
    its first non-zero tap to that of its last (empty for a tile of zeros);
    chunked: all of them for a tile with a column of the matrix, none for
    a tile of padding."""
    win = w.shape[0]
    n_tiles = cols.size // 8
    if not grouped:
        real = (cols >= 0).reshape(n_tiles, 8).any(axis=1)
        return np.where(real[:, None], np.array([0, -(-win // 32)]), 0)
    nz = (permuted_taps(w, cols) != 0).reshape(win, n_tiles, 8).any(axis=2)
    first = nz.argmax(axis=0)
    last = win - 1 - nz[::-1].argmax(axis=0)
    return np.where(nz.any(axis=0)[:, None],
                    np.stack([first // 32, last // 32 + 1], axis=1), 0)


def block_tap_bytes(ranges: np.ndarray, nr_ch: int, cpb: int) -> int:
    """Shared memory the widest channel block's taps take when staged (its
    groups' steps, 4 tiles a step)."""
    n_blocks = -(-nr_ch // cpb)
    spans = imma_split.group_spans(ranges, len(ranges) // n_blocks, _GROUP)
    steps = (spans[:, 1] - spans[:, 0]).reshape(n_blocks, -1)
    return int(steps.sum(axis=1).max()) * _GROUP * _TILE_BYTES


def smem_bytes(tr: int, row: int, cr: int, hc: int) -> int:
    """Shared memory of a kernel block without the taps: the staged rows'
    high and low byte planes and two f32 accumulator planes of ``hc``
    columns, a channel block's outputs a row (``x_bytes + acc_bytes`` in
    chain.cu)."""
    return 2 * (tr + 1 + cr) * (row + _PITCH_PAD) + 2 * (tr + 1) * hc * 4


def launch_shape(row: int, cr: int, nr_ch: int, opr: int,
                 tap_bytes) -> tuple[int, int]:
    """``(tr, channels per block)`` of K1's and K5's launch;
    ``tap_bytes(cpb)`` is what the taps of the widest block of ``cpb``
    channels take in shared memory.

    ``tr + 1`` (the tile and its look-back row) is a multiple of the 16
    rows of an m-tile, at most 256; at a given block width the tile is the
    tallest that fits beside the staged taps where 32 rows or more do (two
    m-tiles a warp), else the tallest that fits without them, its taps
    read from L2. One block of all channels where a tile fits; else the
    widest block of a multiple of 8 channels that fits beside a 32-row
    tile (two m-tiles a warp, so each tap fragment read from L2 feeds two
    products), or beside 16 rows where not even 8 channels fit beside 32,
    evened out over the blocks. Raises where not even 8 channels fit
    beside 16 rows."""
    def tallest(cpb):
        for staged, least in ((tap_bytes(cpb), 32), (0, 16)):
            for rows in range(256, least - 1, -16):
                if (smem_bytes(rows - 1, row, cr, opr * cpb) + staged
                        <= _SMEM_CAP):
                    return rows - 1
        return None

    tr = tallest(nr_ch)
    if tr is not None:
        return tr, nr_ch
    for rows in (32, 16):
        fits = [c for c in range(8, nr_ch, 8)
                if smem_bytes(rows - 1, row, cr, opr * c) <= _SMEM_CAP]
        if fits:
            break
    else:
        raise ValueError(
            f"no launch shape fits in shared memory at row={row}, cr={cr}, "
            f"{nr_ch} channels x {opr} outputs a row: not even 8 channels "
            f"beside a 16-row tile")
    n_blocks = -(-nr_ch // fits[-1])
    per_block = -(-nr_ch // n_blocks)
    cpb = -(-per_block // 8) * 8
    return tallest(cpb), cpb


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
        taps.w_lo.data_ptr(), taps.ktab.data_ptr(), taps.omega_row.data_ptr(),
        prev.data_ptr(), out.data_ptr(), prev_out.data_ptr(), rows, plan.row,
        plan.cr_rows, plan.win, plan.nr_channels, plan.opr,
        taps.chans_per_block, taps.tile_rows, taps.tap_block_bytes, stream)
    build.check(err, "tsl_chain_fm")
    chain_fm.launches += 1
    chain_fm.grouped_launches += taps.grouped
    return out, prev_out


chain_fm.launches = 0
chain_fm.grouped_launches = 0   # launches with grouped operands


def chain_fm_plain(taps: ChainTaps, carry_vals: torch.Tensor,
                   prev: torch.Tensor, block: torch.Tensor):
    """Plain torch version of :func:`chain_fm` (float64 FIR products in the
    taps' form, the same float32 discriminator), on any device."""
    p = taps.fir_sums(carry_vals, block).to(torch.float32)
    half = taps.plan.halfcols
    pcm, pr, pi_ = fm.fm_from_baseband(p[:, :half], p[:, half:], prev[0],
                                       prev[1], taps.omega_c)
    return pcm, torch.stack([pr, pi_])


def _check(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
