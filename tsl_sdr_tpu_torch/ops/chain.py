"""Fused channelizer + FM (kernel K1) behind one function on tensors.

:func:`chain_fm` runs one streaming block: the packed FIR of
:mod:`tsl_sdr_tpu_torch.ops.packed_fir` and the discriminator of
:mod:`tsl_sdr_tpu_torch.ops.fm`, fused. On a CUDA tensor it launches one
of K1's two bodies, which replace the TPU kernels
``tsl_sdr_tpu/ops/pallas_chain.py`` ``_chain_kernel_v2``/``_chain_call_v2``
and ``_chain_kernel``/``_chain_call``, in both forms of their FIR body
``_fir_acc`` (chunked, and phase-grouped for wide banks): the tile body
``csrc/chain.cu`` where its taps fit beside a tile or nothing else keeps
them on chip, the bank body ``csrc/bank.cu`` (resident taps, a persistent
grid, the FM history in registers) where the tile body would read its taps
from L2 once a tile and the bank body keeps them resident
(:attr:`ChainTaps.body`). On a CPU tensor it runs :func:`chain_fm_plain`,
the same arithmetic in plain torch. See the source notes for what bounds
each body on the H100 and how its design responds. :class:`ExactTaps`
holds K5's operands (``csrc/bank.cu`` at every shape).

State layout (the JAX XLA tier's ``MultifmFastState``): ``cr`` rows of int16
stream history and the previous baseband sample of each channel as a
``[2, C]`` float32 (re, im) tensor, which the kernel reads for the first
output row and writes for the last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import fm, imma_split, packed_fir
from tsl_sdr_tpu_torch.ops.packed_fir import PackedFirPlan

_SMEM_CAP = 227 * 1024   # what a block may use (kSmemCap in chain.cu)
_PITCH_PAD = 16          # bytes past ROW per staged row (kPitchPad)
_TILE_BYTES = 2 * 256    # one 32x8 k-step of a column tile, both planes
_GROUP = 4               # n8 tiles a warp multiplies together (kNtG)
_KTAB_ROW = 16           # bytes of a ktab row (an int4)
_FM_ITEMS = 8            # K1 bank items a tile, two warps each (kFmWarps)
_EDGE_BYTES = 2 * 16 * 8 * 2 * 4   # an item's two edge phases (bank.cu)


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

    K1's operands, for its ``body``: ``"tile"`` (``csrc/chain.cu``, the
    launch of :func:`launch_shape`) where its taps fit beside a tile or
    :func:`fm_bank_shape` finds no resident layout either, else ``"bank"``
    (``csrc/bank.cu``). The tap matrix's columns in channel blocks of
    ``chans_per_block`` channels (tile: :func:`channel_block_columns`;
    bank: :func:`octet_columns`, its k order
    :func:`~tsl_sdr_tpu_torch.ops.imma_split.raw_k_order`), split into
    high/low byte planes in B-fragment order
    (:mod:`tsl_sdr_tpu_torch.ops.imma_split`) that keep, for each group of
    tiles a warp multiplies together (tile: 4; bank: 2, a phase's re and
    im), the k-steps of their ranges, side by side a step
    (``w_hi``/``w_lo`` ``[L, 32, 8]``,
    :func:`~tsl_sdr_tpu_torch.ops.imma_split.compact_groups`); ``ktab``
    int32 ``[tiles, 4]``: each tile's first and end k-step, its group's
    base (step ``ks`` of the group's tile ``j`` is fragment ``base +
    group*ks + j``) and the end of its block's fragments;
    ``tap_block_bytes``, the widest block's; ``tile_rows``, ``stages``
    (the bank body's row buffers). K5's operands are :attr:`exact`."""

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
        self._w = w
        layouts = {}

        def tap_bytes(cpb):
            cols = channel_block_columns(plan.opr, plan.nr_channels, cpb)
            ranges = tile_ranges(w, cols, self.grouped)
            layouts[cpb] = (cols, ranges,
                            block_tap_bytes(ranges, plan.nr_channels, cpb))
            return layouts[cpb][2]

        tr, cpb = launch_shape(plan.row, plan.cr_rows, plan.nr_channels,
                               plan.opr, tap_bytes)
        cols, ranges, tb = layouts[cpb]
        bank = None
        if smem_bytes(tr, plan.row, plan.cr_rows, plan.opr * cpb) + tb \
                > _SMEM_CAP:
            # the tile body would read its taps from L2 once a tile
            o_cols = octet_columns(plan.opr, plan.nr_channels)
            o_ranges = tile_ranges(w, o_cols, self.grouped)
            bank = fm_bank_shape(plan.row, plan.cr_rows, plan.opr,
                                 octet_steps(o_ranges, plan.opr))
        if bank is None:
            self.body, self.stages = "tile", 1
            self.tile_rows, self.chans_per_block = tr, cpb
            hi, lo, self.ktab, self.tap_block_bytes = operands(
                w, cols, ranges, self.tiles_per_block, _GROUP, False)
        else:
            octets, self.tile_rows, self.stages = bank
            self.body, self.chans_per_block = "bank", 8 * octets
            n_oct = -(-plan.nr_channels // 8)
            pad = (-n_oct % octets) * 2 * plan.opr
            hi, lo, self.ktab, self.tap_block_bytes = operands(
                w, np.concatenate([o_cols, np.full(8 * pad, -1)]),
                np.concatenate([o_ranges, np.zeros((pad, 2), np.int64)]),
                self.tiles_per_block, 2, True)
        self.w_hi = torch.from_numpy(hi).to(device)
        self.w_lo = torch.from_numpy(lo).to(device)
        self.ktab = torch.from_numpy(self.ktab).to(device)

    @functools.cached_property
    def exact(self) -> ExactTaps:
        """K5's operands and launch shape, built at K5's first use."""
        return ExactTaps(self.plan, self._w, self.grouped, self.w_hi.device)

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
    out = np.zeros((cols.size, w.shape[0]), np.int16)
    ok = cols >= 0
    # gather whole rows of the transpose: a column gather is strided
    out[ok] = np.ascontiguousarray(w.T)[cols[ok]]
    return np.ascontiguousarray(out.T)


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
    # each tap column's first and last non-zero, then each tile's
    nz = w != 0
    live = nz.any(axis=0)
    first_c = np.where(live, nz.argmax(axis=0), win)
    last_c = np.where(live, win - 1 - nz[::-1].argmax(axis=0), -1)
    c = np.maximum(cols, 0)
    first = np.where(cols >= 0, first_c[c], win).reshape(n_tiles, 8).min(1)
    last = np.where(cols >= 0, last_c[c], -1).reshape(n_tiles, 8).max(1)
    return np.where((last >= 0)[:, None],
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


class ExactTaps:
    """K5's device operands and launch shape (``ChainTaps.exact``).

    K5 has no FM stage, so its tile needs no look-back row and no
    accumulator plane, and its columns are independent: a sub-block is any
    run of groups of 4 n8 tiles of the tap matrix in its own column order
    (:func:`channel_block_columns` with one block). ``w_hi``/``w_lo``
    ``[L, 32, 8]`` and ``ktab`` as :class:`ChainTaps`' (compact groups of
    4, k-permuted for the kernel's raw-row A operand,
    :func:`~tsl_sdr_tpu_torch.ops.imma_split.raw_k_order`); ``tile_rows``,
    ``tiles_per_block`` (n8 tiles a sub-block), ``stages`` (row buffers)
    and ``staged`` (taps resident in shared memory, else read from L2)
    from :func:`exact_shape`; ``tap_block_bytes``, what the widest
    sub-block's taps take."""

    def __init__(self, plan: PackedFirPlan, w: np.ndarray, grouped: bool,
                 device):
        cols = channel_block_columns(plan.opr, plan.nr_channels,
                                     plan.nr_channels)
        ranges = tile_ranges(w, cols, grouped)
        steps = _group_steps(ranges, 4)
        groups, self.tile_rows, self.stages, self.staged = exact_shape(
            plan.row, plan.cr_rows, steps)
        self.tiles_per_block = 4 * groups
        pad = -len(ranges) % self.tiles_per_block
        ranges = np.concatenate([ranges, np.zeros((pad, 2), np.int64)])
        cols = np.concatenate([cols, np.full(8 * pad, -1)])
        hi, lo, ktab, self.tap_block_bytes = operands(
            w, cols, ranges, self.tiles_per_block, 4, True)
        self.w_hi = torch.from_numpy(hi).to(device)
        self.w_lo = torch.from_numpy(lo).to(device)
        self.ktab = torch.from_numpy(ktab).to(device)
        self.n_sub = len(ktab) // self.tiles_per_block

    def launch_rows(self, rows: int, n_sm: int) -> int:
        """The tile rows of a launch over ``rows`` packed rows on a card of
        ``n_sm`` SMs: :attr:`tile_rows`, cut (by 32 rows, then to 16)
        until the (sub-block, tile) units number at least ``n_sm``, so
        that a short block still spreads over the card."""
        tr = self.tile_rows
        while tr > 16 and self.n_sub * -(-rows // tr) < n_sm:
            tr = tr - 32 if tr > 32 else 16
        return tr


def octet_columns(opr: int, nr_ch: int) -> np.ndarray:
    """K1's tap columns on wide banks (the bank body, ``csrc/bank.cu``):
    octet by octet (8 channels), phase by phase, re then im, so one warp
    walks an octet's phases in order with a phase's re and im in its
    fragments. Per kernel column, the tap matrix column (``[re/im, j,
    c]`` order) it holds, or -1 past the last channel."""
    o, j, ri, e = np.meshgrid(np.arange(-(-nr_ch // 8)), np.arange(opr),
                              np.arange(2), np.arange(8), indexing="ij")
    c = 8 * o + e
    return np.where(c < nr_ch, (ri * opr + j) * nr_ch + c, -1).reshape(-1)


def _group_steps(ranges: np.ndarray, group: int) -> np.ndarray:
    """The k-steps each group of ``group`` consecutive tiles runs (the
    union of its tiles')."""
    spans = imma_split.group_spans(ranges, len(ranges), group)
    return spans[:, 1] - spans[:, 0]


def octet_steps(ranges: np.ndarray, opr: int) -> np.ndarray:
    """int64 ``[octets]``: the k-steps of an octet's ``opr`` groups of 2
    tiles (re, im of a phase) in :func:`octet_columns` order."""
    return _group_steps(ranges, 2).reshape(-1, opr).sum(axis=1)


def _sub_block_bytes(steps: np.ndarray, width: int, tiles: int) -> int:
    """Shared memory of the widest sub-block of ``width`` units of
    ``steps`` k-steps of ``tiles`` n8 tiles each, both planes."""
    padded = np.concatenate([steps, np.zeros(-len(steps) % width,
                                             np.int64)])
    return int(padded.reshape(-1, width).sum(axis=1).max()) * tiles \
        * _TILE_BYTES


def _widths(n: int):
    """Sub-block widths of ``n`` units, widest first, evened out over the
    sub-blocks (one width a number of sub-blocks)."""
    seen = set()
    for n_sub in range(1, n + 1):
        w = -(-n // n_sub)
        if w not in seen:
            seen.add(w)
            yield w


def bank_x_bytes(rows: int, row: int, cr: int) -> int:
    """One row buffer of the bank body: ``rows + cr`` raw int16 rows at a
    pitch of ``2*row + 16`` bytes."""
    return (rows + cr) * (2 * row + _PITCH_PAD)


def exact_shape(row: int, cr: int, group_steps: np.ndarray):
    """``(groups a sub-block, tile rows, stages, staged)`` of K5's launch,
    for groups of 4 n8 tiles of ``group_steps`` k-steps each.

    The widest sub-block whose taps stay resident in shared memory beside
    ``stages`` buffers of a tile of a multiple of 32 rows (two m-tiles a
    warp's item) with a multiple of 8 items a tile (one a warp): two
    buffers before one, then the tallest tile. Where none fits, sub-blocks
    of at most 8 groups (8 items a 32-row tile) with their taps read from
    L2 and the tallest tile of a multiple of 32 rows, or 16 (two buffers
    where they take as many rows). Raises, naming the shape, where not
    even 16 rows fit. :meth:`ExactTaps.launch_rows` cuts the tile for a
    block of few rows."""
    n = len(group_steps)
    for groups in _widths(n):
        taps = _sub_block_bytes(group_steps, groups, 4)
        for stages in (2, 1):
            for rows in range(256, 31, -32):
                if (groups * rows // 32) % 8 == 0 and (
                        taps + stages * bank_x_bytes(rows, row, cr)
                        + 4 * groups * _KTAB_ROW <= _SMEM_CAP):
                    return groups, rows, stages, True
    groups = -(-n // -(-n // 8))
    fits = [(rows, stages) for stages in (1, 2)
            for rows in (*range(256, 31, -32), 16)
            if stages * bank_x_bytes(rows, row, cr) + 4 * groups * _KTAB_ROW
            <= _SMEM_CAP]
    if not fits:
        raise ValueError(
            f"no K5 launch shape fits in shared memory at row={row}, "
            f"cr={cr}: not even a 16-row tile")
    rows, stages = max(fits)
    return groups, rows, stages, False


def fm_bank_shape(row: int, cr: int, opr: int, octet_steps: np.ndarray):
    """``(octets a sub-block, tile rows, stages)`` of K1's bank body, or
    None where it does not fit: the widest sub-block of whole octets whose
    taps stay resident beside ``stages`` buffers of ``tr + 1`` rows (the
    tile and its look-back row, a multiple of 16), its ktab rows, the edge
    phases and its omega, with 8 items (m-tile, octet) a tile, one a pair
    of the block's 16 warps; two buffers before one."""
    for octets in _widths(len(octet_steps)):
        if _FM_ITEMS % octets:
            continue
        rows = _FM_ITEMS // octets * 16
        small = 2 * opr * octets * _KTAB_ROW + _FM_ITEMS * _EDGE_BYTES \
            + opr * 8 * octets * 4
        taps = _sub_block_bytes(octet_steps, octets, 2)
        for stages in (2, 1):
            if taps + stages * bank_x_bytes(rows, row, cr) + small \
                    <= _SMEM_CAP:
                return octets, rows - 1, stages
    return None


def operands(w: np.ndarray, cols: np.ndarray, ranges: np.ndarray,
             tiles_per_block: int, group: int, raw_k: bool):
    """The kernel's split tap planes for the tap matrix ``w`` in column
    order ``cols``: (hi, lo ``[L, 32, 8]`` uint8, ktab ``[tiles, 4]``
    int32, the widest block's bytes in shared memory). ``raw_k``: the k
    order of :func:`~tsl_sdr_tpu_torch.ops.imma_split.raw_k_order`."""
    wp = permuted_taps(w, cols)
    if raw_k:
        wp = np.concatenate([wp, np.zeros((-len(wp) % 32, wp.shape[1]),
                                          np.int16)])
        wp = wp[imma_split.raw_k_order(len(wp))]
    hi, lo = imma_split.fragment_planes(wp)
    hi, lo, base, end = imma_split.compact_groups(hi, lo, ranges,
                                                  tiles_per_block, group)
    ktab = np.stack([ranges[:, 0], ranges[:, 1], base, end],
                    axis=1).astype(np.int32)
    blocks = np.concatenate([[0], end[::tiles_per_block]])
    return hi, lo, ktab, int(np.diff(blocks).max()) * _TILE_BYTES


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
    args = (carry_vals.data_ptr(), block.data_ptr(), taps.w_hi.data_ptr(),
            taps.w_lo.data_ptr(), taps.ktab.data_ptr(),
            taps.omega_row.data_ptr(), prev.data_ptr(), out.data_ptr(),
            prev_out.data_ptr(), rows, plan.row, plan.cr_rows, plan.win,
            plan.nr_channels, plan.opr)
    if taps.body == "tile":
        err = lib.tsl_chain_fm(*args, taps.chans_per_block, taps.tile_rows,
                               taps.tap_block_bytes, stream)
    else:
        err = lib.tsl_chain_fm_bank(*args, taps.tiles_per_block,
                                    taps.tile_rows, taps.stages,
                                    taps.tap_block_bytes, stream)
    build.check(err, f"tsl_chain_fm ({taps.body} body)")
    chain_fm.launches += 1
    chain_fm.grouped_launches += taps.grouped
    chain_fm.bank_launches += taps.body == "bank"
    return out, prev_out


chain_fm.launches = 0
chain_fm.grouped_launches = 0   # launches with grouped operands
chain_fm.bank_launches = 0      # launches of the bank body


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
