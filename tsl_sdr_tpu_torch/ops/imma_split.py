"""The int8 split that takes exact int16 products to the tensor cores.

Hopper's tensor cores multiply 8-bit operands (``s8``/``u8``) into ``s32``
sums, not 16-bit ones. An int16 splits exactly into a signed high byte and
an unsigned low byte, ``x = 256 * hi(x) + lo(x)`` with ``hi = x >> 8``
(arithmetic) and ``lo = x & 0xFF``, so a sum of int16 products is

    sum x*w = 65536 * HH + 256 * (HL + LH) + LL     (mod 2**32)

over the four cross sums ``HH = sum hi(x)*hi(w)`` (s8 x s8), ``HL = sum
hi(x)*lo(w)`` (s8 x u8), ``LH = sum lo(x)*hi(w)`` (u8 x s8) and ``LL = sum
lo(x)*lo(w)`` (u8 x u8), each an ``mma.sync ... m16n8k32`` on the card
(``csrc/imma_split.cuh``). Recombined in uint32 the result is the wrapped
int32 sum bit for bit. No partial overflows ``s32`` while the depth is at
most :data:`MAX_DEPTH` (``255 * 255`` a term in LL, ``2 * 128 * 255`` in
HL + LH); past it the partials would still wrap to the same result, but
the kernels refuse such depths rather than rely on it.

Taps are split once, at plan time, into zero-padded high and low planes
laid out for the B operand of ``m16n8k32`` (:func:`fragment_planes`): for
a ``[K, N]`` tap matrix, 32-deep by 8-wide tile ``(kt, nt)`` is 32 lanes
of 8 bytes, lane ``4*g + t`` holding rows ``32*kt + 4*t + (0..3)`` and
``32*kt + 16 + 4*t + (0..3)`` of column ``8*nt + g``. A warp then reads
each tile as one coalesced 256-byte load. Where each column tile needs
only some of the k-steps (the phase-grouped FIR), :func:`compact_groups`
keeps just those, in groups of the tiles one warp multiplies together:
a group's tiles side by side at each of its steps, so the warp reads them
from one address a step.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_DEPTH = 32_768   # partial sums stay inside s32 up to this depth
K_STEP = 32          # mma.sync m16n8k32: depth of one product
N_TILE = 8           # and its width


def split_i16(x):
    """int16 -> (signed high byte, unsigned low byte); numpy or torch."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int16)
        return (x >> 8).to(torch.int8), (x & 0xFF).to(torch.uint8)
    x = np.asarray(x, np.int16)
    return (x >> 8).astype(np.int8), (x & 0xFF).astype(np.uint8)


def raw_k_order(k: int) -> np.ndarray:
    """The k order of taps for an A operand read as raw int16 rows and
    split in registers (``imma::load_a_raw``): position ``p = 16h + 4t + i``
    of each 32-value step holds value ``16h + 2t + (i & 1) + 8(i >> 1)``.
    Returns, for ``k`` a multiple of 32, the source index of each
    position; ``w[raw_k_order(len(w))]`` is the permuted tap matrix."""
    p = np.arange(32)
    h, t, i = p // 16, p % 16 // 4, p % 4
    step = 16 * h + 2 * t + (i & 1) + 8 * (i >> 1)
    return (np.arange(k // 32)[:, None] * 32 + step).reshape(-1)


def fragment_planes(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int16 ``[K, N]`` taps -> (high, low) byte planes ``[KT, NT, 32, 8]``
    (``KT = ceil(K / 32)``, ``NT = ceil(N / 8)``), zero-padded, each tile in
    the lane order of the ``m16n8k32`` B fragment."""
    w = np.asarray(w, np.int16)
    k, n = w.shape
    kt, nt = -(-k // K_STEP), -(-n // N_TILE)
    padded = np.zeros((kt * K_STEP, nt * N_TILE), np.int16)
    padded[:k, :n] = w
    planes = []
    for plane in split_i16(padded):
        # rows 32*kt + 16*half + 4*t + i, column 8*nt + g
        p = plane.view(np.uint8).reshape(kt, 2, 4, 4, nt, 8)
        # -> [kt, nt, g, t, half, i]: lane 4*g + t, byte 4*half + i
        planes.append(np.ascontiguousarray(
            p.transpose(0, 4, 5, 2, 1, 3).reshape(kt, nt, 32, 8)))
    return planes[0], planes[1]


def unfragment(hi: np.ndarray, lo: np.ndarray, k: int, n: int) -> np.ndarray:
    """Inverse of :func:`fragment_planes`: the ``[k, n]`` int16 taps."""
    kt, nt = hi.shape[:2]
    w = []
    for plane in (hi, lo):
        p = np.asarray(plane, np.uint8).reshape(kt, nt, 8, 4, 2, 4)
        w.append(p.transpose(0, 4, 3, 5, 1, 2).reshape(kt * K_STEP,
                                                       nt * N_TILE))
    full = w[0].view(np.int8).astype(np.int32) * 256 + w[1].astype(np.int32)
    return full[:k, :n].astype(np.int16)


def group_spans(ranges: np.ndarray, tiles_per_block: int,
                group: int) -> np.ndarray:
    """int64 ``[blocks * groups a block, 2]``: the k-steps ``[first, end)``
    of each group of ``group`` consecutive column tiles, the union of its
    tiles' ``ranges`` (``[0, 0)`` where all are empty). The tiles come in
    blocks of ``tiles_per_block``; a block's last group may be short."""
    ranges = np.asarray(ranges, np.int64).reshape(-1, tiles_per_block, 2)
    pad = -tiles_per_block % group
    ranges = np.concatenate(
        [ranges, np.zeros((len(ranges), pad, 2), np.int64)], axis=1)
    r = ranges.reshape(-1, group, 2)
    live = r[..., 1] > r[..., 0]
    big = np.iinfo(np.int64).max
    first = np.where(live, r[..., 0], big).min(axis=1)
    end = np.where(live, r[..., 1], 0).max(axis=1)
    return np.where(live.any(axis=1)[:, None],
                    np.stack([first, end], axis=1), 0)


def compact_groups(hi: np.ndarray, lo: np.ndarray, ranges: np.ndarray,
                   tiles_per_block: int, group: int):
    """Keep of full planes ``[KT, NT, 32, 8]`` only what each group of
    :func:`group_spans` needs: its steps, one after another, each step
    its ``group`` tiles side by side (a short group padded with zero
    tiles). Returns (high, low) ``[L, 32, 8]``, ``base [NT]``: tile ``t``'s
    fragment of step ``ks`` is at ``base[t] + group * ks + t % group`` (``t``
    counted inside its block), and ``end [NT]``: where the fragments of
    ``t``'s block end."""
    spans = group_spans(ranges, tiles_per_block, group)
    nt = len(ranges)
    gpb = -(-tiles_per_block // group)
    steps = spans[:, 1] - spans[:, 0]
    start = np.concatenate([[0], np.cumsum(steps * group)[:-1]])
    t = np.arange(nt)
    g = t // tiles_per_block * gpb + t % tiles_per_block // group
    base = start[g] - group * spans[g, 0]
    end = (start + steps * group).reshape(-1, gpb)[:, -1]
    out = []
    for plane in (hi, lo):
        frags = np.zeros((int((steps * group).sum()), 32, 8), np.uint8)
        for tt in range(nt):
            ks = np.arange(*spans[g[tt]])
            frags[base[tt] + group * ks + tt % tiles_per_block % group] = \
                plane[ks, tt]
        out.append(frags)
    return out[0], out[1], base, end[t // tiles_per_block]


def expand_groups(hi: np.ndarray, lo: np.ndarray, ranges: np.ndarray,
                  base: np.ndarray, k_tiles: int, tiles_per_block: int,
                  group: int):
    """Each tile's own k-steps of :func:`compact_groups`' planes, back in
    full ``[k_tiles, NT, 32, 8]`` planes (zeros outside the tile's
    range)."""
    full = []
    for plane in (hi, lo):
        out = np.zeros((k_tiles, len(ranges), 32, 8), np.uint8)
        for t, (a, b) in enumerate(np.asarray(ranges)):
            ks = np.arange(a, b)
            out[ks, t] = plane[base[t] + group * ks
                               + t % tiles_per_block % group]
        full.append(out)
    return full[0], full[1]


def split_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int16 ``[M, K]`` @ int16 ``[K, N]`` -> the wrapped int32 sums, by
    the split: four cross sums of byte products (each exact in int64,
    as they are in s32 for K <= MAX_DEPTH), recombined mod 2**32. The
    kernels' arithmetic, written plainly."""
    xh, xl = (t.to(torch.int64) for t in split_i16(x))
    wh, wl = (t.to(torch.int64) for t in split_i16(w))
    hh = xh @ wh
    mid = xh @ wl + xl @ wh
    ll = xl @ wl
    acc = ((hh << 16) + (mid << 8) + ll) & 0xFFFFFFFF
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)
