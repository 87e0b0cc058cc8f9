"""Lane-packed multi-channel decimating FIR: numpy plan + plain torch step.

Port of ``tsl_sdr_tpu/ops/packed_fir.py:62-193`` (plan builder, copied as
numpy because the JAX module imports jax at load), ``:198-318`` (the
phase-grouped windowed form: its plan, its choice and its product),
``:321-403`` (the streaming step), ``:406-464`` (its bit-exact tier, the
plain version of kernel K5, :mod:`tsl_sdr_tpu_torch.ops.exact_fir`) and
``:467-487`` (the integer NCO of the fast tier's debug tap). The interleaved int16 stream is cut into rows of
``ROW = lcm(2*D, 128)`` values; each row yields ``OPR = ROW/(2*D)``
decimated outputs per channel, and output row ``r`` is

    P[r] = sum_i rows[r + i] @ W_i          (i = 0 .. cr)

over the ``cr + 1`` tap chunks ``W_i [ROW, 2*OPR*C]`` (column layout
``[re/im, j, c]``). The chunked product is what kernel K1
(:mod:`tsl_sdr_tpu_torch.ops.chain`) computes in int32 on the card; the
plain version here multiplies in float64, where int16 x int16 sums of a few
thousand terms are exact, and wraps to int32 like the reference's MAC.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import q14
from tsl_sdr_tpu_torch.ops.fir import design_channel_taps


class PackedFirPlan(NamedTuple):
    """Static host-side plan for the lane-packed channel bank (same fields
    as the JAX package's, so plans convert one to one)."""

    w_chunks: tuple       # tuple of np.ndarray [ROW, COLS] f32 tap chunks
    w_chunks_i16: tuple   # same layout, int16 Q.14
    rot_incr_i32: np.ndarray  # [C, 2] int32 Q.14 derotator increment
    omega_d: np.ndarray  # [C] float64: per-output derotation increment (rad)
    row: int             # values per packed row (= lcm(2D, 128))
    opr: int             # outputs per row (= row / (2D))
    win: int             # window span in values (= row - 2D + 2T)
    cr_rows: int         # carried history rows
    decimation: int
    nr_taps: int
    nr_channels: int
    chunk_nnz: tuple = ()  # per-chunk nonzero-row count (128-rounded)

    @property
    def carry_vals(self) -> int:
        return self.cr_rows * self.row

    @property
    def carry_len(self) -> int:
        """Carry length in samples (for stream-prefix priming)."""
        return self.carry_vals // 2

    @property
    def block_quantum(self) -> int:
        """Block lengths must be a multiple of this many samples."""
        return self.row // 2

    @property
    def halfcols(self) -> int:
        """Output columns per row: OPR outputs of each of C channels."""
        return self.opr * self.nr_channels


def make_packed_fir_plan(lpf_taps, offsets_hz, sample_rate: float,
                         decimation: int, gains=None) -> PackedFirPlan:
    """Build the packed plan for a bank of channels on one wideband input
    (tap synthesis of the reference, ``multifm/demod.c:205-243``; per-output
    derotation increment ``-2*pi*offset/fs*D``, ``filter/direct_fir.c:65-76``).
    """
    lpf_taps = np.asarray(lpf_taps, dtype=np.float64)
    offsets_hz = np.atleast_1d(np.asarray(offsets_hz, dtype=np.float64))
    nr_ch = offsets_hz.shape[0]
    nr_taps = lpf_taps.shape[0]
    d = int(decimation)
    if gains is None:
        gains = np.ones(nr_ch)
    gains = np.broadcast_to(np.asarray(gains, dtype=np.float64), (nr_ch,))

    row = math.lcm(2 * d, 128)
    opr = row // (2 * d)
    win = row + max(2 * (nr_taps - d), 0)
    cr_rows = -(-(win - row) // row) if win > row else 0

    cols = 2 * opr * nr_ch
    wf = np.zeros((win, 2, opr, nr_ch), dtype=np.float32)
    wq = np.zeros((win, 2, opr, nr_ch), dtype=np.int16)
    tidx = 2 * np.arange(nr_taps)
    omega_d = np.empty(nr_ch, dtype=np.float64)
    rot_incr = np.empty((nr_ch, 2), dtype=np.int32)
    for c in range(nr_ch):
        taps, f_offs = design_channel_taps(
            lpf_taps, offsets_hz[c], sample_rate, gains[c])
        omega_d[c] = f_offs * d
        incr = np.exp(1j * f_offs * d)
        rot_incr[c, 0] = q14.quantize_q14_i32(incr.real)
        rot_incr[c, 1] = q14.quantize_q14_i32(incr.imag)
        cr = taps.real.astype(np.float32)
        ci = taps.imag.astype(np.float32)
        qr = q14.quantize_q14(taps.real)
        qi = q14.quantize_q14(taps.imag)
        for j in range(opr):
            vre = 2 * d * j + tidx
            # out_re += cr*xr - ci*xi ; out_im += ci*xr + cr*xi
            wf[vre, 0, j, c] += cr
            wf[vre + 1, 0, j, c] -= ci
            wf[vre, 1, j, c] += ci
            wf[vre + 1, 1, j, c] += cr
            wq[vre, 0, j, c] += qr
            wq[vre + 1, 0, j, c] -= qi
            wq[vre, 1, j, c] += qi
            wq[vre + 1, 1, j, c] += qr
    wf = wf.reshape(win, cols)
    wq = wq.reshape(win, cols)

    padded = np.zeros(((cr_rows + 1) * row, cols), dtype=np.float32)
    padded[:win] = wf
    chunks = tuple(padded[i * row:(i + 1) * row] for i in range(cr_rows + 1))
    padded_q = np.zeros(((cr_rows + 1) * row, cols), dtype=np.int16)
    padded_q[:win] = wq
    chunks_q = tuple(
        padded_q[i * row:(i + 1) * row] for i in range(cr_rows + 1))
    chunk_nnz = tuple(
        row if i == 0 else min(row, -(-(win - i * row) // 128) * 128)
        for i in range(cr_rows + 1)
    )
    return PackedFirPlan(
        w_chunks=chunks, w_chunks_i16=chunks_q, rot_incr_i32=rot_incr,
        omega_d=omega_d, row=row, opr=opr, win=win, cr_rows=cr_rows,
        decimation=d, nr_taps=nr_taps, nr_channels=nr_ch,
        chunk_nnz=chunk_nnz,
    )


def tap_matrix_i16(plan: PackedFirPlan) -> np.ndarray:
    """The chunks stacked into one ``[win, 2*halfcols]`` int16 matrix:
    row ``u`` multiplies stream value ``r*ROW + u`` of output row ``r``
    (rows past ``win`` are zero in every chunk and are dropped)."""
    return np.ascontiguousarray(np.concatenate(plan.w_chunks_i16)[:plan.win])


def with_taps_i16(plan: PackedFirPlan, w: np.ndarray) -> PackedFirPlan:
    """``plan`` with its int16 chunks replaced by the ``[win, 2*halfcols]``
    matrix ``w`` (the inverse of :func:`tap_matrix_i16`): other taps of
    the same shape, e.g. full-scale ones for an adversarial check."""
    w = np.asarray(w, np.int16)
    padded = np.zeros(((plan.cr_rows + 1) * plan.row, w.shape[1]), np.int16)
    padded[:plan.win] = w
    return plan._replace(w_chunks_i16=tuple(
        padded[i * plan.row:(i + 1) * plan.row]
        for i in range(plan.cr_rows + 1)))


def reduced_omega(plan: PackedFirPlan) -> np.ndarray:
    """The per-output derotation increment reduced to (-pi, pi] in
    float64, as float32: K1's constants for ``plan``'s channels."""
    w = plan.omega_d.astype(np.float64)
    return (w - 2 * np.pi * np.round(w / (2 * np.pi))).astype(np.float32)


def sub_plan(plan: PackedFirPlan, lo: int, hi: int) -> PackedFirPlan:
    """The plan of channels ``[lo, hi)`` alone: their tap columns of every
    chunk (the ``[re/im, j, c]`` layout cut at ``c``), increments and
    derotation (the JAX package's per-shard ``plan._replace``,
    ``tsl_sdr_tpu/parallel/channelizer.py:221-234``)."""
    def cut(chunks):
        return tuple(np.ascontiguousarray(
            np.asarray(w).reshape(plan.row, 2, plan.opr, plan.nr_channels)
            [..., lo:hi].reshape(plan.row, 2 * plan.opr * (hi - lo)))
            for w in chunks)

    return plan._replace(
        w_chunks=cut(plan.w_chunks), w_chunks_i16=cut(plan.w_chunks_i16),
        rot_incr_i32=plan.rot_incr_i32[lo:hi].copy(),
        omega_d=plan.omega_d[lo:hi].copy(), nr_channels=hi - lo)


def tap_support(plan: PackedFirPlan) -> np.ndarray:
    """bool ``[win, 2*halfcols]``: where the plan's layout may hold a tap.
    Phase ``j``'s columns (both halves, every channel) read the ``2T``
    values from ``2*D*j`` on; the rest is zeros of the layout."""
    t2, step = 2 * plan.nr_taps, 2 * plan.decimation
    u = np.arange(plan.win)[:, None]
    j = np.arange(plan.opr)[None, :]
    phase = (u >= step * j) & (u < step * j + t2)            # [win, opr]
    return np.repeat(np.tile(phase, 2), plan.nr_channels, axis=1)


class GroupedFirPlan(NamedTuple):
    """Phase-grouped windowed form of a :class:`PackedFirPlan` (copied from
    ``tsl_sdr_tpu/ops/packed_fir.py:198-271``): the ``opr`` phases in
    ``n_groups`` groups of ``g`` consecutive phases (``g*2C >= 128``, or the
    whole row); group ``G`` is one dense product

        xw[:, 2*D*g*G : 2*D*g*G + win_g] @ Wg[G]      (win_g = (g-1)*2D + 2T)

    over the windowed row view ``xw[r] = rows[r] ++ rows[r+1][:win-ROW]``,
    which skips the structural zeros of the chunked form."""

    wg_f32: np.ndarray   # [n_groups, win_g, 2*g*C] float32
    wg_i16: np.ndarray   # same, int16 Q.14
    g: int               # phases per group
    n_groups: int        # = opr // g
    win_g: int           # window values per group
    spill: int           # = win - row (windowed-view overhang into next row)


def _group_size(opr: int, nr_channels: int) -> int:
    """Smallest power-of-two phase group with >= 128 output columns (or
    the whole row); it divides ``opr``, a power of two."""
    g = 1
    while g < opr and g * 2 * nr_channels < 128:
        g *= 2
    return g


def make_grouped_from_plan(plan: PackedFirPlan) -> GroupedFirPlan:
    """Regroup a packed plan's taps into the phase-grouped windowed form."""
    row, opr, c = plan.row, plan.opr, plan.nr_channels
    d, t = plan.decimation, plan.nr_taps
    g = _group_size(opr, c)
    n_groups = opr // g
    win_g = (g - 1) * 2 * d + 2 * t
    w_full = np.concatenate([np.asarray(w) for w in plan.w_chunks], axis=0)
    w_full = w_full[:plan.win].reshape(plan.win, 2, opr, c)
    wq_full = np.concatenate([np.asarray(w) for w in plan.w_chunks_i16],
                             axis=0)[:plan.win].reshape(plan.win, 2, opr, c)
    wg = np.zeros((n_groups, win_g, 2, g, c), dtype=np.float32)
    wgq = np.zeros((n_groups, win_g, 2, g, c), dtype=np.int16)
    for grp in range(n_groups):
        off = 2 * d * g * grp
        for jj in range(g):
            j = grp * g + jj
            # phase j's taps live at absolute rows [2*D*j, 2*D*j + 2T)
            a0 = 2 * d * j
            wg[grp, a0 - off:a0 - off + 2 * t, :, jj] = \
                w_full[a0:a0 + 2 * t, :, j]
            wgq[grp, a0 - off:a0 - off + 2 * t, :, jj] = \
                wq_full[a0:a0 + 2 * t, :, j]
    return GroupedFirPlan(
        wg_f32=wg.reshape(n_groups, win_g, 2 * g * c),
        wg_i16=wgq.reshape(n_groups, win_g, 2 * g * c),
        g=g, n_groups=n_groups, win_g=win_g, spill=plan.win - row)


def grouped_fir_worthwhile(plan: PackedFirPlan, threshold=1.3) -> bool:
    """True when the grouped form cuts the product's multiply-adds by at
    least ``threshold`` (the JAX package's choice, made on shapes alone)."""
    chunk_macs = sum(plan.chunk_nnz[i] if plan.chunk_nnz else plan.row
                     for i in range(plan.cr_rows + 1))
    g = _group_size(plan.opr, plan.nr_channels)
    n_groups = plan.opr // g
    win_g = (g - 1) * 2 * plan.decimation + 2 * plan.nr_taps
    grouped_macs = n_groups * win_g * (g / plan.opr)
    return chunk_macs / max(grouped_macs, 1) >= threshold


def grouped_fir_sums(plan: PackedFirPlan, gplan: GroupedFirPlan,
                     carry_vals: torch.Tensor, block: torch.Tensor,
                     wg_f64: torch.Tensor) -> torch.Tensor:
    """The grouped form of :func:`packed_fir_sums` (the JAX package's
    ``_grouped_matmul``, ``tsl_sdr_tpu/ops/packed_fir.py:286-318``): the
    same wrapped int32 ``[rows, 2*halfcols]`` in the same ``[re/im, j, c]``
    column layout, from one float64 windowed product a phase group
    (``wg_f64`` = ``gplan.wg_i16`` as float64, exact products)."""
    row, cr = plan.row, plan.cr_rows
    if block.numel() % row:
        raise ValueError(f"block of {block.numel()} values is not a "
                         f"multiple of the {row}-value row")
    rows = torch.cat([carry_vals, block]).view(-1, row).to(torch.float64)
    r_valid = rows.shape[0] - cr
    # xw[r] = rows[r] ++ rows[r+1] ++ ...: the spill may span several rows
    parts = [rows[:r_valid]]
    rem, k = gplan.spill, 1
    while rem > 0:
        take = min(rem, row)
        parts.append(rows[k:k + r_valid, :take])
        rem -= take
        k += 1
    xw = torch.cat(parts, dim=1)
    step = 2 * plan.decimation * gplan.g
    xg = torch.stack([xw[:, step * grp:step * grp + gplan.win_g]
                      for grp in range(gplan.n_groups)])
    q = torch.bmm(xg, wg_f64)                   # [n_groups, r, 2*g*C]
    # [G, r, 2, g*C] -> [r, 2, G, g*C] -> [r, 2*opr*C] (j = G*g + jj)
    q = q.reshape(gplan.n_groups, r_valid, 2, -1).permute(1, 2, 0, 3)
    return q.reshape(r_valid, -1).to(torch.int64).to(torch.int32)


def init_packed_carry(plan: PackedFirPlan, prefix=None, *,
                      device) -> torch.Tensor:
    """``carry_vals`` interleaved int16 values: zeros, or the first
    ``carry_len`` samples ([n, 2] int16) of the stream."""
    if prefix is None:
        return torch.zeros(plan.carry_vals, dtype=torch.int16, device=device)
    prefix = np.asarray(prefix, np.int16)
    if prefix.shape != (plan.carry_len, 2):
        raise ValueError(f"prefix shape {prefix.shape} != "
                         f"{(plan.carry_len, 2)}")
    return torch.from_numpy(prefix.reshape(-1).copy()).to(device)


def packed_fir_sums(plan: PackedFirPlan, carry_vals: torch.Tensor,
                    block: torch.Tensor, w_f64: torch.Tensor) -> torch.Tensor:
    """The chunked product ``P[r] = sum_i rows[r + i] @ W_i`` as wrapped
    int32 ``[rows, 2*halfcols]`` (columns [re | im]).

    carry_vals [carry_vals] int16, block [2N] int16 flat interleaved (N a
    multiple of ``plan.block_quantum``), ``w_f64`` the tap chunks as one
    float64 tensor ``[cr+1, ROW, COLS]``. Each chunk product is exact in
    float64; the sum wraps to int32 like the reference's MAC
    (``filter/direct_fir.c:366-385``)."""
    row, cr = plan.row, plan.cr_rows
    if block.numel() % row:
        raise ValueError(f"block of {block.numel()} values is not a "
                         f"multiple of the {row}-value row")
    rows = torch.cat([carry_vals, block]).view(-1, row).to(torch.float64)
    r_valid = rows.shape[0] - cr
    p = rows[:r_valid] @ w_f64[0]
    for i in range(1, cr + 1):
        nnz = plan.chunk_nnz[i] if plan.chunk_nnz else row
        p += rows[i:i + r_valid, :nnz] @ w_f64[i, :nnz]
    return p.to(torch.int64).to(torch.int32)


def packed_fir_step(plan: PackedFirPlan, carry_vals: torch.Tensor,
                    block: torch.Tensor, w_f64: torch.Tensor):
    """One streaming step of the plain tier (operands as
    :func:`packed_fir_sums`). Returns (new_carry, ar, ai) with ar/ai
    ``[rows, halfcols]`` float32 — channelized, decimated, not derotated
    baseband in flat (k, c) order."""
    p = packed_fir_sums(plan, carry_vals, block, w_f64).to(torch.float32)
    half = plan.halfcols
    return (next_carry(carry_vals, block, plan.carry_vals),
            p[:, :half], p[:, half:2 * half])


def packed_fir_step_exact(plan: PackedFirPlan, carry_vals: torch.Tensor,
                          block: torch.Tensor, w_f64: torch.Tensor):
    """The bit-exact tier of :func:`packed_fir_step` (int32 modular sums
    are order-free, so the chunked product is the reference's MAC exactly).
    Returns (new_carry, a_re, a_im) with a_re/a_im ``[rows, halfcols]``
    int16: the Q.28 -> Q.14 rounded, not yet derotated sums (reference
    rounding ``filter/complex.h:30-34``)."""
    p = packed_fir_sums(plan, carry_vals, block, w_f64)
    half = plan.halfcols
    return (next_carry(carry_vals, block, plan.carry_vals),
            q14.round_q28_q14(p[:, :half]),
            q14.round_q28_q14(p[:, half:2 * half]))


def omega_turns_i32(omega_d: np.ndarray) -> np.ndarray:
    """Per-output phase increment as signed-int32 turns (2^32 = one turn)."""
    turns = np.asarray(omega_d, dtype=np.float64) / (2.0 * np.pi)
    frac = turns - np.round(turns)
    return np.round(frac * 2.0**32).astype(np.int64).astype(np.int32)


def nco_rotate(ar: torch.Tensor, ai: torch.Tensor, omega_i32: torch.Tensor,
               k0: int):
    """Rotate baseband ``[K, C]`` float32 by ``e^{j*omega_d*k}`` with an
    integer NCO: the phase ``k * omega`` accumulates in wrapping int32
    turns (exact at any absolute index ``k``), then one float32 angle."""
    k = k0 + torch.arange(ar.shape[0], dtype=torch.int64, device=ar.device)
    ph = (k[:, None] * omega_i32.to(torch.int64)[None, :]).to(torch.int32)
    th = ph.to(torch.float32) * float(np.float32(2.0 * np.pi / 2.0**32))
    rr = torch.cos(th)
    ri = torch.sin(th)
    return ar * rr - ai * ri, ar * ri + ai * rr


def next_carry(carry_vals: torch.Tensor, block: torch.Tensor,
               n: int) -> torch.Tensor:
    """The last ``n`` values of ``carry ++ block`` along the last dim
    (each channel's, for ``[G, n]`` tensors), copying only those."""
    if n == 0:
        return carry_vals[..., :0].clone()
    if block.shape[-1] >= n:
        return block[..., block.shape[-1] - n:].clone()
    return torch.cat([carry_vals, block], dim=-1)[..., -n:].contiguous()
