"""Polyphase rational resampler: numpy plan + the streaming step.

Port of ``tsl_sdr_tpu/ops/polyphase.py:36-205`` (plan builder, copied as
numpy because the JAX module imports jax at load) and of ``resample_step``
(``:348-391``) in both of its forms, both tiers.

Packed-row form (``plan.k_row``): each channel's stream ``T = carry ++
block`` is cut into rows of ``ROW_IN`` samples; row ``m`` yields ``K_ROW``
outputs from its own samples against ``w_row [ROW_IN, K_ROW]`` plus the
first ``sp`` samples of row ``m + 1`` against the trimmed spill matrix
``w_spill [sp, K_ROW]`` (reference hot loop ``filter/polyphase_fir.c:
162-233``). The product runs in
:func:`tsl_sdr_tpu_torch.ops.row_resampler.row_resample`: kernel K3 on the
card, one launch for every channel of a ratio group.

Frame form (``plan.k_row == 0``): output ``m * I_rep + j`` is column
``j``'s phase filter over the window at ``m * D_rep + oj[j]``, in
:func:`tsl_sdr_tpu_torch.ops.frame_resampler.frame_resample` (kernel K4).

Both accumulate int16 x int16 products in wrapping int32. The fast tier
(``exact=False``) scales them to float32 sample units, the exact tier
rounds them Q.28 -> Q.14 as the reference does; each is bit-identical to
the JAX ``resample_step`` of the same tier. (The JAX package's per-output
gather oracle, ``exact_impl="gather"``, is not ported: it computes the same
exact output, and the JAX package remains the oracle.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import imma_split, q14
from tsl_sdr_tpu_torch.ops.frame_resampler import FrameTaps, frame_resample
from tsl_sdr_tpu_torch.ops.frame_resampler import frame_taps
from tsl_sdr_tpu_torch.ops.packed_fir import next_carry
from tsl_sdr_tpu_torch.ops.row_resampler import RowTaps, row_resample


class ResamplerPlan(NamedTuple):
    """Static plan (same fields as the JAX package's)."""

    taps_sel_i16: np.ndarray  # [K, P] int16 — phase taps gathered per output
    taps_sel_f32: np.ndarray  # [K, P] float32
    offsets: np.ndarray       # [K] int32 — window start per output
    interpolation: int
    decimation: int
    block_in: int             # N_in input samples consumed per step
    block_out: int            # K outputs produced per step
    carry_len: int
    phase0: int
    w_frames: np.ndarray      # [S*D_rep, I_rep] float32 (frame form)
    w_frames_i16: np.ndarray  # same, int16 Q.14
    frame_shifts: int         # S
    i_rep: int
    d_rep: int
    k_row: int = 0            # packed-row form: outputs per row (0 = none)
    row_in: int = 0           # input samples per row
    spill: int = 0            # window overhang into the next row
    w_row_i16: np.ndarray | None = None    # [ROW_IN, K_ROW] int16
    w_spill_i16: np.ndarray | None = None  # [spill_pad, K_ROW] or None


def build_phase_filters(fir_coeff, interpolate: int) -> np.ndarray:
    """[I, P] int16 phase decomposition with the reference's zero padding
    (``polyphase_fir.c:70-83``)."""
    coeff = np.asarray(fir_coeff, dtype=np.int16)
    nr = coeff.shape[0]
    pc = (nr + interpolate - 1) // interpolate
    pc = (pc + 3) & ~3
    phases = np.zeros((interpolate, pc), dtype=np.int16)
    i = np.arange(nr)
    phases[i % interpolate, i // interpolate] = coeff
    return phases


def make_resampler_plan(fir_coeff_q14, interpolate: int, decimate: int,
                        block_out_target: int = 1024, phase0: int = 0,
                        align_k_row: bool = True,
                        k_row_max: int = 1024) -> ResamplerPlan:
    """Build the static plan from int16 Q.14 taps
    (:func:`tsl_sdr_tpu_torch.ops.q14.quantize_q14` of float coefficients).
    ``align_k_row=False`` keeps the exact ``block_out_target`` grid (the
    pipeline needs ``block_in`` equal to its per-block channel span)."""
    phases = build_phase_filters(fir_coeff_q14, interpolate)
    p = phases.shape[1]

    g = math.gcd(interpolate, decimate)
    base = interpolate // g
    k_row = math.lcm(base, 128)
    if k_row > k_row_max:
        k_row = 0
    if align_k_row and k_row:
        k_out = k_row * max(1, -(-block_out_target // k_row))
    else:
        k_out = base * max(1, -(-block_out_target // base))
        if k_row and k_out % k_row:
            k_row = 0
    n_in = k_out * decimate // interpolate

    k = np.arange(k_out, dtype=np.int64)
    phase_seq = (phase0 + k * decimate) % interpolate
    offsets = (phase0 + k * decimate) // interpolate
    carry_len = int(max(0, offsets[-1] + p - n_in))
    taps_sel = phases[phase_seq]

    i_rep = interpolate // g
    d_rep = decimate // g
    oj = (phase0 + np.arange(i_rep, dtype=np.int64) * decimate) // interpolate
    span = int(oj.max()) + p
    s_shifts = -(-span // d_rep)
    wf = np.zeros((s_shifts * d_rep, i_rep), dtype=np.float32)
    wq = np.zeros((s_shifts * d_rep, i_rep), dtype=np.int16)
    for j in range(i_rep):
        ph = phases[(phase0 + j * decimate) % interpolate]
        wf[oj[j]:oj[j] + p, j] = ph.astype(np.float32) / q14.Q14_ONE
        wq[oj[j]:oj[j] + p, j] = ph

    w_row = None
    w_spill = None
    row_in = 0
    spill = 0
    if k_row:
        frames = k_row // i_rep
        row_in = frames * d_rep
        win_r = (frames - 1) * d_rep + span
        spill = max(0, win_r - row_in)
        if spill > row_in:
            k_row = 0
            row_in = 0
            spill = 0
    if k_row:
        spill_pad = min(row_in, -(-spill // 128) * 128) if spill else 0
        wp = np.zeros((row_in + spill_pad, k_row), dtype=np.int16)
        for f in range(frames):
            for j in range(i_rep):
                ph = phases[(phase0 + j * decimate) % interpolate]
                u0 = f * d_rep + int(oj[j])
                wp[u0:u0 + p, f * i_rep + j] = ph
        w_row = wp[:row_in]
        w_spill = np.ascontiguousarray(wp[row_in:]) if spill else None

    return ResamplerPlan(
        taps_sel_i16=taps_sel,
        taps_sel_f32=taps_sel.astype(np.float32) / q14.Q14_ONE,
        offsets=offsets.astype(np.int32),
        interpolation=int(interpolate),
        decimation=int(decimate),
        block_in=int(n_in),
        block_out=int(k_out),
        carry_len=carry_len,
        phase0=int(phase0),
        w_frames=wf,
        w_frames_i16=wq,
        frame_shifts=int(s_shifts),
        i_rep=int(i_rep),
        d_rep=int(d_rep),
        k_row=int(k_row),
        row_in=int(row_in),
        spill=int(spill),
        w_row_i16=w_row,
        w_spill_i16=w_spill,
    )


def row_taps(plan: ResamplerPlan, *, device) -> RowTaps:
    """The plan's packed-row taps on ``device``: ``w0``/``w1`` as the plan
    holds them, and the split planes of the kernel, built from the row's
    taps followed by the plan's real spill (``plan.spill`` rows, not the
    128-padded ``w_spill_i16``), zero-padded to a multiple of 32 rows."""
    if not plan.k_row:
        raise ValueError("plan has no packed-row form (k_row == 0); "
                         "use plan_taps")
    w1 = plan.w_spill_i16
    full = plan.w_row_i16 if w1 is None else np.concatenate(
        [plan.w_row_i16, w1[:plan.spill]])
    hi, lo = imma_split.fragment_planes(full)
    return RowTaps(
        torch.from_numpy(np.ascontiguousarray(plan.w_row_i16)).to(device),
        None if w1 is None else torch.from_numpy(w1).to(device),
        torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def plan_taps(plan: ResamplerPlan, *, device) -> RowTaps | FrameTaps:
    """A plan's taps on the device: packed-row (K3) where the plan has
    that form, else frame form (K4) — the JAX ``resample_step``'s choice."""
    if plan.k_row:
        return row_taps(plan, device=device)
    return frame_taps(plan, device=device)


def init_resampler_carry(plan: ResamplerPlan, groups: int, *, device,
                         prefix=None) -> torch.Tensor:
    """History for ``groups`` channels: ``[G, carry_len]`` int16, zeros or
    ``prefix`` (each channel's first ``carry_len`` stream samples, which
    aligns output 0 with the reference's first output)."""
    if prefix is None:
        return torch.zeros((groups, plan.carry_len), dtype=torch.int16,
                           device=device)
    prefix = torch.as_tensor(prefix, dtype=torch.int16).reshape(groups, -1)
    if prefix.shape[1] != plan.carry_len:
        raise ValueError(f"prefix of {prefix.shape[1]} samples per channel, "
                         f"plan carries {plan.carry_len}")
    return prefix.to(device).contiguous()


def resample_step(plan: ResamplerPlan, carry: torch.Tensor,
                  block: torch.Tensor, taps: RowTaps | FrameTaps, *,
                  exact: bool = False):
    """One streaming step, batched over a ratio group.

    carry [G, carry_len] int16, block [G, block_in] int16, ``taps`` from
    :func:`plan_taps` -> (new carry, out [G, block_out]): float32 sample
    units (``exact=False``) or int16 Q.14 (``exact=True``). Each channel
    equals the JAX ``resample_step(plan, state, block, exact=exact)``."""
    if block.shape[1] != plan.block_in:
        raise ValueError(f"block of {block.shape[1]} samples per channel, "
                         f"plan expects {plan.block_in}")
    out = "q14" if exact else "f32"
    if plan.k_row:
        if plan.carry_len != plan.spill:
            raise ValueError(f"packed-row plans carry exactly the spill "
                             f"({plan.carry_len} != {plan.spill})")
        res = row_resample(carry, block, taps, row_in=plan.row_in, out=out)
    else:
        res = frame_resample(carry, block, taps,
                             frames=plan.block_out // plan.i_rep, out=out)
    new_carry = next_carry(carry, block, plan.carry_len)
    return new_carry, res.reshape(block.shape[0], -1)
