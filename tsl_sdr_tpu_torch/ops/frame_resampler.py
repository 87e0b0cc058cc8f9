"""Frame-form rational resampler (kernel K4) behind functions on tensors.

The frame form serves every resampler plan without a packed-row form
(``plan.k_row == 0``): ``lcm(I_rep, 128) > 1024`` (147/160, 25/16, 25/48)
or a filter span longer than a row (the heavy upsamplers 64/1, 64/3,
32/5), and most capture-tail plans of ``ResamplerChain``. With
``g = gcd(I, D)``, ``I_rep = I / g`` and ``D_rep = D / g``, frame ``m`` of
a stream ``T`` gives outputs ``m * I_rep + j``:

    acc[m, j] = sum_{k < S * D_rep} T[m * D_rep + k] * W[k, j]

summed in wrapping int32, with ``W = plan.w_frames_i16`` the dense
``[S * D_rep, I_rep]`` frame matrix (column ``j`` holds its phase filter at
its window offset). :func:`frame_resample` writes ``out="f32"``
(``float32(acc) / 16384``: the JAX package's
``_resample_fast_kernel_t(exact=False)``, ``tsl_sdr_tpu/ops/polyphase.py:
258-301``, bit for bit) or ``out="q14"`` (int16 ``round_q28_q14(acc)``:
its ``exact=True``). On a CUDA tensor it launches ``csrc/frame_resampler.cu``,
which replaces the TPU kernel ``tsl_sdr_tpu/ops/pallas_resampler.py``
``_resample_kernel``/``_resample_call`` and runs the product on the int8
tensor cores through the exact split of
:mod:`tsl_sdr_tpu_torch.ops.imma_split` (A the Hankel windows
``T[m * D_rep + k]``, B the split planes of ``W``); on a CPU tensor it
runs :func:`frame_resample_plain`, the same dense product in float64. See
the source note in ``csrc/frame_resampler.cu``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import imma_split, q14
from tsl_sdr_tpu_torch.ops.row_resampler import OUT_MODES


class FrameTaps(NamedTuple):
    """A plan's frame-form taps on the device."""

    w_frames: torch.Tensor  # [S * D_rep, I_rep] int16 (the plain version's)
    # the kernel's: w_frames zero-padded to [K_PAD, N_PAD] (multiples of 32
    # and 8) and split into high/low byte planes of 32x8 tiles in B-fragment
    # order (imma_split.fragment_planes); only the L tiles that hold a
    # non-zero tap are kept ([L, 32, 8] uint8 each, in (k-step, n8 tile)
    # order: W is banded, so at 147/160 that is 44 of 190)
    w_hi: torch.Tensor
    w_lo: torch.Tensor
    # [K_PAD/32, ceil(N_PAD/256), 2] int32: per k-step and word of 32 n8
    # tiles, the word's live bits (bit nt % 32: tile nt is kept) and the
    # number of kept tiles before the word
    w_index: torch.Tensor
    d_rep: int


def live_tiles(hi: np.ndarray, lo: np.ndarray):
    """Split planes ``[KT, NT, 32, 8]`` -> (their tiles that hold a
    non-zero byte, ``[L, 32, 8]`` each, and the ``w_index`` table)."""
    kt, nt = hi.shape[:2]
    live = (hi.reshape(kt, nt, -1) | lo.reshape(kt, nt, -1)).any(axis=2)
    bits = np.zeros((kt, -(-nt // 32) * 32), np.int64)
    bits[:, :nt] = live
    bits = bits.reshape(kt, -1, 32)
    words = (bits << np.arange(32)).sum(axis=2)
    before = np.cumsum(bits.sum(axis=2).reshape(-1)) - bits.sum(
        axis=2).reshape(-1)
    index = np.stack([words.reshape(-1), before], axis=1).reshape(kt, -1, 2)
    index = index.astype(np.uint32).view(np.int32)
    return hi[live], lo[live], index


def frame_taps_of(w_frames, d_rep: int, *, device) -> FrameTaps:
    """Frame-form taps from an int16 ``[S * D_rep, I_rep]`` frame matrix."""
    w_frames = np.ascontiguousarray(w_frames, dtype=np.int16)
    hi, lo, index = live_tiles(*imma_split.fragment_planes(w_frames))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FrameTaps(dev(w_frames), dev(hi), dev(lo), dev(index), int(d_rep))


def frame_taps(plan, *, device) -> FrameTaps:
    """The frame-form taps of a ``ResamplerPlan``, built once per plan."""
    return frame_taps_of(plan.w_frames_i16, plan.d_rep, device=device)


TM_MAX = 64            # frames a block
WARPS_MIN, WARPS_MAX = 4, 8
NT_W = 4               # n8 tiles of a warp's unit
SMEM_MAX = 200 * 1024  # bytes of dynamic shared memory a block


class K4Launch(NamedTuple):
    """How ``csrc/frame_resampler.cu`` runs one call: ``tm`` frames a block
    on ``warps`` warps with ``smem`` bytes of dynamic shared memory, over
    the tap matrix padded to ``k_pad`` x ``8 * n_tiles`` of which
    ``n_live`` 32x8 tiles are kept."""

    tm: int
    warps: int
    smem: int
    k_pad: int
    n_tiles: int
    n_live: int


def launch_shape(taps: FrameTaps, frames: int, out: str = "f32") -> K4Launch:
    """The kernel's launch for ``frames`` frames, the one place its rule
    lives (the wrapper passes it to the kernel; the kernel rejects a
    ``smem`` that is not its layout's size). TM is at most ``TM_MAX`` and
    small enough that a block's units (m16 tiles x groups of ``NT_W`` n8
    tiles) take its warps two rounds, then cut by 16 while the block's
    shared memory passes ``SMEM_MAX``: two window planes of ``(TM - 1) *
    D_rep + K_PAD`` bytes (plus a word, rounded to 16), the kept tiles
    (512 bytes each), their index, and the output tile (16 bytes of
    alignment slack)."""
    k, i_rep = taps.w_frames.shape
    return _launch_shape(k, i_rep, taps.d_rep, taps.w_hi.shape[0], frames,
                         2 if out == "q14" else 4)


# cached: a stream asks for the same launch every step, and working it out
# anew costs the host several microseconds a call
@functools.lru_cache(maxsize=256)
def _launch_shape(k: int, i_rep: int, d_rep: int, n_live: int, frames: int,
                  elem: int) -> K4Launch:
    k_pad = imma_split.K_STEP * -(-k // imma_split.K_STEP)
    n_tiles = -(-i_rep // imma_split.N_TILE)
    n_groups = -(-n_tiles // NT_W)

    def smem(tm):
        window = ((tm - 1) * d_rep + k_pad + 4 + 15) // 16 * 16
        index = (k_pad // 32 * -(-n_tiles // 32) * 8 + 15) // 16 * 16
        return (2 * window + 512 * n_live + index
                + (tm * i_rep * elem + 16 + 15) // 16 * 16)

    tm = min(TM_MAX, -(-frames // 16) * 16,
             16 * max(1, 2 * WARPS_MAX // n_groups))
    while tm > 16 and smem(tm) > SMEM_MAX:
        tm -= 16
    if smem(tm) > SMEM_MAX:
        raise ValueError(f"K4 needs {smem(tm)} bytes of shared memory a "
                         f"block at 16 frames, over {SMEM_MAX}")
    warps = min(WARPS_MAX, max(WARPS_MIN, tm // 16 * n_groups))
    return K4Launch(tm, warps, smem(tm), k_pad, n_tiles, n_live)


def frame_resample(carry: torch.Tensor, block: torch.Tensor, taps: FrameTaps,
                   *, frames: int, out: str = "f32") -> torch.Tensor:
    """carry [G, n_carry] int16, block [G, n] int16 -> [G, frames * I_rep]
    float32 (``out="f32"``) or int16 (``out="q14"``) over ``T = carry ++
    block``; windows past the end of ``T`` read zeros."""
    if out not in OUT_MODES:
        raise ValueError(f"out must be 'f32' or 'q14', not {out!r}")
    if frames <= 0:
        raise ValueError(f"frames must be positive, got {frames}")
    if block.device.type == "cpu":
        return frame_resample_plain(carry, block, taps, frames=frames,
                                    out=out)
    if block.device.type != "cuda":
        raise ValueError(f"frame_resample runs on cuda or cpu, not "
                         f"{block.device}")
    g, n = block.shape
    k, i_rep = taps.w_frames.shape
    launch = launch_shape(taps, frames, out)
    k_tiles = launch.k_pad // imma_split.K_STEP
    n_live = launch.n_live
    checks = [(block, torch.int16, (g, n), "block"),
              (carry, torch.int16, (g, carry.shape[1]), "carry"),
              (taps.w_frames, torch.int16, (k, i_rep), "w_frames"),
              (taps.w_hi, torch.uint8, (n_live, 32, 8), "w_hi"),
              (taps.w_lo, torch.uint8, (n_live, 32, 8), "w_lo"),
              (taps.w_index, torch.int32,
               (k_tiles, -(-launch.n_tiles // 32), 2), "w_index")]
    for t, dtype, shape, name in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != block.device:
            raise ValueError(f"{name} on {t.device}, block on {block.device}")
    if launch.k_pad > imma_split.MAX_DEPTH:
        raise ValueError(f"{k} taps a frame exceed the split's depth limit "
                         f"{imma_split.MAX_DEPTH}")
    mode, dtype = OUT_MODES[out]
    lib = build.load()
    res = torch.empty((g, frames * i_rep), dtype=dtype, device=block.device)
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = lib.tsl_frame_resample(
        carry.data_ptr(), block.data_ptr(), taps.w_hi.data_ptr(),
        taps.w_lo.data_ptr(), taps.w_index.data_ptr(), res.data_ptr(),
        frames, i_rep, taps.d_rep, launch.k_pad, launch.n_tiles, n_live,
        carry.shape[1], n, g, mode, launch.tm, launch.warps, launch.smem,
        stream)
    build.check(err, "tsl_frame_resample")
    frame_resample.launches += 1
    return res


frame_resample.launches = 0


def frame_resample_plain(carry: torch.Tensor, block: torch.Tensor,
                         taps: FrameTaps, *, frames: int,
                         out: str = "f32") -> torch.Tensor:
    """Plain torch version of :func:`frame_resample`: the dense frame form
    ``sum_s F[m + s] @ W_s`` over frames ``F`` of ``D_rep`` samples, as
    the XLA tier computes it, in float64 (exact: a few hundred int16 x
    int16 products per output), wrapped to int32, then the same epilogue."""
    g = block.shape[0]
    d = taps.d_rep
    w = taps.w_frames.to(torch.float64)
    s = w.shape[0] // d
    need = (frames + s - 1) * d
    total = torch.cat([carry, block], dim=1)[:, :need]
    if total.shape[1] < need:
        total = torch.nn.functional.pad(total, (0, need - total.shape[1]))
    f = total.reshape(g, frames + s - 1, d).to(torch.float64)
    acc = f[:, :frames] @ w[:d]
    for k in range(1, s):
        acc += f[:, k:k + frames] @ w[k * d:(k + 1) * d]
    acc = acc.to(torch.int64).to(torch.int32).reshape(g, -1)
    return q14.from_acc(acc, out)


def resample_capture(plan, pcm: torch.Tensor, taps: FrameTaps, *,
                     out: str = "f32") -> torch.Tensor:
    """Whole-capture resample, the counterpart of the JAX package's
    ``resample_capture_pallas``: pcm [N] int16, ``N`` a multiple of
    ``D_rep`` -> [N * I_rep / D_rep]; output ``k`` is the window at input
    offset ``k * D // I``, and the last ``S - 1`` frames' windows read
    zeros past the end."""
    if plan.phase0 != 0:
        raise ValueError("resample_capture supports phase0 == 0 plans")
    n = pcm.shape[0]
    if n % plan.d_rep:
        raise ValueError(f"input length {n} not a multiple of {plan.d_rep}")
    return frame_resample(pcm.new_zeros((1, 0)), pcm[None], taps,
                          frames=n // plan.d_rep, out=out)[0]
