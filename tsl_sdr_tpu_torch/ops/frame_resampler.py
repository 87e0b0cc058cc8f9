"""Frame-form rational resampler (kernel K4) behind functions on tensors.

The frame form serves every resampler plan without a packed-row form
(``plan.k_row == 0``): ``lcm(I_rep, 128) > 1024`` (147/160, 25/16, 25/48)
or a filter span longer than a row (the heavy upsamplers 64/1, 64/3,
32/5), and most capture-tail plans of ``ResamplerChain``. With
``g = gcd(I, D)``, ``I_rep = I / g`` and ``D_rep = D / g``, output
``k = m * I_rep + j`` (frame ``m``, column ``j``) of a stream ``T`` is

    acc = sum_{q < P} T[m * D_rep + oj[j] + q] * cols[j, q]

summed in wrapping int32, with ``oj[j] = (phase0 + j*D) // I`` and
``cols[j] = phases[(phase0 + j*D) % I]``. :func:`frame_resample` writes
``out="f32"`` (``float32(acc) / 16384``: the JAX package's
``_resample_fast_kernel_t(exact=False)``, ``tsl_sdr_tpu/ops/polyphase.py:
258-301``, bit for bit) or ``out="q14"`` (int16 ``round_q28_q14(acc)``:
its ``exact=True``). On a CUDA tensor it launches ``csrc/frame_resampler.cu``,
which replaces the TPU kernel ``tsl_sdr_tpu/ops/pallas_resampler.py``
``_resample_kernel``/``_resample_call``; on a CPU tensor it runs
:func:`frame_resample_plain`, the dense frame-matrix product the TPU and
XLA forms compute. See the source note in ``csrc/frame_resampler.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import q14
from tsl_sdr_tpu_torch.ops.row_resampler import OUT_MODES


class FrameTaps(NamedTuple):
    """A plan's frame-form taps on the device."""

    cols: torch.Tensor      # [I_rep, P] int16: column j's phase filter
    oj: torch.Tensor        # [I_rep] int32: column j's window start in a frame
    w_frames: torch.Tensor  # [S * D_rep, I_rep] int16: the dense frame matrix
    d_rep: int
    span: int               # max(oj) + P: the window's reach from a frame start


def frame_taps(plan, *, device) -> FrameTaps:
    """The frame-form taps of a ``ResamplerPlan``, built once per plan."""
    i_, d_ = plan.interpolation, plan.decimation
    j = np.arange(plan.i_rep, dtype=np.int64)
    oj = (plan.phase0 + j * d_) // i_
    # taps_sel[k] is output k's phase filter; outputs 0..I_rep-1 are the
    # columns of frame 0
    cols = np.ascontiguousarray(plan.taps_sel_i16[:plan.i_rep])
    p = cols.shape[1]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FrameTaps(cols=dev(cols), oj=dev(oj.astype(np.int32)),
                     w_frames=dev(plan.w_frames_i16), d_rep=int(plan.d_rep),
                     span=int(oj.max()) + p)


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
    i_rep, p = taps.cols.shape
    checks = [(block, torch.int16, (g, n), "block"),
              (carry, torch.int16, (g, carry.shape[1]), "carry"),
              (taps.cols, torch.int16, (i_rep, p), "cols"),
              (taps.oj, torch.int32, (i_rep,), "oj")]
    for t, dtype, shape, name in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != block.device:
            raise ValueError(f"{name} on {t.device}, block on {block.device}")
    mode, dtype = OUT_MODES[out]
    lib = build.load()
    res = torch.empty((g, frames * i_rep), dtype=dtype, device=block.device)
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = lib.tsl_frame_resample(
        carry.data_ptr(), block.data_ptr(), taps.cols.data_ptr(),
        taps.oj.data_ptr(), res.data_ptr(), frames, i_rep, taps.d_rep, p,
        taps.span, carry.shape[1], n, g, mode, stream)
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
