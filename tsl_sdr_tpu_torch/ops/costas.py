"""2nd-order Costas loop (coherent PLL) over channel planes: kernel K6.

Port of ``tsl_sdr_tpu/ops/costas.py``. Reference behaviour
(``multifm/costas_demod.c:26-115``): per int16 IQ sample (scaled by
2^-14) rotate by the NCO ``e^{-j phase}``, error = Im*Re clamped to
+/-e_max, PI update ``f_dev += beta*err; phase += f_dev + alpha*err``, f_dev
clamped to +/-0.3 rad around nominal, phase wrapped to ``[0, 2*pi)``.

The production tier (:func:`costas_block_planes`) is the JAX package's
chunked loop ``_costas_chunks``: per chunk of ``L`` samples the NCO phase is
predicted linearly (``phase0 + k*f_dev``) and the serial PI integration is
applied in closed form::

    S      = sum_k err_k,    R = sum_k (L-k)*err_k
    f_dev' = clip(f_dev + beta*S)
    phase' = mod(phase0 + L*f_dev + beta*R + alpha*S, 2*pi)

A scan over chunks: torch has no scan, so on the card it is the hand kernel
``csrc/costas.cu`` (K6, one warp a channel), on the CPU the Python loop
:func:`costas_block_planes_plain`. Both take the sums as one pairwise tree
over the chunk padded with zeros to ``max(32, next_pow2(L))`` values (the
kernel's lane-local halving then its warp butterfly) and wrap the phase as
``fmod`` plus ``2*pi`` for a negative remainder (``jnp.mod``'s floor-mod),
so on the card the two agree bit for bit. Against the JAX package they
differ by the ulps of torch's and XLA's sin/cos and XLA's order of the sums.

The serial oracles (``costas_step``, ``costas_np``) are not ported: the JAX
package stays the oracle; the host serial loop of the reference is
:func:`tsl_sdr_tpu_torch.runtime.native.costas_native`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import q14

TWO_PI = np.float32(2 * np.pi)
MAX_CHUNK = 512   # the kernel's widest chunk: 16 samples a lane


class CostasParams(NamedTuple):
    alpha: float
    beta: float
    f_dev_nominal: float   # 2*pi*f_shift (radians/sample)
    f_dev_min: float
    f_dev_max: float
    e_max: float


def make_costas_params(f_shift: float, alpha: float, beta: float,
                       e_max_q14: int) -> CostasParams:
    f_dev = 2.0 * np.pi * f_shift
    return CostasParams(
        alpha=float(alpha),
        beta=float(beta),
        f_dev_nominal=float(f_dev),
        f_dev_min=float(f_dev) - 0.3,
        f_dev_max=float(f_dev) + 0.3,
        e_max=float(e_max_q14) / q14.Q14_ONE,
    )


class CostasState(NamedTuple):
    last_phase: torch.Tensor  # [C] float32 (a scalar in costas_block_step)
    f_dev: torch.Tensor       # [C] float32


def init_costas_state(params: CostasParams, nr_channels: int,
                      device) -> CostasState:
    return CostasState(
        last_phase=torch.zeros(nr_channels, dtype=torch.float32,
                               device=device),
        f_dev=torch.full((nr_channels,), params.f_dev_nominal,
                         dtype=torch.float32, device=device))


def stable_chunk(params: CostasParams, amp2: float = 0.25,
                 target: float = 0.4, max_chunk: int = MAX_CHUNK) -> int:
    """Largest chunk length that keeps the chunked loop stable.

    Linearizing the closed-form update for a small phase error ``theta``
    (error ``~ amp2 * theta`` for a half-scale carrier), one chunk applies
    a phase gain ``g = (alpha*L + beta*L^2/2) * amp2``; the chunk
    approximation needs ``g < 1`` (target 0.4 for damping margin).
    """
    a = params.beta * amp2 / 2.0
    b = params.alpha * amp2
    if a > 0:
        l_max = (-b + np.sqrt(b * b + 4.0 * a * target)) / (2.0 * a)
    elif b > 0:
        l_max = target / b
    else:
        l_max = max_chunk
    return int(max(4, min(max_chunk, l_max)))


def tree_width(chunk: int) -> int:
    """Values the chunk's sums run over: ``chunk`` padded with zeros to a
    power of two, at least a warp's 32 lanes."""
    return max(32, 1 << (int(chunk) - 1).bit_length())


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (exact in either
    precision, so a torch op with it computes the float32 operation)."""
    return float(np.float32(v))


def costas_block_planes(params: CostasParams, state: CostasState,
                        xr: torch.Tensor, xi: torch.Tensor,
                        chunk: int | None = None):
    """Chunked Costas over ``[K, C]`` float32 planes in Q.14-normalized
    units (int16 samples / 16384), time-major. ``state`` leaves are ``[C]``.
    Returns ``(state, o_re [K, C], o_im [K, C])`` in the same units.

    The chunk grid is the JAX package's: ``K // chunk`` chunks of ``chunk``,
    then one of the remainder; so a stream fed in blocks that are
    multiples of ``chunk`` gives the same output as one block.
    ``chunk=None`` takes :func:`stable_chunk`. On a CUDA tensor it
    launches ``csrc/costas.cu``; on a CPU tensor it runs
    :func:`costas_block_planes_plain`."""
    if chunk is None:
        chunk = stable_chunk(params)
    chunk = int(chunk)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if xr.device.type == "cpu":
        return costas_block_planes_plain(params, state, xr, xi, chunk)
    if xr.device.type != "cuda":
        raise ValueError(f"costas_block_planes runs on cuda or cpu, not "
                         f"{xr.device}")
    if xr.dim() != 2:
        raise ValueError(f"xr: expected [K, C], got {list(xr.shape)}")
    k, c = xr.shape
    for t, shape, name in ((xr, (k, c), "xr"), (xi, (k, c), "xi"),
                           (state.last_phase, (c,), "last_phase"),
                           (state.f_dev, (c,), "f_dev")):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != xr.device:
            raise ValueError(f"{name} on {t.device}, xr on {xr.device}")
    if k == 0:
        empty = xr.new_zeros((0, c))
        return state, empty, empty.clone()
    xr, xi = xr.contiguous(), xi.contiguous()
    o_re, o_im = torch.empty_like(xr), torch.empty_like(xi)
    phase = torch.empty_like(state.last_phase)
    f_dev = torch.empty_like(state.f_dev)
    lib = build.load()
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = lib.tsl_costas_chunks(
        xr.data_ptr(), xi.data_ptr(), o_re.data_ptr(), o_im.data_ptr(),
        state.last_phase.contiguous().data_ptr(),
        state.f_dev.contiguous().data_ptr(), phase.data_ptr(),
        f_dev.data_ptr(), k, c, chunk, params.alpha, params.beta,
        params.e_max, params.f_dev_min, params.f_dev_max, stream)
    build.check(err, "tsl_costas_chunks")
    costas_block_planes.launches += 1
    return CostasState(last_phase=phase, f_dev=f_dev), o_re, o_im


costas_block_planes.launches = 0


def _tree_sum(x: torch.Tensor, width: int) -> torch.Tensor:
    """``[n, C]`` -> ``[C]``: zero-padded to ``width`` rows, then halved
    as ``x[:h] + x[h:]`` down to one row (K6's lane-local tree, then its
    xor butterfly)."""
    x = torch.nn.functional.pad(x, (0, 0, 0, width - x.shape[0]))
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod(x, y)`` for ``y > 0``: ``fmod`` (exact), plus ``y`` where
    the remainder is negative."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def costas_block_planes_plain(params: CostasParams, state: CostasState,
                              xr: torch.Tensor, xi: torch.Tensor,
                              chunk: int | None = None):
    """Plain torch version of :func:`costas_block_planes`: a Python loop
    over the chunks, each chunk's arithmetic in float32 ops in the order
    K6 computes it, on any device."""
    if chunk is None:
        chunk = stable_chunk(params)
    k, c = xr.shape
    if k == 0:
        empty = xr.new_zeros((0, c))
        return state, empty, empty.clone()
    alpha, beta = _f32(params.alpha), _f32(params.beta)
    e_max = _f32(params.e_max)
    dev_min, dev_max = _f32(params.f_dev_min), _f32(params.f_dev_max)
    two_pi = float(TWO_PI)
    width = tree_width(chunk)
    idx = torch.arange(chunk, dtype=torch.float32, device=xr.device)[:, None]
    phase, f_dev = state.last_phase, state.f_dev
    o_re = torch.empty_like(xr)
    o_im = torch.empty_like(xi)
    for lo in range(0, k, chunk):
        n = min(chunk, k - lo)
        xcr, xci = xr[lo:lo + n], xi[lo:lo + n]
        ph = phase[None, :] + f_dev[None, :] * idx[:n]
        cs, sn = torch.cos(ph), torch.sin(ph)
        r = xcr * cs + xci * sn                  # x * e^{-j ph}
        i = xci * cs - xcr * sn
        err = torch.clamp(i * r, -e_max, e_max)
        s_tot = _tree_sum(err, width)
        ramp = _tree_sum((float(n) - idx[:n]) * err, width)
        f_dev2 = torch.clamp(f_dev + beta * s_tot, dev_min, dev_max)
        phase = _floor_mod(
            phase + float(n) * f_dev + beta * ramp + alpha * s_tot, two_pi)
        f_dev = f_dev2
        o_re[lo:lo + n] = r
        o_im[lo:lo + n] = i
    return CostasState(last_phase=phase, f_dev=f_dev), o_re, o_im


def costas_block_step(params: CostasParams, state: CostasState, block,
                      chunk: int | None = None):
    """One channel, the serial loop's interface: ``[N, 2]`` int16 IQ ->
    ``(state, [N, 2] int16)``; ``state`` leaves are scalars. ``block`` is a
    tensor (on the device the loop runs on) or a host array (CPU)."""
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.asarray(block))
    x = block.to(torch.float32) / q14.Q14_ONE
    st_c = CostasState(last_phase=state.last_phase.reshape(1),
                       f_dev=state.f_dev.reshape(1))
    st2, o_re, o_im = costas_block_planes(params, st_c, x[:, :1], x[:, 1:],
                                          chunk=chunk)
    out = torch.stack([o_re[:, 0], o_im[:, 0]], dim=-1)
    out_i16 = q14.to_int16(torch.trunc(out * q14.Q14_ONE))
    return CostasState(last_phase=st2.last_phase[0],
                       f_dev=st2.f_dev[0]), out_i16
