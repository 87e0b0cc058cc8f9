"""FM quadrature discriminators (plain torch): the production tier's on
channelized baseband, and the bit-exact tier's on Q.14 IQ.

Port of ``tsl_sdr_tpu/ops/fm.py:66-142`` ``fm_from_baseband`` and
``:145-158`` ``fm_demod_np`` (:func:`fm_demod_exact`, see there). The
reference derotates each FIR output by ``e^{j*omega_d*k}`` and discriminates
``arg(y[k] conj(y[k-1]))`` (``multifm/fm_demod.c:36-83``); the rotation only
adds ``omega_d`` to each phase difference, so it is folded into a post-atan2
add and wrap.

The angle comes from :func:`atan2_poly`, the polynomial of the fused TPU
kernel (``tsl_sdr_tpu/ops/pallas_chain.py:50-97``, max error ~2e-6 rad =
0.01 PCM LSB). Kernel K1 evaluates the same expression in the same order,
each operation rounded once in float32, so the plain version is the
kernel's oracle on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import q14
from tsl_sdr_tpu_torch.ops.atan2 import fast_atan2

PI_F32 = float(np.float32(np.pi))
HALF_PI_F32 = float(np.float32(np.pi / 2))
# float32 values as Python floats: a Python scalar meets a float32 tensor
# as float32, so every operation below rounds once in float32
ATAN_COEFFS = tuple(float(np.float32(c)) for c in (
    -0.0117212,
    0.05265332,
    -0.11643287,
    0.19354346,
    -0.33262348,
    0.99997726,
))


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Quadrant-unfolded polynomial atan2 in float32, exact divide."""
    ya = y.abs()
    xa = x.abs()
    hi = torch.maximum(ya, xa)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    z = torch.minimum(ya, xa) / safe
    z2 = z * z
    p = torch.full_like(z, ATAN_COEFFS[0])
    for c in ATAN_COEFFS[1:]:
        p = p * z2 + c
    base = z * p
    pi, hp = PI_F32, HALF_PI_F32
    ax = torch.where(x >= 0, torch.where(y >= 0, base, -base),
                     torch.where(y >= 0, pi - base, base - pi))
    ay = torch.where(y >= 0, torch.where(x >= 0, hp - base, hp + base),
                     torch.where(x >= 0, base - hp, -base - hp))
    return torch.where(xa > ya, ax, ay)


def fm_from_baseband(ar: torch.Tensor, ai: torch.Tensor,
                     prev_r: torch.Tensor, prev_i: torch.Tensor,
                     omega_d: torch.Tensor):
    """FM-discriminate un-derotated baseband.

    ar/ai: float32 whose flat order is (k, c) — ``[K, C]`` or the packed
    ``[rows, opr*C]`` layout; prev_r/prev_i: [C] float32 previous baseband
    output per channel; omega_d: [C] float32 per-output rotation, already
    reduced to (-pi, pi]. Returns (pcm int16 shaped like ar, new prev_r,
    new prev_i)."""
    c = omega_d.shape[0]
    arf = ar.reshape(-1, c)
    aif = ai.reshape(-1, c)
    pr = torch.cat([prev_r[None].to(torch.float32), arf[:-1]])
    pi_ = torch.cat([prev_i[None].to(torch.float32), aif[:-1]])
    sre = arf * pr + aif * pi_
    sim = aif * pr - arf * pi_
    phi = atan2_poly(sim, sre) + omega_d[None, :]
    pi = PI_F32
    phi = torch.where(phi > pi, phi - 2 * pi, phi)
    phi = torch.where(phi <= -pi, phi + 2 * pi, phi)
    # zero-power inputs (incl. the cold-start k=0 sample) emit 0, matching
    # the reference LUT's both-zero guard (multifm/fast_atan2f.c:109-111)
    phi = torch.where((sre == 0) & (sim == 0), torch.zeros_like(phi), phi)
    # divide by a tensor: a division by a Python scalar runs on the card as
    # a multiplication by its reciprocal, which rounds differently
    pcm = torch.trunc(phi / torch.full_like(phi, pi) * float(q14.Q14_ONE))
    pcm = pcm.to(torch.int16)
    return pcm.reshape(ar.shape), arf[-1].clone(), aif[-1].clone()


def fm_demod_exact(ch: torch.Tensor, last: torch.Tensor):
    """The reference discriminator on channelized Q.14 IQ
    (``multifm/fm_demod.c:36-83``), bit for bit the JAX ``fm_demod_np``.

    ch: [..., K, 2] int16 (re, im); last: [..., 2] int32, the sample before
    the first. Returns (pcm [..., K] int16, new last [..., 2] int32). The
    conjugate products are int32 and wrap (``-32768^2 * 2`` is ``-2^31``):
    they are formed in int64 and narrowed. int32 -> float32 rounds to
    nearest; ``(phi / pi) * 16384`` is evaluated in float64 (the divide by
    a tensor, so that the card divides), stored to float32, truncated."""
    a = ch.to(torch.int64)
    prev = torch.cat([last.to(torch.int64)[..., None, :], a[..., :-1, :]],
                     dim=-2)
    # int64 -> int32 narrows modulo 2^32, as the reference's int32 wraps
    s_re = (a[..., 0] * prev[..., 0] + a[..., 1] * prev[..., 1]).to(
        torch.int32)
    s_im = (a[..., 1] * prev[..., 0] - a[..., 0] * prev[..., 1]).to(
        torch.int32)
    phi = fast_atan2(s_im.to(torch.float32), s_re.to(torch.float32))
    phi = phi.to(torch.float64)
    scaled = (phi / torch.full_like(phi, np.pi) * float(q14.Q14_ONE)).to(
        torch.float32)
    pcm = torch.trunc(scaled).to(torch.int16)
    return pcm, ch[..., -1, :].to(torch.int32)
