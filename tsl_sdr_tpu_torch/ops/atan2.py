"""The reference demodulator's table-driven arctangent, on tensors.

Port of ``tsl_sdr_tpu/ops/atan2.py:22-39, 83-117`` (``fast_atan2_np``, the
bit-exact tier's angle): a 257-entry table of ``atan(i / 255)`` printed to
7 significant digits, linear interpolation between entries, then the
reference's quadrant unfolding (``multifm/fast_atan2f.c:14-174``). Every
step is one float32 operation rounded to nearest, as C evaluates it; the
``z < TAN_MAP_RES`` test compares in float64, as C promotes the double
constant. :func:`fast_atan2` runs on any device and gives the same bits on
the CPU and the card: each torch operation below is its own kernel, so no
two of them fuse into one rounding, and the one divide is by a tensor (a
divide by a Python scalar would run on the card as a multiplication by the
reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch

TAN_MAP_RES = 0.003921569  # smallest non-zero table abscissa (1/255, rounded)
TAN_MAP_SIZE = 255

PI_F32 = float(np.float32(3.14159265358979323846))
HALF_PI_F32 = float(np.float32(1.57079632679489661923))


def _build_table() -> np.ndarray:
    """atan(i/255) for i=0..255 (+ repeated last entry), rounded the way the
    published table was printed (7 significant digits), stored as float32."""
    idx = np.minimum(np.arange(257), 255)
    exact = np.arctan(idx / 255.0)
    return np.asarray([np.float32(float(f"{v:.6e}")) for v in exact],
                      dtype=np.float32)


ATAN_TABLE = _build_table()
_TABLES: dict = {}


def _table(device) -> torch.Tensor:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(ATAN_TABLE).to(device)
    return _TABLES[key]


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Angle of (x, y) in (-pi, pi], float32, bit for bit the JAX
    package's ``fast_atan2_np``; 0 where both are zero."""
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    ya = y.abs()
    xa = x.abs()
    both_zero = (ya == 0) & (xa == 0)
    hi = torch.maximum(ya, xa)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    z = torch.minimum(ya, xa) / safe
    alpha = z * float(TAN_MAP_SIZE)
    index = alpha.to(torch.int32) & 0xFF
    frac = alpha - index.to(torch.float32)
    table = _table(z.device)
    idx = index.to(torch.int64)
    t0 = table[idx]
    t1 = table[idx + 1]
    interp = t0 + (t1 - t0) * frac
    base = torch.where(z.to(torch.float64) < TAN_MAP_RES, z, interp)
    pi, hp = PI_F32, HALF_PI_F32
    ax = torch.where(x >= 0, torch.where(y >= 0, base, -base),
                     torch.where(y >= 0, pi - base, base - pi))
    ay = torch.where(y >= 0, torch.where(x >= 0, hp - base, hp + base),
                     torch.where(x >= 0, -hp + base, -hp - base))
    angle = torch.where(xa > ya, ax, ay)
    return torch.where(both_zero, torch.zeros_like(angle), angle)
