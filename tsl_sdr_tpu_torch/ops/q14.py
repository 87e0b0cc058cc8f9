"""Q.14 fixed-point constants, the host-side tap quantizers, and the
rounding and scaling of int32 accumulators on tensors.

Port of ``tsl_sdr_tpu/ops/q14.py``: unity is ``1 << 14``; tap quantization
is a C double->int16 cast, which truncates toward zero (reference
``multifm/demod.c:242-243``, ``resampler/resampler.c:148-151``); an int32
Q.28 accumulator rounds to int16 Q.14 as ``(a >> 14) + ((a >> 13) & 1)``
with the narrowing wrapping mod 2^16 (reference ``filter/complex.h:30-34``).
"""

from __future__ import annotations

import numpy as np
import torch

Q14_SHIFT = 14
Q14_ONE = 1 << Q14_SHIFT  # 16384 == unity gain
_Q14_SCALE = 1.0 / Q14_ONE


def quantize_q14(x) -> np.ndarray:
    """Quantize float taps/values to int16 Q.14 with C cast semantics."""
    return np.trunc(np.asarray(x, dtype=np.float64) * Q14_ONE).astype(np.int16)


def quantize_q14_i32(x) -> np.ndarray:
    """Same truncating quantization kept in int32 (derotator increments,
    reference ``filter/direct_fir.c:76-77``)."""
    return np.trunc(np.asarray(x, dtype=np.float64) * Q14_ONE).astype(np.int32)


def round_q28_q14(a: torch.Tensor) -> torch.Tensor:
    """int32 Q.28 -> int16 Q.14 exactly as the C code rounds: arithmetic
    shifts, a round-half-up bit, then a wrapping int32 -> int16 cast."""
    a = a.to(torch.int32)
    return ((a >> Q14_SHIFT) + ((a >> (Q14_SHIFT - 1)) & 1)).to(torch.int16)


def from_acc(acc: torch.Tensor, out: str) -> torch.Tensor:
    """Wrapped int32 filter accumulators -> the resampler's output: "f32"
    is ``float32(acc) / 2^14`` (the fast tier, in sample units), "q14" is
    :func:`round_q28_q14` (the exact tier)."""
    if out == "f32":
        return acc.to(torch.float32) * _Q14_SCALE
    if out == "q14":
        return round_q28_q14(acc)
    raise ValueError(f"out must be 'f32' or 'q14', not {out!r}")


def to_int16(x: torch.Tensor) -> torch.Tensor:
    """float -> int16 as the JAX package's ``astype(jnp.int16)``: truncate
    toward zero, saturate at the int16 range (a bare ``.to(torch.int16)``
    of an out-of-range float is not specified)."""
    if not x.is_floating_point():
        return x.to(torch.int16)
    return torch.clamp(x, -32768, 32767).to(torch.int16)
