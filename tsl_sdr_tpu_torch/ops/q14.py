"""Q.14 fixed-point constants and the host-side tap quantizers.

Port of ``tsl_sdr_tpu/ops/q14.py`` (numpy part): unity is ``1 << 14`` and
tap quantization is a C double->int16 cast, which truncates toward zero
(reference ``multifm/demod.c:242-243``, ``resampler/resampler.c:148-151``).
"""

from __future__ import annotations

import numpy as np

Q14_SHIFT = 14
Q14_ONE = 1 << Q14_SHIFT  # 16384 == unity gain


def quantize_q14(x) -> np.ndarray:
    """Quantize float taps/values to int16 Q.14 with C cast semantics."""
    return np.trunc(np.asarray(x, dtype=np.float64) * Q14_ONE).astype(np.int16)


def quantize_q14_i32(x) -> np.ndarray:
    """Same truncating quantization kept in int32 (derotator increments,
    reference ``filter/direct_fir.c:76-77``)."""
    return np.trunc(np.asarray(x, dtype=np.float64) * Q14_ONE).astype(np.int32)
