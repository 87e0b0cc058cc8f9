"""Channel tap design (numpy).

Port of ``tsl_sdr_tpu/ops/fir.py:75`` ``design_channel_taps``: the real
baseband LPF shifted to a complex bandpass filter per channel (reference
``multifm/demod.c:205-243``). The bit-exact scan tier of that module stays
with the JAX package.
"""

from __future__ import annotations

import numpy as np


def design_channel_taps(lpf_taps, offset_hz: float, sample_rate: float,
                        gain: float = 1.0):
    """tap[i] = gain * exp(-j*2*pi*offset/fs * i) * lpf[i].

    Returns (complex128 taps [T], f_offs) where ``f_offs`` is the per-input
    phase step ``-2*pi*offset/fs``."""
    lpf_taps = np.asarray(lpf_taps, dtype=np.float64)
    f_offs = -2.0 * np.pi * float(offset_hz) / float(sample_rate)
    i = np.arange(lpf_taps.shape[0], dtype=np.float64)
    taps = gain * np.exp(1j * f_offs * i) * lpf_taps
    return taps, f_offs
