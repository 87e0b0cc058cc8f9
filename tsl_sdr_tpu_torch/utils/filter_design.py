"""Filter design: Kaiser-window low-pass replicating the GNURadio designer.

The reference designs rational-resampler filters offline with GNURadio
(``scripts/design_interpolation_filter.py``): ``firdes.low_pass`` with a
Kaiser window (beta = 7), gain = interpolation, designed at the interpolated
rate. We reimplement that design rule in numpy (the classic firdes recipe)
so emitted coefficient sets are drop-in compatible, plus a generic
channel-LPF designer for multifm configs.
"""

from __future__ import annotations

import json
import numpy as np


def _kaiser_attenuation(beta: float) -> float:
    return beta / 0.1102 + 8.7


def _compute_ntaps(sampling_freq: float, transition_width: float, beta: float) -> int:
    delta_f = transition_width / sampling_freq
    ntaps = int(_kaiser_attenuation(beta) / (22.0 * delta_f))
    return ntaps + 1 if ntaps % 2 == 0 else ntaps  # force odd


def firdes_low_pass(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
    beta: float = 7.0,
) -> np.ndarray:
    """windowed-sinc LPF normalized to DC gain == ``gain``."""
    ntaps = _compute_ntaps(sampling_freq, transition_width, beta)
    w = np.kaiser(ntaps, beta)
    m = (ntaps - 1) // 2
    fw_t0 = 2.0 * np.pi * cutoff_freq / sampling_freq
    n = np.arange(ntaps) - m
    taps = np.empty(ntaps, dtype=np.float64)
    nz = n != 0
    taps[nz] = np.sin(n[nz] * fw_t0) / (n[nz] * np.pi) * w[nz]
    taps[~nz] = fw_t0 / np.pi * w[~nz]
    # normalize to unity DC gain, then apply requested gain
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:])
    return taps * (gain / fmax)


def design_rational_resampler_filter(
    interpolation: int, decimation: int, fractional_bw: float = 0.4
) -> np.ndarray:
    """The exact design rule of ``scripts/design_interpolation_filter.py:7-42``:
    LPF at the interpolated rate, gain = interpolation, Kaiser beta = 7."""
    if not (0.0 < fractional_bw < 0.5):
        raise ValueError("fractional_bw must be in (0, 0.5)")
    if interpolation < 1 or decimation < 1:
        raise ValueError("interpolation and decimation must be positive integers")
    halfband = 0.5
    rate = float(interpolation) / float(decimation)
    if rate >= 1.0:
        trans_width = halfband - fractional_bw
        mid_transition_band = halfband - trans_width / 2.0
    else:
        trans_width = rate * (halfband - fractional_bw)
        mid_transition_band = rate * halfband - trans_width / 2.0
    return firdes_low_pass(
        gain=float(interpolation),
        sampling_freq=float(interpolation),
        cutoff_freq=mid_transition_band,
        transition_width=trans_width,
    )


def design_channel_lpf(
    sample_rate: float, cutoff: float, transition: float | None = None
) -> np.ndarray:
    """Unity-gain channel LPF for multifm-style channelizers."""
    if transition is None:
        transition = cutoff / 4.0
    return firdes_low_pass(1.0, sample_rate, cutoff, transition)


def resampler_filter_json(
    interpolation: int, decimation: int, fractional_bw: float = 0.4
) -> str:
    """Emit the designer's JSON document shape (reference script line 54)."""
    taps = design_rational_resampler_filter(interpolation, decimation, fractional_bw)
    return json.dumps(
        {
            "rationalResampler": {
                "interpolate": interpolation,
                "decimate": decimation,
                "fractionalBw": fractional_bw,
                "lpfCoeffs": list(map(float, taps)),
            }
        }
    )
