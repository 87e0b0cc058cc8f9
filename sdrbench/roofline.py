"""The H100's peaks and the least time each stage of a block needs, counted
from the configuration's own shapes (samples in, channels, taps,
decimation, each resampler's ratio, taps and rows), never from the
program's plans or launch shapes.

Conventions (those of ``chip_smoke.py``'s kernel bounds): an int16
multiply-add is four int8 tensor-core products of two operations each;
bytes are each input read once and each output written once, at the
narrowest type the stage's definition has (wire samples in, int16 PCM
out).
"""

from __future__ import annotations

import math

from sdrbench.reference import receiver

# NVIDIA H100 SXM data sheet, dense: int8 tensor cores 1,979 T operations/s
# (two a multiply-add), HBM3 3.35 TB/s; both at the card's 700 W limit
INT8_TC_OPS = 1979e12
HBM_BYTES = 3.35e12
OPS_PER_INT16_MAC = 8
WIRE_BYTES = {"cs16": 4, "rtl_u8": 2}


def least_s(int16_macs: float, nbytes: float) -> float:
    return max(OPS_PER_INT16_MAC * int16_macs / INT8_TC_OPS,
               nbytes / HBM_BYTES)


def k1_least_s(samples: int, channels: int, taps: int, decimation: int,
               wire_fmt: str) -> float:
    """Channelizer + discriminator: each of ``samples // decimation``
    outputs of each channel is a complex product of ``taps`` complex taps
    with complex samples (4 real multiply-adds a tap); the wire samples
    in, int16 PCM out."""
    outs = samples // decimation
    macs = outs * channels * 4 * taps
    nbytes = samples * WIRE_BYTES[wire_fmt] + outs * channels * 2
    return least_s(macs, nbytes)


def resampler_taps(interpolation: int, decimation: int) -> int:
    """The length of upstream's designed filter for ``I/D``."""
    return receiver.resampler_taps(interpolation, decimation).shape[0]


def resample_least_s(samples_in: int, rows: int, interpolation: int,
                     decimation: int, taps: int) -> float:
    """One ratio group: ``rows`` rows of ``samples_in`` int16 samples in,
    ``samples_in * I / D`` int16 outputs each, each output the sum of one
    phase's ``ceil(taps / I)`` products."""
    outs = samples_in * interpolation // decimation
    macs = rows * outs * math.ceil(taps / interpolation)
    nbytes = rows * (samples_in + outs) * 2
    return least_s(macs, nbytes)
