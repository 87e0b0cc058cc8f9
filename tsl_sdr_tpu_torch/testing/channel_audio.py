"""Decoder-rate channel audio with synthetic bursts: input for the decoder
front end (``decoder-torch``), as a receiver's channel output would hand it
over (reference ``decoder/decoder.c`` reads int16 PCM at the channel rate).

Bursts come from the protocol generators (``testing.{pocsag,flex}_gen``)
at the protocol's rate (POCSAG 38,400 Hz, FLEX 16,000 Hz) and are moved to
the channel rate
by nearest-sample indexing (as ``tests/test_ref_parity.py`` delivers
POCSAG at 25 kHz), spread evenly over the capture, on Gaussian noise.
"""

from __future__ import annotations

import numpy as np

from tsl_sdr_tpu_torch.testing import flex_gen, pocsag_gen
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter, resampler_filter_json)

PROTOCOL_RATES = {"pocsag": 38_400, "flex": 16_000}


def _burst(protocol: str, k: int):
    """Burst ``k``: (PCM at the protocol rate, (capcode, text))."""
    if protocol == "pocsag":
        capcode, text = 1_200_000 + 8 * k, f"POCSAG BURST {k:02d}"
        pcm = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=capcode, function=1,
                                    kind="alpha", content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        return pcm, (capcode, text)
    capcode, text = 400_000 + 8 * k, f"FLEX BURST {k:02d}"
    pcm, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=capcode, kind="alnum",
                                   content=text)],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    return pcm, (capcode, text)


def capture(protocol: str, rate: int, seconds: float, n_bursts: int, *,
            seed: int = 0, noise: float = 100.0, dc: int = 0):
    """``seconds`` of int16 channel audio at ``rate`` with ``n_bursts``
    bursts of ``protocol`` and a constant ``dc`` offset. Returns (pcm,
    expected [(capcode, text)] in time order)."""
    proto_rate = PROTOCOL_RATES[protocol]
    n = int(seconds * rate)
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=noise, size=n) + dc
    expected = []
    slot = n // n_bursts
    for k in range(n_bursts):
        bb, exp = _burst(protocol, k)
        idx = (np.arange(len(bb) * rate // proto_rate) * proto_rate) // rate
        sig = bb[idx].astype(np.float64)
        start = k * slot + slot // 8
        if start + len(sig) > min(n, (k + 1) * slot):
            raise ValueError(f"burst {k} of {len(sig)} samples does not fit "
                             f"its {slot}-sample slot")
        x[start:start + len(sig)] += sig
        expected.append(exp)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16), expected


def resampler_taps(interpolate: int, decimate: int) -> np.ndarray:
    """The float taps ``design-filter-tpu I D 0.4`` designs."""
    return design_rational_resampler_filter(interpolate, decimate, 0.4)


def write_filter(path, interpolate: int, decimate: int) -> None:
    """The resampler filter file ``design-filter-tpu I D 0.4`` writes."""
    with open(path, "w") as f:
        f.write(resampler_filter_json(interpolate, decimate, 0.4))
