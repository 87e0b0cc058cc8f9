"""The 8-channel pager deployment and synthetic captures for it.

Configuration (the repo's 8-channel end-to-end row, ``bench/e2e_breakdown.py``,
at the reference's 8-channel flagship width ``etc/multifm_rtlsdr_8ch.json``):
fs = 1,228,800 Hz, decimation 32 (38,400 Hz channels),
``firdes_low_pass(1.0, fs, 9600, 7000)`` (577 taps), channels at the center
+-60/190/320/450 kHz: six POCSAG (ratio 1, no resampler) and two FLEX
(5/12 resampler to 16 kHz), the last one DC-blocked.

Bursts come from the protocol generators (``testing.{pocsag,flex}_gen``)
and are NBFM-modulated onto their carriers as ``tests/test_pipeline.py``
does.
"""

from __future__ import annotations

import numpy as np

from tsl_sdr_tpu_torch.testing import flex_gen, pocsag_gen
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

FS = 1_228_800
DECIMATION = 32
CENTER_HZ = 929_500_000
OFFSETS_HZ = (-450_000, -320_000, -190_000, -60_000,
              60_000, 190_000, 320_000, 450_000)
PROTOCOLS = ("pocsag",) * 6 + ("flex",) * 2
DC_BLOCK = (False,) * 7 + (True,)


def lpf_taps() -> np.ndarray:
    return firdes_low_pass(1.0, FS, 9_600, 7_000)


# The same band at decimation 50: 24,576 Hz channels, where POCSAG needs a
# 25/16 resampler, a ratio with no packed-row form (lcm(25, 128) > 1024),
# so the group runs the frame-form resampler. The six POCSAG channels only.
# The LPF's stopband starts at 16 kHz: what folds back past the channel's
# 12,288 Hz Nyquist lands above 8.5 kHz, clear of the POCSAG signal.
DEC50_DECIMATION = 50
DEC50_CHANNELS = 6


def dec50_lpf_taps() -> np.ndarray:
    return firdes_low_pass(1.0, FS, 10_000, 6_000)


def dec50_channel_specs(spec_type):
    return channel_specs(spec_type)[:DEC50_CHANNELS]


def channel_specs(spec_type):
    """The eight channels as ``spec_type`` (either package's ChannelSpec)."""
    return [spec_type(CENTER_HZ + off, proto, dc_block=dc)
            for off, proto, dc in zip(OFFSETS_HZ, PROTOCOLS, DC_BLOCK)]


def config(iq_path: str, fmt: str = "cs16") -> dict:
    """The deployment as a pipeline JSON config (multifm vocabulary)."""
    return {
        "device": {"type": "file", "filename": iq_path, "fileFormat": fmt},
        "sampleRateHz": FS,
        "centerFreqHz": CENTER_HZ,
        "decimationFactor": DECIMATION,
        "lpfTaps": [float(t) for t in lpf_taps()],
        "channels": [
            {"chanCenterFreq": CENTER_HZ + off, "protocol": proto,
             "dcBlock": dc}
            for off, proto, dc in zip(OFFSETS_HZ, PROTOCOLS, DC_BLOCK)
        ],
    }


def fm_mod(baseband, channel_rate, offset, fs, amp, dev_hz=None):
    """NBFM-modulate decoder-rate PCM onto a carrier at ``offset`` in a
    wideband capture; zero-order-hold upsampling handles non-integer
    fs/channel_rate ratios."""
    dev = baseband.astype(np.float64) / 16384.0 * (
        dev_hz if dev_hz is not None else channel_rate / 2)
    n_out = int(len(dev) * fs / channel_rate)
    idx = np.minimum(
        (np.arange(n_out) * channel_rate / fs).astype(np.int64), len(dev) - 1)
    phase = np.cumsum(2 * np.pi * (offset + dev[idx]) / fs)
    return np.stack([np.cos(phase), np.sin(phase)], -1) * amp


def burst(channel: int, capcode: int, text: str):
    """One message on ``channel``: (wideband IQ float [n, 2], expected
    (capcode, text))."""
    off = OFFSETS_HZ[channel]
    if PROTOCOLS[channel] == "pocsag":
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=capcode, function=1,
                                    kind="alpha", content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        return fm_mod(bb, 38_400, off, FS, amp=4000), (capcode, text)
    bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=capcode, kind="alnum",
                                   content=text)],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    return fm_mod(bb, 16_000, off, FS, amp=4000), (capcode, text)


def _message(ch: int):
    """The (capcode, text) that :func:`capture` sends on channel ``ch``."""
    return (1_100_000 + 1_000 * ch + (8 if PROTOCOLS[ch] == "flex" else 0),
            f"{PROTOCOLS[ch].upper():6s} CH{ch}!")


def burst_spans(starts):
    """[start, end) in wideband samples of each burst :func:`capture` makes
    from ``starts``."""
    return [(start, start + len(burst(ch, *_message(ch))[0]))
            for ch, start in enumerate(starts)]


def capture(n_samples: int, starts, *, seed: int = 0, noise: float = 80.0):
    """A cs16 capture of ``n_samples`` with burst ``k`` on channel ``k`` at
    wideband sample ``starts[k]``. Returns (iq int16 [n, 2], expected:
    per-channel list of (capcode, text))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=noise, size=(n_samples, 2))
    expected = [[] for _ in OFFSETS_HZ]
    for ch, start in enumerate(starts):
        sig, exp = burst(ch, *_message(ch))
        if start + len(sig) > n_samples:
            raise ValueError(f"channel {ch}'s burst ends at sample "
                             f"{start + len(sig)}, past the capture's end")
        x[start:start + len(sig)] += sig
        expected[ch].append(exp)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16), expected


def to_rtl_u8(iq: np.ndarray) -> np.ndarray:
    """cs16 -> RTL-SDR u8 wire bytes ``s / 128 + 127`` (widens back as
    ``(s - 127) << 7``)."""
    return np.clip(np.round(iq / 128.0) + 127, 0, 255).astype(np.uint8)
