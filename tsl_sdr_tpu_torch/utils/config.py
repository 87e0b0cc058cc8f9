"""Config system speaking the reference's JSON vocabulary.

The reference merges any number of JSON config files on the command line and
reads typed keys (``multifm/multifm.c:105-116``, ``multifm/receiver.c:128-244``).
We mirror that: :func:`load_config` deep-merges files left-to-right, and the
typed dataclasses below map the exact key names (``sampleRateHz``,
``centerFreqHz``, ``decimationFactor``, ``lpfTaps``, ``channels[].outFifo``,
``channels[].chanCenterFreq``, ``channels[].dBGain``, device blocks) so the
shipped ``etc/*.json`` files load unmodified.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any


class ConfigError(ValueError):
    """Malformed or incomplete configuration. The reference prints a
    diagnostic and exits instead of crashing (``multifm/multifm.c:105-146``,
    TSL config engine error returns); CLIs catch this and exit 2."""


def _req(cfg: dict, key: str, what: str):
    if key not in cfg:
        raise ConfigError(f"missing required config key '{key}' ({what})")
    return cfg[key]


def _deep_merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(*paths) -> dict:
    """Load and deep-merge one or more JSON config files (later files win)."""
    merged: dict = {}
    for p in paths:
        try:
            with open(p) as f:
                merged = _deep_merge(merged, json.load(f))
        except FileNotFoundError:
            raise ConfigError(f"config file not found: {p}") from None
        except json.JSONDecodeError as e:
            raise ConfigError(f"invalid JSON in {p}: {e}") from None
    return merged


@dataclass
class ChannelConfig:
    out_fifo: str
    chan_center_freq: int
    db_gain: float | None = None
    signal_debug_file: str | None = None

    @property
    def linear_gain(self) -> float:
        """Reference converts dB with the power formula and applies it as a
        tap multiplier (``multifm/receiver.c:218-221``)."""
        if self.db_gain is None:
            return 1.0
        return math.pow(10.0, self.db_gain / 10.0)


@dataclass
class DeviceConfig:
    type: str  # rtlsdr | airspy | usrp | file
    params: dict[str, Any] = field(default_factory=dict)


@dataclass
class MultifmConfig:
    device: DeviceConfig
    sample_rate_hz: int
    center_freq_hz: int
    decimation_factor: int
    lpf_taps: list[float]
    channels: list[ChannelConfig]
    nr_samp_bufs: int = 128
    # startup mute: samples delivered in the first N ms are discarded, the
    # CLI analogue of the reference's receiver mute gate (the receiver starts
    # muted and multifm.c:158 unmutes once setup is done; receiver.h:98)
    mute_startup_ms: int = 0
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, cfg: dict) -> "MultifmConfig":
        dev = dict(cfg.get("device", {}))
        dev_type = dev.pop("type", "file")
        channels_raw = _req(cfg, "channels", "channel list")
        if not isinstance(channels_raw, list) or not channels_raw:
            raise ConfigError("'channels' must be a non-empty list")
        try:
            channels = [
                ChannelConfig(
                    out_fifo=ch.get("outFifo"),  # optional for pipeline-tpu
                                                 # protocol channels
                    chan_center_freq=int(
                        _req(ch, "chanCenterFreq",
                             "channel center frequency in Hz")),
                    db_gain=ch.get("dBGain"),
                    signal_debug_file=ch.get("signalDebugFile"),
                )
                for ch in channels_raw
            ]
        except AttributeError:
            raise ConfigError(
                "'channels' entries must be JSON objects") from None
        except ConfigError:
            raise
        except (TypeError, ValueError) as e:
            raise ConfigError(f"bad channel value in config: {e}") from None
        if "lpfTaps" not in cfg:
            raise ConfigError(
                "Need a baseband filter with at least two taps as 'lpfTaps'"
            )
        try:
            return cls(
                device=DeviceConfig(type=dev_type, params=dev),
                sample_rate_hz=int(
                    _req(cfg, "sampleRateHz", "input sample rate in Hz")),
                center_freq_hz=int(
                    _req(cfg, "centerFreqHz", "capture center frequency in Hz")),
                decimation_factor=int(
                    _req(cfg, "decimationFactor", "channelizer decimation")),
                lpf_taps=[float(t) for t in cfg["lpfTaps"]],
                channels=channels,
                nr_samp_bufs=int(cfg.get("nrSampBufs", 128)),
                mute_startup_ms=int(cfg.get("muteStartupMs", 0)),
                raw=cfg,
            )
        except (TypeError, ValueError) as e:
            if isinstance(e, ConfigError):
                raise
            raise ConfigError(f"bad value in config: {e}") from None

    @classmethod
    def load(cls, *paths) -> "MultifmConfig":
        return cls.from_dict(load_config(*paths))

    @property
    def channel_offsets_hz(self) -> list[int]:
        return [c.chan_center_freq - self.center_freq_hz for c in self.channels]

    @property
    def channel_gains(self) -> list[float]:
        return [c.linear_gain for c in self.channels]


@dataclass
class RationalResamplerConfig:
    """The ``rationalResampler`` block emitted by the filter designer
    (``scripts/design_interpolation_filter.py:54``) / consumed by the
    resampler and decoder CLIs (``lpfCoeffs`` key,
    ``resampler/resampler.c:139-151``)."""

    interpolate: int
    decimate: int
    lpf_coeffs: list[float]
    fractional_bw: float | None = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "RationalResamplerConfig":
        if "rationalResampler" in cfg:
            cfg = cfg["rationalResampler"]
        try:
            return cls(
                interpolate=(int(cfg["interpolate"])
                             if "interpolate" in cfg else 1),
                decimate=int(cfg["decimate"]) if "decimate" in cfg else 1,
                lpf_coeffs=[float(t) for t in
                            _req(cfg, "lpfCoeffs", "resampler filter taps")],
                fractional_bw=cfg.get("fractionalBw"),
            )
        except ConfigError:
            raise
        except (TypeError, ValueError) as e:
            raise ConfigError(f"bad resampler config value: {e}") from None

    @classmethod
    def load(cls, *paths) -> "RationalResamplerConfig":
        return cls.from_dict(load_config(*paths))


def load_lpf_coeffs(path) -> list[float]:
    """Load ``lpfCoeffs`` (decoder/resampler ``-F filter.json``) — the key the
    stream tools read (``resampler/resampler.c:139``, ``decoder/decoder.c``)."""
    cfg = load_config(path)
    if "rationalResampler" in cfg:
        cfg = cfg["rationalResampler"]
    key = "lpfCoeffs" if "lpfCoeffs" in cfg else "lpfTaps"
    if key not in cfg:
        raise ConfigError(
            f"no 'lpfCoeffs' (or 'lpfTaps') filter taps in {path}")
    try:
        return [float(t) for t in cfg[key]]
    except (TypeError, ValueError) as e:
        raise ConfigError(f"bad filter tap in {path}: {e}") from None
