"""Airspy source config.

The port's copy of ``tsl_sdr_tpu/sources/airspy.py``, less the config's
always-failing ``open()`` (the driver is :mod:`.hw`).

Reference: ``multifm/airspy_if.c:151-270`` — gains are three independent
stages (LNA 0-14, mixer 0-15, VGA 0-15) plus an optional bias-tee supply,
and the stream arrives as CS16 blocks copied straight into sample buffers
(``:45-81``). Config keys from ``etc/multifm_airspy.json``:
lnaGain, mixerGain, vgaGain, biasTee.
"""

from __future__ import annotations

from dataclasses import dataclass

_RANGES = {"lna": (0, 14), "mixer": (0, 15), "vga": (0, 15)}


@dataclass
class AirspyConfig:
    lna_gain: int = 0
    mixer_gain: int = 0
    vga_gain: int = 0
    bias_tee: bool = False

    @classmethod
    def from_dict(cls, device: dict):
        cfg = cls(
            lna_gain=int(device.get("lnaGain", 0)),
            mixer_gain=int(device.get("mixerGain", 0)),
            vga_gain=int(device.get("vgaGain", 0)),
            bias_tee=bool(device.get("biasTee", False)),
        )
        cfg.validate()
        return cfg

    def validate(self):
        for name, val in (
            ("lna", self.lna_gain),
            ("mixer", self.mixer_gain),
            ("vga", self.vga_gain),
        ):
            lo, hi = _RANGES[name]
            if not lo <= val <= hi:
                raise ValueError(
                    f"airspy {name} gain {val} outside [{lo}, {hi}]"
                )
