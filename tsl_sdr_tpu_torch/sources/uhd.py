"""USRP/UHD source config.

The port's copy of ``tsl_sdr_tpu/sources/uhd.py``, less the config's
always-failing ``open()`` (the driver is :mod:`.hw`).

Reference: ``multifm/uhd_if.c:133-306,415-434`` — device selected by a UHD
args string, one RX channel, an antenna name, and a LIST of named gain
elements each with a dB value (the reference iterates the config's ``gain``
array and applies each element by name). Config keys from
``etc/multifm_usrp.json``: deviceId, channel, antenna,
gain: [{name, dBValue}, ...].
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class UhdGainElement:
    name: str
    db_value: float


@dataclass
class UhdConfig:
    device_id: str = ""
    channel: int = 0
    antenna: str = "RX2"
    gains: list = field(default_factory=list)

    @classmethod
    def from_dict(cls, device: dict):
        gains = [
            UhdGainElement(name=g["name"], db_value=float(g["dBValue"]))
            for g in device.get("gain", [])
        ]
        return cls(
            device_id=str(device.get("deviceId", "")),
            channel=int(device.get("channel", 0)),
            antenna=str(device.get("antenna", "RX2")),
            gains=gains,
        )
