"""Mock radio libraries for driver tests: the port's copy of
``tsl_sdr_tpu/testing/mock_radios``.

``mock_rtlsdr.c``, ``mock_airspy.c`` and ``mock_uhd.c`` stand in for
librtlsdr, libairspy and the UHD shim: they record every setting applied
and deliver known streams (the RTL-SDR test-mode counter or the bytes of
``MOCK_RTLSDR_DATA``, CS16 ramps). :func:`build` compiles one with ``gcc``
into ``build/tsl_sdr_tpu_torch/`` (never into the package directory); it
raises RuntimeError where there is no C compiler.
"""

from __future__ import annotations

from pathlib import Path

from tsl_sdr_tpu_torch.runtime import native

_HERE = Path(__file__).resolve().parent

ENV_VARS = {
    "rtlsdr": "TSL_RTLSDR_LIB",
    "airspy": "TSL_AIRSPY_LIB",
    "uhd": "TSL_UHD_LIB",
}


def build(kind: str) -> Path:
    """Compile (if missing or stale) and return the mock library for
    ``kind`` (rtlsdr, airspy or uhd)."""
    return native.build_shared(_HERE / f"mock_{kind}.c", f"mock_{kind}",
                               "gcc", ["-O2", "-shared", "-fPIC", "-pthread"])

