"""Structured diagnostics: the TSL logging surface, Python-shaped.

Port of ``tsl_sdr_tpu/utils/diag.py`` (numpy only, as the JAX module is).
The reference logs through ``MESSAGE(subsystem, severity, CODE, fmt, ...)``
macros wrapped per component (``MFM_MSG``/``FIL_MSG``/``PAG_MSG``/...) plus
a hexdump helper (``tsl/hexdump.h``). Here that maps onto :mod:`logging`
with the same shape: a subsystem-tagged logger (``tsl_sdr_tpu_torch.<subsys>``)
emitting ``[SUBSYS] CODE: message`` lines, and :func:`hexdump` for packet
debugging.

The two coefficient dumps are runtime forms of the reference's compile-time
dump blocks, gated on environment variables and called by the plan
builders (:func:`tsl_sdr_tpu_torch.ops.packed_fir.make_packed_fir_plan`,
:func:`tsl_sdr_tpu_torch.ops.polyphase.make_resampler_plan`), so every
``-torch`` CLI honours them: ``TSL_DUMP_LPF`` and
``TSL_DUMP_FILTER_COEFFICIENTS``, each ``stderr`` (or ``-``, ``1``,
``true``) or a file path to append to. Their text is the JAX package's,
byte for byte.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np

_SEVERITIES = {
    "FATAL": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARNING": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
}


def subsystem_logger(subsystem: str) -> logging.Logger:
    return logging.getLogger(f"tsl_sdr_tpu_torch.{subsystem.lower()}")


def message(subsystem: str, severity: str, code: str, fmt: str, *args):
    """``MESSAGE(subsys, SEV_*, "CODE", fmt, ...)`` equivalent."""
    subsystem_logger(subsystem).log(
        _SEVERITIES.get(severity.upper(), logging.INFO),
        "[%s] %s: " + fmt, subsystem.upper(), code, *args,
    )


def _dump_stream(env_value: str):
    """``stderr``/``-`` -> stderr; anything else -> append to that path."""
    if env_value in ("stderr", "-", "1", "true"):
        return sys.stderr, False
    return open(env_value, "a"), True


def dump_shifted_lpf(offset_hz: int, taps, q_re, q_im) -> None:
    """Per-channel shifted-LPF coefficient dump, gated on ``TSL_DUMP_LPF``
    (the reference's ``_DUMP_LPF`` block, ``multifm/demod.c:229-258``): the
    complex bandpass taps and their Q.14 integer forms in the same
    MATLAB-ish layout, then the total tap power."""
    dst = os.environ.get("TSL_DUMP_LPF")
    if not dst:
        return
    f, close = _dump_stream(dst)
    try:
        f.write(f"lpf_shifted_{offset_hz} = [\n")
        power = 0
        dpower = 0.0
        for t, qr, qi in zip(np.asarray(taps), q_re, q_im):
            f.write(f"    complex({t.real:f}, {t.imag:f}), "
                    f"%% ({int(qr)}, {int(qi)})\n")
            power += int(np.sqrt(float(int(qr) ** 2 + int(qi) ** 2)))
            dpower += abs(t)
        f.write("];\n")
        f.write(f"%% Total power: {power} ({power:016x}) ({dpower:f})\n")
    finally:
        if close:
            f.close()


def dump_phase_filters(phases) -> None:
    """Polyphase phase-filter dump, gated on
    ``TSL_DUMP_FILTER_COEFFICIENTS`` (the reference's
    ``_DUMP_FILTER_COEFFICIENTS`` block, ``filter/polyphase_fir.c:86-94``):
    one line a phase with its zero-padded integer coefficients."""
    dst = os.environ.get("TSL_DUMP_FILTER_COEFFICIENTS")
    if not dst:
        return
    f, close = _dump_stream(dst)
    try:
        for i, row in enumerate(phases):
            f.write(f"\nPhase {i:4d}: ")
            f.write(" ".join(f"{int(v):6d}" for v in row))
        f.write("\n")
    finally:
        if close:
            f.close()


def hexdump(data: bytes, width: int = 16) -> str:
    """Classic offset/hex/ASCII dump (``tsl/hexdump.h`` equivalent)."""
    data = bytes(data)
    lines = []
    for off in range(0, len(data), width):
        chunk = data[off:off + width]
        hx = " ".join(f"{b:02x}" for b in chunk).ljust(width * 3 - 1)
        asc = "".join(chr(b) if 0x20 <= b <= 0x7E else "." for b in chunk)
        lines.append(f"{off:08x}  {hx}  |{asc}|")
    return "\n".join(lines)
