"""IQ / PCM file format handling with the reference's exact widening rules.

Formats (reference ``multifm/file_if.c:35-157``):

* ``cs16`` — interleaved little-endian int16 I/Q, passed through.
* ``cs8``  — int8 I/Q widened to int16 by plain cast (NO gain shift).
* ``cu8``  — bytes cast through *signed* int8 first, then ``- 127`` — i.e. a
  0xFF byte becomes -1-127 = -128, not 255-127 = 128. That is what the C
  does (``file_if.c:140-146`` reads into an ``int8_t`` bounce buffer); we
  replicate it for parity and offer ``cu8_unbiased`` for the obvious intent.

The RTL-SDR live path widens differently: ``(s - 127) << 7``
(``multifm/rtl_sdr_if.c:147``) — exposed as :func:`rtl_u8_to_q14`. The two
8-bit ingest paths really do differ by 2^7 gain in the reference.
"""

from __future__ import annotations

import numpy as np

IQ_FORMATS = ("cs16", "cs8", "cu8", "cu8_unbiased", "rtl_u8")

# Wire-ingest view dtypes: the dtype raw wire bytes are REINTERPRETED as
# (never converted) so an 8-bit stream can ride host->device at
# 2 B/sample and widen on the chip. cs8/cu8 view through *signed* int8 —
# cu8's reference quirk (file_if.c:140-146 reads into an int8_t bounce
# buffer) then subtracts 127, so int8 + (-127) reproduces it exactly.
WIRE_DTYPES = {
    "cs16": np.int16,
    "cs8": np.int8,
    "cu8": np.int8,
    "cu8_unbiased": np.uint8,
    "rtl_u8": np.uint8,
}

# The wire byte value that widens to PCM zero — what zero-padding a
# truncated tail block must be filled with per format.
WIRE_ZERO = {"cs16": 0, "cs8": 0, "cu8": 127, "cu8_unbiased": 127,
             "rtl_u8": 127}


def unit_bytes(fmt: str) -> int:
    """Bytes per complex IQ sample (I+Q pair) in format ``fmt`` — the
    single source of truth for file-offset arithmetic (seek/resume)."""
    if fmt not in IQ_FORMATS:
        raise ValueError(f"unknown IQ format {fmt!r}; expected one of "
                         f"{IQ_FORMATS}")
    return 4 if fmt == "cs16" else 2


def rtl_u8_to_q14(raw: np.ndarray) -> np.ndarray:
    """RTL-SDR u8 -> Q.14 int16: (s - 127) << 7."""
    return ((raw.astype(np.int16) - 127) << 7).astype(np.int16)


def widen_iq_bytes(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Convert a flat byte/int16 stream to interleaved int16 samples."""
    if fmt == "cs16":
        out = raw.view(np.int16) if raw.dtype == np.uint8 else raw.astype(np.int16)
    elif fmt == "cs8":
        out = raw.view(np.int8).astype(np.int16)
    elif fmt == "cu8":
        out = raw.view(np.int8).astype(np.int16) - 127  # reference quirk
    elif fmt == "cu8_unbiased":
        out = raw.view(np.uint8).astype(np.int16) - 127
    elif fmt == "rtl_u8":
        out = rtl_u8_to_q14(raw.view(np.uint8))
    else:
        raise ValueError(f"unknown IQ format {fmt!r}; expected one of {IQ_FORMATS}")
    return out.astype(np.int16)


def read_iq_file(path, fmt: str = "cs16", max_samples: int | None = None) -> np.ndarray:
    """Read an IQ capture -> [N, 2] int16 (I, Q interleaved pairs)."""
    itemsize = 2 if fmt == "cs16" else 1
    count = -1 if max_samples is None else max_samples * 2 * itemsize
    raw = np.fromfile(path, dtype=np.uint8, count=count)
    flat = widen_iq_bytes(raw, fmt)
    flat = flat[: (flat.shape[0] // 2) * 2]
    return flat.reshape(-1, 2)


def write_iq_file(path, iq: np.ndarray) -> None:
    """Write [N, 2] int16 as interleaved cs16."""
    np.asarray(iq, dtype=np.int16).reshape(-1).tofile(path)


def read_pcm_file(path, max_samples: int | None = None) -> np.ndarray:
    """Read 16-bit mono PCM (the inter-tool transport format)."""
    return np.fromfile(
        path, dtype=np.int16, count=-1 if max_samples is None else max_samples
    )


def write_pcm_file(path, pcm: np.ndarray) -> None:
    np.asarray(pcm, dtype=np.int16).tofile(path)
