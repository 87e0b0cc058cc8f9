"""ctypes bindings for the port's native C++ runtime (``native/tslstream.cc``).

The port's copy of ``tsl_sdr_tpu/runtime/native.py:129-458``: the decoders'
sample state machines (:class:`PocsagNative`, :class:`FlexNative`,
:class:`AisNative`), the batch BCH(31,21) corrector, the bit-exact tier's
serial Q.14 rotator (:func:`rotator_seq`), the serial Costas loop
(:func:`costas_native`), and the threaded file/FIFO source and
EPIPE-tolerant sink of ``multifm-torch``'s native runtime
(:class:`NativeSource`, :class:`NativeSink`). The source is the JAX
package's, copied whole.

Beside it, ``native/pin_copy.cc``: the copy of a block into a pinned upload
slot in parts on a persistent pool of threads (:func:`pin_copy`).

The library is built with ``g++`` at first use into
``build/tsl_sdr_tpu_torch/`` beside the package, under a name keyed on a
hash of the source and the command, so a changed source rebuilds and the
package directory is never written (:func:`build_shared`, which also
builds the UHD shim and the mock radios). Processes that share a checkout (test
workers) build one at a time under an ``fcntl`` lock, each to a temporary
name that is then renamed into place. A failed build raises. The library
is loaded with ctypes' default ``RTLD_LOCAL``, so it coexists in one
process with the JAX package's copy, which exports the same symbols.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "tslstream.cc"
PIN_COPY_SRC = SRC.with_name("pin_copy.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tsl_sdr_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIB = None
_PIN_COPY = None

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_I16P = ctypes.POINTER(ctypes.c_int16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32 = ctypes.c_float
_F32P = ctypes.POINTER(ctypes.c_float)
# name -> (restype, argtypes)
SIGNATURES = {
    "tsl_bch3121_decode": (None, [_U32P, ctypes.c_long, _U32P, _U8P]),
    "tsl_flex_new": (_P, []),
    "tsl_flex_free": (None, [_P]),
    "tsl_flex_in_search": (ctypes.c_int, [_P]),
    "tsl_flex_sync_reset_only": (None, [_P]),
    "tsl_flex_verdict": (None, [_P, ctypes.c_int]),
    "tsl_flex_on_pcm": (ctypes.c_long,
                        [_P, _I16P, _SZ, _U8P, _SZ, ctypes.POINTER(_SZ)]),
    "tsl_pocsag_new": (_P, []),
    "tsl_pocsag_free": (None, [_P]),
    "tsl_pocsag_state": (ctypes.c_int, [_P]),
    "tsl_pocsag_detect_reset": (None, [_P]),
    "tsl_pocsag_on_pcm": (ctypes.c_long, [_P, _I16P, _SZ, _U8P, _SZ]),
    "tsl_ais_new": (_P, []),
    "tsl_ais_free": (None, [_P]),
    "tsl_ais_detect_reset": (None, [_P]),
    "tsl_ais_crc_rejects": (ctypes.c_uint64, [_P]),
    "tsl_ais_state": (ctypes.c_int, [_P]),
    "tsl_ais_on_pcm": (ctypes.c_long, [_P, _I16P, _SZ, _U8P, _SZ]),
    "tsl_rotator_seq": (None, [_I16P, _I32P, _SZ, _SZ, _I16P]),
    "tsl_costas": (None, [_I16P, _SZ, _F32, _F32, _F32, _F32, _F32, _F32P,
                          _I16P]),
    "tsl_source_new": (_P, [ctypes.c_char_p, ctypes.c_int, _SZ, _SZ,
                            ctypes.c_double, ctypes.c_int]),
    "tsl_source_start": (ctypes.c_int, [_P]),
    "tsl_source_read": (ctypes.c_long, [_P, _I16P, _SZ]),
    "tsl_source_stats": (None, [_P, _U64P]),
    "tsl_source_free": (None, [_P]),
    "tsl_sink_new": (_P, [ctypes.c_char_p]),
    "tsl_sink_write": (ctypes.c_long, [_P, _I16P, _SZ]),
    "tsl_sink_stats": (None, [_P, _U64P]),
    "tsl_sink_free": (None, [_P]),
}
# wire formats of the native source (its ingest widening)
FORMATS = {"cs16": 0, "cs8": 1, "cu8": 2, "rtl_u8": 3}


def _keyed_path(src: Path, stem: str, command) -> Path:
    h = hashlib.sha256(" ".join(command).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def lib_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _keyed_path(SRC, "tslstream", ["g++", *CXX_FLAGS])


def build_shared(src: Path, stem: str, compiler: str, flags,
                 libs=()) -> Path:
    """Build C/C++ ``src`` into a shared library in ``BUILD_DIR`` (named
    ``lib<stem>-<hash of source and command>.so``) unless it is there, and
    return its path. A missing compiler or a failed build raises
    RuntimeError."""
    path = _keyed_path(src, stem, [compiler, *flags, *libs])
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.so")
        try:
            try:
                res = subprocess.run(
                    [compiler, *flags, str(src), "-o", str(tmp), *libs],
                    capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"building {src.name} needs {compiler}, "
                                   "which is not installed") from e
            if res.returncode != 0:
                raise RuntimeError(f"building {src.name} failed "
                                   f"({res.returncode}):\n{res.stderr}")
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path


def load() -> ctypes.CDLL:
    """Build (if missing) and load the native library; raise if it cannot
    be built."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_shared(SRC, "tslstream", "g++",
                                           CXX_FLAGS)))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def _pin_copy_lib() -> ctypes.CDLL:
    """Build (if missing) and load ``pin_copy.cc``; raise if it cannot be
    built."""
    global _PIN_COPY
    with _LOCK:
        if _PIN_COPY is None:
            lib = ctypes.CDLL(str(build_shared(PIN_COPY_SRC, "pin_copy",
                                               "g++", CXX_FLAGS)))
            lib.tsl_pin_copy.restype = ctypes.c_int
            lib.tsl_pin_copy.argtypes = [_P, _P, _SZ, ctypes.c_int]
            lib.tsl_pin_copy_threads.restype = ctypes.c_int
            lib.tsl_pin_copy_threads.argtypes = []
            _PIN_COPY = lib
        return _PIN_COPY


def pin_copy(dst: np.ndarray, src: np.ndarray, parts: int) -> None:
    """Copy ``src`` into ``dst`` (1-D, one length and dtype, contiguous,
    apart) as ``parts`` contiguous byte ranges: the calling thread copies
    the first, the process's pool of threads the others, started at the
    first copy that needs them and kept. The interpreter lock is released
    for the copy. Raises ValueError for arrays it cannot copy, OSError when
    a pool thread cannot start."""
    if not (dst.ndim == 1 and dst.shape == src.shape
            and dst.dtype == src.dtype and dst.flags.c_contiguous
            and src.flags.c_contiguous and dst.flags.writeable):
        raise ValueError(f"copy of {src.dtype}{src.shape} into "
                         f"{dst.dtype}{dst.shape}: two contiguous 1-D "
                         "arrays of one length and dtype")
    if np.may_share_memory(dst, src):
        raise ValueError("copy between overlapping arrays")
    err = _pin_copy_lib().tsl_pin_copy(dst.ctypes.data, src.ctypes.data,
                                       src.nbytes, parts)
    if err:
        raise OSError(err, f"copy in {parts} parts: {os.strerror(err)}")


def pin_copy_threads() -> int:
    """The threads of the pool :func:`pin_copy` keeps (0 until a copy of
    more than one part)."""
    return _PIN_COPY.tsl_pin_copy_threads() if _PIN_COPY is not None else 0


def bch3121_decode_native(words: np.ndarray):
    """Batch BCH(31,21,t=2) decode via the native corrector: the contract
    of ``models.bch.BchCode.decode`` on the POCSAG/FLEX instance."""
    lib = load()
    words = np.ascontiguousarray(words, np.uint32)
    out = np.empty_like(words)
    fail = np.empty(words.size, np.uint8)
    lib.tsl_bch3121_decode(words.ctypes.data_as(_U32P), words.size,
                           out.ctypes.data_as(_U32P),
                           fail.ctypes.data_as(_U8P))
    return out, fail.astype(bool)


class _Handle:
    """One native FSM instance, freed with its Python owner."""

    _free = ""

    def __del__(self):
        try:
            if self._h:
                getattr(self._lib, self._free)(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class FlexNative(_Handle):
    """The native FLEX sample FSM (``tslstream.cc`` ``tsl_flex_*``).

    Pauses at each FIW for the caller's BCH verdict (the FLEX FSM's
    transitions depend on BCH there, unlike POCSAG); frame events carry
    each phase's 88 words for vectorized BCH + message assembly."""

    _free = "tsl_flex_free"

    def __init__(self):
        self._lib = load()
        self._h = self._lib.tsl_flex_new()

    def on_pcm(self, pcm: np.ndarray):
        """Returns (events, consumed). Events: ('fiw', coding_idx, range,
        delta, fiw_raw) — processing paused, call verdict() — or
        ('frame', coding_idx, [(phase_id, words[88])...])."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        cap = pcm.size // 8 + 8192
        out = np.empty(cap, np.uint8)
        consumed = _SZ(0)
        ret = self._lib.tsl_flex_on_pcm(
            self._h, pcm.ctypes.data_as(_I16P), pcm.size,
            out.ctypes.data_as(_U8P), cap, ctypes.byref(consumed))
        if ret < 0:
            raise RuntimeError("tsl_flex_on_pcm output buffer overflow")
        events = []
        buf = bytes(out[:ret])
        o = 0
        while o < ret:
            tag = buf[o]
            o += 1
            if tag == ord("F"):
                idx = buf[o]
                rng = int.from_bytes(buf[o + 1:o + 5], "little", signed=True)
                delta = int.from_bytes(buf[o + 5:o + 9], "little", signed=True)
                fiw = int.from_bytes(buf[o + 9:o + 13], "little")
                events.append(("fiw", idx, rng, delta, fiw))
                o += 13
            else:
                idx = buf[o]
                o += 1
                phases = []
                for _ in range((1, 2, 2, 4)[idx]):
                    pid = buf[o]
                    words = np.frombuffer(buf, np.uint32, 88, o + 1)
                    phases.append((pid, words))
                    o += 1 + 88 * 4
                events.append(("frame", idx, phases))
        return events, int(consumed.value)

    def verdict(self, ok: bool):
        self._lib.tsl_flex_verdict(self._h, 1 if ok else 0)

    def sync_reset_only(self):
        self._lib.tsl_flex_sync_reset_only(self._h)

    @property
    def in_search(self) -> bool:
        """SYNC_1 hunt with zero progress (see tsl_flex_in_search)."""
        return bool(self._lib.tsl_flex_in_search(self._h))


class PocsagNative(_Handle):
    """The native POCSAG sample FSM (``tslstream.cc`` ``tsl_pocsag_*``).

    Emits ('batch', baud, words[16]) and ('sync_lost',) events; BCH and
    message assembly stay on the Python side (the FSM's transitions never
    depend on BCH, pager_pocsag.c:451-540)."""

    _free = "tsl_pocsag_free"

    def __init__(self):
        self._lib = load()
        self._h = self._lib.tsl_pocsag_new()

    def on_pcm(self, pcm: np.ndarray) -> list[tuple]:
        pcm = np.ascontiguousarray(pcm, np.int16)
        # one batch per 512*spb(>=16) samples max, 67 bytes per event
        cap = pcm.size // 64 + 4096
        out = np.empty(cap, np.uint8)
        ret = self._lib.tsl_pocsag_on_pcm(
            self._h, pcm.ctypes.data_as(_I16P), pcm.size,
            out.ctypes.data_as(_U8P), cap)
        if ret < 0:
            raise RuntimeError("tsl_pocsag_on_pcm output buffer overflow")
        events = []
        buf = bytes(out[:ret])
        o = 0
        while o < ret:
            tag = buf[o]
            o += 1
            if tag == ord("B"):
                baud = int.from_bytes(buf[o:o + 2], "little")
                words = np.frombuffer(buf, np.uint32, 16, o + 2)
                events.append(("batch", baud, words))
                o += 2 + 64
            else:
                events.append(("sync_lost",))
        return events

    def detect_reset(self):
        self._lib.tsl_pocsag_detect_reset(self._h)

    @property
    def in_search(self) -> bool:
        return self._lib.tsl_pocsag_state(self._h) == 0


class AisNative(_Handle):
    """The native AIS demod FSM (``tslstream.cc`` ``tsl_ais_*``)."""

    _free = "tsl_ais_free"

    def __init__(self):
        self._lib = load()
        self._h = self._lib.tsl_ais_new()

    def on_pcm(self, pcm: np.ndarray) -> list[bytes]:
        pcm = np.ascontiguousarray(pcm, np.int16)
        cap = pcm.size // 8 + 4096  # dense-traffic worst case, with margin
        out = np.empty(cap, np.uint8)
        ret = self._lib.tsl_ais_on_pcm(
            self._h, pcm.ctypes.data_as(_I16P), pcm.size,
            out.ctypes.data_as(_U8P), cap)
        if ret < 0:
            raise RuntimeError("tsl_ais_on_pcm output buffer overflow")
        pkts = []
        o = 0
        buf = bytes(out[:ret])
        while o < ret:
            ln = int.from_bytes(buf[o:o + 4], "little")
            pkts.append(buf[o + 4:o + 4 + ln])
            o += 4 + ln
        return pkts

    def detect_reset(self):
        self._lib.tsl_ais_detect_reset(self._h)

    @property
    def in_search(self) -> bool:
        return self._lib.tsl_ais_state(self._h) == 0

    @property
    def crc_rejects(self) -> int:
        return int(self._lib.tsl_ais_crc_rejects(self._h))


def rotator_seq(rot: np.ndarray, incr: np.ndarray, n: int) -> np.ndarray:
    """The bit-exact tier's Q.14 derotator sequence.

    rot: [C, 2] int16 current rotator, UPDATED IN PLACE to the state after
    ``n`` outputs; incr: [C, 2] int32 Q.14 increment. Returns [n, C, 2]
    int16, the rotator BEFORE each output: the reference's use-then-advance
    recurrence with round-half-up and no renormalisation
    (``filter/direct_fir.c:152-172``), serial, so it runs here on the host.
    """
    lib = load()
    if rot.dtype != np.int16 or not rot.flags.c_contiguous:
        raise ValueError("rot must be a C-contiguous int16 array (it is "
                         "updated in place)")
    incr = np.ascontiguousarray(incr, np.int32)
    c = rot.shape[0]
    out = np.empty((n, c, 2), dtype=np.int16)
    lib.tsl_rotator_seq(rot.ctypes.data_as(_I16P), incr.ctypes.data_as(_I32P),
                        c, n, out.ctypes.data_as(_I16P))
    return out


def costas_native(x: np.ndarray, params, state=None):
    """The reference's serial Costas loop, one sample at a time in C
    (``multifm/costas_demod.c:56-115``; semantics in
    :mod:`tsl_sdr_tpu_torch.ops.costas`).

    x: [N, 2] int16 IQ; params: ``CostasParams``; state: optional (phase,
    f_dev) floats. Returns (out [N, 2] int16, (phase, f_dev)).
    """
    lib = load()
    x = np.ascontiguousarray(x, np.int16)
    if x.ndim != 2 or x.shape[1] != 2:
        raise ValueError(f"x: expected [N, 2] int16, got {list(x.shape)}")
    out = np.empty_like(x)
    st = np.asarray(
        [0.0, params.f_dev_nominal] if state is None else list(state),
        dtype=np.float32)
    lib.tsl_costas(x.ctypes.data_as(_I16P), x.shape[0], params.alpha,
                   params.beta, params.e_max, params.f_dev_min,
                   params.f_dev_max, st.ctypes.data_as(_F32P),
                   out.ctypes.data_as(_I16P))
    return out, (float(st[0]), float(st[1]))


class NativeSource:
    """Background-threaded IQ source over a file or FIFO: a C++ reader
    thread fills a pool of frames while the caller computes (the
    reference's receiver thread, ``multifm/receiver.c:78-98``).

    ``fmt`` selects the ingest widening (cs16/cs8/cu8/rtl_u8), ``pace_sps``
    (complex samples/s) paces delivery like ``file_if.c``, and
    ``drop_on_full`` drops and counts frames when the pool is full instead
    of holding the reader back."""

    def __init__(self, path, fmt="cs16", frame_samples=65536, pool_frames=64,
                 pace_sps=0.0, drop_on_full=False):
        self._lib = load()
        self._h = self._lib.tsl_source_new(
            str(path).encode(), FORMATS[fmt], 2 * frame_samples, pool_frames,
            2.0 * pace_sps, 1 if drop_on_full else 0)
        if not self._h:
            raise OSError(f"cannot open source {path}")
        self._lib.tsl_source_start(self._h)

    def read(self, n_samples: int) -> np.ndarray:
        """Blocking read of up to ``n_samples``; a short result means EOF.
        Returns flat interleaved int16 values [2 * got]."""
        out = np.empty(2 * n_samples, dtype=np.int16)
        got = self._lib.tsl_source_read(self._h, out.ctypes.data_as(_I16P),
                                        out.size)
        return out[: got - (got % 2)]

    @property
    def stats(self) -> dict:
        if not self._h:
            raise ValueError("source is closed")
        buf = (ctypes.c_uint64 * 4)()
        self._lib.tsl_source_stats(self._h, buf)
        return {"values_in": buf[0], "values_out": buf[1],
                "dropped_frames": buf[2], "eof": bool(buf[3])}

    def close(self):
        if self._h:
            self._lib.tsl_source_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeSink:
    """PCM sink that drops and counts on EPIPE, like the reference's demod
    thread (``multifm/demod.c:93-110``)."""

    def __init__(self, path):
        self._lib = load()
        self._h = self._lib.tsl_sink_new(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open sink {path}")

    def write(self, pcm: np.ndarray) -> int:
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        return self._lib.tsl_sink_write(self._h, pcm.ctypes.data_as(_I16P),
                                        pcm.size)

    @property
    def stats(self) -> dict:
        if not self._h:
            raise ValueError("sink is closed")
        buf = (ctypes.c_uint64 * 4)()
        self._lib.tsl_sink_stats(self._h, buf)
        return {"values_out": buf[1], "dropped_writes": buf[2],
                "broken": bool(buf[3])}

    def close(self):
        if self._h:
            self._lib.tsl_sink_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
