"""Hardware source drivers: ctypes ingest loops feeding a bounded pool.

The port's copy of ``tsl_sdr_tpu/sources/hw.py``, with
:func:`make_hw_source` and :func:`pairs` from ``tsl_sdr_tpu/cli/multifm.py``
(``:102-112, 127-152``) so that every CLI of the port can share them.

Real device I/O for the three radio families the reference supports, as
dlopen-gated ctypes bindings (VERDICT r1 item 2):

* RTL-SDR  — librtlsdr async callback ingest with u8 -> Q.14 widening
  ``(s - 127) << 7``, gain-table select / E4000 IF ladder / ppm / test-mode
  setup in the reference's order (``multifm/rtl_sdr_if.c:88-479``)
* Airspy   — CS16 block callback copied straight through
  (``multifm/airspy_if.c:45-112``; bound against the public libairspy ABI
  rather than the author's private libdespairspy fork)
* USRP/UHD — C-API streamer recv loop accumulating 16 Ki-sample sc16
  buffers (``multifm/uhd_if.c:21-95``)

All three deliver into :class:`HwIngestQueue`, the reference receiver's
frame-pool contract: a bounded queue that DROPS the incoming buffer (with a
counter) when the consumer falls behind (``multifm/receiver.c:45-76``), and
a mute gate that discards deliveries while set (``receiver.h:98``).

Library locations honor env overrides (``TSL_RTLSDR_LIB``,
``TSL_AIRSPY_LIB``, ``TSL_UHD_LIB``) so the mock libraries of
:mod:`tsl_sdr_tpu_torch.testing.mock_radios` can stand in for hardware;
without an override the standard soname is dlopened and a missing library
raises :class:`HwLibraryMissing` with the stream-a-capture hint.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import queue
import threading
import time
from pathlib import Path

import numpy as np

from tsl_sdr_tpu_torch.sources.airspy import AirspyConfig
from tsl_sdr_tpu_torch.sources.rtl_sdr import (RtlSdrConfig,
                                               e4000_if_gain_plan,
                                               select_tuner_gain)
from tsl_sdr_tpu_torch.sources.uhd import UhdConfig

RTLSDR_TUNER_E4000 = 1


class HwLibraryMissing(RuntimeError):
    pass


def _dlopen(env_var: str, soname: str, what: str) -> ctypes.CDLL:
    path = os.environ.get(env_var)
    if path is None:
        path = ctypes.util.find_library(soname)
    if path is None:
        raise HwLibraryMissing(
            f"{what} requires lib{soname} and attached hardware; on this "
            f"host stream a capture instead (device type 'file' or "
            f"--iq-file), or point {env_var} at a library"
        )
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise HwLibraryMissing(f"failed to load {path}: {e}") from e


class HwIngestQueue:
    """Bounded delivery queue with the reference receiver's semantics:
    drop-and-count on overflow, discard while muted, EOF sentinel."""

    _EOF = object()

    def __init__(self, depth: int = 128):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self.muted = True
        self.dropped = 0
        self.delivered = 0

    def deliver(self, block: np.ndarray):
        if self.muted:
            return
        try:
            self._q.put_nowait(block)
            self.delivered += 1
        except queue.Full:
            self.dropped += 1

    def eof(self):
        # never blocks (the queue may be full with no consumer yet); the
        # sentinel is best-effort, the event is the durable signal
        self._closed.set()
        try:
            self._q.put_nowait(self._EOF)
        except queue.Full:
            pass

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is self._EOF:
                return
            yield item


class _HwSourceBase:
    """Common surface: iterate int16 IQ blocks (flat interleaved values)."""

    def __init__(self, depth: int):
        self.ingest = HwIngestQueue(depth)
        self._thread: threading.Thread | None = None

    def set_mute(self, muted: bool):
        self.ingest.muted = muted

    @property
    def stats(self) -> dict:
        return {
            "delivered": self.ingest.delivered,
            "dropped": self.ingest.dropped,
        }

    def blocks(self):
        """Iterate delivered int16 blocks until the stream ends."""
        return iter(self.ingest)


class RtlSdrSource(_HwSourceBase):
    """librtlsdr ingest (multifm/rtl_sdr_if.c:308-479 setup, :88-177 loop)."""

    def __init__(self, cfg: RtlSdrConfig, *, depth: int = 128,
                 buf_bytes: int = 0):
        super().__init__(depth)
        self.cfg = cfg
        lib = self._lib = _dlopen("TSL_RTLSDR_LIB", "rtlsdr",
                                  "rtlsdr hardware source")
        lib.rtlsdr_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.c_uint32]
        lib.rtlsdr_close.argtypes = [ctypes.c_void_p]
        lib.rtlsdr_get_tuner_type.argtypes = [ctypes.c_void_p]
        lib.rtlsdr_set_sample_rate.argtypes = [ctypes.c_void_p,
                                               ctypes.c_uint32]
        lib.rtlsdr_set_center_freq.argtypes = [ctypes.c_void_p,
                                               ctypes.c_uint32]
        lib.rtlsdr_set_tuner_gain_mode.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int]
        lib.rtlsdr_get_tuner_gains.argtypes = [ctypes.c_void_p,
                                               ctypes.POINTER(ctypes.c_int)]
        lib.rtlsdr_set_tuner_gain.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rtlsdr_get_tuner_gain.argtypes = [ctypes.c_void_p]
        lib.rtlsdr_set_tuner_if_gain.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_int]
        lib.rtlsdr_set_freq_correction.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int]
        lib.rtlsdr_set_testmode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rtlsdr_reset_buffer.argtypes = [ctypes.c_void_p]
        self._cb_t = ctypes.CFUNCTYPE(
            None, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.c_void_p)
        lib.rtlsdr_read_async.argtypes = [
            ctypes.c_void_p, self._cb_t, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32]
        lib.rtlsdr_cancel_async.argtypes = [ctypes.c_void_p]

        self._dev = ctypes.c_void_p()
        self._buf_bytes = buf_bytes  # 0 = librtlsdr default
        self._dump = (open(cfg.iq_dump_file, "wb")
                      if cfg.iq_dump_file else None)
        self._keepalive_cb = None

    def open(self, sample_rate: int, center_freq: int):
        lib, cfg = self._lib, self.cfg
        if lib.rtlsdr_open(ctypes.byref(self._dev), cfg.device_index) != 0:
            raise RuntimeError(
                f"rtlsdr_open({cfg.device_index}) failed (no device?)")
        tuner = lib.rtlsdr_get_tuner_type(self._dev)
        if lib.rtlsdr_set_sample_rate(self._dev, int(sample_rate)) != 0:
            raise RuntimeError("rtlsdr_set_sample_rate failed")
        if lib.rtlsdr_set_center_freq(self._dev, int(center_freq)) != 0:
            raise RuntimeError("rtlsdr_set_center_freq failed")
        if cfg.gain_tenths is not None:
            # disable AGC, then pick from the device's supported-gain table
            if lib.rtlsdr_set_tuner_gain_mode(self._dev, 1) != 0:
                raise RuntimeError("rtlsdr_set_tuner_gain_mode failed")
            count = lib.rtlsdr_get_tuner_gains(self._dev, None)
            table = (ctypes.c_int * max(count, 1))()
            lib.rtlsdr_get_tuner_gains(self._dev, table)
            gain = select_tuner_gain(cfg.gain_tenths, list(table[:count]))
            if lib.rtlsdr_set_tuner_gain(self._dev, gain) != 0:
                raise RuntimeError("rtlsdr_set_tuner_gain failed")
        else:
            lib.rtlsdr_set_tuner_gain_mode(self._dev, 0)
        if cfg.db_gain_if is not None and tuner == RTLSDR_TUNER_E4000:
            stages, _total = e4000_if_gain_plan(int(cfg.db_gain_if * 10))
            for stage, tenths in enumerate(stages, start=1):
                lib.rtlsdr_set_tuner_if_gain(self._dev, stage, tenths)
        if cfg.ppm_correction:  # 0 ppm is skipped, like the reference
            lib.rtlsdr_set_freq_correction(self._dev, cfg.ppm_correction)
        if cfg.test_mode:
            if lib.rtlsdr_set_testmode(self._dev, 1) != 0:
                raise RuntimeError("rtlsdr_set_testmode failed")
        if lib.rtlsdr_reset_buffer(self._dev) != 0:
            raise RuntimeError("rtlsdr_reset_buffer failed")
        return self

    def _on_block(self, buf, length, _ctx):
        if self._dump is not None:
            self._dump.write(ctypes.string_at(buf, length))
        raw = np.ctypeslib.as_array(buf, shape=(length,))
        # u8 -> Q.14: (s - 127) << 7 (rtl_sdr_if.c:147)
        vals = ((raw.astype(np.int16) - 127) << 7).astype(np.int16)
        self.ingest.deliver(vals)

    def start(self):
        """Hand a reader thread over to rtlsdr_read_async."""
        self._keepalive_cb = self._cb_t(
            lambda b, n, c: self._on_block(b, n, c))

        def run():
            self._lib.rtlsdr_read_async(
                self._dev, self._keepalive_cb, None, 0, self._buf_bytes)
            self.ingest.eof()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._dev:
            self._lib.rtlsdr_cancel_async(self._dev)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._dev:
            self._lib.rtlsdr_close(self._dev)
            self._dev = ctypes.c_void_p()
        if self._dump is not None:
            self._dump.close()
            self._dump = None


class _AirspyTransfer(ctypes.Structure):
    # public libairspy airspy_transfer layout
    _fields_ = [
        ("device", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
        ("samples", ctypes.c_void_p),
        ("sample_count", ctypes.c_int),
        ("dropped_samples", ctypes.c_uint64),
        ("sample_type", ctypes.c_int),
    ]


AIRSPY_SAMPLE_INT16_IQ = 2


class AirspySource(_HwSourceBase):
    """libairspy ingest (multifm/airspy_if.c:45-112 + gain setup :151-270).

    The reference links the author's private libdespairspy fork
    (init_rx/do_rx/term_rx); this driver binds the equivalent PUBLIC
    libairspy surface (start_rx/stop_rx) with INT16_IQ sample delivery —
    the same CS16 blocks memcpy'd through.
    """

    def __init__(self, cfg: AirspyConfig, *, depth: int = 128):
        super().__init__(depth)
        self.cfg = cfg
        lib = self._lib = _dlopen("TSL_AIRSPY_LIB", "airspy",
                                  "airspy hardware source")
        for name in ("airspy_open", "airspy_close", "airspy_set_samplerate",
                     "airspy_set_freq", "airspy_set_lna_gain",
                     "airspy_set_vga_gain", "airspy_set_mixer_gain",
                     "airspy_set_rf_bias", "airspy_set_sample_type",
                     "airspy_is_streaming", "airspy_stop_rx"):
            getattr(lib, name)  # resolve early for a clear error
        self._cb_t = ctypes.CFUNCTYPE(ctypes.c_int,
                                      ctypes.POINTER(_AirspyTransfer))
        lib.airspy_open.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.airspy_start_rx.argtypes = [ctypes.c_void_p, self._cb_t,
                                        ctypes.c_void_p]
        self._dev = ctypes.c_void_p()
        self._keepalive_cb = None

    def open(self, sample_rate: int, center_freq: int):
        lib, cfg = self._lib, self.cfg
        if lib.airspy_open(ctypes.byref(self._dev)) != 0:
            raise RuntimeError("airspy_open failed (no device?)")
        if lib.airspy_set_samplerate(self._dev, int(sample_rate)) != 0:
            raise RuntimeError("airspy_set_samplerate failed")
        if lib.airspy_set_freq(self._dev, int(center_freq)) != 0:
            raise RuntimeError("airspy_set_freq failed")
        for fn, val in (("airspy_set_lna_gain", cfg.lna_gain),
                        ("airspy_set_vga_gain", cfg.vga_gain),
                        ("airspy_set_mixer_gain", cfg.mixer_gain)):
            if getattr(lib, fn)(self._dev, int(val)) != 0:
                raise RuntimeError(f"{fn} failed")
        if lib.airspy_set_rf_bias(self._dev, 1 if cfg.bias_tee else 0) != 0:
            raise RuntimeError("airspy_set_rf_bias failed")
        lib.airspy_set_sample_type(self._dev, AIRSPY_SAMPLE_INT16_IQ)
        return self

    def _on_transfer(self, transfer_p):
        t = transfer_p.contents
        n_vals = 2 * t.sample_count
        src = ctypes.cast(t.samples, ctypes.POINTER(ctypes.c_int16))
        vals = np.ctypeslib.as_array(src, shape=(n_vals,)).copy()
        self.ingest.deliver(vals)
        return 0

    def start(self):
        self._keepalive_cb = self._cb_t(
            lambda tp: self._on_transfer(tp))
        if self._lib.airspy_start_rx(self._dev, self._keepalive_cb,
                                     None) != 0:
            raise RuntimeError("airspy_start_rx failed")

        def monitor():
            # libairspy delivers on its own USB thread; EOF when it stops
            while self._dev and self._lib.airspy_is_streaming(self._dev):
                time.sleep(0.05)
            self.ingest.eof()

        self._thread = threading.Thread(target=monitor, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        # stop_rx -> join the monitor -> close: the monitor polls
        # airspy_is_streaming, so the handle must outlive it
        if self._dev:
            self._lib.airspy_stop_rx(self._dev)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._dev:
            self._lib.airspy_close(self._dev)
            self._dev = ctypes.c_void_p()
        self.ingest.eof()


class UhdSource(_HwSourceBase):
    """UHD streamer ingest (multifm/uhd_if.c:21-95 recv loop, :133-306
    tune/gain plumbing), via a small C shim ABI.

    UHD's C API traffics in opaque handles plus several by-value structs
    (tune_request, stream_args, stream_cmd) whose layouts drag in libuhd
    headers; rather than replicating them field-for-field in ctypes (one
    ABI drift away from corruption), the binding targets the flat shim ABI
    ``tsl_uhd_*`` — implemented over real libuhd when built against it, and
    by the mock library in tests. The shim carries exactly the reference's
    usage: make(args) -> set rate -> tune -> named gains -> antenna ->
    streamer -> issue STREAM_MODE_START_CONTINUOUS -> recv loop.
    """

    MAX_BUF_SAMPS = 16384  # uhd_if.c:18

    @staticmethod
    def _shim_lib() -> ctypes.CDLL:
        """Locate or build the tsl_uhd_* shim: env override (mocks) first,
        then a gcc build of ``native/tsl_uhd_shim.c`` against the REAL
        libuhd, when it is installed, into ``build/tsl_sdr_tpu_torch/``."""
        from tsl_sdr_tpu_torch.runtime import native

        path = os.environ.get("TSL_UHD_LIB")
        if path is not None:
            try:
                return ctypes.CDLL(path)
            except OSError as e:
                raise HwLibraryMissing(f"failed to load {path}: {e}") from e
        src = Path(__file__).resolve().parents[1] / "native" / "tsl_uhd_shim.c"
        try:
            so = native.build_shared(src, "tsl_uhd_shim", "gcc",
                                     ["-O2", "-shared", "-fPIC"], ["-luhd"])
        except RuntimeError as e:
            raise HwLibraryMissing(
                "usrp hardware source requires libuhd (+ headers) and an "
                "attached radio; on this host stream a capture instead "
                "(device type 'file' or --iq-file), or point TSL_UHD_LIB "
                f"at a shim library. Shim build said: {str(e)[-200:]}"
            ) from e
        return ctypes.CDLL(str(so))

    def __init__(self, cfg: UhdConfig, *, depth: int = 128):
        super().__init__(depth)
        self.cfg = cfg
        lib = self._lib = self._shim_lib()
        lib.tsl_uhd_make.restype = ctypes.c_void_p
        lib.tsl_uhd_make.argtypes = [ctypes.c_char_p]
        lib.tsl_uhd_set_rate.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_double]
        lib.tsl_uhd_tune.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_double]
        lib.tsl_uhd_set_gain.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_char_p, ctypes.c_double]
        lib.tsl_uhd_set_antenna.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_char_p]
        lib.tsl_uhd_start.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.tsl_uhd_recv.restype = ctypes.c_long
        lib.tsl_uhd_recv.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int16),
                                     ctypes.c_size_t]
        lib.tsl_uhd_free.argtypes = [ctypes.c_void_p]
        self._dev = None
        self._stop = threading.Event()

    def open(self, sample_rate: int, center_freq: int):
        lib, cfg = self._lib, self.cfg
        self._dev = lib.tsl_uhd_make(cfg.device_id.encode())
        if not self._dev:
            raise RuntimeError(f"uhd make failed for {cfg.device_id!r}")
        ch = cfg.channel
        lib.tsl_uhd_set_rate(self._dev, ch, float(sample_rate))
        lib.tsl_uhd_tune(self._dev, ch, float(center_freq))
        for g in cfg.gains:
            lib.tsl_uhd_set_gain(self._dev, ch, g.name.encode(),
                                 float(g.db_value))
        lib.tsl_uhd_set_antenna(self._dev, ch, cfg.antenna.encode())
        return self

    def start(self):
        self._lib.tsl_uhd_start(self._dev, self.cfg.channel)

        def run():
            # accumulate into MAX_BUF_SAMPS sc16 buffers like the
            # reference's recv loop (uhd_if.c:47-88)
            while not self._stop.is_set():
                buf = np.empty(2 * self.MAX_BUF_SAMPS, np.int16)
                filled = 0
                while filled < self.MAX_BUF_SAMPS:
                    got = self._lib.tsl_uhd_recv(
                        self._dev,
                        buf[2 * filled:].ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int16)),
                        self.MAX_BUF_SAMPS - filled)
                    if got <= 0:
                        if filled:
                            self.ingest.deliver(buf[: 2 * filled])
                        self.ingest.eof()
                        return
                    filled += got
                self.ingest.deliver(buf)
            self.ingest.eof()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._dev:
            self._lib.tsl_uhd_free(self._dev)
            self._dev = None


def make_hw_source(cfg, dev_type: str):
    """Construct (not yet started) the dlopen-gated hardware ingest source
    for ``dev_type`` (rtlsdr/airspy/usrp) of a
    :class:`~tsl_sdr_tpu_torch.utils.config.MultifmConfig`, or None for
    other types. Raises :class:`HwLibraryMissing` when the driver library
    is absent."""
    depth = max(2, cfg.nr_samp_bufs)
    if dev_type == "rtlsdr":
        rtl = RtlSdrConfig.from_dict(
            cfg.device.params, {"sdrTestMode": cfg.raw.get("sdrTestMode")})
        return RtlSdrSource(rtl, depth=depth)
    if dev_type == "airspy":
        return AirspySource(AirspyConfig.from_dict(cfg.device.params),
                            depth=depth)
    if dev_type == "usrp":
        return UhdSource(UhdConfig.from_dict(cfg.device.params), depth=depth)
    return None


def pairs(block_iter):
    """[N, 2] int16 IQ blocks from flat int16 hardware blocks, carrying an
    odd trailing value into the next block: dropping it would swap I and Q
    for the rest of the run."""
    residue = np.zeros((0,), np.int16)
    for b in block_iter:
        flat = np.concatenate([residue, np.asarray(b, np.int16).reshape(-1)])
        usable = flat.size // 2 * 2
        residue = flat[usable:]
        if usable:
            yield flat[:usable].reshape(-1, 2)
