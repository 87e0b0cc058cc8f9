"""multifm-torch: N-channel NBFM channelizer (reference ``multifm/multifm.c``).

Port of ``multifm-tpu`` (``tsl_sdr_tpu/cli/multifm.py``). Usage:
``multifm-torch config.json [more-config.json ...]`` — configs deep-merge
left to right like the reference (``multifm.c:105-111``) and use the same
vocabulary (device/sampleRateHz/centerFreqHz/decimationFactor/lpfTaps/
channels). The ``file`` device streams an IQ capture through the
channelizer and writes each channel's 16-bit PCM to its ``outFifo`` path
(FIFO or regular file); ``--iq-file`` streams a capture in place of a
radio device's input; an ``rtlsdr``, ``airspy`` or ``usrp`` device without
it is opened through its driver library, and the run exits with code 2
when none is installed.

``--exact`` runs the bit-exact tier (the reference's PCM byte for byte),
the default the production tier; both on the card (``--device cuda``,
the default, which fails without CUDA) or, for tests, ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from collections import deque

import numpy as np

PROG = "multifm-torch"
# blocks of the bit-exact tier kept in flight by both I/O runtimes
EXACT_INFLIGHT_DEPTH = 2


class _ExactPipeliner:
    """Begin/end pipelining of the bit-exact tier for the block loops of
    both runtimes: up to ``depth`` blocks stay dispatched (their PCM's
    device->host copies overlap the following blocks' compute) and finish
    in dispatch order."""

    def __init__(self, chain, emit, depth: int = EXACT_INFLIGHT_DEPTH):
        self._chain = chain
        self._emit = emit
        self._depth = depth
        self._infl: deque = deque()

    def feed(self, state, blk):
        """Dispatch one block; emit the oldest once over depth. Returns the
        advanced chain state."""
        state, pend = self._chain.step_exact_packed_begin(state, blk)
        self._infl.append(pend)
        if len(self._infl) > self._depth:
            self._end_one()
        return state

    def _end_one(self):
        self._emit(self._chain.step_exact_packed_end(self._infl.popleft()))

    def drain(self):
        """Finish every dispatched block (EOF or Ctrl-C)."""
        while self._infl:
            self._end_one()


def build_argparser():
    from tsl_sdr_tpu_torch.cli import cli_version

    p = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("configs", nargs="+", help="JSON config file(s), merged")
    p.add_argument("--exact", action="store_true", default=False,
                   help="bit-exact integer tier (default: production tier)")
    p.add_argument("--iq-file", default=None,
                   help="stream this IQ capture instead of the hardware")
    p.add_argument("--iq-format", default=None,
                   choices=["cs16", "cs8", "cu8", "rtl_u8"],
                   help="sample format of --iq-file")
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--realtime", action="store_true",
                   help="pace file playback at sampleRateHz "
                        "(file_if.c:160-203)")
    p.add_argument("--runtime", default="native",
                   choices=["native", "python"],
                   help="I/O runtime: native C++ reader/writer threads "
                        "(frame pool + drop counters) or Python loops")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas", "pallas-high"],
                   help="accepted for multifm-tpu command lines and "
                        "ignored: every value runs the one production "
                        "kernel (K1)")
    p.add_argument("--iq-dump", default=None,
                   help="dump ingested wideband IQ (int16 values) to this "
                        "file — the reference's iqDumpFile tap "
                        "(rtl_sdr_if.c:132-136)")
    p.add_argument("--test-samples", type=int, default=1_048_576,
                   help="samples to synthesize when sdrTestMode is set")
    p.add_argument("--inflight-depth", type=int, default=EXACT_INFLIGHT_DEPTH,
                   help="exact tier: blocks kept in flight on the device "
                        "(adds that many blocks of output latency)")
    p.add_argument("--stats", type=float, default=0.0, metavar="SECS",
                   help="print a live counters line to stderr every SECS "
                        "seconds (0 = only the exit summary)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without CUDA)")
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {cli_version()}")
    return p


def _iq_block_iter(path, fmt):
    from tsl_sdr_tpu_torch.runtime.stream import iter_file_blocks
    from tsl_sdr_tpu_torch.utils import iq as iqio

    if fmt == "cs16":
        for flat in iter_file_blocks(path, dtype=np.int16, unit_items=2):
            yield flat.reshape(-1, 2)
    else:
        for raw in iter_file_blocks(path, dtype=np.uint8, unit_items=2):
            yield iqio.widen_iq_bytes(raw, fmt).reshape(-1, 2)


def _rtl_test_mode(args, cfg, stack):
    """With an ``rtlsdr`` device and no ``--iq-file``: log the E4000 IF
    gain plan as the reference's driver does and, in ``sdrTestMode`` with
    no driver library, synthesize the test-mode counter stream into a
    temporary cs16 file. Returns (path, format) or (None, None)."""
    from tsl_sdr_tpu_torch.sources import hw as hwmod
    from tsl_sdr_tpu_torch.sources.rtl_sdr import (RtlSdrConfig,
                                                   e4000_if_gain_plan,
                                                   test_mode_pattern)
    from tsl_sdr_tpu_torch.utils import iq as iqio

    rtl = RtlSdrConfig.from_dict(cfg.device.params,
                                 {"sdrTestMode": cfg.raw.get("sdrTestMode")})
    if rtl.db_gain_if is not None:
        stages, total = e4000_if_gain_plan(int(rtl.db_gain_if * 10))
        print(f"{PROG}: E4000 IF gain plan {stages} (total "
              f"{total / 10:.1f} dB)", file=sys.stderr)
    if not rtl.test_mode:
        return None, None
    try:
        # with the library present, test mode runs on the device itself
        hwmod._dlopen("TSL_RTLSDR_LIB", "rtlsdr", "rtlsdr")
        return None, None
    except hwmod.HwLibraryMissing:
        pass
    import tempfile

    raw = test_mode_pattern(2 * args.test_samples)
    fd, path = tempfile.mkstemp(suffix=".cs16")
    stack.callback(os.unlink, path)
    with os.fdopen(fd, "wb") as f:
        iqio.rtl_u8_to_q14(raw).astype(np.int16).tofile(f)
    return path, "cs16"


def main(argv=None):
    args = build_argparser().parse_args(argv)
    with contextlib.ExitStack() as stack:
        return _main(args, stack)


def _main(args, stack):
    import torch

    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.runtime.stream import (StreamCounters,
                                                  install_sigterm_as_interrupt)
    from tsl_sdr_tpu_torch.sources.hw import HwLibraryMissing, make_hw_source
    from tsl_sdr_tpu_torch.utils.config import ConfigError, MultifmConfig

    install_sigterm_as_interrupt()
    try:
        cfg = MultifmConfig.load(*args.configs)
    except ConfigError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    missing = [k for k, ch in enumerate(cfg.channels) if ch.out_fifo is None]
    if missing:
        print(f"{PROG}: channels {missing} have no outFifo (required here; "
              "only pipeline-torch protocol channels may omit it)",
              file=sys.stderr)
        return 2
    dev_type = cfg.device.type
    iq_path = args.iq_file
    iq_fmt = args.iq_format
    if dev_type == "file" and iq_path is None:
        iq_path = cfg.device.params["filename"]
        iq_fmt = iq_fmt or cfg.device.params.get("fileFormat", "cs16")
    if iq_path is None and dev_type == "rtlsdr":
        iq_path, iq_fmt = _rtl_test_mode(args, cfg, stack)
    hw_source = None
    if iq_path is None:
        # a radio: its driver library through ctypes (sources/hw.py)
        try:
            hw_source = make_hw_source(cfg, dev_type)
        except HwLibraryMissing as e:
            print(f"{PROG}: {e}", file=sys.stderr)
            return 2
    if iq_path is None and hw_source is None:
        print(f"{PROG}: device type '{dev_type}' needs attached hardware; "
              "use a 'file' device or --iq-file to stream a capture",
              file=sys.stderr)
        return 2

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print(f"{PROG}: --device {args.device} but CUDA is not available",
              file=sys.stderr)
        return 2
    chain = MultifmChain.from_config(cfg, exact=args.exact,
                                     device=args.device)
    block = args.block_size - (args.block_size % chain.block_quantum)
    if block <= 0:
        block = chain.block_quantum
    counters = StreamCounters()
    debug_iq = any(ch.signal_debug_file for ch in cfg.channels)
    if args.runtime == "native" and not debug_iq and hw_source is None:
        return _run_native(args, cfg, chain, iq_path, iq_fmt or "cs16",
                           block, counters)
    return _run_python(args, cfg, chain, iq_path, iq_fmt or "cs16", block,
                       counters, hw_source, debug_iq)


def _run_python(args, cfg, chain, iq_path, iq_fmt, block, counters,
                hw_source, debug_iq):
    """Python I/O loops: a feeder thread reads, widens, mutes, peels the
    stream prefix and cuts blocks while the device computes."""
    from tsl_sdr_tpu_torch.models.channelizer import HostCopy
    from tsl_sdr_tpu_torch.runtime.feeder import AsyncFeeder
    from tsl_sdr_tpu_torch.runtime.stream import StatsTicker
    from tsl_sdr_tpu_torch.sources.hw import pairs

    if hw_source is not None:
        # reference order: unmute, then start the receiver (multifm.c:158)
        hw_source.open(cfg.sample_rate_hz, cfg.center_freq_hz)
        hw_source.set_mute(False)
        hw_source.start()

    mute_left = cfg.sample_rate_hz * cfg.mute_startup_ms // 1000
    sinks = [open(ch.out_fifo, "wb") for ch in cfg.channels]
    iq_dump = open(args.iq_dump, "wb") if args.iq_dump else None
    dbg_sinks = [open(ch.signal_debug_file, "wb")
                 if ch.signal_debug_file else None for ch in cfg.channels]
    state = None
    t0 = time.monotonic()
    ticker = StatsTicker(args.stats, counters, PROG)
    prefix_holder: list = []

    def produce():
        # host staging in the feeder's thread: reads, widening, the mute
        # gate, the prefix peel and block cutting overlap device compute
        nonlocal mute_left
        pending = np.zeros((0, 2), np.int16)
        carry_done = chain.carry_len == 0
        raw_iter = (pairs(hw_source.blocks()) if hw_source is not None
                    else _iq_block_iter(iq_path, iq_fmt))
        for iq in raw_iter:
            if mute_left > 0:
                # startup mute gate (receiver.h:98, multifm/multifm.c:158)
                drop = min(mute_left, len(iq))
                iq = iq[drop:]
                mute_left -= drop
                if not len(iq):
                    continue
            if iq_dump is not None:
                iq.astype(np.int16).tofile(iq_dump)
            pending = np.concatenate([pending, iq])
            if not carry_done:
                if len(pending) < chain.carry_len:
                    continue
                prefix_holder.append(pending[: chain.carry_len].copy())
                pending = pending[chain.carry_len:]
                carry_done = True
            while len(pending) >= block:
                yield np.ascontiguousarray(pending[:block])
                pending = pending[block:]

    # the exact tier's step uploads its own block (after the host rotator)
    feeder = AsyncFeeder(produce(), depth=3, device=chain.device,
                         device_put=not chain.exact)
    # the production tier's PCM copies to the host behind the next block's
    # compute and is written one block late; the exact tier pipelines
    # through _ExactPipeliner
    pending_pcm = None
    exact_pipe = chain.exact and not debug_iq

    def emit(pcm):
        counters.samples_out += pcm.shape[1]
        for c, sink in enumerate(sinks):
            pcm[c].astype(np.int16).tofile(sink)

    xp = (_ExactPipeliner(chain, emit, depth=args.inflight_depth)
          if exact_pipe else None)
    try:
        for blk in feeder:
            if state is None:
                state = chain.init_state(
                    prefix=prefix_holder[0] if prefix_holder else None)
            if debug_iq:
                state, pcm, ch_iq = chain.step_debug(state, blk)
                for c, dbg in enumerate(dbg_sinks):
                    if dbg is not None:
                        ch_iq[c].astype(np.int16).tofile(dbg)
                emit(pcm)
            elif exact_pipe:
                state = xp.feed(state, blk)
            else:
                state, pcm = chain.step(state, blk)
                copy = HostCopy(pcm)
                if pending_pcm is not None:
                    emit(pending_pcm.numpy())
                pending_pcm = copy
            counters.samples_in += block
            ticker.tick()
            if args.realtime:
                target = counters.samples_in / cfg.sample_rate_hz
                lag = target - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        # Ctrl-C is the normal way to stop a live run: it must not drop
        # the blocks already computed
        try:
            if pending_pcm is not None:
                emit(pending_pcm.numpy())
            if xp is not None:
                xp.drain()
        except (KeyboardInterrupt, BrokenPipeError, ValueError):
            pass
        feeder.close()
        if hw_source is not None:
            hw_source.stop()
            print(f"{PROG}: hw source {hw_source.stats}", file=sys.stderr)
        for f in (*sinks, iq_dump, *dbg_sinks):
            if f is not None:
                f.close()
        print(f"{PROG}: {counters.summary()}", file=sys.stderr)
    return 0


def _run_native(args, cfg, chain, iq_path, iq_fmt, block, counters):
    """Production I/O: C++ reader and writer threads around the device
    chain. The native source keeps the FIFO drained into a frame pool while
    the device computes (the reference's receiver thread,
    ``multifm/receiver.c:78-98``); native sinks drop and count on EPIPE
    (``multifm/demod.c:93-110``)."""
    from tsl_sdr_tpu_torch.models.channelizer import HostCopy
    from tsl_sdr_tpu_torch.runtime.native import NativeSink, NativeSource
    from tsl_sdr_tpu_torch.runtime.stream import StatsTicker

    label = f"{PROG}[native]"
    pace = cfg.sample_rate_hz if args.realtime else 0.0
    # pool sized from nrSampBufs (multifm/receiver.c:154-157); realtime
    # delivery drops and counts on a full pool like a live source
    # (multifm/receiver.c:56-62), offline files hold the reader back
    src = NativeSource(iq_path, iq_fmt, frame_samples=block,
                       pool_frames=max(2, cfg.nr_samp_bufs), pace_sps=pace,
                       drop_on_full=bool(args.realtime))
    sinks = [NativeSink(ch.out_fifo) for ch in cfg.channels]
    ticker = StatsTicker(args.stats, counters, label)
    state = None
    pending = np.zeros(0, np.int16)  # flat interleaved values
    quantum2 = 2 * chain.block_quantum
    iq_dump = open(args.iq_dump, "wb") if args.iq_dump else None
    pending_pcm = None

    def emit(pcm):
        counters.samples_out += pcm.shape[1]
        for c, sink in enumerate(sinks):
            sink.write(pcm[c])

    xp = (_ExactPipeliner(chain, emit, depth=args.inflight_depth)
          if chain.exact else None)
    try:
        eof = False
        mute_vals = 2 * (cfg.sample_rate_hz * cfg.mute_startup_ms // 1000)
        while not eof:
            vals = src.read(block)
            eof = vals.size < 2 * block
            if mute_vals > 0:
                drop = min(mute_vals, vals.size)
                vals = vals[drop:]
                mute_vals -= drop
                if not vals.size and not eof:
                    continue
            if iq_dump is not None:
                vals.tofile(iq_dump)
            pending = np.concatenate([pending, vals])
            if state is None:
                c_need = 2 * chain.carry_len
                if pending.size < c_need + quantum2:
                    if eof:
                        break
                    continue
                state = chain.init_state(
                    prefix=pending[:c_need].reshape(-1, 2))
                pending = pending[c_need:]
            n = pending.size // quantum2 * quantum2
            if n == 0:
                continue
            blk = pending[:n].reshape(-1, 2)
            pending = pending[n:]
            counters.samples_in += n // 2
            if xp is not None:
                state = xp.feed(state, blk)
            else:
                state, pcm = chain.step(state, blk)
                copy = HostCopy(pcm)
                if pending_pcm is not None:
                    emit(pending_pcm.numpy())
                pending_pcm = copy
            ticker.tick()
    except KeyboardInterrupt:
        pass
    finally:
        # guarded, so that a second Ctrl-C mid-fetch still reaches the
        # closes
        try:
            if pending_pcm is not None:
                emit(pending_pcm.numpy())
            if xp is not None:
                xp.drain()
        except (KeyboardInterrupt, BrokenPipeError, ValueError):
            pass
        counters.dropped += int(src.stats["dropped_frames"] + sum(
            s.stats["dropped_writes"] for s in sinks))
        src.close()
        for s in sinks:
            s.close()
        if iq_dump is not None:
            iq_dump.close()
        print(f"{label}: {counters.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
