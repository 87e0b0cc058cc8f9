"""pipeline-torch: wideband IQ -> decoded messages, one process.

Port of ``pipeline-tpu`` (``tsl_sdr_tpu/cli/pipeline.py``): one JSON config
in the multifm vocabulary (each channel may carry ``"protocol": "pocsag" |
"flex" | "ais" | "pcm"``), messages as JSON lines tagged with the channel's
center frequency. A finished capture file, or live with ``--follow``: a
FIFO, a growing file or a radio (rtlsdr, airspy, usrp device types),
decoded as it arrives until EOF, idle, SIGTERM or Ctrl-C, with
``--state-file`` for restarts that lose nothing and ``--standby`` for a
warm failover leg.

    pipeline-torch cfg.json --iq-file cap.cs16 -o out.jsonl
    pipeline-torch cfg.json --follow --iq-file iq.fifo --state-file s.npz
    pipeline-torch cfg.json --iq-file cap.cs16 --exact

``--exact`` runs the bit-exact tier (the reference's PCM bit for bit, no
egress gating, no ``--state-file``).

``--time-shards``/``--channel-shards`` run each block over a mesh of
devices (:mod:`tsl_sdr_tpu_torch.parallel.pipeline`): the CUDA devices
this process sees, or, with ``--device cpu``, the CPU standing in for as
many devices as the mesh asks for. ``--distributed HOST:PORT`` spans the
mesh over ``--num-processes`` processes (gloo; run the same command with
each ``--process-id``): every process reads the same input, uploads only
its own time span of each block, and decodes identically; only process 0
writes messages, audio and NMEA. Without shard flags the time axis takes
every process's devices (one a process with ``--device cpu``).

    pipeline-torch cfg.json --iq-file cap.cs16 --time-shards 2
    pipeline-torch cfg.json --iq-file cap.cs16 \\
        --distributed 10.0.0.1:29500 --num-processes 2 --process-id 0

``--backend`` is accepted for ``pipeline-tpu`` command lines and ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import stat
import sys
import time

import numpy as np

PROG = "pipeline-torch"


class _SignalGuard:
    """Route SIGTERM/SIGINT through KeyboardInterrupt, but never inside a
    critical section: while :meth:`defer` is held the signal only sets
    ``pending``. A raise landing inside push() could strand a block between
    the host buffer and the device state (the checkpoint's consumed-sample
    count would then skip it on resume), or cut a checkpoint short."""

    def __init__(self):
        self.pending = False
        self._defer = False

    def handler(self, signum, frame):
        self.pending = True
        if not self._defer:
            raise KeyboardInterrupt

    @contextlib.contextmanager
    def defer(self):
        self._defer = True
        try:
            yield
        finally:
            self._defer = False


def _check_resume_offset(path, fmt, resume_samples):
    """A rotated or recreated input file shorter than the checkpoint's
    resume offset would seek past EOF and decode nothing (exit 0, stale
    checkpoint rewritten); restart from sample 0 instead."""
    from tsl_sdr_tpu_torch.utils.iq import unit_bytes

    try:
        st = os.stat(path)
    except OSError:
        return resume_samples
    if stat.S_ISFIFO(st.st_mode):
        return resume_samples
    if st.st_size < resume_samples * unit_bytes(fmt):
        print(f"{PROG}: {path} is shorter than the checkpoint's "
              f"{resume_samples}-sample resume offset (rotated?); "
              "restarting from the beginning", file=sys.stderr)
        return 0
    return resume_samples


def build_argparser():
    p = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("configs", nargs="+", help="JSON config file(s), merged")
    p.add_argument("--iq-file", default=None)
    p.add_argument("--iq-format", default=None,
                   choices=["cs16", "cs8", "cu8", "cu8_unbiased", "rtl_u8"])
    p.add_argument("-o", "--output", default=None, help="messages JSON file")
    p.add_argument("--exact", action="store_true",
                   help="bit-exact integer tier (the reference's PCM bit "
                        "for bit)")
    p.add_argument("--follow", action="store_true",
                   help="consume the IQ source live (FIFO, growing file or "
                        "hardware device): decode as data arrives, emit JSON "
                        "lines at once, run until EOF, idle, SIGTERM or "
                        "Ctrl-C")
    p.add_argument("--block-size", type=int, default=None,
                   help="streaming block length in wideband samples")
    p.add_argument("--inflight-depth", type=int, default=2,
                   help="device blocks kept in flight before the oldest "
                        "is decoded: higher hides device->host latency, "
                        "lower tightens live decode latency")
    p.add_argument("--no-drain-async", action="store_true",
                   help="with --follow: drain (device fetch, bit unpack, "
                        "decoder scans) on the dispatch thread instead of "
                        "a worker overlapping the next block's upload")
    p.add_argument("--state-file", default=None,
                   help="with --follow: restore the streaming state from "
                        "this .npz if it exists (regular-file inputs resume "
                        "at the consumed offset), and write it on exit "
                        "instead of flushing")
    p.add_argument("--stats", type=float, default=0.0, metavar="SECS",
                   help="with --follow: print a stats line to stderr every "
                        "SECS seconds (samples, rate, messages, device "
                        "blocks, gated fetches)")
    p.add_argument("--standby", action="store_true",
                   help="hot standby (with --follow and --state-file): warm "
                        "the device, wait for the state file (written by a "
                        "stopping primary) or <state-file>.takeover (touched "
                        "by a supervisor: start fresh), then stream")
    p.add_argument("--no-warm", action="store_true",
                   help="with --follow: skip the throwaway warm-up block "
                        "that moves device start-up off live traffic")
    p.add_argument("--idle-exit", type=float, default=1.0,
                   help="with --follow on a regular file: stop once it has "
                        "not grown for this many seconds (0: at the first "
                        "EOF)")
    p.add_argument("--realtime", action="store_true",
                   help="with --follow on a file: pace reads at "
                        "sampleRateHz, like a live capture")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without CUDA)")
    p.add_argument("--iq-dump", default=None,
                   help="dump ingested wideband IQ (int16 values) to this "
                        "file — the reference's iqDumpFile tap")
    p.add_argument("--nmea", default=None, metavar="FILE",
                   help="emit NMEA 0183 !AIVDM sentences for every "
                        "CRC-valid packet on ais channels to FILE "
                        "('-' = stdout)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas", "pallas-high"],
                   help="accepted for pipeline-tpu command lines and "
                        "ignored: every value runs the one production "
                        "kernel (K1)")
    p.add_argument("--channel-shards", type=int, default=1,
                   help="split the channels over this many devices (the "
                        "channel count must divide evenly); decodes what "
                        "one device decodes")
    p.add_argument("--time-shards", type=int, default=1,
                   help="split each block's samples over this many "
                        "devices (the mesh's time axis); composes with "
                        "--channel-shards (time x channels devices)")
    p.add_argument("--distributed", metavar="HOST:PORT", default=None,
                   help="span the mesh over --num-processes processes "
                        "(gloo at tcp://HOST:PORT; the same command on "
                        "each with its --process-id): each reads the same "
                        "input and uploads only its time span of a block; "
                        "only process 0 writes output")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --distributed")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --distributed")
    return p


def _local_devices(device: str, n_need: int, n_proc: int) -> list:
    """This process's devices for a mesh of ``n_need`` over ``n_proc``
    processes: the CUDA devices it sees, or the CPU standing in for its
    share of the mesh (so the device count never refuses a CPU mesh)."""
    import torch

    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * max(1, n_need // n_proc)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", k) for k in range(n)]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    is_main = True
    if args.distributed is not None:
        if args.num_processes is None or args.process_id is None:
            print(f"{PROG}: --distributed needs --num-processes and "
                  "--process-id", file=sys.stderr)
            return 2
        if args.state_file is not None:
            print(f"{PROG}: --state-file is single-process; multi-host "
                  "deployments checkpoint their input feed per host",
                  file=sys.stderr)
            return 2
        from tsl_sdr_tpu_torch.parallel import multihost

        multihost.init(args.distributed, num_processes=args.num_processes,
                       process_id=args.process_id)
        is_main = multihost.rank() == 0
        n_need = args.time_shards * args.channel_shards
        n_global = multihost.global_device_count(
            _local_devices(args.device, n_need, multihost.world_size()))
        if args.time_shards == 1 and args.channel_shards == 1:
            # default: split each block's samples over every device of
            # every process
            args.time_shards = n_global
    if args.state_file is not None and not args.follow:
        print(f"{PROG}: --state-file requires --follow", file=sys.stderr)
        return 2
    if args.state_file is not None and args.exact:
        print(f"{PROG}: --state-file covers the production streaming tier; "
              "the bit-exact tier is a parity oracle (drop --exact)",
              file=sys.stderr)
        return 2
    if args.follow and args.standby and args.state_file is None:
        print(f"{PROG}: --standby requires --state-file", file=sys.stderr)
        return 2

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.utils import iq as iqio
    from tsl_sdr_tpu_torch.utils.config import (ConfigError, MultifmConfig,
                                                load_config)
    from tsl_sdr_tpu_torch.utils.jsonout import message_to_json

    try:
        raw = load_config(*args.configs)
        cfg = MultifmConfig.from_dict(raw)
    except ConfigError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2

    iq_path = args.iq_file
    fmt = args.iq_format
    dev_type = cfg.device.type
    if dev_type == "file" and iq_path is None:
        iq_path = cfg.device.params["filename"]
        fmt = fmt or cfg.device.params.get("fileFormat", "cs16")
    hw_source = None
    if iq_path is None and args.follow:
        from tsl_sdr_tpu_torch.sources.hw import (HwLibraryMissing,
                                                  make_hw_source)

        try:
            hw_source = make_hw_source(cfg, dev_type)
        except HwLibraryMissing as e:
            print(f"{PROG}: {e}", file=sys.stderr)
            return 2
    if iq_path is None and hw_source is None:
        print(f"{PROG}: need a file device, --iq-file, or --follow with a "
              "hardware device", file=sys.stderr)
        return 2
    fmt = fmt or "cs16"
    # 8-bit file/FIFO captures ride the wire-format ingest path: raw bytes
    # upload at 2 B/sample and widen in the device step's first stage;
    # hardware sources deliver int16 blocks and stay cs16
    wire_fmt = fmt if iq_path is not None else "cs16"

    specs = [
        ChannelSpec(
            center_freq_hz=ch.chan_center_freq,
            protocol=str(ch_raw.get("protocol", "pcm")).lower(),
            invert=bool(ch_raw.get("invert", False)),
            dc_block=bool(ch_raw.get("dcBlock", False)),
            dc_block_pole=float(ch_raw.get("dcBlockPole", 0.9999)),
            db_gain=ch_raw.get("dBGain"),
        )
        for ch_raw, ch in zip(raw["channels"], cfg.channels)
    ]

    mesh = None
    if args.channel_shards > 1 or args.time_shards > 1:
        from tsl_sdr_tpu_torch.parallel import multihost
        from tsl_sdr_tpu_torch.parallel.mesh import make_mesh

        n_need = args.channel_shards * args.time_shards
        n_proc = multihost.world_size()
        local = _local_devices(args.device, n_need, n_proc)
        n_dev = (multihost.global_device_count(local)
                 if args.distributed is not None else len(local))
        if n_dev < n_need:
            print(f"{PROG}: --time-shards {args.time_shards} x "
                  f"--channel-shards {args.channel_shards} needs "
                  f"{n_need} devices, have {n_dev}", file=sys.stderr)
            return 2
        if args.distributed is not None and n_need != n_dev:
            # a partial mesh would leave other ranks' devices out of the
            # computation, and the ranks would cut blocks differently
            print(f"{PROG}: --distributed meshes must span every global "
                  f"device: time x channels = {n_need} but {n_dev} "
                  "devices are attached", file=sys.stderr)
            return 2
        if len(specs) % args.channel_shards:
            print(f"{PROG}: {len(specs)} channels not divisible by "
                  f"--channel-shards {args.channel_shards}", file=sys.stderr)
            return 2
        if args.distributed is not None:
            mesh = multihost.make_global_mesh(args.channel_shards,
                                              local_devices=local)
        else:
            mesh = make_mesh(time=args.time_shards,
                             channels=args.channel_shards,
                             devices=local[:n_need])

    nmea_out = None
    ais_hook = None
    if args.nmea is not None:
        if not any(s.protocol == "ais" for s in specs):
            print(f"{PROG}: --nmea needs at least one ais channel",
                  file=sys.stderr)
            return 2
    if args.nmea is not None and is_main:
        # every process decodes identically; only process 0 feeds NMEA
        from tsl_sdr_tpu_torch.models.ais import (NmeaEmitter,
                                                  aivdm_channel_for_freq)

        nmea_out = sys.stdout if args.nmea == "-" else open(args.nmea, "w")
        ais_hook = NmeaEmitter(nmea_out, channel=aivdm_channel_for_freq)

    pipe = ReceivePipeline(
        cfg.lpf_taps, cfg.center_freq_hz, cfg.sample_rate_hz,
        cfg.decimation_factor, specs,
        exact=args.exact,
        block_size=args.block_size,
        inflight_depth=args.inflight_depth,
        ais_packet_hook=ais_hook,
        wire_fmt=wire_fmt,
        device=args.device,
        drain_async=args.follow and not args.no_drain_async,
        mesh=mesh,
    )

    if is_main:
        out = (open(args.output, "w", buffering=1) if args.output
               else sys.stdout)
    else:
        # every process decodes the same; only process 0 writes
        out = open(os.devnull, "w")
    iq_dump = open(args.iq_dump, "wb") if args.iq_dump and is_main else None
    pcm_sinks = {
        i: open(ch.out_fifo, "wb")
        for i, (spec, ch) in enumerate(zip(specs, cfg.channels))
        if spec.protocol == "pcm" and ch.out_fifo and is_main
    }
    n_msgs = 0

    def emit(results) -> int:
        """Write the messages (and pcm audio) of one call; returns how many
        messages it wrote."""
        nonlocal n_msgs
        before = n_msgs
        for i, (spec, res) in enumerate(zip(specs, results)):
            if spec.protocol == "pcm":
                sink = pcm_sinks.get(i)
                if sink is not None:
                    for arr in (res if isinstance(res, list) else [res]):
                        np.asarray(arr, np.int16).tofile(sink)
                continue
            for m in res:
                out.write(message_to_json(m, freq_hz=spec.center_freq_hz)
                          + "\n")
                n_msgs += 1
        out.flush()
        return n_msgs - before

    def dump_iq(iq):
        """--iq-dump taps ingested IQ as int16 values whatever the wire
        format (the reference's iqDumpFile)."""
        if wire_fmt == "cs16":
            np.asarray(iq, np.int16).tofile(iq_dump)
        else:
            iqio.widen_iq_bytes(
                np.ascontiguousarray(iq).reshape(-1).view(np.uint8),
                wire_fmt).tofile(iq_dump)

    n_samples = 0
    t0 = time.monotonic()
    try:
        if args.follow:
            n_samples = _follow(args, cfg, pipe, emit,
                                dump_iq if iq_dump is not None else None,
                                iq_path, fmt, wire_fmt, hw_source)
            if n_samples is None:   # stopped before streaming began
                return 0
        else:
            if wire_fmt == "cs16":
                iq = iqio.read_iq_file(iq_path, fmt)
            else:
                # raw wire bytes straight to the pipeline: the widening
                # runs on the device (2 B/sample over the host->device link)
                raw_bytes = np.fromfile(iq_path, np.uint8)
                iq = raw_bytes[: len(raw_bytes) // 2 * 2].reshape(-1, 2)
            n_samples = len(iq)
            if iq_dump is not None:
                dump_iq(iq)
            emit(pipe.process_capture(iq))
    finally:
        if out is not sys.stdout:
            out.close()
        for sink in pcm_sinks.values():
            sink.close()
        if iq_dump is not None:
            iq_dump.close()
        if nmea_out is not None and nmea_out is not sys.stdout:
            nmea_out.close()
    dt = time.monotonic() - t0
    print(f"{PROG}: {n_samples} samples, {len(specs)} channels, {n_msgs} "
          f"messages in {dt:.2f}s ({n_samples / max(dt, 1e-9) / 1e6:.1f} "
          "Msps)", file=sys.stderr)
    print(f"{PROG}: decoder tier {' '.join(sorted(pipe.decoder_tiers))}",
          file=sys.stderr)
    if args.distributed is not None:
        from tsl_sdr_tpu_torch.parallel import multihost

        st = pipe.stream_stats
        print(f"{PROG}: process {multihost.rank()} of "
              f"{multihost.world_size()}: blocks={st['blocks']} "
              f"upload_bytes={st['upload_bytes']} "
              f"halo_bytes={st['halo_bytes']}", file=sys.stderr)
    return 0


def _follow(args, cfg, pipe, emit, dump_iq, iq_path, fmt, wire_fmt,
            hw_source):
    """The --follow run with SIGTERM and SIGINT routed through
    :class:`_SignalGuard` (the previous handlers are put back after it).
    Returns the samples this run consumed, or None if it was stopped
    before streaming began."""
    guard = _SignalGuard()
    # SIGTERM (a service manager's stop) and Ctrl-C both take the clean
    # shutdown path (drain, checkpoint or flush, summary), and only at
    # block boundaries, never inside push
    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, guard.handler)
        except ValueError:
            pass  # not the main thread: keep the default handlers
    try:
        return _follow_loop(args, cfg, pipe, emit, dump_iq, iq_path, fmt,
                            wire_fmt, hw_source, guard)
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)


def _follow_loop(args, cfg, pipe, emit, dump_iq, iq_path, fmt, wire_fmt,
                 hw_source, guard):
    """Warm, stand by, restore, stream, then checkpoint or flush."""
    from tsl_sdr_tpu_torch.runtime.stream import StatsTicker, StreamCounters

    n_samples = 0
    resume_samples = 0
    if not args.no_warm:
        # before the restore: warming needs a pristine stream, and a resume
        # leg gains most (its start-up stall would otherwise land on the
        # backlog behind the FIFO)
        try:
            warm_s = pipe.warm_device()
        except KeyboardInterrupt:
            print(f"{PROG}: interrupted during device warm", file=sys.stderr)
            return None
        print(f"{PROG}: device warm in {warm_s:.1f}s", file=sys.stderr)
    if args.standby:
        print(f"{PROG}: standby — warmed, waiting for {args.state_file}",
              file=sys.stderr)
        # the primary writes the state file as its last act (an atomic
        # rename: a partial file is never seen); a supervisor that saw the
        # primary die without one touches <state-file>.takeover instead:
        # take over fresh, the protocols synchronise themselves
        takeover = args.state_file + ".takeover"
        try:
            while not (os.path.exists(args.state_file)
                       or os.path.exists(takeover)):
                if guard.pending:
                    raise KeyboardInterrupt
                time.sleep(0.1)
        except KeyboardInterrupt:
            print(f"{PROG}: standby cancelled", file=sys.stderr)
            return None
        if os.path.exists(takeover):
            with contextlib.suppress(OSError):
                os.unlink(takeover)
        print(f"{PROG}: standby taking over", file=sys.stderr)
    if args.state_file is not None and os.path.exists(args.state_file):
        t_restore = time.perf_counter()
        try:
            user = pipe.restore_stream(args.state_file)
        except Exception as e:  # noqa: BLE001
            # an unreadable or incompatible state file must not crash-loop
            # the service: set it aside and start fresh
            bad = args.state_file + ".bad"
            os.replace(args.state_file, bad)
            print(f"{PROG}: state file unusable ({type(e).__name__}: {e}); "
                  f"moved to {bad}, starting fresh", file=sys.stderr)
        else:
            resume_samples = int(user.get("consumed_samples", 0))
            print(f"{PROG}: resumed from {args.state_file} "
                  f"({resume_samples} samples consumed) in "
                  f"{time.perf_counter() - t_restore:.3f}s", file=sys.stderr)
            if resume_samples and iq_path is not None:
                resume_samples = _check_resume_offset(iq_path, fmt,
                                                      resume_samples)
    if hw_source is not None:
        from tsl_sdr_tpu_torch.sources.hw import pairs

        hw_source.open(cfg.sample_rate_hz, cfg.center_freq_hz)
        hw_source.set_mute(False)
        hw_source.start()
        blocks = pairs(hw_source.blocks())
        source = f"{cfg.device.type} device"
    else:
        blocks = _follow_blocks(
            iq_path, fmt, idle_exit=args.idle_exit,
            skip_samples=resume_samples,
            pace_sps=cfg.sample_rate_hz if args.realtime else 0,
            raw_wire=(wire_fmt != "cs16"))
        source = iq_path
    # the startup mute gate of live hardware (receiver.h:98,
    # multifm/multifm.c:158): drop the tuner-settling head
    mute_left = (cfg.sample_rate_hz * cfg.mute_startup_ms // 1000
                 if hw_source is not None else 0)
    counters = StreamCounters()
    ticker = StatsTicker(args.stats, counters, PROG)
    print(f"{PROG}: following {source}", file=sys.stderr, flush=True)
    primed = False
    try:
        for iq in blocks:
            if mute_left > 0:
                drop = min(mute_left, len(iq))
                iq = iq[drop:]
                mute_left -= drop
                if not len(iq):
                    continue
            n_samples += len(iq)
            if dump_iq is not None:
                dump_iq(iq)
            with guard.defer():
                counters.messages += emit(pipe.push(iq))
            if guard.pending:
                raise KeyboardInterrupt
            if not primed and pipe.primed:
                primed = True
                print(f"{PROG}: stream primed", file=sys.stderr, flush=True)
            if args.stats:
                counters.samples_in = n_samples
                with guard.defer():
                    st = pipe.stream_stats
                    ticker.tick(f" blocks={st['blocks']} "
                                f"fetched={st['fetched'].tolist()}")
                if guard.pending:
                    raise KeyboardInterrupt
    except KeyboardInterrupt:
        pass
    finally:
        if hw_source is not None:
            hw_source.stop()
    if args.state_file is not None and pipe.primed:
        # a second SIGTERM during the save must not kill it: the drain and
        # the write are one critical section (the rename itself is atomic)
        t_save = time.perf_counter()
        with guard.defer():
            emit(pipe.checkpoint_stream(
                args.state_file,
                user_meta={"consumed_samples": resume_samples + n_samples}))
        print(f"{PROG}: state saved to {args.state_file} in "
              f"{time.perf_counter() - t_save:.3f}s", file=sys.stderr)
    else:
        try:
            with guard.defer():
                emit(pipe.flush())
        except ValueError as e:
            # a follow run stopped before the stream ever primed (fewer
            # than prefix samples arrived) is a clean stop, not a crash
            print(f"{PROG}: {e}", file=sys.stderr)
    st = pipe.stream_stats
    print(f"{PROG}: stream blocks={st['blocks']} "
          f"fetched={st['fetched'].tolist()}", file=sys.stderr)
    return n_samples


def _follow_blocks(path, fmt, chunk_bytes: int = 1 << 20,
                   idle_exit: float | None = None, skip_samples: int = 0,
                   pace_sps: float = 0, raw_wire: bool = False):
    """Yield [N, 2] IQ blocks from a FIFO or regular file as data arrives.
    A FIFO ends when every writer has closed; a regular file is polled past
    EOF (it may still be growing, as ``tail -f``) until it has not grown
    for ``idle_exit`` seconds. ``pace_sps`` > 0 sleeps so that delivery
    tracks that sample rate (the reference file source's real-time pacing,
    ``file_if.c:160-203``). ``raw_wire`` yields the wire view dtype
    unwidened (the device widens it); otherwise int16 values."""
    from tsl_sdr_tpu_torch.utils import iq as iqio

    unit = iqio.unit_bytes(fmt)
    residue = b""
    t0 = time.monotonic()
    delivered = 0
    with open(path, "rb") as f:
        is_fifo = stat.S_ISFIFO(os.fstat(f.fileno()).st_mode)
        if skip_samples and not is_fifo:
            # a FIFO is a live stream: its writer restarted too, so there
            # is nothing to skip
            f.seek(skip_samples * unit)
        idle = 0.0
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                if is_fifo:
                    break  # every writer closed
                if idle_exit is not None and idle >= idle_exit:
                    break
                time.sleep(0.05)
                idle += 0.05
                continue
            idle = 0.0
            data = residue + chunk
            usable = len(data) // unit * unit
            residue = data[usable:]
            if not usable:
                continue
            raw = np.frombuffer(data[:usable], np.uint8)
            if raw_wire:
                block = raw.view(iqio.WIRE_DTYPES[fmt]).reshape(-1, 2)
            else:
                block = iqio.widen_iq_bytes(raw, fmt).reshape(-1, 2)
            if pace_sps > 0:
                delivered += block.shape[0]
                lag = delivered / pace_sps - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
            yield block


if __name__ == "__main__":
    sys.exit(main())
