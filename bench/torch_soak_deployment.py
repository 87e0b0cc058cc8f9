#!/usr/bin/env python3
"""Live deployment soak of the PyTorch port on a GPU.

The operator's shape of use: ``pipeline-torch --follow`` consumes a named
FIFO fed by a paced writer at the pager band's rate (1.2288 Msps, 8 POCSAG
channels) for the requested duration, with ONE kill (SIGTERM ->
checkpoint) mid-run, after which a hot ``--standby`` leg, warmed while
the primary served, resumes from the ``--state-file``.

The writer stamps every burst with a sequence number and records the wall
time each was written; the soak tails the legs' JSONL output and turns
each decode into an end-to-end latency sample. Reported at the end (one
JSON line, also written to ``<workdir>/soak_result.json``; the raw write
and decode times go to ``soak_times.json`` and the legs' stderr to
``legs.log`` beside it):

* offered vs achieved ingest rate (writer side; a slow pipeline would
  backpressure the FIFO and drag the achieved rate below nominal),
* written and decoded burst counts, the outage (SIGTERM to the resumed
  leg's first decode) and the bursts lost inside and outside it,
* end-to-end latency percentiles (write -> decoded message on disk), in
  seconds and in block times,
* the kill/resume event log and each leg's device warm-up.

A warm-up leg first runs the same streaming configuration on 12 seconds
of recorded traffic (10 with bursts, 2 of noise), so the kernels' nvcc
build and the native decoders' g++ build are paid before live traffic.

Usage:  python bench/torch_soak_deployment.py [--minutes 30] [--kill-at 0.5]
            [--workdir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tsl_sdr_tpu_torch.testing import pocsag_gen  # noqa: E402

DECIM = 32
CHANNEL_RATE = 38400
FS = CHANNEL_RATE * DECIM          # 1.2288 Msps wideband
CENTER = 929_500_000
OFFSETS = [-450_000, -320_000, -190_000, -60_000,
           60_000, 190_000, 320_000, 450_000]
BAUD = 1200
# live latency: ~1 s blocks, no block in flight and the synchronous drain,
# so each block decodes inside its own push (the device is far faster than
# the 1.2288 Msps stream: depth and an async drain add a block time of
# latency each and no throughput)
BLOCK_TARGET = 1_228_800
INFLIGHT_DEPTH = 0
CLI = "tsl_sdr_tpu_torch.cli.pipeline"
# the standby starts this long after the primary, or at half the time to
# the kill where that is sooner
STANDBY_DELAY_S = 45.0
# noise after the last burst: one block to complete the last burst's block,
# one to spare
TAIL_S = 2


class PacedWriter(threading.Thread):
    """Generates the live IQ stream second by second and writes it to the
    FIFO at real-time pace. Each stream-second carries one POCSAG burst on
    channel ``seq % 8`` stamped with ``seq``; write times are recorded for
    latency measurement. Survives reader restarts (reopens the FIFO).
    ``TAIL_S`` seconds of noise, paced too, follow the last burst: a leg
    decodes a block once it is whole, and stopped with ``--state-file`` it
    saves a partial block for the next leg, so without the tail the last
    burst would sit in the final leg's checkpoint, never decoded."""

    def __init__(self, fifo: str, seconds: float):
        super().__init__(daemon=True)
        self.fifo = fifo
        self.seconds = seconds
        self.write_times = {}          # seq -> wall time fully written
        self.bytes_written = 0
        self.t_start = None
        self.t_end = None
        self.reopens = 0
        self.stop_flag = threading.Event()
        self._rng = np.random.default_rng(42)

    def _second(self, seq: int) -> np.ndarray:
        """One second of wideband IQ: noise + one stamped burst on
        channel seq % 8.

        Capcodes are frame-0 aligned (capcode % 8 == 0): a frame-7 address
        lands in the batch's last codeword pair, its message spills into a
        second batch and the burst grows to 1728 bits = 1.44 s at 1200
        baud, longer than this 1 s slot. Frame-0 bursts are 1184 bits =
        0.99 s and fit."""
        n = FS
        ch = seq % len(OFFSETS)
        off = OFFSETS[ch]
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=100_000 + 16 * ch, function=1,
                                    kind="alpha", content=f"SOAK {seq}")],
            baud=BAUD, amplitude=6000, tail_bits=64)
        dev = bb.astype(np.float64) / 16384.0 * (CHANNEL_RATE / 2)
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / FS, DECIM))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 6000
        iq = self._rng.normal(scale=90, size=(n, 2))
        m = min(len(sig), n - 8192)
        iq[4096:4096 + m] += sig[:m]
        return iq.astype(np.int16)

    def run(self):
        self.t_start = time.monotonic()
        deadline = self.t_start + self.seconds
        seq = 0
        f = open(self.fifo, "wb", buffering=0)
        try:
            while not self.stop_flag.is_set():
                now = time.monotonic()
                if now >= deadline:
                    break
                buf = self._second(seq).tobytes()
                # pace: second k of the stream goes out during wall second k
                target = self.t_start + seq
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                f = self._write(f, buf)
                self.write_times[seq] = time.time()
                seq += 1
            self.n_seq = seq
            for k in range(TAIL_S):
                if self.stop_flag.is_set():
                    break
                buf = self._rng.normal(scale=90, size=(FS, 2)).astype(
                    np.int16).tobytes()
                delay = self.t_start + seq + k - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                f = self._write(f, buf)
        finally:
            try:
                f.close()
            except BrokenPipeError:
                pass
            self.t_end = time.monotonic()

    def _write(self, f, buf: bytes):
        """Write ``buf`` whole; returns the file, reopened if the reader
        went away meanwhile."""
        view = memoryview(buf)
        while len(view) and not self.stop_flag.is_set():
            try:
                k = f.write(view)
                view = view[k:]
                self.bytes_written += k
            except BrokenPipeError:
                # reader restarting (the kill/resume window): the reopen
                # blocks until the resumed leg attaches
                f.close()
                self.reopens += 1
                f = open(self.fifo, "wb", buffering=0)
        return f


def python_m(argv):
    """The default leg launcher: ``python -m <argv>``."""
    return [sys.executable, "-m", *argv]


def leg_argv(cfg_path, fifo, out_path, state_file, *, standby=False,
             device="cuda"):
    """A live leg's module and arguments. ``out_path`` must be unique per
    leg: ``-o`` opens with "w" and would truncate the previous leg's
    messages on resume. ``standby`` makes the hot-standby resume leg: it
    warms its device session at once and attaches to the FIFO only once
    the primary's checkpoint (or ``<state_file>.takeover``) appears."""
    return ([CLI, str(cfg_path),
             "--iq-file", str(fifo), "--iq-format", "cs16", "--follow",
             "--idle-exit", "30", "--stats", "15",
             "--block-size", str(BLOCK_TARGET),
             "--inflight-depth", str(INFLIGHT_DEPTH), "--no-drain-async",
             "--state-file", str(state_file)]
            + (["--standby"] if standby else [])
            + ["-o", str(out_path), "--device", device])


def warm_argv(cfg_path, warm_file, device="cuda"):
    """The warm-up leg: ``--follow`` on a recorded file with the live legs'
    block and depth, so it builds and runs the same streaming programs."""
    return [CLI, str(cfg_path), "--iq-file", str(warm_file),
            "--iq-format", "cs16", "--follow", "--idle-exit", "2",
            "--block-size", str(BLOCK_TARGET),
            "--inflight-depth", str(INFLIGHT_DEPTH),
            "-o", os.devnull, "--device", device]


def soak_config():
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    return {
        "sampleRateHz": FS,
        "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, firdes_low_pass(1.0, FS, 9_600, 7_000))),
        "channels": [
            {"chanCenterFreq": CENTER + o, "protocol": "pocsag"}
            for o in OFFSETS
        ],
    }


def block_samples(cfg) -> int:
    """The block the legs run: the library rounds ``--block-size`` to the
    pipeline's quantum (the same on every device)."""
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    return ReceivePipeline(
        np.asarray(cfg["lpfTaps"]), CENTER, FS, DECIM,
        [ChannelSpec(CENTER + o, "pocsag") for o in OFFSETS],
        block_size=BLOCK_TARGET, device="cpu").block_size


def summarize(write_times, decode_times, t_sigterm, t_restarted, *,
              minutes, achieved_sps, block_s, reopens=0, events=(),
              warm_s=None, stderr_lines=(), kill_resume_ok=False) -> dict:
    """The soak's result from its raw times (wall clock, seconds):
    ``write_times`` and ``decode_times`` map a burst's seq to when it was
    written and first seen decoded. The outage is [SIGTERM, the first
    decode at or after the resumed leg took over]; a burst written from 2 s
    before the SIGTERM to the outage's end is inside it (one mid-flight
    when the SIGTERM lands is outage loss too: the decoders restart in
    search)."""
    outage_end = None
    if t_restarted is not None:
        post = [t for t in decode_times.values() if t >= t_restarted]
        outage_end = min(post) if post else None
    outage = (round(outage_end - t_sigterm, 1)
              if (t_sigterm and outage_end) else None)

    def in_window(wt):
        return (t_sigterm is not None and outage_end is not None
                and t_sigterm - 2.0 <= wt <= outage_end)

    lost_in = lost_out = dec_out = 0
    for seq, wt in write_times.items():
        inside = in_window(wt)
        if seq in decode_times:
            dec_out += not inside
        elif inside:
            lost_in += 1
        else:
            lost_out += 1

    lat = sorted(decode_times[s] - write_times[s]
                 for s in decode_times if s in write_times)

    def pct(p):
        return (round(lat[min(len(lat) - 1, int(p * len(lat)))], 2)
                if lat else None)

    return {
        "minutes": minutes,
        "offered_msps": FS / 1e6,
        "achieved_msps": round(achieved_sps / 1e6, 4),
        "bursts_written": len(write_times),
        "bursts_decoded": len(decode_times),
        "outage_s": outage,
        "bursts_lost_in_outage": lost_in,
        "bursts_lost_outside": lost_out,
        "decode_pct_outside_outage": round(
            100.0 * dec_out / max(dec_out + lost_out, 1), 2),
        "fifo_reopens": reopens,
        "block_s": round(block_s, 2),
        "latency_s": {"p50": pct(0.5), "p90": pct(0.9), "max": pct(1.0),
                      "n": len(lat)},
        "latency_block_times": {
            "p50": round(pct(0.5) / block_s, 2) if lat else None,
            "p90": round(pct(0.9) / block_s, 2) if lat else None,
        },
        "events": [e[0] for e in events],
        "warmup_s": warm_s,
        "leg_device_warm_s": [
            float(m.group(1)) for m in
            (re.search(r"device warm in ([0-9.]+)s", ln)
             for ln in stderr_lines) if m],
        "kill_resume_ok": kill_resume_ok,
        "takeover_fresh": any(e[0] == "takeover-fresh" for e in events),
        "stats_tail": list(stderr_lines)[-6:],
    }


def _release(writer: PacedWriter, fifo: Path) -> None:
    """Stop the writer; where it waits in ``open`` for a reader that will
    not come, open the FIFO's read end so the open returns."""
    writer.stop_flag.set()
    deadline = time.monotonic() + 30
    while writer.is_alive() and time.monotonic() < deadline:
        try:
            fd = os.open(fifo, os.O_RDONLY | os.O_NONBLOCK)
        except OSError:
            fd = None
        writer.join(timeout=0.2)
        if fd is not None:
            os.close(fd)


def _stop(p, timeout: float = 300.0) -> None:
    if p.poll() is None:
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


def run(minutes: float = 30.0, kill_at: float = 0.5, workdir=None,
        device: str = "cuda", launcher=python_m) -> dict:
    """The soak: the warm-up leg, then ``minutes`` of paced traffic through
    a primary leg, a SIGTERM at ``kill_at`` of the run and the standby's
    takeover. Every leg is started as ``launcher(argv)`` (``argv`` begins
    with the CLI's module). Returns :func:`summarize`'s result and writes
    it to ``<workdir>/soak_result.json``."""
    wd = Path(workdir or Path(tempfile.gettempdir()) / "soak_deploy")
    wd.mkdir(parents=True, exist_ok=True)
    fifo = wd / "iq.fifo"
    if fifo.exists():
        fifo.unlink()
    os.mkfifo(fifo)
    out_paths = [wd / "messages_0.jsonl"]
    out_paths[0].write_text("")
    state_file = wd / "pipe.state.npz"
    takeover = Path(str(state_file) + ".takeover")
    for p in (state_file, takeover):
        if p.exists():
            p.unlink()
    cfg = soak_config()
    cfg_path = wd / "soak.json"
    cfg_path.write_text(json.dumps(cfg))
    block_n = block_samples(cfg)
    print(f"soak: block = {block_n} samples ({block_n / FS:.2f} s), "
          f"inflight depth {INFLIGHT_DEPTH}", flush=True)

    # a burst-bearing warm-up: 10 stream-seconds with one stamped burst on
    # each channel (the decoders and the hot/cold gate transitions), then
    # 2 seconds of noise (the hot -> cold edge)
    t_warm0 = time.monotonic()
    warm_file = wd / "warmup.cs16"
    warm_writer = PacedWriter(str(fifo), 0)  # generator only, never started
    with open(warm_file, "wb") as wf:
        for wseq in range(10):
            wf.write(warm_writer._second(wseq).tobytes())
        noise = warm_writer._rng.normal(scale=90, size=(FS, 2))
        for _ in range(2):
            wf.write(noise.astype(np.int16).tobytes())
    warm = subprocess.run(launcher(warm_argv(cfg_path, warm_file, device)),
                          capture_output=True, text=True, timeout=1800)
    warm_s = round(time.monotonic() - t_warm0, 1)
    warm_file.unlink()
    print(f"soak: warmup leg rc={warm.returncode} in {warm_s}s", flush=True)
    if warm.returncode:
        print(warm.stderr[-4000:], flush=True)

    total_s = minutes * 60.0
    writer = PacedWriter(str(fifo), total_s)
    events = [("warmup", time.time(), warm.returncode, warm_s)]
    stderr_lines = []
    stamped = []                   # the same, with wall time and leg pid
    procs = []
    drains = []

    def launch(out_path, standby=False):
        p = subprocess.Popen(
            launcher(leg_argv(cfg_path, fifo, out_path, state_file,
                              standby=standby, device=device)),
            stderr=subprocess.PIPE, text=True)
        procs.append(p)

        def drain():
            for line in p.stderr:
                stderr_lines.append(line.rstrip())
                stamped.append(f"{time.time():.3f} {p.pid} {line.rstrip()}")

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        drains.append(t)
        return p

    proc = launch(out_paths[-1])
    out_paths.append(wd / "messages_1.jsonl")
    sb = {}
    # the hot standby warms its own session while the primary serves and
    # attaches within seconds of the checkpoint appearing; staggered so the
    # two start-ups do not contend
    standby_at = min(STANDBY_DELAY_S, total_s * kill_at / 2)
    timer = threading.Timer(
        standby_at, lambda: sb.setdefault("proc",
                                          launch(out_paths[1], True)))
    decode_times = {}              # seq -> wall time first seen decoded
    seq_re = re.compile(r"SOAK (\d+)")

    def scan_output():
        lines = []
        for p in out_paths:
            try:
                lines += p.read_text().splitlines()
            except FileNotFoundError:
                pass
        now = time.time()
        for line in lines:
            m = seq_re.search(line)
            if m:
                decode_times.setdefault(int(m.group(1)), now)

    try:
        timer.start()
        writer.start()
        events.append(("start", time.time()))
        kill_t = time.monotonic() + total_s * kill_at
        end_t = time.monotonic() + total_s
        killed = False
        t_sigterm = t_restarted = None
        while time.monotonic() < end_t:
            time.sleep(0.5)  # the latencies' and the outage's resolution
            scan_output()
            if not killed and time.monotonic() >= kill_t:
                events.append(("sigterm", time.time()))
                t_sigterm = time.time()
                proc.send_signal(signal.SIGTERM)
                try:
                    rc = proc.wait(timeout=300)
                except subprocess.TimeoutExpired:
                    # must not abort the soak: escalate, record, resume
                    events.append(("sigterm-timeout-kill", time.time()))
                    proc.kill()
                    rc = proc.wait(timeout=30)
                events.append(("checkpointed", time.time(), rc,
                               state_file.exists()))
                scan_output()
                if not state_file.exists():
                    # the primary died before it could checkpoint: have the
                    # standby take over fresh (its crash-supervision path)
                    takeover.touch()
                    events.append(("takeover-fresh", time.time()))
                # failover: the warm standby sees the state file and takes
                # over on its own; it becomes the tracked leg
                while "proc" not in sb:
                    time.sleep(0.5)
                proc = sb["proc"]
                t_restarted = time.time()
                events.append(("resumed", time.time()))
                killed = True
            if proc.poll() is not None and time.monotonic() < end_t - 35:
                events.append(("unexpected-exit", time.time(),
                               proc.returncode))
                break

        writer.join(timeout=TAIL_S + 30)
        writer.stop_flag.set()
        # let the leg drain its last blocks (it ends at the FIFO's EOF),
        # still scanning, so a late decode keeps its own time; then stop it
        drain_end = time.monotonic() + max(15.0, minutes)
        while time.monotonic() < drain_end and proc.poll() is None:
            time.sleep(0.5)
            scan_output()
        scan_output()
    finally:
        timer.cancel()
        _release(writer, fifo)
        for p in procs:
            _stop(p)
        for t in drains:
            t.join(timeout=10)
        fifo.unlink(missing_ok=True)
    scan_output()

    achieved = writer.bytes_written / 4 / max(
        (writer.t_end or time.monotonic()) - writer.t_start, 1e-9)
    result = summarize(
        writer.write_times, decode_times, t_sigterm, t_restarted,
        minutes=minutes, achieved_sps=achieved, block_s=block_n / FS,
        reopens=writer.reopens, events=events, warm_s=warm_s,
        stderr_lines=stderr_lines,
        kill_resume_ok=killed and state_file.exists())
    (wd / "soak_result.json").write_text(json.dumps(result, indent=1))
    # the raw times and the legs' stderr, for a look behind the percentiles
    (wd / "soak_times.json").write_text(json.dumps({
        "write": writer.write_times, "decode": decode_times,
        "t_sigterm": t_sigterm, "t_restarted": t_restarted,
        "events": events}))
    (wd / "legs.log").write_text("\n".join(stamped) + "\n")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--kill-at", type=float, default=0.5,
                    help="fraction of the run at which to SIGTERM + resume")
    ap.add_argument("--workdir", default=None,
                    help="FIFO, legs' output and soak_result.json (default "
                         "<tmp>/soak_deploy)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.minutes, args.kill_at, args.workdir, args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
