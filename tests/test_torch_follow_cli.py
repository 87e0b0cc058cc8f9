"""``pipeline-torch --follow`` against ``pipeline-tpu --follow`` on the CPU:
FIFOs, growing files, kill-and-resume through ``--state-file``, SIGTERM,
hot standby, ``--stats``, ``--realtime``, ``--nmea`` and the flag guards
(after tests/test_pipeline_stream.py:265-1340).

Bars: the JSON lines byte-equal to pipeline-tpu's but for the wall-clock
``timestamp`` field, the NMEA sentences byte-equal, the same exit codes,
and the guards' error texts equal but for the program's name.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from tsl_sdr_tpu.cli import pipeline as jax_cli
from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu.testing import ais_gen
from tsl_sdr_tpu_torch.cli import pipeline as torch_cli
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.testing import pocsag_gen
from tsl_sdr_tpu_torch.testing.pager import fm_mod
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

from tests.test_torch_stream_engine import _make_capture

ROOT = Path(__file__).resolve().parents[1]
DECIM = 32
FS = 38_400 * DECIM
CENTER = 929_500_000
LPF_WIDE = firdes_low_pass(1.0, FS, 12_000, 8_000)
LPF = firdes_low_pass(1.0, FS, 9_600, 7_000)
THREE = [{"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag"},
         {"chanCenterFreq": CENTER - 180_000, "protocol": "flex"},
         {"chanCenterFreq": CENTER + 400_000, "protocol": "ais"}]
ONE = [{"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag"}]
CLIS = {"tpu": (jax_cli.main, []), "torch": (torch_cli.main,
                                             ["--device", "cpu"])}


def _config(tmp_path, name, source, channels, lpf=LPF, fs=FS, decim=DECIM,
            center=CENTER):
    cfg = {
        "device": {"type": "file", "filename": str(source),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": channels,
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def _lines(path):
    """The JSON lines with the wall-clock timestamp blanked."""
    return [re.sub(r'"timestamp":"[^"]*"', '"timestamp":""', x)
            for x in Path(path).read_text().splitlines()]


def _pairs(lines):
    return [(m["capCode"], m["message"]) for m in map(json.loads, lines)]


def _feed_fifo(fifo, raw, step=1 << 20):
    def writer():
        with open(fifo, "wb") as f:
            for o in range(0, len(raw), step):
                f.write(raw[o:o + step])
                f.flush()
    t = threading.Thread(target=writer, daemon=True)
    t.start()
    return t


def _two_bursts(seed, texts):
    """Noise, a POCSAG burst, noise, a second burst, noise (after
    tests/test_pipeline_stream.py:579)."""
    rng = np.random.default_rng(seed)
    pad = rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16)
    parts = [pad]
    for cap, text in texts:
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        parts += [fm_mod(bb, 38_400, 250_000, FS, amp=9000)
                  .astype(np.int16), pad]
    iq = np.concatenate(parts)
    return (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)


@pytest.fixture(scope="module")
def two_bursts():
    iq = _two_bursts(9, [(111, "PART ONE"), (222, "PART TWO")])
    want = [(m.capcode, m.data.decode()) for m in jpipe.ReceivePipeline(
        LPF, CENTER, FS, DECIM, [jpipe.ChannelSpec(CENTER + 250_000,
                                                   "pocsag")],
        exact=False, block_size=393_216).process_capture(iq)[0]]
    assert [c for c, _ in want] == [111, 222]
    return iq, want


@pytest.fixture(scope="module")
def fifo_tpu(tmp_path_factory):
    """pipeline-tpu --follow on a FIFO fed the three-protocol capture."""
    tmp = tmp_path_factory.mktemp("fifo_tpu")
    iq = _make_capture(seed=33)
    fifo = tmp / "iq.fifo"
    os.mkfifo(fifo)
    cfg = _config(tmp, "tpu", fifo, THREE, lpf=LPF_WIDE)
    t = _feed_fifo(fifo, iq.tobytes())
    assert jax_cli.main([str(cfg), "--follow", "--block-size", "262144",
                         "-o", str(tmp / "tpu.jsonl")]) == 0
    t.join(timeout=60)
    lines = _lines(tmp / "tpu.jsonl")
    assert {m.get("capCode") for m in map(json.loads, lines)} >= {1122334,
                                                              1234567}
    return iq, lines


@pytest.mark.parametrize("flags", [[], ["--no-drain-async"]])
def test_follow_fifo(tmp_path, fifo_tpu, flags):
    iq, want = fifo_tpu
    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)
    cfg = _config(tmp_path, "torch", fifo, THREE, lpf=LPF_WIDE)
    t = _feed_fifo(fifo, iq.tobytes())
    assert torch_cli.main([str(cfg), "--follow", "--block-size", "262144",
                           "--device", "cpu", "-o",
                           str(tmp_path / "m.jsonl"), *flags]) == 0
    t.join(timeout=60)
    assert not t.is_alive()
    assert _lines(tmp_path / "m.jsonl") == want and len(want) == 3


def test_follow_growing_file(tmp_path):
    """A regular file still being written: polled past EOF, stopped by
    --idle-exit, the same lines as pipeline-tpu."""
    iq = _make_capture(seed=41)
    raw = iq.tobytes()
    out = {}
    for name, (main, extra) in CLIS.items():
        path = tmp_path / f"grow_{name}.cs16"
        path.write_bytes(b"")
        cfg = _config(tmp_path, name, path, ONE, lpf=LPF_WIDE)

        def writer(path=path):
            time.sleep(0.3)   # the reader meets EOF on the empty file first
            with open(path, "ab") as f:
                for o in range(0, len(raw), 1 << 20):
                    f.write(raw[o:o + (1 << 20)])
                    f.flush()
                    time.sleep(0.05)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert main([str(cfg), "--follow", "--block-size", "262144",
                     "--idle-exit", "1.0", "-o",
                     str(tmp_path / f"{name}.jsonl"), *extra]) == 0
        t.join(timeout=60)
        out[name] = _lines(tmp_path / f"{name}.jsonl")
    assert out["torch"] == out["tpu"]
    assert [c for c, _ in _pairs(out["tpu"])] == [1122334]


def test_state_file_kill_and_resume(tmp_path, two_bursts):
    """Leg 1 stops at idle with its state saved, the file grows, leg 2
    resumes: both legs' messages are one uninterrupted run's. The port's
    legs also run --no-warm and --no-drain-async."""
    iq, want = two_bursts
    half = len(iq) // 2
    got = {}
    for name, (main, extra) in CLIS.items():
        path = tmp_path / f"cap_{name}.cs16"
        iq[:half].tofile(path)
        cfg = _config(tmp_path, name, path, ONE)
        state = tmp_path / f"state_{name}.npz"
        legs = [["--no-warm"], ["--no-drain-async"]] if name == "torch" \
            else [[], []]
        lines = []
        for k, leg in enumerate(legs):
            if k:
                with open(path, "ab") as f:
                    iq[half:].tofile(f)
            out = tmp_path / f"{name}{k}.jsonl"
            assert main([str(cfg), "--follow", "--idle-exit", "0.3",
                         "--block-size", "393216", "--state-file",
                         str(state), "-o", str(out), *extra, *leg]) == 0
            assert state.exists()
            lines += _lines(out)
        got[name] = lines
    assert got["torch"] == got["tpu"]
    assert _pairs(got["torch"]) == want


def test_sigterm_writes_the_checkpoint(tmp_path):
    """SIGTERM to a pipeline-torch --follow --state-file process takes the
    clean path: it saves a checkpoint that a pipeline of the same config
    restores. The test waits for the 'stream primed' line, not a fixed
    time."""
    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)
    cfg = _config(tmp_path, "p", fifo, ONE)
    state = tmp_path / "state.npz"
    argv = [str(cfg), "--follow", "--block-size", "393216", "--device",
            "cpu", "--state-file", str(state), "-o",
            str(tmp_path / "m.jsonl")]
    child = ("import sys; from tsl_sdr_tpu_torch.cli import pipeline; "
             f"sys.exit(pipeline.main({argv!r}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", child], cwd=ROOT, env=env,
                            stderr=subprocess.PIPE, text=True)
    err, primed = [], threading.Event()

    def read_stderr():
        for line in proc.stderr:
            err.append(line)
            if "stream primed" in line:
                primed.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()

    def feed():
        rng = np.random.default_rng(4)
        try:
            with open(fifo, "wb") as w:
                while proc.poll() is None:
                    w.write(rng.integers(-300, 300, size=(65_536, 2))
                            .astype(np.int16).tobytes())
                    w.flush()
                    time.sleep(0.02)
        except OSError:
            pass  # the reader went away mid-write

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    try:
        assert primed.wait(timeout=120), "".join(err)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    reader.join(timeout=30)
    feeder.join(timeout=30)
    text = "".join(err)
    assert rc == 0, text
    assert "state saved" in text and state.exists(), text
    pipe = tpipe.ReceivePipeline(
        LPF, CENTER, FS, DECIM, [tpipe.ChannelSpec(CENTER + 250_000,
                                                   "pocsag")],
        device="cpu", block_size=393_216)
    user = pipe.restore_stream(state)
    assert user["consumed_samples"] > pipe.chain.carry_len


def test_corrupt_state_file_is_set_aside(tmp_path, capsys):
    rng = np.random.default_rng(5)
    path = tmp_path / "cap.cs16"
    rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16).tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    state = tmp_path / "s.npz"
    state.write_bytes(b"not a zipfile at all")
    assert torch_cli.main([str(cfg), "--follow", "--idle-exit", "0.2",
                           "--block-size", "262144", "--device", "cpu",
                           "--state-file", str(state), "-o",
                           str(tmp_path / "m.jsonl")]) == 0
    assert "state file unusable" in capsys.readouterr().err
    assert (tmp_path / "s.npz.bad").exists()
    with np.load(state) as data:     # a valid replacement was written
        assert "__meta__" in data


def test_stop_before_the_stream_primes(tmp_path, capsys):
    path = tmp_path / "tiny.cs16"
    np.zeros((100, 2), np.int16).tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    assert torch_cli.main([str(cfg), "--follow", "--idle-exit", "0.2",
                           "--block-size", "262144", "--device", "cpu",
                           "-o", str(tmp_path / "m.jsonl")]) == 0
    assert "shorter than the pipeline prefix" in capsys.readouterr().err


@pytest.mark.parametrize("argv,text", [
    (["--state-file", "{st}"], "--state-file requires --follow"),
    (["--follow", "--standby"], "--standby requires --state-file"),
    (["--follow", "--nmea", "-"], "--nmea needs at least one ais channel"),
])
def test_flag_guards(tmp_path, capsys, argv, text):
    """Both CLIs refuse the same misuse with exit 2 and the same words."""
    path = tmp_path / "cap.cs16"
    np.zeros((1_000, 2), np.int16).tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    argv = [a.format(st=tmp_path / "s.npz") for a in argv]
    errs = {}
    for name, (main, extra) in CLIS.items():
        capsys.readouterr()
        assert main([str(cfg), "--no-warm", *argv, *extra]) == 2
        errs[name] = capsys.readouterr().err.strip().splitlines()[-1]
    assert errs["tpu"] == f"pipeline-tpu: {text}"
    assert errs["torch"] == f"pipeline-torch: {text}"


def test_signal_guard_defers_inside_critical_section():
    g = torch_cli._SignalGuard()
    with pytest.raises(KeyboardInterrupt):
        g.handler(signal.SIGTERM, None)
    g2 = torch_cli._SignalGuard()
    with g2.defer():
        g2.handler(signal.SIGTERM, None)   # only flags
        assert g2.pending
    with pytest.raises(KeyboardInterrupt):
        g2.handler(signal.SIGTERM, None)


def test_check_resume_offset_matches_pipeline_tpu(tmp_path, capsys):
    path = tmp_path / "cap.cs16"
    path.write_bytes(b"\x00" * 400)     # 100 cs16 samples, 200 cs8
    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)
    for p, fmt, n in ((path, "cs16", 50), (path, "cs16", 1000),
                      (path, "cs8", 150), (path, "cs8", 500),
                      (fifo, "cs16", 10**9), (tmp_path / "gone", "cs16", 7)):
        want = jax_cli._check_resume_offset(str(p), fmt, n)
        assert torch_cli._check_resume_offset(str(p), fmt, n) == want
    assert [torch_cli._check_resume_offset(str(path), "cs16", n)
            for n in (50, 1000)] == [50, 0]
    assert "restarting from the beginning" in capsys.readouterr().err


def test_stats_line(tmp_path, capsys):
    path = tmp_path / "cap.cs16"
    np.random.default_rng(3).integers(
        -300, 300, size=(2_000_000, 2)).astype(np.int16).tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    assert torch_cli.main([str(cfg), "--follow", "--idle-exit", "0.2",
                           "--block-size", "262144", "--stats", "0.0001",
                           "--device", "cpu", "-o",
                           str(tmp_path / "m.jsonl")]) == 0
    err = capsys.readouterr().err
    assert "pipeline-torch: stats samples_in=" in err, err
    assert "Msps]" in err and "blocks=" in err and "fetched=" in err, err


def test_realtime_pacing_and_iq_dump(tmp_path):
    """--realtime paces delivery at sampleRateHz (file_if.c:160-203) and
    --iq-dump taps the ingested IQ byte for byte."""
    iq = np.random.default_rng(7).integers(
        -300, 300, size=(900_000, 2)).astype(np.int16)
    path = tmp_path / "cap.cs16"
    iq.tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    dump = tmp_path / "tap.cs16"
    t0 = time.monotonic()
    assert torch_cli.main([str(cfg), "--follow", "--realtime", "--no-warm",
                           "--idle-exit", "0.2", "--block-size", "262144",
                           "--iq-dump", str(dump), "--device", "cpu", "-o",
                           str(tmp_path / "m.jsonl")]) == 0
    assert time.monotonic() - t0 >= len(iq) / FS
    np.testing.assert_array_equal(np.fromfile(dump, np.int16).reshape(-1, 2),
                                  iq)


def _standby(cfg, state, out, extra=()):
    rc = []
    t = threading.Thread(target=lambda: rc.append(torch_cli.main(
        [str(cfg), "--follow", "--idle-exit", "0.5", "--block-size",
         "393216", "--state-file", str(state), "--standby", "--device",
         "cpu", "-o", str(out), *extra])), daemon=True)
    t.start()
    return t, rc


def test_standby_failover(tmp_path, two_bursts):
    """The standby leg warms, waits for the primary's checkpoint, restores
    and streams on: the two legs' messages are one uninterrupted run's."""
    iq, want = two_bursts
    half = len(iq) // 2
    path = tmp_path / "cap.cs16"
    iq[:half].tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    state = tmp_path / "state.npz"
    standby, sb_rc = _standby(cfg, state, tmp_path / "m2.jsonl")
    time.sleep(0.3)
    assert not state.exists() and standby.is_alive()
    assert torch_cli.main([str(cfg), "--follow", "--idle-exit", "0.3",
                           "--block-size", "393216", "--state-file",
                           str(state), "--device", "cpu", "-o",
                           str(tmp_path / "m1.jsonl")]) == 0
    with open(path, "ab") as f:
        iq[half:].tofile(f)
    standby.join(timeout=120)
    assert not standby.is_alive() and sb_rc == [0]
    got = _lines(tmp_path / "m1.jsonl") + _lines(tmp_path / "m2.jsonl")
    assert _pairs(got) == want


def test_standby_fresh_takeover(tmp_path):
    """A supervisor that saw the primary die without a checkpoint touches
    <state-file>.takeover: the standby starts fresh on the stream."""
    iq = _two_bursts(13, [(444, "FRESH TAKEOVER")])
    path = tmp_path / "cap.cs16"
    iq.tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    state = tmp_path / "state.npz"
    standby, sb_rc = _standby(cfg, state, tmp_path / "m.jsonl",
                              ["--no-warm"])
    time.sleep(0.5)
    assert standby.is_alive()      # still waiting: no trigger yet
    (tmp_path / "state.npz.takeover").touch()
    standby.join(timeout=120)
    assert not standby.is_alive() and sb_rc == [0]
    assert not (tmp_path / "state.npz.takeover").exists()
    assert _pairs(_lines(tmp_path / "m.jsonl")) == [
        (444, pocsag_gen.expected_alpha_decode(b"FRESH TAKEOVER").decode())]


def test_nmea_under_follow(tmp_path):
    """--nmea with --follow: the same AIVDM sentences and JSON lines as
    pipeline-tpu (after tests/test_pipeline_stream.py:1020)."""
    decim = 24
    fs = 51_200 * decim     # 51,200 Hz channels -> AIS 48 kHz is 15/16
    center = 161_900_000
    pkt = ais_gen.make_position_report(366778899, latitude=48.5,
                                       longitude=-124.75)
    bb = ais_gen.generate([pkt], amplitude=9000)
    sig = fm_mod(bb, 48_000, 75_000, fs, amp=7000, dev_hz=4800)
    iq = np.concatenate([np.zeros((400_000, 2)), sig,
                         np.zeros((400_000, 2))])
    iq += np.random.default_rng(3).normal(scale=60, size=iq.shape)
    path = tmp_path / "cap.cs16"
    iq.astype(np.int16).tofile(path)
    cfg = _config(tmp_path, "p", path,
                  [{"protocol": "ais", "chanCenterFreq": center + 75_000}],
                  lpf=firdes_low_pass(1.0, fs, 24_000, 14_000), fs=fs,
                  decim=decim, center=center)
    out = {}
    for name, (main, extra) in CLIS.items():
        nmea = tmp_path / f"{name}.nmea"
        assert main([str(cfg), "--follow", "--idle-exit", "0.2", "-o",
                     str(tmp_path / f"{name}.jsonl"), "--nmea", str(nmea),
                     *extra]) == 0
        out[name] = (_lines(tmp_path / f"{name}.jsonl"), nmea.read_text())
    assert out["torch"] == out["tpu"]
    lines, nmea = out["torch"]
    assert [json.loads(x)["mmsi"] for x in lines] == [366778899]
    assert nmea.startswith("!AIVDM,1,1,,A,") and nmea.count("\n") == 1


@pytest.mark.parametrize("kind", ["reshaped", "no_buf"])
def test_state_file_with_bad_arrays_is_set_aside(tmp_path, capsys,
                                                 two_bursts, kind):
    """A state file whose arrays do not match its metadata (one reshaped,
    or the input buffer missing) is moved to .bad, and the run decodes
    exactly as a run without a state file."""
    from tests.test_torch_stream_engine import _corrupt_checkpoint

    iq, want = two_bursts
    path = tmp_path / "cap.cs16"
    iq.tofile(path)
    cfg = _config(tmp_path, "p", path, ONE)
    # a real checkpoint of this configuration, then corrupted
    pipe = tpipe.ReceivePipeline(
        LPF, CENTER, FS, DECIM, [tpipe.ChannelSpec(CENTER + 250_000,
                                                   "pocsag")],
        device="cpu", block_size=393_216)
    pipe.push(iq[:1_000_000])
    pipe.checkpoint_stream(tmp_path / "good.npz")
    state = tmp_path / "s.npz"
    _corrupt_checkpoint(tmp_path / "good.npz", state, kind)
    common = [str(cfg), "--follow", "--idle-exit", "0.2", "--block-size",
              "393216", "--device", "cpu"]
    assert torch_cli.main([*common, "--state-file", str(state), "-o",
                           str(tmp_path / "with.jsonl")]) == 0
    assert "state file unusable" in capsys.readouterr().err
    assert (tmp_path / "s.npz.bad").exists()
    assert torch_cli.main([*common, "-o", str(tmp_path / "without.jsonl")]) \
        == 0
    # the state-file leg saves its partial block instead of flushing it;
    # both bursts lie in its whole blocks
    with_ = _lines(tmp_path / "with.jsonl")
    assert with_ == _lines(tmp_path / "without.jsonl")
    assert _pairs(with_) == want
