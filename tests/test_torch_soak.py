"""The port's soaks (``bench/torch_soak_pipeline.py``,
``bench/torch_soak_deployment.py``) and its version stamp
(``tsl_sdr_tpu_torch/_version.py``) against the JAX package's
(``bench/soak_pipeline.py``, ``bench/soak_deployment_tpu.py``,
``tsl_sdr_tpu/_version.py``), on the CPU.

Bars: the pipeline soak's captures equal the JAX soak's byte for byte;
on seeds 0-1 of each tier the port's engine, the port's host path, and
the JAX package's engine and host path decode the same messages; the
soak fails on a dropped message or a seed that decoded nothing. The
deployment soak's paced writer writes the JAX writer's bytes, its legs
run the JAX legs' arguments (but for the module and ``--device``), and
its result arithmetic gives hand-worked values. The version resolves as
the JAX package's does.
"""

import importlib.util
import os
import runpy
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def soak():
    return _load(BENCH / "torch_soak_pipeline.py", "torch_soak_pipeline")


@pytest.fixture(scope="module")
def deploy():
    return _load(BENCH / "torch_soak_deployment.py", "torch_soak_deployment")


@pytest.fixture(scope="module")
def jax_deploy():
    # the JAX soak sets JAX_COMPILATION_CACHE_DIR on import: keep it out of
    # the environment the rest of the run sees
    saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    try:
        return _load(BENCH / "soak_deployment_tpu.py", "jax_soak_deployment")
    finally:
        if saved is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved


# -- the pipeline soak --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_captures():
    """The channel mixes and captures ``bench/soak_pipeline.py``'s own
    ``main`` hands ``ReceivePipeline`` for seeds 0-3 (a stub that records
    them and decodes nothing)."""
    jax_soak = _load(BENCH / "soak_pipeline.py", "jax_soak_pipeline")
    seen = []

    class Recorder:
        def __init__(self, lpf, center, fs, decim, specs, **kw):
            self.specs = specs

        def _record(self, iq):
            seen.append(([s.protocol for s in self.specs],
                         [s.center_freq_hz - jax_soak.CENTER
                          for s in self.specs], np.array(iq)))
            return [[] for _ in self.specs]

        def _process_capture_host(self, iq, device_decode=False):
            return self._record(iq)

        process_capture = _record

    jax_soak.ReceivePipeline = Recorder
    assert jax_soak.main(4) == 1        # nothing decoded: every seed fails
    assert len(seen) == 8               # host path and engine, each seed
    for a, b in zip(seen[::2], seen[1::2]):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2])
    return seen[::2]


@pytest.mark.parametrize("seed", range(4))
def test_capture_equals_jax_soak(soak, jax_captures, seed):
    protos, offs, iq = soak.capture(seed)
    want_protos, want_offs, want_iq = jax_captures[seed]
    assert (protos, offs) == (want_protos, want_offs)
    assert soak.channels(seed) == (protos, offs)
    assert iq.dtype == want_iq.dtype == np.int16
    assert iq.shape == want_iq.shape
    assert iq.tobytes() == want_iq.tobytes()


def _jax_seed(soak, seed: int, exact: bool):
    """The JAX package's ReceivePipeline on the soak's seed: (engine,
    host path), as the soak keys them; the exact engine pushed at the
    split points the port's soak draws."""
    from tsl_sdr_tpu.models import pipeline as jpipe
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    rng, protos, offs, iq = soak._capture(seed)
    specs = [jpipe.ChannelSpec(soak.CENTER + o, p)
             for p, o in zip(protos, offs)]

    def pipe():
        return jpipe.ReceivePipeline(
            firdes_low_pass(1.0, soak.FS, 12_000, 8_000), soak.CENTER,
            soak.FS, soak.DECIM, specs, exact=exact,
            block_size=soak.BLOCK_SIZE)

    host = soak._keys(pipe()._process_capture_host(iq, device_decode=False))
    engine = pipe()
    if not exact:
        return soak._keys(engine.process_capture(iq)), host
    got = [[] for _ in specs]
    i0 = 0
    while i0 < len(iq):
        ln = int(rng.integers(50_000, 400_000))
        for c, part in enumerate(engine.push(iq[i0 : i0 + ln])):
            got[c].extend(part)
        i0 += ln
    for c, part in enumerate(engine.flush()):
        got[c].extend(part)
    return soak._keys(got), host


@pytest.mark.parametrize("exact", [False, True], ids=["fused", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_seed_matches_host_path_and_jax(soak, seed, exact):
    got, want = soak.run_seed(seed, exact=exact, device="cpu")
    assert sum(map(len, want)) > 0
    assert got == want
    jax_engine, jax_host = _jax_seed(soak, seed, exact)
    assert got == jax_engine == jax_host


def test_main_passes_and_prints_the_jax_lines(soak, capsys):
    assert soak.main(1, device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "seed 0: ['flex', 'ais'] -> fused 2, host 2 [OK]"
    assert out[-1] == "fails: 0"


def test_main_fails_when_the_engine_drops_a_message(soak, monkeypatch,
                                                    capsys):
    real = soak.ReceivePipeline.process_capture
    calls = []

    def dropping(self, iq, **kw):
        res = real(self, iq, **kw)
        calls.append(1)
        if len(calls) == 2:              # seed 1's engine loses a message
            ch = next(i for i, m in enumerate(res) if m)
            res[ch] = res[ch][:-1]
        return res

    monkeypatch.setattr(soak.ReceivePipeline, "process_capture", dropping)
    assert soak.main(2, device="cpu") == 1
    out = capsys.readouterr().out
    assert "seed 0: ['flex', 'ais'] -> fused 2, host 2 [OK]" in out
    assert "-> fused 2, host 3 [DIFF]" in out
    assert out.splitlines()[-1] == "fails: 1"


def test_main_fails_on_a_seed_that_decoded_nothing(soak, monkeypatch,
                                                   capsys):
    def nothing(self, iq, **kw):
        return [[] for _ in self.channels]

    monkeypatch.setattr(soak.ReceivePipeline, "process_capture", nothing)
    monkeypatch.setattr(soak.ReceivePipeline, "_process_capture_host",
                        nothing)
    assert soak.main(1, device="cpu") == 1
    assert "-> fused 0, host 0 [DIFF]" in capsys.readouterr().out


# -- the deployment soak ------------------------------------------------------

def test_paced_writer_second_matches_jax(deploy, jax_deploy, tmp_path):
    ours = deploy.PacedWriter(str(tmp_path / "fifo"), 0)
    theirs = jax_deploy.PacedWriter(str(tmp_path / "fifo"), 0)
    for seq in range(3):
        a, b = ours._second(seq), theirs._second(seq)
        assert a.dtype == b.dtype == np.int16
        assert a.shape == b.shape == (deploy.FS, 2)
        assert a.tobytes() == b.tobytes()


def test_soak_constants_match_jax(deploy, jax_deploy):
    for name in ("DECIM", "CHANNEL_RATE", "FS", "CENTER", "OFFSETS", "BAUD",
                 "BLOCK_TARGET", "INFLIGHT_DEPTH"):
        assert getattr(deploy, name) == getattr(jax_deploy, name), name


@pytest.mark.parametrize("standby", [False, True],
                         ids=["primary", "standby"])
def test_leg_argv_matches_jax(deploy, jax_deploy, monkeypatch, standby):
    seen = []

    def popen(argv, **kw):
        seen.append(list(argv))
        return types.SimpleNamespace()

    monkeypatch.setattr(jax_deploy.subprocess, "Popen", popen)
    paths = ("cfg.json", "iq.fifo", "out.jsonl", "state.npz")
    jax_deploy.launch_pipeline(*paths, standby=standby)
    want = seen[0]
    assert want[:3] == [sys.executable, "-m", "tsl_sdr_tpu.cli.pipeline"]
    got = deploy.leg_argv(*paths, standby=standby, device="cuda:0")
    assert got[0] == "tsl_sdr_tpu_torch.cli.pipeline"
    assert got[-2:] == ["--device", "cuda:0"]
    assert got[1:-2] == want[3:]
    assert deploy.python_m(got) == [sys.executable, "-m", *got]


def test_summarize_by_hand(deploy):
    # SIGTERM at 104.5, the standby took over at 105.0; its first decode
    # (106.5) ends the outage. The window is [102.5, 106.5]: seqs 9 (at
    # its padded start), 3, 4, 5 and 6 are inside it.
    write = {0: 100.0, 1: 101.0, 2: 102.0, 9: 102.5, 3: 103.0, 4: 104.0,
             5: 105.0, 6: 106.0, 7: 107.0, 8: 109.0}
    decode = {0: 101.5, 1: 102.5, 2: 103.5, 4: 106.5, 6: 107.0, 7: 108.5}
    events = [("warmup", 0.0, 0, 12.5), ("start", 1.0), ("sigterm", 104.5),
              ("checkpointed", 105.0, 0, True), ("resumed", 105.0)]
    lines = ["pipeline-torch: device warm in 3.5s", "stats a",
             "pipeline-torch: device warm in 0.4s", "b", "c", "d", "e", "f"]
    res = deploy.summarize(write, decode, 104.5, 105.0, minutes=1.5,
                           achieved_sps=1_228_000.0, block_s=1.25,
                           reopens=1, events=events, warm_s=12.5,
                           stderr_lines=lines, kill_resume_ok=True)
    assert res == {
        "minutes": 1.5,
        "offered_msps": 1.2288,
        "achieved_msps": 1.228,
        "bursts_written": 10,
        "bursts_decoded": 6,
        "outage_s": 2.0,                  # 106.5 - 104.5
        "bursts_lost_in_outage": 3,       # seqs 9, 3, 5
        "bursts_lost_outside": 1,         # seq 8
        "decode_pct_outside_outage": 80.0,    # seqs 0, 1, 2, 7 of those + 8
        "fifo_reopens": 1,
        "block_s": 1.25,
        # latencies 1.5, 1.5, 1.5, 2.5, 1.0, 1.5 -> sorted, n 6: p50 is
        # index 3, p90 index 5, max index 5
        "latency_s": {"p50": 1.5, "p90": 2.5, "max": 2.5, "n": 6},
        "latency_block_times": {"p50": 1.2, "p90": 2.0},
        "events": ["warmup", "start", "sigterm", "checkpointed", "resumed"],
        "warmup_s": 12.5,
        "leg_device_warm_s": [3.5, 0.4],
        "kill_resume_ok": True,
        "takeover_fresh": False,
        "stats_tail": lines[-6:],
    }


def test_summarize_pads_the_window_2_s_back(deploy):
    # one lost burst 2.0 s before the SIGTERM is outage loss, one 2.5 s
    # before is not; a fresh takeover is reported
    write = {0: 97.5, 1: 98.0, 2: 100.0}
    decode = {2: 101.0}
    res = deploy.summarize(write, decode, 100.0, 100.5, minutes=0.1,
                           achieved_sps=0.0, block_s=1.0,
                           events=[("takeover-fresh", 100.2)])
    assert res["outage_s"] == 1.0
    assert (res["bursts_lost_in_outage"], res["bursts_lost_outside"]) == (1, 1)
    assert res["decode_pct_outside_outage"] == 0.0
    assert res["latency_s"] == {"p50": 1.0, "p90": 1.0, "max": 1.0, "n": 1}
    assert res["takeover_fresh"] is True


def test_summarize_without_a_kill(deploy):
    # no SIGTERM: no outage, every lost burst is outside one
    res = deploy.summarize({0: 10.0, 1: 11.0, 2: 12.0}, {0: 11.0, 2: 14.0},
                           None, None, minutes=0.05, achieved_sps=1.0,
                           block_s=2.0)
    assert res["outage_s"] is None
    assert (res["bursts_lost_in_outage"], res["bursts_lost_outside"]) == (0, 1)
    assert res["decode_pct_outside_outage"] == 66.67
    assert res["latency_s"] == {"p50": 2.0, "p90": 2.0, "max": 2.0, "n": 2}
    assert res["latency_block_times"] == {"p50": 1.0, "p90": 1.0}
    empty = deploy.summarize({}, {}, None, None, minutes=0, achieved_sps=0,
                             block_s=1.0)
    assert empty["latency_s"]["p50"] is None
    assert empty["latency_block_times"] == {"p50": None, "p90": None}


# -- the version stamp --------------------------------------------------------

def test_version_resolves_stamp_then_git_then_base(monkeypatch):
    from tsl_sdr_tpu_torch import _version

    monkeypatch.setitem(sys.modules, "tsl_sdr_tpu_torch._version_stamp",
                        types.SimpleNamespace(version="7.7.7+gstamp"))
    assert _version.resolve_version() == "7.7.7+gstamp"
    monkeypatch.setitem(sys.modules, "tsl_sdr_tpu_torch._version_stamp",
                        None)
    monkeypatch.setattr(_version, "git_describe", lambda: "v1.2.3-4-gabc123")
    assert _version.resolve_version() == "1.2.3.post4+gabc123"
    monkeypatch.setattr(_version, "git_describe", lambda: None)
    assert _version.resolve_version() == _version.BASE_VERSION == "0.1.0"


@pytest.mark.parametrize("desc", ["v0.1.0", "v0.1.0-3-gabc123",
                                  "v0.1.0-0-gabc123-dirty", "abc123",
                                  "abc123-dirty", "2.0-12-g0fe1d2c-dirty"])
def test_describe_to_pep440_matches_jax(desc):
    from tsl_sdr_tpu import _version as jax_version
    from tsl_sdr_tpu_torch import _version

    assert _version.describe_to_pep440(desc) == \
        jax_version.describe_to_pep440(desc)


def test_package_version_follows_version_module():
    import tsl_sdr_tpu
    import tsl_sdr_tpu_torch
    from tsl_sdr_tpu_torch import _version
    from tsl_sdr_tpu_torch.cli import cli_version

    assert "__version__" not in vars(tsl_sdr_tpu_torch)   # resolved lazily
    assert tsl_sdr_tpu_torch.__version__ == _version.__version__
    assert _version.git_describe(str(ROOT)) == _version.git_describe()
    if not (ROOT / "tsl_sdr_tpu_torch" / "_version_stamp.py").exists() \
            and not (ROOT / "tsl_sdr_tpu" / "_version_stamp.py").exists():
        # one checkout, one git describe: the two packages agree
        assert tsl_sdr_tpu_torch.__version__ == tsl_sdr_tpu.__version__
    assert cli_version().startswith(tsl_sdr_tpu_torch.__version__)


def test_setup_stamps_both_packages(monkeypatch, tmp_path):
    import setuptools

    monkeypatch.setattr(setuptools, "setup", lambda **kw: None)
    ns = runpy.run_path(str(ROOT / "setup.py"))
    assert ns["STAMPED"] == ("tsl_sdr_tpu", "tsl_sdr_tpu_torch")
    for pkg in ns["STAMPED"]:
        ns["_write_stamp"](str(tmp_path / pkg), "9.8.7+gfeed")
        stamp = runpy.run_path(str(tmp_path / pkg / "_version_stamp.py"))
        assert stamp["version"] == "9.8.7+gfeed"
    assert "tsl_sdr_tpu_torch/_version_stamp.py" in \
        (ROOT / ".gitignore").read_text().splitlines()


def test_paced_writer_streams_its_seconds_then_a_noise_tail(deploy,
                                                            jax_deploy,
                                                            tmp_path):
    """Through a real FIFO: the burst seconds the JAX writer makes, paced,
    then ``TAIL_S`` seconds of noise with no write time of their own."""
    import threading

    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)
    got = bytearray()

    def read():
        with open(fifo, "rb") as f:
            while chunk := f.read(1 << 20):
                got.extend(chunk)

    reader = threading.Thread(target=read)
    reader.start()
    writer = deploy.PacedWriter(str(fifo), 0.5)
    writer.start()
    writer.join(timeout=60)
    reader.join(timeout=60)
    assert not writer.is_alive() and not reader.is_alive()
    second = deploy.FS * 4
    theirs = jax_deploy.PacedWriter(str(fifo), 0)
    assert sorted(writer.write_times) == [0, 1] == list(range(writer.n_seq))
    assert deploy.TAIL_S == 2
    assert writer.bytes_written == len(got) == 4 * second
    assert bytes(got[:2 * second]) == \
        theirs._second(0).tobytes() + theirs._second(1).tobytes()
    tail = np.frombuffer(bytes(got[2 * second:]), np.int16)
    assert 80 < tail.std() < 100        # noise at the writer's scale 90
    assert writer.t_end - writer.t_start >= 3.0     # paced: tail at 2, 3 s
