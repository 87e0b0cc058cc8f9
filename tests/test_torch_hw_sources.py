"""The port's hardware sources on the port's mock radios against the JAX
package's sources on its mocks (after tests/test_hw_sources.py).

Bars: the same blocks, value for value, and the same settings recorded by
the mocks; ``pipeline-torch --follow`` on the mock RTL-SDR writes the same
JSON lines as ``pipeline-tpu --follow`` (the wall-clock ``timestamp``
blanked). The JAX mocks are compiled here from their C sources into the
test's temporary directory, so no build writes into the JAX package.
"""

import ctypes
import ctypes.util
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from tsl_sdr_tpu.cli import pipeline as jax_cli
from tsl_sdr_tpu.sources import hw as jhw
from tsl_sdr_tpu.testing import mock_radios as jax_mocks
from tsl_sdr_tpu_torch.cli import pipeline as torch_cli
from tsl_sdr_tpu_torch.sources import hw as thw
from tsl_sdr_tpu_torch.sources.airspy import AirspyConfig
from tsl_sdr_tpu_torch.sources.rtl_sdr import RtlSdrConfig, e4000_if_gain_plan
from tsl_sdr_tpu_torch.sources.rtl_sdr import test_mode_pattern as counter
from tsl_sdr_tpu_torch.sources.uhd import UhdConfig, UhdGainElement
from tsl_sdr_tpu_torch.testing import mock_radios, pocsag_gen
from tsl_sdr_tpu_torch.utils.config import MultifmConfig
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="no C toolchain for the mock radios")

ENV = mock_radios.ENV_VARS


@pytest.fixture(scope="module")
def jax_mock(tmp_path_factory):
    """kind -> path of the JAX package's mock library, built here."""
    out = tmp_path_factory.mktemp("jax_mocks")
    src_dir = Path(jax_mocks.__file__).resolve().parent
    paths = {}
    for kind in ENV:
        so = out / f"libmock_{kind}.so"
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-pthread", "-o",
                        str(so), str(src_dir / f"mock_{kind}.c")],
                       check=True, capture_output=True)
        paths[kind] = so
    return paths


def _blocks(monkeypatch, kind, lib, make, open_args):
    monkeypatch.setenv(ENV[kind], str(lib))
    src = make()
    src.open(*open_args)
    src.set_mute(False)
    src.start()
    blocks = list(src.blocks())
    src.stop()
    return blocks, src.stats


@pytest.mark.parametrize("kind", ["rtlsdr", "rtlsdr_file", "airspy", "uhd"])
def test_sources_deliver_what_the_jax_sources_do(monkeypatch, tmp_path,
                                                 jax_mock, kind):
    """RTL-SDR test-mode counter and file stream (u8 widened to Q.14),
    Airspy CS16 ramp, UHD ramp in 16 Ki-sample buffers."""
    monkeypatch.delenv("MOCK_RTLSDR_DATA", raising=False)
    lib_kind = "rtlsdr" if kind.startswith("rtlsdr") else kind
    if kind == "rtlsdr":
        cfgs = (jhw.RtlSdrConfig(db_gain_lna=32.8, ppm_correction=12,
                                 test_mode=True),
                RtlSdrConfig(db_gain_lna=32.8, ppm_correction=12,
                             test_mode=True))
        makes = (lambda: jhw.RtlSdrSource(cfgs[0], depth=64),
                 lambda: thw.RtlSdrSource(cfgs[1], depth=64))
        open_args = (1_000_000, 929_500_000)
    elif kind == "rtlsdr_file":
        raw = np.random.default_rng(3).integers(0, 256, size=500_000)
        raw.astype(np.uint8).tofile(tmp_path / "cap.u8")
        monkeypatch.setenv("MOCK_RTLSDR_DATA", str(tmp_path / "cap.u8"))
        makes = (lambda: jhw.RtlSdrSource(jhw.RtlSdrConfig()),
                 lambda: thw.RtlSdrSource(RtlSdrConfig()))
        open_args = (1_000_000, 100_000_000)
    elif kind == "airspy":
        monkeypatch.setenv("MOCK_AIRSPY_BLOCKS", "4")
        makes = (lambda: jhw.AirspySource(jhw.AirspyConfig(11, 9, 13, True),
                                          depth=32),
                 lambda: thw.AirspySource(AirspyConfig(11, 9, 13, True),
                                          depth=32))
        open_args = (3_000_000, 162_000_000)
    else:
        monkeypatch.setenv("MOCK_UHD_SAMPS", str(3 * 16384 + 5000))
        gains = [UhdGainElement("PGA", 20.5), UhdGainElement("LNA", 12.0)]
        makes = (lambda: jhw.UhdSource(jhw.UhdConfig("type=b200", 0, "TX/RX",
                                                     gains), depth=32),
                 lambda: thw.UhdSource(UhdConfig("type=b200", 0, "TX/RX",
                                                 gains), depth=32))
        open_args = (2_500_000, 915_000_000)
    want, want_stats = _blocks(monkeypatch, lib_kind, jax_mock[lib_kind],
                               makes[0], open_args)
    got, stats = _blocks(monkeypatch, lib_kind,
                         mock_radios.build(lib_kind), makes[1], open_args)
    assert [b.size for b in got] == [b.size for b in want] and want
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    assert stats == want_stats and stats["dropped"] == 0
    if kind == "rtlsdr":
        vals = np.concatenate(got)
        np.testing.assert_array_equal(
            vals, ((counter(vals.size).astype(np.int16) - 127)
                   << 7).astype(np.int16))
        lib = ctypes.CDLL(str(mock_radios.build("rtlsdr")))
        lib.mock_rtlsdr_center_freq.restype = ctypes.c_uint32
        assert lib.mock_rtlsdr_center_freq() == 929_500_000
        assert lib.mock_rtlsdr_tuner_gain() == 328
        assert lib.mock_rtlsdr_freq_corr() == 12
    if kind == "uhd":
        assert [b.size // 2 for b in got] == [16384] * 3 + [5000]


def test_e4000_if_ladder_and_mute(monkeypatch):
    monkeypatch.setenv(ENV["rtlsdr"], str(mock_radios.build("rtlsdr")))
    monkeypatch.setenv("MOCK_RTLSDR_TUNER", "1")   # E4000
    monkeypatch.delenv("MOCK_RTLSDR_DATA", raising=False)
    src = thw.RtlSdrSource(RtlSdrConfig(db_gain_lna=20.0, db_gain_if=19.0,
                                        test_mode=True))
    src.open(2_400_000, 100_000_000)
    src.start()                  # never unmuted: everything is discarded
    assert list(src.blocks()) == []
    src.stop()
    assert src.stats["delivered"] == 0
    lib = ctypes.CDLL(str(mock_radios.build("rtlsdr")))
    stages, _ = e4000_if_gain_plan(190)
    assert [lib.mock_rtlsdr_if_gain(i) for i in range(1, 7)] == stages


def test_ingest_queue_drops_and_counts():
    q = thw.HwIngestQueue(depth=2)
    q.muted = False
    for k in range(5):
        q.deliver(np.full(4, k, np.int16))
    q.eof()
    got = list(q)
    assert [int(b[0]) for b in got] == [0, 1]
    assert (q.delivered, q.dropped) == (2, 3)


def test_missing_library_gives_the_gated_error(monkeypatch):
    monkeypatch.delenv(ENV["uhd"], raising=False)
    if ctypes.util.find_library("uhd") is None:
        # no libuhd: the shim's build fails with the stream-a-capture hint
        with pytest.raises(thw.HwLibraryMissing, match="stream a capture"):
            thw.UhdSource(UhdConfig())
    monkeypatch.setenv(ENV["rtlsdr"], "/nonexistent/libno.so")
    with pytest.raises(thw.HwLibraryMissing, match="failed to load"):
        thw.RtlSdrSource(RtlSdrConfig())
    monkeypatch.delenv(ENV["rtlsdr"])
    monkeypatch.setattr("ctypes.util.find_library", lambda name: None)
    with pytest.raises(thw.HwLibraryMissing, match="stream a capture"):
        thw.RtlSdrSource(RtlSdrConfig())


def test_make_hw_source_and_pairs():
    cfg = MultifmConfig.from_dict({
        "device": {"type": "file", "filename": "x"}, "sampleRateHz": 1e6,
        "centerFreqHz": 1e8, "decimationFactor": 10, "lpfTaps": [1.0],
        "channels": [{"chanCenterFreq": 1e8, "outFifo": "y"}]})
    assert thw.make_hw_source(cfg, "file") is None
    blocks = [np.arange(3, dtype=np.int16), np.arange(3, 8, dtype=np.int16),
              np.arange(8, 9, dtype=np.int16)]
    got = list(thw.pairs(blocks))
    assert [b.tolist() for b in got] == [[[0, 1]], [[2, 3], [4, 5], [6, 7]]]


def _rtl_capture(tmp_path):
    """One POCSAG burst as RTL-SDR u8 wire bytes (after
    tests/test_hw_sources.py:353)."""
    decim, offset = 32, 150_000
    fs = 38_400 * decim
    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=246802, function=1, kind="alpha",
                                content="LIVE HW PIPE")],
        baud=1200, amplitude=4096, tail_bits=512)
    dev = bb.astype(np.float64) / 16384.0 * (38_400 / 2)
    phase = np.cumsum(np.repeat(2 * np.pi * (offset + dev) / fs, decim))
    iq = np.stack([np.cos(phase), np.sin(phase)], -1)
    u8 = np.clip(np.round(iq * 100 + 127), 0, 255).astype(np.uint8)
    u8.tofile(tmp_path / "wire.u8")
    cfg = {
        "device": {"type": "rtlsdr", "deviceIndex": 0, "dBGainLNA": 32.8},
        "sampleRateHz": fs, "centerFreqHz": 929_500_000,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, firdes_low_pass(1.0, fs, 9_600, 7_000))),
        "channels": [{"chanCenterFreq": 929_500_000 + offset,
                      "protocol": "pocsag"}],
    }
    (tmp_path / "hw.json").write_text(json.dumps(cfg))
    return tmp_path / "hw.json"


def test_follow_on_mock_rtlsdr_matches_pipeline_tpu(monkeypatch, tmp_path,
                                                    jax_mock):
    cfg = _rtl_capture(tmp_path)
    monkeypatch.setenv("MOCK_RTLSDR_DATA", str(tmp_path / "wire.u8"))
    out = {}
    for name, main, lib, extra in (
            ("tpu", jax_cli.main, jax_mock["rtlsdr"], []),
            ("torch", torch_cli.main, mock_radios.build("rtlsdr"),
             ["--device", "cpu"])):
        monkeypatch.setenv(ENV["rtlsdr"], str(lib))
        assert main([str(cfg), "--follow", "-o",
                     str(tmp_path / f"{name}.jsonl"), *extra]) == 0
        out[name] = [json.loads(x) for x in
                     (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        for m in out[name]:
            m.pop("timestamp")
    assert out["torch"] == out["tpu"]
    want = pocsag_gen.expected_alpha_decode(b"LIVE HW PIPE").decode()
    assert [(m["capCode"], m["message"], m["freqHz"])
            for m in out["torch"]] == [(246802, want, 929_650_000)]


def test_follow_without_the_radio_library_exits_2(monkeypatch, tmp_path,
                                                   capsys):
    cfg = _rtl_capture(tmp_path)
    monkeypatch.setenv(ENV["rtlsdr"], "/nonexistent/libno.so")
    assert torch_cli.main([str(cfg), "--follow", "--device", "cpu"]) == 2
    assert "pipeline-torch: failed to load" in capsys.readouterr().err
