"""multifm-torch against multifm-tpu on the same captures, on the CPU
(the port's counterparts of tests/test_cli.py's and
tests/test_hw_sources.py's multifm tests).

Bars:
- ``--exact``: every channel's PCM file BYTE-EQUAL to multifm-tpu's, under
  both I/O runtimes (the bit-exact tier's contract);
- the production tier: within 1 PCM LSB of multifm-tpu's XLA tier, the +-pi
  phase wrap folded (the chain's bound, tests/test_torch_chain.py), same
  length, under both runtimes;
- every channel's PCM decodes its burst (the port's POCSAG decoder);
- the startup mute, ``signalDebugFile`` (the exact tier's IQ byte-equal,
  the production tier's within 1 LSB: its NCO's cos/sin may differ from
  XLA's by an ulp, which can flip a truncation), ``--iq-dump`` (byte-equal),
  the hardware gate (exit 2) and the mock RTL-SDR device;
- the same two bars on a 64-channel bank, where both packages take the
  phase-grouped form of the FIR.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from tsl_sdr_tpu.cli import multifm as jax_cli
from tsl_sdr_tpu_torch.cli import multifm as torch_cli
from tsl_sdr_tpu_torch.models.pocsag import PocsagDecoder
from tsl_sdr_tpu_torch.testing import mock_radios, pocsag_gen
from tsl_sdr_tpu_torch.testing.pager import fm_mod
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

DECIM = 32
FS = 38_400 * DECIM
CENTER = 929_500_000
OFFSETS = (150_000, -210_000)
MSGS = ((888_001, "MULTIFM ONE"), (888_002, "MULTIFM TWO"))


def _lsb_diff(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return np.minimum(d, 32768 - d)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """Two NBFM POCSAG channels (one burst each) in a cs16 capture."""
    tmp = tmp_path_factory.mktemp("multifm")
    parts = []
    for off, (cap, text) in zip(OFFSETS, MSGS):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        parts.append(fm_mod(bb, 38_400, off, FS, amp=6000))
    iq = np.zeros((max(map(len, parts)) + 40_000, 2))
    for k, p in enumerate(parts):
        iq[20_000 * k:20_000 * k + len(p)] += p
    rng = np.random.default_rng(9)
    iq = np.clip(np.round(iq + rng.normal(scale=80, size=iq.shape)),
                 -32768, 32767).astype(np.int16)
    path = tmp / "cap.cs16"
    iq.reshape(-1).tofile(path)
    return {"iq": iq, "path": path}


def _config(tmp_path, name, capture, **extra):
    cfg = {
        "device": {"type": "file", "filename": str(capture["path"]),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, firdes_low_pass(1.0, FS, 9_600, 7_000))),
        "channels": [{"outFifo": str(tmp_path / f"{name}_ch{k}.pcm"),
                      "chanCenterFreq": CENTER + off}
                     for k, off in enumerate(OFFSETS)],
    }
    cfg.update(extra)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def _run_both(tmp_path, capture, flags, **extra):
    """Run multifm-tpu and multifm-torch (--device cpu) with ``flags``;
    returns {name: [channel PCM arrays]}."""
    out = {}
    for name, main in (("tpu", jax_cli.main), ("torch", torch_cli.main)):
        cfg = _config(tmp_path, name, capture, **extra)
        argv = [str(cfg), "--block-size", "131072", *flags]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        out[name] = [np.fromfile(tmp_path / f"{name}_ch{k}.pcm", np.int16)
                     for k in range(len(OFFSETS))]
    return out


def _decoded(pcm):
    return [(m.capcode, m.data.rstrip(b"\0").decode())
            for m in PocsagDecoder().scan(pcm)]


@pytest.mark.parametrize("runtime", ["native", "python"])
def test_exact_pcm_byte_equal(tmp_path, capture, runtime):
    got = _run_both(tmp_path, capture, ["--exact", "--runtime", runtime])
    for k, msg in enumerate(MSGS):
        assert got["torch"][k].size > 0
        assert got["torch"][k].tobytes() == got["tpu"][k].tobytes(), k
        assert _decoded(got["torch"][k]) == [msg]


@pytest.mark.parametrize("runtime", ["native", "python"])
def test_fast_tier_within_one_lsb(tmp_path, capture, runtime):
    got = _run_both(tmp_path, capture, ["--runtime", runtime,
                                        "--backend", "xla"])
    for k, msg in enumerate(MSGS):
        a, b = got["tpu"][k], got["torch"][k]
        assert a.shape == b.shape and a.size > 0
        assert _lsb_diff(a, b).max() <= 1
        assert _decoded(b) == [msg]


def test_startup_mute(tmp_path, capture):
    """muteStartupMs drops the head before any channel output, as
    multifm-tpu does (receiver.h:98), in both runtimes and tiers."""
    for runtime in ("native", "python"):
        got = _run_both(tmp_path, capture,
                        ["--exact", "--runtime", runtime],
                        muteStartupMs=5)
        full = len(capture["iq"]) - FS * 5 // 1000
        for k in range(len(OFFSETS)):
            assert got["torch"][k].tobytes() == got["tpu"][k].tobytes()
            assert got["torch"][k].size <= full // DECIM


@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_signal_debug_file_and_iq_dump(tmp_path, capture, tier):
    flags = ["--exact"] if tier == "exact" else ["--backend", "xla"]
    res = {}
    for name, main in (("tpu", jax_cli.main), ("torch", torch_cli.main)):
        cfg = _config(tmp_path, name, capture)
        doc = json.loads(cfg.read_text())
        doc["channels"][1]["signalDebugFile"] = str(tmp_path / f"{name}.dbg")
        cfg.write_text(json.dumps(doc))
        argv = [str(cfg), "--block-size", "131072", "--runtime", "python",
                "--iq-dump", str(tmp_path / f"{name}.iq"), *flags]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        res[name] = {
            "dbg": np.fromfile(tmp_path / f"{name}.dbg", np.int16),
            "dump": (tmp_path / f"{name}.iq").read_bytes(),
            "pcm": np.fromfile(tmp_path / f"{name}_ch1.pcm", np.int16)}
    tpu, port = res["tpu"], res["torch"]
    assert port["dump"] == tpu["dump"] and len(tpu["dump"]) > 0
    assert port["dbg"].shape == tpu["dbg"].shape
    assert port["dbg"].size == 2 * tpu["pcm"].size > 0
    if tier == "exact":
        assert port["dbg"].tobytes() == tpu["dbg"].tobytes()
        assert port["pcm"].tobytes() == tpu["pcm"].tobytes()
    else:
        assert np.abs(port["dbg"].astype(np.int32) - tpu["dbg"]).max() <= 1
        assert _lsb_diff(port["pcm"], tpu["pcm"]).max() <= 1
    assert _decoded(port["pcm"]) == [MSGS[1]]


WIDE_ETC = Path(__file__).resolve().parents[1] / "etc"
WIDE_OFFSETS = -400_000 + 12_500 * np.arange(64)
WIDE_MSGS = {3: (777_003, "WIDE BANK CH3"), 30: (777_030, "WIDE BANK CH30"),
             57: (777_057, "WIDE BANK CH57")}


def _decoded_25k(pcm):
    """POCSAG messages of 25 kHz channel PCM, resampled 192/125 to the
    decoder's 38,400 Hz on the exact tier."""
    from tsl_sdr_tpu_torch.models.resampler import ResamplerChain
    from tsl_sdr_tpu_torch.utils.config import load_lpf_coeffs

    rs = ResamplerChain(load_lpf_coeffs(
        WIDE_ETC / "pocsag_38400_from_25k.json"), 192, 125, exact=True,
        device="cpu")
    return _decoded(rs.process_array(pcm))


def test_wide_bank_64_channels(tmp_path):
    """etc/multifm_rtlsdr_8ch.json's rate, decimation and 365 taps widened
    to 64 channels, 12.5 kHz apart: the grouped form on both tiers. The
    exact tier's PCM byte-equal to multifm-tpu's on every channel, the
    production tier's within 1 LSB; the three bursts decode."""
    base = json.loads((WIDE_ETC / "multifm_rtlsdr_8ch.json").read_text())
    fs = base["sampleRateHz"]
    sigs = {}
    for k, (cap, text) in WIDE_MSGS.items():
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        sigs[k] = fm_mod(bb, 38_400, WIDE_OFFSETS[k], fs, amp=4000)
    iq = np.random.default_rng(4).normal(
        scale=60, size=(max(map(len, sigs.values())) + 150_000, 2))
    for i, x in enumerate(sigs.values()):
        iq[30_000 * i:30_000 * i + len(x)] += x
    cap_path = tmp_path / "wide.cs16"
    np.clip(np.round(iq), -32768, 32767).astype(np.int16).tofile(cap_path)
    out = {}
    for name, main in (("tpu", jax_cli.main), ("torch", torch_cli.main)):
        cfg = dict(base, device={"type": "file", "filename": str(cap_path),
                                 "fileFormat": "cs16"})
        for tier, flags in (("exact", ["--exact"]),
                            ("fast", ["--backend", "xla"])):
            cfg["channels"] = [
                {"outFifo": str(tmp_path / f"{name}_{tier}_ch{k}.pcm"),
                 "chanCenterFreq": base["centerFreqHz"] + int(off)}
                for k, off in enumerate(WIDE_OFFSETS)]
            path = tmp_path / f"{name}_{tier}.json"
            path.write_text(json.dumps(cfg))
            argv = [str(path), "--runtime", "python", *flags]
            if name == "torch":
                argv += ["--device", "cpu"]
            assert main(argv) == 0
            out[name, tier] = [
                np.fromfile(tmp_path / f"{name}_{tier}_ch{k}.pcm", np.int16)
                for k in range(len(WIDE_OFFSETS))]
    for k in range(len(WIDE_OFFSETS)):
        a, b = out["tpu", "exact"][k], out["torch", "exact"][k]
        assert b.size > 0 and a.tobytes() == b.tobytes(), k
        a, b = out["tpu", "fast"][k], out["torch", "fast"][k]
        assert a.shape == b.shape and _lsb_diff(a, b).max() <= 1, k
    for k, msg in WIDE_MSGS.items():
        assert _decoded_25k(out["torch", "exact"][k]) == [msg]


def test_hardware_gate_and_config_errors(tmp_path, capsys, monkeypatch):
    """A radio device without its driver library, a channel without
    outFifo and a broken config exit 2 with a diagnostic, as multifm-tpu
    does."""
    monkeypatch.setenv("TSL_RTLSDR_LIB", "/nonexistent/libno.so")
    cfg = {"device": {"type": "rtlsdr", "deviceIndex": 0},
           "sampleRateHz": 1_000_000, "centerFreqHz": CENTER,
           "decimationFactor": 40, "lpfTaps": [0.5, 0.5],
           "channels": [{"outFifo": str(tmp_path / "x"),
                         "chanCenterFreq": CENTER + 100_000}]}
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    for main in (jax_cli.main, torch_cli.main):
        assert main([str(p)]) == 2
        assert "failed to load" in capsys.readouterr().err
    cfg["device"] = {"type": "file", "filename": "x", "fileFormat": "cs16"}
    cfg["channels"][0].pop("outFifo")
    p.write_text(json.dumps(cfg))
    assert torch_cli.main([str(p)]) == 2
    assert "no outFifo" in capsys.readouterr().err
    p.write_text("{not json")
    assert torch_cli.main([str(p)]) == 2
    assert "invalid JSON" in capsys.readouterr().err


@pytest.mark.skipif(shutil.which("gcc") is None,
                    reason="no C toolchain for the mock radio")
@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_mock_rtlsdr_device(tmp_path, monkeypatch, capture, tier):
    """An rtlsdr device config on the port's mock librtlsdr, fed the
    capture's rtl_u8 bytes: the same PCM as multifm-tpu's run on the same
    mock and bytes (byte-equal on the exact tier, within 1 LSB on the
    production tier), and every burst decodes."""
    monkeypatch.setenv(mock_radios.ENV_VARS["rtlsdr"],
                       str(mock_radios.build("rtlsdr")))
    wire = tmp_path / "wire.u8"
    np.clip(np.round(capture["iq"] / 128.0) + 127, 0, 255).astype(
        np.uint8).tofile(wire)
    monkeypatch.setenv("MOCK_RTLSDR_DATA", str(wire))
    flags = ["--exact"] if tier == "exact" else ["--backend", "xla"]
    got = _run_both(tmp_path, capture, flags,
                    device={"type": "rtlsdr", "deviceIndex": 0,
                            "dBGainLNA": 32.8})
    for k, msg in enumerate(MSGS):
        a, b = got["tpu"][k], got["torch"][k]
        assert a.shape == b.shape and a.size > 0
        if tier == "exact":
            assert a.tobytes() == b.tobytes()
        else:
            assert _lsb_diff(a, b).max() <= 1
        assert _decoded(b) == [msg]
