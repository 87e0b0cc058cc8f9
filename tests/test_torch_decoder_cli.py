"""decoder-torch and resampler-torch against decoder-tpu and resampler-tpu.

Bars: the same JSON lines (the wall-clock ``timestamp`` field dropped, as
tests/test_torch_pipeline.py does), the same NMEA sentences, and
byte-identical PCM dumps and resampled PCM files; with ``-b --fast`` the
PCM within 2 LSB (the DC blocker's float tier: a float32 scan in JAX, a
float64 one here; tests/test_torch_stages.py holds the same bound). Both CLIs run here on the CPU
(``--device cpu``), so the port's plain versions stand in for K3, K4 and
the exact DC kernel.
"""

import json

import numpy as np
import pytest

from tsl_sdr_tpu.cli import decoder as jax_decoder
from tsl_sdr_tpu.cli import resampler as jax_resampler
from tsl_sdr_tpu.testing import ais_gen, flex_gen, pocsag_gen
from tsl_sdr_tpu.utils.filter_design import resampler_filter_json
from tsl_sdr_tpu_torch.cli import decoder as torch_decoder
from tsl_sdr_tpu_torch.cli import resampler as torch_resampler

UNITY_FILTER = {"lpfCoeffs": [1.0]}


def _nearest(pcm, rate_in, rate_out, rng, noise=100.0):
    """Nearest-sample rate change plus noise: decoder input at a rate the
    decoder resamples back from."""
    idx = (np.arange(int(len(pcm) * rate_out / rate_in)) * rate_in) \
        // rate_out
    x = pcm[idx].astype(np.float64) + rng.normal(scale=noise, size=idx.shape)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def _pocsag(rate, rng):
    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=1234567, function=2, kind="alpha",
                                content="TORCH DECODER"),
         pocsag_gen.PocsagBurst(capcode=7654321, function=0, kind="numeric",
                                content="0123456789")],
        baud=1200, amplitude=4096, tail_bits=256)
    pcm = np.concatenate([np.zeros(3000, np.int16), bb,
                          np.zeros(2000, np.int16)])
    return pcm if rate == 38_400 else _nearest(pcm, 38_400, rate, rng)


def _case(name, tmp_path):
    """(decoder argv without the input and the -o/--nmea/-d paths, input
    PCM, expected message count)."""
    rng = np.random.default_rng(len(name))
    unity = tmp_path / "unity.json"
    unity.write_text(json.dumps(UNITY_FILTER))
    if name == "pocsag_passthrough":
        return ["-m", "pocsag", "-I", "1", "-D", "1", "-S", "38400",
                "-F", str(unity)], _pocsag(38_400, rng), 2
    if name == "pocsag_invert":
        pcm = (-_pocsag(38_400, rng).astype(np.int32)).clip(
            -32768, 32767).astype(np.int16)
        return ["-m", "pocsag", "-F", str(unity), "-i"], pcm, 2
    if name in ("pocsag_192_125_dc", "pocsag_192_125_dc_fast"):
        filt = tmp_path / "pocsag_192_125.json"
        filt.write_text(resampler_filter_json(192, 125, 0.4))
        pcm = _pocsag(25_000, rng) + np.int16(700)   # a DC offset to block
        argv = ["-m", "pocsag", "-I", "192", "-D", "125", "-S", "25000",
                "-F", str(filt), "-b"]
        return (argv + (["--fast"] if name.endswith("fast") else []),
                pcm, 2)
    if name == "pocsag_25_16":
        filt = tmp_path / "pocsag_25_16.json"
        filt.write_text(resampler_filter_json(25, 16, 0.4))
        return ["-m", "pocsag", "-I", "25", "-D", "16", "-S", "24576",
                "-F", str(filt)], _pocsag(24_576, rng), 2
    if name == "flex_16_25":
        bb, _ = flex_gen.generate(
            [flex_gen.FlexBurstMessage(capcode=424242, kind="alnum",
                                       content="RESAMPLED")],
            baud=1600, fsk_levels=2)
        filt = tmp_path / "flex_16_25.json"
        filt.write_text(resampler_filter_json(16, 25, 0.4))
        return ["-m", "flex", "-I", "16", "-D", "25", "-S", "25000",
                "-F", str(filt), "-f", "929612500"], \
            _nearest(bb, 16_000, 25_000, rng), 1
    if name == "ais_nmea":
        pkts = [ais_gen.make_position_report(367001234, latitude=37.7749,
                                             longitude=-122.4194),
                ais_gen.make_position_report(367009999, latitude=42.36,
                                             longitude=-70.9)]
        return ["-m", "ais", "-S", "48000", "-F", str(unity),
                "-f", "161975000", "--nmea-channel", "B"], \
            ais_gen.generate(pkts), 2
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "pocsag_passthrough", "pocsag_invert", "pocsag_192_125_dc",
    "pocsag_192_125_dc_fast", "pocsag_25_16", "flex_16_25", "ais_nmea"])
def test_decoder_torch_matches_decoder_tpu(tmp_path, name):
    argv, pcm, n_msgs = _case(name, tmp_path)
    src = tmp_path / "in.pcm"
    pcm.tofile(src)
    outs = {}
    for tag, main in (("tpu", jax_decoder.main), ("torch", torch_decoder.main)):
        extra = ["-o", str(tmp_path / f"{tag}.json"), "-c",
                 "-d", str(tmp_path / f"{tag}.dump")]
        if name == "ais_nmea":
            extra += ["--nmea", str(tmp_path / f"{tag}.nmea")]
        if tag == "torch":
            extra += ["--device", "cpu"]
        assert main([*argv, *extra, str(src)]) == 0
        msgs = [json.loads(x) for x in
                (tmp_path / f"{tag}.json").read_text().splitlines()]
        for m in msgs:
            m.pop("timestamp", None)
        outs[tag] = {
            "msgs": msgs,
            "dump": (tmp_path / f"{tag}.dump").read_bytes(),
            "nmea": ((tmp_path / f"{tag}.nmea").read_text()
                     if name == "ais_nmea" else ""),
        }
    tpu, port = outs["tpu"], outs["torch"]
    assert len(tpu["msgs"]) == n_msgs, tpu["msgs"]
    assert port["msgs"] == tpu["msgs"]
    assert len(port["dump"]) == len(tpu["dump"]) > 0
    if name.endswith("_dc_fast"):
        # the DC blocker's float tier: float32 scan in JAX, float64 here
        a = np.frombuffer(tpu["dump"], np.int16).astype(np.int32)
        assert np.abs(a - np.frombuffer(port["dump"], np.int16)).max() <= 2
    else:
        assert port["dump"] == tpu["dump"]
    assert port["nmea"] == tpu["nmea"]
    if name == "ais_nmea":
        assert tpu["nmea"].count("!AIVDM") == 2


@pytest.mark.parametrize("flags", [[], ["--fast"], ["-b"], ["-b", "--fast"]],
                         ids=["exact", "fast", "exact-dc", "fast-dc"])
def test_resampler_torch_matches_resampler_tpu(tmp_path, flags):
    rng = np.random.default_rng(0)
    pcm = rng.integers(-10000, 10000, size=70_001,
                       dtype=np.int64).astype(np.int16)
    src = tmp_path / "in.pcm"
    pcm.tofile(src)
    filt = tmp_path / "filt_147_160.json"
    filt.write_text(resampler_filter_json(147, 160, 0.4))
    argv = ["-I", "147", "-D", "160", "-S", "48000", "-F", str(filt), *flags]
    assert jax_resampler.main([*argv, str(src),
                               str(tmp_path / "tpu.pcm")]) == 0
    assert torch_resampler.main([*argv, "--device", "cpu", str(src),
                                 str(tmp_path / "torch.pcm")]) == 0
    ref = (tmp_path / "tpu.pcm").read_bytes()
    got = (tmp_path / "torch.pcm").read_bytes()
    assert len(ref) > 2 * 70_001 * 147 // 160 - 8192
    if "--fast" in flags and "-b" in flags:
        # the DC blocker's float tier: float32 scan in JAX, float64 here
        a, b = np.frombuffer(ref, np.int16), np.frombuffer(got, np.int16)
        assert a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b).max() <= 2
    else:
        assert got == ref


def test_config_errors_are_clean(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nothing": 1}))
    src = tmp_path / "in.pcm"
    np.zeros(100, np.int16).tofile(src)
    assert torch_decoder.main(["-m", "pocsag", "-F", str(bad), "--device",
                               "cpu", str(src)]) == 2
    assert "decoder-torch" in capsys.readouterr().err
    assert torch_decoder.main(["-m", "flex", "-F", str(bad), "--nmea", "-",
                               "--device", "cpu", str(src)]) == 2
    assert torch_resampler.main(["-I", "1", "-D", "1", "-F", str(bad),
                                 "--device", "cpu", str(src),
                                 str(tmp_path / "o.pcm")]) == 2
    assert "resampler-torch" in capsys.readouterr().err
