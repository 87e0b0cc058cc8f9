"""The port's diagnostics (``tsl_sdr_tpu_torch/utils/diag.py``) against the
JAX package's ``tsl_sdr_tpu/utils/diag.py``, on the CPU.

Bars:
- the coefficient dumps the plan builders write under ``TSL_DUMP_LPF`` and
  ``TSL_DUMP_FILTER_COEFFICIENTS`` are byte-equal to the JAX package's for
  the same plans (the plans of ``tests/test_models.py``'s dump test, the
  pager deployment's bank, a gained bank and three resampler ratios), to a
  file and to stderr;
- with the variables unset nothing is written;
- ``resampler-torch`` writes the phase dump ``resampler-tpu`` writes;
- ``hexdump`` is equal, and ``message`` logs the same record text under
  the port's logger (``tests/test_sources.py``'s case).
"""

import logging

import numpy as np
import pytest

from tsl_sdr_tpu.ops import packed_fir as jax_packed_fir
from tsl_sdr_tpu.ops import polyphase as jax_polyphase
from tsl_sdr_tpu.utils import diag as jax_diag
from tsl_sdr_tpu_torch.ops import packed_fir, polyphase, q14
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.utils import diag
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter, firdes_low_pass)

VARS = ("TSL_DUMP_LPF", "TSL_DUMP_FILTER_COEFFICIENTS")

_LPF = firdes_low_pass(1.0, 256_000, 12_500, 9_000)[:32]
BANKS = {
    # tests/test_models.py::test_debug_coefficient_dumps
    "models_2ch": (_LPF, [40_000, -30_000], 256_000, 8, None),
    "models_1ch": (_LPF, [10_000], 256_000, 8, None),
    "pager_8ch": (pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS,
                  pager.DECIMATION, None),
    "gains_3ch": (_LPF, [12_345, -70_000, 0], 256_000, 4,
                  [1.0, 0.5, 2.0]),
}
RATIOS = [(3, 2), (5, 12), (25, 16)]


def _dumps(tmp_path, monkeypatch, tag: str, build) -> dict:
    """Run ``build()`` with both variables set to files of their own;
    returns each file's bytes."""
    paths = {v: tmp_path / f"{tag}_{v}.txt" for v in VARS}
    for v, p in paths.items():
        monkeypatch.setenv(v, str(p))
    build()
    for v in VARS:
        monkeypatch.delenv(v)
    return {v: p.read_bytes() if p.exists() else None
            for v, p in paths.items()}


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_lpf_dump_matches_jax(tmp_path, monkeypatch, bank):
    lpf, offs, fs, d, gains = BANKS[bank]
    got = _dumps(tmp_path, monkeypatch, "torch", lambda: packed_fir
                 .make_packed_fir_plan(lpf, offs, fs, d, gains))
    want = _dumps(tmp_path, monkeypatch, "jax", lambda: jax_packed_fir
                  .make_packed_fir_plan(lpf, offs, fs, d, gains))
    assert got == want
    txt = got["TSL_DUMP_LPF"].decode()
    assert txt.count("complex(") == len(lpf) * len(offs)
    assert txt.count("Total power:") == len(offs)
    assert got["TSL_DUMP_FILTER_COEFFICIENTS"] is None


@pytest.mark.parametrize("ratio", RATIOS, ids=lambda r: f"{r[0]}_{r[1]}")
def test_phase_dump_matches_jax(tmp_path, monkeypatch, ratio):
    i, d = ratio
    coeffs = q14.quantize_q14(design_rational_resampler_filter(i, d, 0.4))
    got = _dumps(tmp_path, monkeypatch, "torch",
                 lambda: polyphase.make_resampler_plan(coeffs, i, d))
    want = _dumps(tmp_path, monkeypatch, "jax",
                  lambda: jax_polyphase.make_resampler_plan(coeffs, i, d))
    assert got == want
    assert got["TSL_DUMP_FILTER_COEFFICIENTS"].decode().count("Phase ") == i
    assert got["TSL_DUMP_LPF"] is None


def test_dumps_to_stderr_match_jax(monkeypatch, capsys):
    coeffs = q14.quantize_q14(design_rational_resampler_filter(3, 2, 0.4))
    texts = []
    for pf, pp in ((packed_fir, polyphase), (jax_packed_fir, jax_polyphase)):
        for v, value in zip(VARS, ("stderr", "-")):
            monkeypatch.setenv(v, value)
        pf.make_packed_fir_plan(_LPF, [40_000, -30_000], 256_000, 8)
        pp.make_resampler_plan(coeffs, 3, 2)
        out = capsys.readouterr()
        assert out.out == ""
        texts.append(out.err)
    assert texts[0] == texts[1]
    assert "lpf_shifted_40000 = [" in texts[0] and "Phase    2:" in texts[0]


def test_nothing_written_when_unset(tmp_path, monkeypatch, capsys):
    for v in VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.chdir(tmp_path)
    coeffs = q14.quantize_q14(design_rational_resampler_filter(3, 2, 0.4))
    packed_fir.make_packed_fir_plan(_LPF, [10_000], 256_000, 8)
    polyphase.make_resampler_plan(coeffs, 3, 2)
    out = capsys.readouterr()
    assert out.out == out.err == ""
    assert not list(tmp_path.iterdir())


def test_resampler_cli_phase_dump_matches_jax(tmp_path, monkeypatch):
    """resampler-torch and resampler-tpu on one PCM file write the same
    phase dump (every plan either builds, tail plans included)."""
    from tsl_sdr_tpu.cli import resampler as jax_cli
    from tsl_sdr_tpu_torch.cli import resampler as torch_cli
    from tsl_sdr_tpu_torch.utils.filter_design import resampler_filter_json

    rng = np.random.default_rng(5)
    (tmp_path / "in.pcm").write_bytes(
        rng.integers(-3000, 3000, 20_001).astype(np.int16).tobytes())
    (tmp_path / "f.json").write_text(resampler_filter_json(5, 12, 0.4))
    dumps = {}
    for tag, main, extra in (("torch", torch_cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, [])):
        dst = tmp_path / f"{tag}.txt"
        monkeypatch.setenv("TSL_DUMP_FILTER_COEFFICIENTS", str(dst))
        assert main(["-I", "5", "-D", "12", "-F", str(tmp_path / "f.json"),
                     *extra, str(tmp_path / "in.pcm"),
                     str(tmp_path / f"{tag}.pcm")]) == 0
        dumps[tag] = dst.read_bytes()
    assert dumps["torch"] == dumps["jax"]
    assert dumps["torch"].decode().count("Phase    4:") >= 1


@pytest.mark.parametrize("n,width", [(0, 16), (28, 16), (77, 8), (256, 32)])
def test_hexdump_matches_jax(n, width):
    data = np.random.default_rng(n).integers(0, 256, n).astype(
        np.uint8).tobytes()
    assert diag.hexdump(data, width) == jax_diag.hexdump(data, width)


def test_hexdump_and_message(caplog):
    """tests/test_sources.py's case, on both packages' loggers."""
    data = b"Hello\x00World!" + bytes(range(8))
    out = diag.hexdump(data)
    assert out == jax_diag.hexdump(data)
    assert out.splitlines()[0].startswith("00000000")
    assert "|Hello.World!" in out
    with caplog.at_level(logging.INFO):
        diag.message("MFM", "INFO", "RECV-GAIN", "gain set to %d.%d dB",
                     20, 7)
        jax_diag.message("MFM", "INFO", "RECV-GAIN", "gain set to %d.%d dB",
                         20, 7)
    got, want = caplog.records[-2:]
    assert got.name == "tsl_sdr_tpu_torch.mfm" and want.name == \
        "tsl_sdr_tpu.mfm"
    assert got.getMessage() == want.getMessage() == \
        "[MFM] RECV-GAIN: gain set to 20.7 dB"
    assert got.levelno == want.levelno == logging.INFO
    caplog.clear()
    with caplog.at_level(logging.DEBUG):
        diag.message("pag", "fatal", "X", "%s", "boom")
        diag.message("pag", "bogus", "Y", "plain")
    assert [(r.levelno, r.getMessage()) for r in caplog.records] == [
        (logging.CRITICAL, "[PAG] X: boom"), (logging.INFO, "[PAG] Y: plain")]
