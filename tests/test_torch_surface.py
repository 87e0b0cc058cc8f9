"""The port's public surface against the JAX package's, on the CPU: what JAX
takes, the port takes, and what JAX gives, the port gives.

Bars:
- both packages' ``MultifmChain(taps, offsets, fs, D)`` (no tier keyword)
  are the bit-exact tier, and their PCM on one capture is equal;
- the JAX keywords construct: ``MultifmChain(backend=, exact_tier=
  "packed")``, ``MultifmChain.from_config(backend=)``,
  ``ResamplerChain(backend=)``, ``ReceivePipeline(backend=, max_ratio=)``;
  a value JAX refuses raises ``ValueError`` in both, the ``max_ratio``
  guard with JAX's message; ``exact_tier="scan"`` raises and names the JAX
  oracle;
- ``process_capture(iq, device_decode=False)`` decodes the messages of the
  port's push/flush and of JAX's ``device_decode=False`` (production tier,
  at decimation 32 with every protocol and at decimation 50, a frame-form
  group); on the bit-exact tier ``device_decode`` True and False give the
  same messages and PCM, equal to JAX's;
- ``pipeline-torch -V`` and ``pipeline-tpu -V`` exit 0 with the program's
  name;
- the nine top-level names resolve, and importing the package loads no
  model and no torch;
- ``design-filter-torch`` prints what ``design-filter-tpu`` prints;
- ``testing.mock_radios``'s ``env_for`` and ``install``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tsl_sdr_tpu
import tsl_sdr_tpu_torch
from tsl_sdr_tpu.models import channelizer as jchan
from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu.models import resampler as jres
from tsl_sdr_tpu_torch.models import channelizer as tchan
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.models import resampler as tres
from tsl_sdr_tpu_torch.testing import ais_gen, flex_gen, pocsag_gen
from tsl_sdr_tpu_torch.testing.pager import fm_mod
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter, firdes_low_pass)

ROOT = Path(__file__).resolve().parents[1]
CENTER = 929_500_000
FS = 38_400 * 32
NAMES = ("MultifmChain", "ResamplerChain", "ReceivePipeline", "ChannelSpec",
         "PocsagDecoder", "FlexDecoder", "AisDecoder", "CostasChannelizer",
         "MultifmConfig")


def _fields(msgs):
    return [(type(m).__name__, dataclasses.asdict(m)) for m in msgs]


# -- the default tier -------------------------------------------------------

def test_multifm_chain_default_tier_matches_jax():
    rng = np.random.default_rng(11)
    fs, d = 256_000, 8
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:48]
    offs = [40_000, -30_000, 5_000]
    iq = rng.integers(-6000, 6000, size=(40_000, 2)).astype(np.int16)
    jax_chain = jchan.MultifmChain(lpf, offs, fs, d)
    chain = tchan.MultifmChain(lpf, offs, fs, d, device="cpu")
    assert chain.exact is True and jax_chain.exact is True
    assert chain.exact_tier == jax_chain.exact_tier == "packed"
    got = chain.process_array(iq, block_size=8_192)
    want = np.asarray(jax_chain.process_array(iq, block_size=8_192))
    assert got.dtype == np.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the keywords -----------------------------------------------------------

_LPF = firdes_low_pass(1.0, 256_000, 12_500, 9_000)[:32]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "pallas-high"])
def test_multifm_chain_takes_jax_backends(backend, exact):
    jchan.MultifmChain(_LPF, [40_000], 256_000, 8, exact=exact,
                       backend=backend, exact_tier="packed")
    chain = tchan.MultifmChain(_LPF, [40_000], 256_000, 8, exact=exact,
                               backend=backend, exact_tier="packed",
                               device="cpu")
    assert chain.exact is exact


@pytest.mark.parametrize("kw", [{"backend": "cuda"}, {"backend": "XLA"},
                                {"exact_tier": "fast"}],
                         ids=["backend_cuda", "backend_case", "tier_bogus"])
def test_multifm_chain_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        jchan.MultifmChain(_LPF, [40_000], 256_000, 8, **kw)
    with pytest.raises(ValueError):
        tchan.MultifmChain(_LPF, [40_000], 256_000, 8, device="cpu", **kw)


def test_exact_tier_scan_names_the_jax_oracle():
    jchan.MultifmChain(_LPF, [40_000], 256_000, 8, exact_tier="scan")
    with pytest.raises(ValueError, match=r"tsl_sdr_tpu\.models\.channelizer"):
        tchan.MultifmChain(_LPF, [40_000], 256_000, 8, exact_tier="scan",
                           device="cpu")


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto"])
def test_from_config_takes_backend(backend):
    from tsl_sdr_tpu.utils.config import MultifmConfig as JaxConfig
    from tsl_sdr_tpu_torch.utils.config import MultifmConfig

    raw = json.loads((ROOT / "etc" / "multifm_rtlsdr_8ch.json").read_text())
    jax_chain = jchan.MultifmChain.from_config(JaxConfig.from_dict(raw),
                                               backend=backend)
    chain = tchan.MultifmChain.from_config(MultifmConfig.from_dict(raw),
                                           backend=backend, device="cpu")
    assert chain.exact is jax_chain.exact is True
    assert chain.nr_channels == jax_chain.nr_channels == 8
    with pytest.raises(ValueError):
        tchan.MultifmChain.from_config(MultifmConfig.from_dict(raw),
                                       backend="tpu", device="cpu")


@pytest.mark.parametrize("backend,ok", [("auto", True), ("xla", True),
                                        ("pallas", True),
                                        ("pallas-high", False),
                                        ("bogus", False)])
def test_resampler_chain_backend(backend, ok):
    taps = design_rational_resampler_filter(5, 12, 0.4)
    if ok:
        jres.ResamplerChain(taps, 5, 12, backend=backend)
        rs = tres.ResamplerChain(taps, 5, 12, backend=backend, device="cpu")
        assert rs.plan.interpolation == 5
        return
    with pytest.raises(ValueError):
        jres.ResamplerChain(taps, 5, 12, backend=backend)
    with pytest.raises(ValueError):
        tres.ResamplerChain(taps, 5, 12, backend=backend, device="cpu")


def _pipe_specs(mod):
    return [mod.ChannelSpec(CENTER + 250_000, "pocsag"),
            mod.ChannelSpec(CENTER - 180_000, "flex", dc_block=True)]


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas-high"])
def test_receive_pipeline_takes_backend_and_max_ratio(backend):
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    kw = dict(backend=backend, max_ratio=12, block_size=294_912)
    jp = jpipe.ReceivePipeline(lpf, CENTER, FS, 32, _pipe_specs(jpipe),
                               exact=False, **kw)
    tp = tpipe.ReceivePipeline(lpf, CENTER, FS, 32, _pipe_specs(tpipe),
                               device="cpu", **kw)
    assert tp.block_size == jp.block_size
    with pytest.raises(ValueError):
        tpipe.ReceivePipeline(lpf, CENTER, FS, 32, _pipe_specs(tpipe),
                              device="cpu", backend="gpu")


@pytest.mark.parametrize("max_ratio", [11, 4])
def test_max_ratio_guard_matches_jax(max_ratio):
    """FLEX at 38,400 Hz needs 5/12: JAX's guard and message."""
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    errs = []
    for mod, kw in ((jpipe, {"exact": False}), (tpipe, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.ReceivePipeline(lpf, CENTER, FS, 32, _pipe_specs(mod),
                                max_ratio=max_ratio, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert "needs 5/12" in errs[0]


# -- process_capture(device_decode=) ----------------------------------------

def _specs(mod):
    return [mod.ChannelSpec(CENTER + 250_000, "pocsag"),
            mod.ChannelSpec(CENTER - 180_000, "flex", dc_block=True),
            mod.ChannelSpec(CENTER + 400_000, "ais"),
            mod.ChannelSpec(CENTER - 50_000, "pcm", invert=True)]


@pytest.fixture(scope="module")
def capture():
    """POCSAG + FLEX (DC-blocked) + AIS + an inverted pcm channel at
    decimation 32 (tests/test_torch_pipeline.py's capture)."""
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=1122335, function=2, kind="alpha",
                                content="HOST PATH")],
        baud=1200, amplitude=4096, tail_bits=256)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=1234568, kind="alnum",
                                   content="HOST FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999112, longitude=-70.8,
                                      latitude=42.3)], amplitude=9000)
    parts = [fm_mod(p_bb, 38_400, 250_000, FS, amp=9000),
             fm_mod(f_bb, 16_000, -180_000, FS, amp=7000),
             fm_mod(a_bb, 48_000, 400_000, FS, amp=7000, dev_hz=4800)]
    iq = np.zeros((max(map(len, parts)), 2))
    for p in parts:
        iq[:len(p)] += p
    rng = np.random.default_rng(22)
    iq = (iq + rng.normal(scale=120, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    jp = jpipe.ReceivePipeline(lpf, CENTER, FS, 32, _specs(jpipe),
                               exact=False, block_size=294_912)
    return {"iq": iq, "lpf": lpf, "jax_host": jp.process_capture(
        iq, device_decode=False)}


def test_process_capture_host_path_matches_push_and_jax(capture):
    iq = capture["iq"]
    pipe = tpipe.ReceivePipeline(capture["lpf"], CENTER, FS, 32,
                                 _specs(tpipe), device="cpu",
                                 block_size=294_912)
    host = pipe.process_capture(iq, device_decode=False)
    fused = pipe.process_capture(iq)
    want = capture["jax_host"]
    for i in range(3):
        assert _fields(host[i]) == _fields(fused[i]) == _fields(want[i])
        assert len(host[i]) == 1, i
    # the pcm channel: the host path's chain PCM, within the production
    # chain's 1 LSB of JAX's (tests/test_torch_chain.py)
    assert host[3].dtype == np.int16 and host[3].shape == want[3].shape
    assert np.abs(host[3].astype(np.int32) - want[3]).max() <= 1
    n = min(len(host[3]), len(fused[3]))
    np.testing.assert_array_equal(host[3][:n], fused[3][:n])


def test_process_capture_host_path_decimation_50():
    """A frame-form (K4) group, one channel DC-blocked: the host path, the
    port's push/flush and JAX's host path decode the same."""
    fs, decim = 1_228_800, 50
    bursts = [(200_000, 778001, "HOST 50 A"), (-300_000, 778002,
                                               "HOST 50 B")]
    iq = np.zeros((2_000_000, 2))
    for k, (off, cap, text) in enumerate(bursts):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=3, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        sig = fm_mod(bb, 38_400, off, fs, amp=9000)
        lo = 100_000 + 300_000 * k
        iq[lo:lo + len(sig)] += sig
    rng = np.random.default_rng(4)
    iq = (iq + rng.normal(scale=100, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 10_000, 6_000)
    res = {}
    for mod, kw in ((jpipe, {"exact": False}), (tpipe, {"device": "cpu"})):
        specs = [mod.ChannelSpec(CENTER + off, "pocsag", dc_block=k == 1)
                 for k, (off, _, _) in enumerate(bursts)]
        pipe = mod.ReceivePipeline(lpf, CENTER, fs, decim, specs,
                                   block_size=400_000, **kw)
        res[mod, False] = [_fields(m) for m in pipe.process_capture(
            iq, device_decode=False)]
        if mod is tpipe:
            res[mod, True] = [_fields(m) for m in pipe.process_capture(iq)]
    assert res[tpipe, False] == res[tpipe, True] == res[jpipe, False]
    assert [[f["capcode"] for _, f in ch] for ch in res[tpipe, False]] == [
        [778001], [778002]]


def test_exact_tier_device_decode_both_ways():
    """The bit-exact tier takes the stage-by-stage path either way:
    device_decode keeps the arrays on the device between the stages, and
    both give JAX's messages and PCM."""
    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=424243, function=1, kind="alpha",
                                content="EXACT HOST")],
        baud=1200, amplitude=4096, tail_bits=256)
    iq = fm_mod(bb, 38_400, 250_000, FS, amp=9000)
    rng = np.random.default_rng(6)
    iq = (iq + rng.normal(scale=100, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)

    def specs(mod):
        return [mod.ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
                mod.ChannelSpec(CENTER + 250_000, "flex"),
                mod.ChannelSpec(CENTER + 250_000, "pcm", invert=True)]

    jp = jpipe.ReceivePipeline(lpf, CENTER, FS, 32, specs(jpipe), exact=True)
    want = jp.process_capture(iq)
    tp = tpipe.ReceivePipeline(lpf, CENTER, FS, 32, specs(tpipe), exact=True,
                               device="cpu")
    for device_decode in (True, False):
        got = tp.process_capture(iq, device_decode=device_decode)
        assert _fields(got[0]) == _fields(want[0]) and len(got[0]) == 1
        assert _fields(got[1]) == _fields(want[1])
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


# -- -V ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["tsl_sdr_tpu_torch", "tsl_sdr_tpu"])
def test_pipeline_cli_version(pkg, capsys):
    import importlib

    cli = importlib.import_module(f"{pkg}.cli.pipeline")
    for flag in ("-V", "--version"):
        with pytest.raises(SystemExit) as e:
            cli.main([flag])
        assert e.value.code == 0
        out = capsys.readouterr().out
        name = "pipeline-torch" if pkg.endswith("torch") else "pipeline-tpu"
        assert out.startswith(f"{name} ") and len(out.split()) == 2, out


def test_pipeline_torch_version_in_a_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m",
                          "tsl_sdr_tpu_torch.cli.pipeline", "-V"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("pipeline-torch ")


# -- the top-level names ----------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_top_level_name(name):
    got = getattr(tsl_sdr_tpu_torch, name)
    want = getattr(tsl_sdr_tpu, name)
    assert got.__name__ == want.__name__ == name
    assert got.__module__.startswith("tsl_sdr_tpu_torch.")
    assert got.__module__.split(".", 1)[1] == want.__module__.split(".", 1)[1]


def test_top_level_unknown_name_raises():
    with pytest.raises(AttributeError):
        tsl_sdr_tpu_torch.NoSuchThing  # noqa: B018


def test_package_import_loads_no_model():
    script = (
        "import sys\n"
        "import tsl_sdr_tpu_torch\n"
        "assert 'torch' not in sys.modules, 'torch loaded'\n"
        "assert not [m for m in sys.modules if m.startswith("
        "'tsl_sdr_tpu_torch.')], sorted(sys.modules)\n"
        "print('LAZY OK')\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0 and "LAZY OK" in res.stdout, res.stderr


# -- design-filter-torch ----------------------------------------------------

@pytest.mark.parametrize("argv", [["16", "25", "0.4"], ["192", "125", "0.4"],
                                  ["3", "2", "0.25"], ["25", "16", "0.4"]],
                         ids=lambda a: "_".join(a))
def test_design_filter_matches_jax(argv, capsys):
    from tsl_sdr_tpu.cli import design_filter as jax_cli
    from tsl_sdr_tpu_torch.cli import design_filter as torch_cli
    from tsl_sdr_tpu_torch.utils.filter_design import resampler_filter_json

    assert torch_cli.main(argv) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert got == want
    assert got == resampler_filter_json(int(argv[0]), int(argv[1]),
                                        float(argv[2])) + "\n"
    assert json.loads(got)


def test_design_filter_usage_and_version(capsys):
    from tsl_sdr_tpu.cli import design_filter as jax_cli
    from tsl_sdr_tpu_torch.cli import design_filter as torch_cli

    assert torch_cli.main(["16", "25"]) == jax_cli.main(["16", "25"]) == 1
    err = capsys.readouterr().err
    assert "Usage: design-filter-torch" in err and \
        "Usage: design-filter-tpu" in err
    assert torch_cli.main(["-V"]) == 0
    assert capsys.readouterr().out.startswith("design-filter-torch ")


def test_design_filter_script_is_registered():
    text = (ROOT / "pyproject.toml").read_text()
    assert ('design-filter-torch = "tsl_sdr_tpu_torch.cli.design_filter:main"'
            in text)


# -- mock radios ------------------------------------------------------------

def test_mock_radios_env_for_and_install(monkeypatch):
    from tsl_sdr_tpu.testing import mock_radios as jax_mock
    from tsl_sdr_tpu_torch.testing import mock_radios

    assert mock_radios.ENV_VARS == jax_mock.ENV_VARS
    env = mock_radios.env_for("rtlsdr")
    assert list(env) == ["TSL_RTLSDR_LIB"]
    assert Path(env["TSL_RTLSDR_LIB"]) == mock_radios.build("rtlsdr")
    assert Path(env["TSL_RTLSDR_LIB"]).is_file()
    # monkeypatch owns the variable (set, even to "", so that teardown
    # restores it, or its absence) before install() writes os.environ
    # directly: otherwise the mock stays installed for every later test in
    # the process
    monkeypatch.setenv("TSL_RTLSDR_LIB", "")
    mock_radios.install("rtlsdr")
    assert os.environ["TSL_RTLSDR_LIB"] == env["TSL_RTLSDR_LIB"]
