"""The port's bit-exact ReceivePipeline and ``pipeline-torch --exact``
against the JAX package's exact tier, on the CPU.

Bars: decoded messages IDENTICAL (every field, per channel, in order) and
``pcm`` channels BYTE-EQUAL to the JAX exact tier's, through push/flush at
several splits (cs16 and rtl_u8 wire bytes, drain worker on and off), and
through process_capture (the host path); the same at decimation 50, whose
25/16 group runs the frame-form resampler; pipeline-torch --exact writes
pipeline-tpu --exact's JSON lines but for the timestamps. The exact tier
cannot checkpoint.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

from tsl_sdr_tpu.cli import pipeline as jax_cli
from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu_torch.cli import pipeline as torch_cli
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.testing import ais_gen, flex_gen, pocsag_gen
from tsl_sdr_tpu_torch.testing.pager import fm_mod, to_rtl_u8
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

CENTER = 929_500_000
DECIM = 24
FS = 51_200 * DECIM     # POCSAG 3/4 and FLEX 5/16 resampler ratios
LPF = firdes_low_pass(1.0, FS, 12_000, 8_000)
BLOCK = 262_144


def _specs(mod):
    return [mod.ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
            mod.ChannelSpec(CENTER - 180_000, "flex"),
            mod.ChannelSpec(CENTER + 400_000, "pcm", invert=True)]


@pytest.fixture(scope="module")
def capture():
    """POCSAG + FLEX bursts and a pcm channel (after
    tests/test_pipeline_stream.py:208), as cs16 and as rtl_u8 wire bytes,
    with the JAX exact tier's streamed results on both."""
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=555001, function=2, kind="alpha",
                                content="EXACT STREAM")],
        baud=1200, amplitude=4096, tail_bits=128)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=555002, kind="alnum",
                                   content="EXACT FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=200)
    p_iq = fm_mod(p_bb, 38_400, 250_000, FS, amp=9000)
    f_iq = fm_mod(f_bb, 16_000, -180_000, FS, amp=7000)
    n = max(len(p_iq), len(f_iq)) + 300_000
    rng = np.random.default_rng(17)
    iq = rng.normal(scale=100, size=(n, 2))
    iq[200_000:200_000 + len(p_iq)] += p_iq
    iq[200_000:200_000 + len(f_iq)] += f_iq
    iq = np.clip(np.round(iq), -32768, 32767).astype(np.int16)
    wire = to_rtl_u8(iq)
    bounds = [0, 50_000, 333_333, 700_001, n]
    ref = {fmt: _stream(_jax(wire_fmt=fmt), data, bounds)
           for fmt, data in (("cs16", iq), ("rtl_u8", wire))}
    assert [len(r) for r in ref["cs16"][:2]] == [1, 1]
    return {"iq": iq, "rtl_u8": wire, "bounds": bounds, "ref": ref}


def _jax(**kw):
    return jpipe.ReceivePipeline(LPF, CENTER, FS, DECIM, _specs(jpipe),
                                 exact=True, block_size=BLOCK, **kw)


def _port(**kw):
    return tpipe.ReceivePipeline(LPF, CENTER, FS, DECIM, _specs(tpipe),
                                 exact=True, block_size=BLOCK, device="cpu",
                                 **kw)


def _stream(pipe, data, bounds):
    got = [[] for _ in pipe.channels]
    for lo, hi in zip(bounds, bounds[1:]):
        for c, part in enumerate(pipe.push(data[lo:hi])):
            got[c].extend(part)
    for c, part in enumerate(pipe.flush()):
        got[c].extend(part)
    got[2] = np.concatenate(got[2])
    return got


def _fields(msgs):
    return [(type(m).__name__, dataclasses.asdict(m)) for m in msgs]


def _same(got, ref):
    assert _fields(got[0]) == _fields(ref[0])
    assert _fields(got[1]) == _fields(ref[1])
    assert got[2].dtype == np.int16 and got[2].size > 0
    assert got[2].tobytes() == np.asarray(ref[2], np.int16).tobytes()


@pytest.mark.parametrize("drain_async", [False, True])
@pytest.mark.parametrize("fmt", ["cs16", "rtl_u8"])
def test_push_flush_matches_jax_exact(capture, fmt, drain_async):
    data = capture["iq"] if fmt == "cs16" else capture["rtl_u8"]
    pipe = _port(wire_fmt=fmt, drain_async=drain_async)
    _same(_stream(pipe, data, capture["bounds"]), capture["ref"][fmt])
    assert pipe._xstream is None and pipe._stream is None


@pytest.mark.parametrize("split", ["whole", "small_pushes"])
def test_other_splits_and_depths(capture, split):
    """The split and the in-flight depth move where blocks are cut and
    drained, never what is computed."""
    iq = capture["iq"]
    if split == "whole":
        bounds, depth = [0, len(iq)], 1
    else:
        rng = np.random.default_rng(2)
        cuts = np.cumsum(rng.integers(10_000, 120_000, size=60))
        bounds, depth = [0, *[int(c) for c in cuts if c < len(iq)],
                         len(iq)], 3
    _same(_stream(_port(inflight_depth=depth), iq, bounds),
          capture["ref"]["cs16"])


def test_process_capture_matches_jax(capture):
    iq = capture["iq"]
    want = _jax().process_capture(iq)
    got = _port().process_capture(iq)
    _same(got, want)


def test_decimation_50_frame_form_group():
    """fs 1,228,800 / 50: the 25/16 POCSAG group has no packed-row form and
    runs the frame-form resampler (K4) with Q.14 output; one channel
    DC-blocked. Streamed and whole-capture, equal to JAX's exact tier."""
    fs, decim = 1_228_800, 50
    bursts = [(200_000, 777001, "DECIM 50 A"), (-300_000, 777002,
                                                "DECIM 50 B")]
    iq = np.zeros((1_700_000, 2))
    for k, (off, cap, text) in enumerate(bursts):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=3, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=128)
        sig = fm_mod(bb, 38_400, off, fs, amp=9000)
        lo = 50_000 + 150_000 * k
        iq[lo:lo + len(sig)] += sig
    rng = np.random.default_rng(3)
    iq = np.clip(np.round(iq + rng.normal(scale=100, size=iq.shape)),
                 -32768, 32767).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 10_000, 6_000)
    res = {}
    for mod, kw in ((jpipe, {}), (tpipe, {"device": "cpu"})):
        specs = [mod.ChannelSpec(CENTER + off, "pocsag", dc_block=k == 1)
                 for k, (off, _, _) in enumerate(bursts)]

        def make():
            return mod.ReceivePipeline(lpf, CENTER, fs, decim, specs,
                                       exact=True, block_size=400_000, **kw)
        pipe = make()
        got = [[] for _ in specs]
        for lo, hi in ((0, 333_333), (333_333, len(iq))):
            for c, part in enumerate(pipe.push(iq[lo:hi])):
                got[c].extend(part)
        for c, part in enumerate(pipe.flush()):
            got[c].extend(part)
        res[mod] = (got, make().process_capture(iq))
        if mod is tpipe:
            assert pipe._rs_chains[(25, 16)].plan.k_row == 0
    for a, b in zip(res[tpipe], res[jpipe]):
        assert [_fields(m) for m in a] == [_fields(m) for m in b]
    assert [[(m.capcode, m.data.rstrip(b"\0")) for m in msgs]
            for msgs in res[tpipe][0]] == [[(777001, b"DECIM 50 A")],
                                           [(777002, b"DECIM 50 B")]]


def test_exact_tier_cannot_checkpoint(capture, tmp_path):
    pipe = _port()
    pipe.push(capture["iq"][:600_000])
    with pytest.raises(NotImplementedError):
        pipe.checkpoint_stream(tmp_path / "s.npz")
    with pytest.raises(NotImplementedError):
        pipe.restore_stream(tmp_path / "s.npz")


def _blank(path):
    return [re.sub(r'"timestamp":"[^"]*"', '"timestamp":""', x)
            for x in path.read_text().splitlines()]


@pytest.mark.parametrize("fmt", ["cs16", "rtl_u8"])
def test_cli_exact_matches_pipeline_tpu(tmp_path, capture, fmt):
    """pipeline-torch --exact vs pipeline-tpu --exact: POCSAG + AIS and an
    audio channel, the same JSON lines and the same audio bytes."""
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367000333, longitude=-71.0,
                                      latitude=42.3)], amplitude=9000)
    iq = capture["iq"].astype(np.float64)
    a_iq = fm_mod(a_bb, 48_000, -400_000, FS, amp=7000, dev_hz=4800)
    iq[300_000:300_000 + len(a_iq)] += a_iq
    iq = np.clip(np.round(iq), -32768, 32767).astype(np.int16)
    path = tmp_path / f"cap.{fmt}"
    (iq if fmt == "cs16" else to_rtl_u8(iq)).tofile(path)
    outs = {}
    for name, main in (("tpu", jax_cli.main), ("torch", torch_cli.main)):
        cfg = {
            "device": {"type": "file", "filename": str(path),
                       "fileFormat": fmt},
            "sampleRateHz": FS, "centerFreqHz": CENTER,
            "decimationFactor": DECIM,
            "lpfTaps": list(map(float, LPF)),
            "channels": [
                {"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag",
                 "dcBlock": True},
                {"chanCenterFreq": CENTER - 400_000, "protocol": "ais"},
                {"chanCenterFreq": CENTER + 400_000,
                 "outFifo": str(tmp_path / f"audio_{name}.pcm")},
            ],
        }
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(cfg))
        argv = [str(cfg_path), "--exact", "--block-size", str(BLOCK), "-o",
                str(tmp_path / f"{name}.jsonl")]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        outs[name] = (_blank(tmp_path / f"{name}.jsonl"),
                      (tmp_path / f"audio_{name}.pcm").read_bytes())
    assert outs["torch"] == outs["tpu"]
    assert [json.loads(x)["proto"] for x in outs["torch"][0]] == [
        "pocsag", "ais"]
    assert len(outs["torch"][1]) > 0


def test_cli_exact_refuses_state_file(tmp_path, capsys):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "device": {"type": "file", "filename": "x", "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER, "decimationFactor": DECIM,
        "lpfTaps": [0.5, 0.5],
        "channels": [{"chanCenterFreq": CENTER, "protocol": "pocsag"}]}))
    assert torch_cli.main([str(cfg), "--exact", "--follow", "--state-file",
                           str(tmp_path / "s.npz"), "--device", "cpu"]) == 2
    assert "drop --exact" in capsys.readouterr().err
