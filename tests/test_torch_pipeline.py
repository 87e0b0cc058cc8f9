"""The port's ReceivePipeline and pipeline-torch CLI against the JAX
package's, on the CPU.

Bars:
- decoded messages IDENTICAL to the JAX ReceivePipeline's, at two push
  splits, with identical egress-gating counts (the prefilter flags agree);
- a ``pcm`` channel within 1 PCM LSB (the chain's discriminator bound, see
  tests/test_torch_chain.py);
- one block from the same mid-stream state (converted with
  tsl_sdr_tpu_torch/utils/convert.py): same prefilter flags, the chain carry
  exact, PCM-derived outputs within the chain's LSB bound carried through
  the resampler and DC blocker (stated at each assertion);
- pipeline-torch writes the same JSON lines as pipeline-tpu (timestamps
  aside) and the same audio within 1 LSB.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu.testing import flex_gen, pocsag_gen
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass
from tsl_sdr_tpu_torch.cli import pipeline as torch_cli
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.testing import ais_gen
from tsl_sdr_tpu_torch.testing.pager import fm_mod
from tsl_sdr_tpu_torch.utils import convert

DECIM = 32
FS = 38_400 * DECIM
CENTER = 929_500_000
BLOCK = 294_912   # 6 quanta: a 2.6 M-sample capture spans 9 blocks


def _specs(mod):
    return [
        mod.ChannelSpec(CENTER + 250_000, "pocsag"),
        mod.ChannelSpec(CENTER - 180_000, "flex", dc_block=True),
        mod.ChannelSpec(CENTER + 400_000, "ais"),
        mod.ChannelSpec(CENTER - 50_000, "pcm", invert=True),
    ]


@pytest.fixture(scope="module")
def capture():
    """POCSAG + FLEX + AIS in one capture (after tests/test_pipeline.py:30)
    and the JAX pipeline's results on it."""
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=1122334, function=2, kind="alpha",
                                content="PIPE POCSAG")],
        baud=1200, amplitude=4096, tail_bits=256)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=1234567, kind="alnum",
                                   content="PIPE FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999111, longitude=-70.9,
                                      latitude=42.36)], amplitude=9000)
    parts = [fm_mod(p_bb, 38_400, 250_000, FS, amp=9000),
             fm_mod(f_bb, 16_000, -180_000, FS, amp=7000),
             fm_mod(a_bb, 48_000, 400_000, FS, amp=7000, dev_hz=4800)]
    iq = np.zeros((max(map(len, parts)), 2))
    for p in parts:
        iq[:len(p)] += p
    rng = np.random.default_rng(21)
    iq = (iq + rng.normal(scale=120, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    jp = jpipe.ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(jpipe),
                               exact=False, block_size=BLOCK)
    ref = jp.process_capture(iq)
    return {"iq": iq, "lpf": lpf, "jax_pipe": jp, "ref": ref,
            "ref_stats": jp.stream_stats}


def _fields(msgs):
    """Decoded messages as comparable values: the port's message classes
    are its own copies of the JAX package's, equal field for field."""
    return [(type(m).__name__, dataclasses.asdict(m)) for m in msgs]


def _port(capture, **kw):
    return tpipe.ReceivePipeline(capture["lpf"], CENTER, FS, DECIM,
                                 _specs(tpipe), device="cpu",
                                 block_size=BLOCK, **kw)


@pytest.mark.parametrize("split", ["whole", "uneven_pushes"])
def test_pipeline_matches_jax(capture, split):
    iq, ref = capture["iq"], capture["ref"]
    pipe = _port(capture)
    assert pipe.block_size == capture["jax_pipe"].block_size
    if split == "whole":
        got = pipe.process_capture(iq)
    else:
        got = [[] for _ in range(4)]
        bounds = [0, 1_000, 300_001, 1_234_567, len(iq)]
        for lo, hi in zip(bounds, bounds[1:]):
            for i, part in enumerate(pipe.push(iq[lo:hi])):
                got[i].extend(part)
        for i, part in enumerate(pipe.flush()):
            got[i].extend(part)
        got[3] = np.concatenate(got[3])
    for i in range(3):
        assert _fields(got[i]) == _fields(ref[i]) and len(ref[i]) == 1, i
    assert got[3].shape == ref[3].shape
    assert np.abs(got[3].astype(np.int32) - ref[3]).max() <= 1
    stats, ref_stats = pipe.stream_stats, capture["ref_stats"]
    assert stats["blocks"] == ref_stats["blocks"]
    np.testing.assert_array_equal(stats["fetched"], ref_stats["fetched"])


def test_dev_step_from_jax_mid_stream_state(capture):
    jp = capture["jax_pipe"]
    iq = capture["iq"]
    jp.stream_reset()
    c_len = jp.chain.carry_len
    jp.push(iq[: c_len + 4 * BLOCK])      # prime + dispatch four blocks
    jst = jp._stream["st"]
    st = convert.stream_state_from_jax(jst)
    # the conversion round-trips leaf for leaf
    back = convert.stream_state_to_jax(st, like=jst)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    block = iq[c_len + 4 * BLOCK: c_len + 5 * BLOCK].reshape(-1)
    pipe = _port(capture)
    prog = pipe._program(BLOCK)
    stats = {"upload_elems": 0, "upload_bytes": 0, "halo_bytes": 0}
    st2, (pack, raw) = pipe._engine.step(st, block.copy(), stats)
    assert stats == {"upload_elems": block.size,
                     "upload_bytes": block.nbytes, "halo_bytes": 0}
    jprog = jp._program(BLOCK)
    jc, jrs, jdc, jtails, (jpack, jraw) = jprog.fn(
        jst["chain"], jst["rs"], jst["dc"], jst["tails"], block)
    assert prog.meta_bytes == jprog.meta_bytes
    for pgid in jpack:
        a, b = np.asarray(jpack[pgid]), pack[pgid].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a[:, 0], b[:, 0])    # prefilter flags
    # POCSAG sign bits of PCM within 1 LSB: only zero crossings may flip
    pa, pb = np.asarray(jpack["pocsag"]), pack["pocsag"].numpy()
    bits_a, bits_b = np.unpackbits(pa[:, 1:]), np.unpackbits(pb[:, 1:])
    assert (bits_a == bits_b).mean() > 0.999
    # FLEX int16 after the 5/12 resampler and the DC blocker: the chain's
    # 1 LSB through the resampler (worst-case tap-sum gain 1.90, then the
    # int16 truncation: <= 2 LSB), through the DC blocker (gain <= 2 at
    # Nyquist: <= 4), plus the DC fast tier's own 2 LSB: <= 6
    fa, fb = np.asarray(jpack["flex"]), pack["flex"].numpy()
    assert np.abs(fa[:, 1:].astype(np.int32) - fb[:, 1:]).max() <= 6
    ra, rb = np.asarray(jraw["pcm"]), raw["pcm"].numpy()
    assert np.abs(ra.astype(np.int32) - rb).max() <= 1
    np.testing.assert_array_equal(np.asarray(jc.carry_vals),
                                  st2["chain"].carry_vals.numpy())
    np.testing.assert_array_equal(np.asarray(jc.prev_r),
                                  st2["chain"].prev_r.numpy())
    assert jrs.keys() == st2["rs"].keys() == {(5, 12), (5, 4)}
    for gid, jcarry in jrs.items():   # resampler carries: chain PCM
        assert np.abs(np.asarray(jcarry.carry).astype(np.int32)
                      - st2["rs"][gid].numpy()).max() <= 1
    jp.stream_reset()


@pytest.mark.parametrize("fmt", ["cs16", "rtl_u8"])
def test_cli_matches_pipeline_tpu(tmp_path, fmt):
    """POCSAG + AIS + an audio channel (after tests/test_pipeline.py:89),
    with the --iq-dump and --nmea taps, from a cs16 or an rtl_u8 file."""
    from tsl_sdr_tpu.cli import pipeline as jax_cli

    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=555001, function=1, kind="alpha",
                                content="CLI PIPE")],
        baud=1200, amplitude=4096, tail_bits=256)
    iq = fm_mod(bb, 38_400, 250_000, FS, amp=9000)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367000222, longitude=-71.0,
                                      latitude=42.3)], amplitude=9000)
    a_iq = fm_mod(a_bb, 48_000, 400_000, FS, amp=7000, dev_hz=4800)
    iq[200_000:200_000 + len(a_iq)] += a_iq
    rng = np.random.default_rng(5)
    iq = (iq + rng.normal(scale=100, size=iq.shape)).astype(np.int16)
    iq_path = tmp_path / f"cap.{fmt}"
    if fmt == "cs16":
        iq.reshape(-1).tofile(iq_path)
    else:
        np.clip(np.round(iq / 128.0) + 127, 0, 255).astype(np.uint8).tofile(
            iq_path)
    outs = {}
    for name, main in (("tpu", jax_cli.main), ("torch", torch_cli.main)):
        cfg = {
            "device": {"type": "file", "filename": str(iq_path),
                       "fileFormat": fmt},
            "sampleRateHz": FS, "centerFreqHz": CENTER,
            "decimationFactor": DECIM,
            "lpfTaps": list(map(float, firdes_low_pass(1.0, FS, 9_600,
                                                       7_000))),
            "channels": [
                {"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag"},
                {"chanCenterFreq": CENTER + 400_000, "protocol": "ais"},
                {"chanCenterFreq": CENTER - 200_000,
                 "outFifo": str(tmp_path / f"audio_{name}.pcm")},
            ],
        }
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(cfg))
        argv = [str(cfg_path), "-o", str(tmp_path / f"{name}.jsonl"),
                "--iq-dump", str(tmp_path / f"dump_{name}.iq"),
                "--nmea", str(tmp_path / f"{name}.nmea")]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        msgs = [json.loads(x) for x in lines]
        for m in msgs:
            m.pop("timestamp")
        outs[name] = {
            "msgs": msgs,
            "audio": np.fromfile(tmp_path / f"audio_{name}.pcm", np.int16),
            "dump": (tmp_path / f"dump_{name}.iq").read_bytes(),
            "nmea": (tmp_path / f"{name}.nmea").read_text(),
        }
    tpu, port = outs["tpu"], outs["torch"]
    assert port["msgs"] == tpu["msgs"]
    assert [m["proto"] for m in tpu["msgs"]] == ["pocsag", "ais"]
    assert tpu["msgs"][0]["capCode"] == 555001
    assert port["nmea"] == tpu["nmea"] and "!AIVDM" in tpu["nmea"]
    assert port["dump"] == tpu["dump"] and len(tpu["dump"]) == iq.size * 2
    a, b = tpu["audio"], port["audio"]
    assert a.shape == b.shape and a.size > 0
    assert np.abs(a.astype(np.int32) - b).max() <= 1


def _pager_cli_config(tmp_path, n_samples, starts):
    """The 8-channel pager deployment as a pipeline config over a short
    capture with bursts at ``starts``; returns (config path, expected)."""
    from tsl_sdr_tpu_torch.testing import pager

    iq, expected = pager.capture(n_samples, starts, seed=3)
    iq_path = tmp_path / "pager.cs16"
    iq.reshape(-1).tofile(iq_path)
    cfg_path = tmp_path / "pager.json"
    cfg_path.write_text(json.dumps(pager.config(str(iq_path))))
    return cfg_path, expected


@pytest.mark.parametrize("argv", [
    ["--distributed", "h:1"],
    ["--distributed", "h:1", "--num-processes", "2"],
    ["--distributed", "h:1", "--process-id", "0"],
    ["--distributed", "h:1", "--num-processes", "2", "--process-id", "1",
     "--state-file", "s.npz"],
    ["--channel-shards", "3"],
    ["--channel-shards", "3", "--time-shards", "2"],
    ["--channel-shards", "5"],
    ["--state-file", "s.npz", "--time-shards", "2"],
    ["--follow", "--state-file", "s.npz", "--exact", "--channel-shards", "2"],
], ids=["distributed-alone", "no-process-id", "no-num-processes",
        "distributed-state-file", "channels-3", "channels-3-time-2",
        "channels-5", "state-file-no-follow", "state-file-exact"])
def test_cli_mesh_guards_match_jax(tmp_path, capsys, argv):
    """The guards of the mesh and multi-process flags, through
    pipeline-torch --device cpu and pipeline-tpu (8 virtual CPU devices):
    the same exit code and the same stderr, program name aside. (The
    device-count guard cannot fire on the CPU, which stands in for as many
    devices as a mesh asks for; tests/test_torch_cuda.py holds it.)"""
    from tsl_sdr_tpu.cli import pipeline as jax_cli

    cfg_path, _ = _pager_cli_config(tmp_path, 300_000, ())
    argv = [str(cfg_path), "-o", str(tmp_path / "out.jsonl"), *argv]
    rc_tpu = jax_cli.main(argv)
    err_tpu = capsys.readouterr().err
    rc_torch = torch_cli.main(argv + ["--device", "cpu"])
    err_torch = capsys.readouterr().err
    assert rc_tpu == rc_torch == 2
    assert err_torch == err_tpu.replace("pipeline-tpu", "pipeline-torch")
    assert not (tmp_path / "out.jsonl").exists()


def test_cli_backend_is_accepted_and_ignored(tmp_path, capsys):
    """--backend takes pipeline-tpu's four values (and only those) and
    changes nothing."""
    cfg_path, expected = _pager_cli_config(tmp_path, 1_700_000, (150_000,))
    outs = []
    for extra in ([], ["--backend", "pallas"], ["--backend", "xla"]):
        out = tmp_path / f"out{len(outs)}.jsonl"
        assert torch_cli.main([str(cfg_path), "-o", str(out), "--device",
                               "cpu", *extra]) == 0
        outs.append([{k: v for k, v in json.loads(x).items()
                      if k != "timestamp"}
                     for x in out.read_text().splitlines()])
    assert outs[0] == outs[1] == outs[2]
    assert [(m["capCode"], m["message"]) for m in outs[0]] == expected[0]
    with pytest.raises(SystemExit):
        torch_cli.main([str(cfg_path), "--backend", "cuda"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("shards", [["--channel-shards", "2"],
                                    ["--channel-shards", "2",
                                     "--time-shards", "2"]],
                         ids=["channels-2", "2x2"])
def test_cli_shards_decode_pager_as_without_mesh(tmp_path, shards):
    """The pager deployment (eight channels, a burst on the first) through
    pipeline-torch --device cpu with shard flags writes what the run
    without them writes."""
    cfg_path, expected = _pager_cli_config(tmp_path, 1_700_000, (150_000,))
    outs = []
    for extra in ([], shards):
        out = tmp_path / f"out{len(outs)}.jsonl"
        assert torch_cli.main([str(cfg_path), "-o", str(out), "--device",
                               "cpu", *extra]) == 0
        outs.append([{k: v for k, v in json.loads(x).items()
                      if k != "timestamp"}
                     for x in out.read_text().splitlines()])
    assert outs[0] == outs[1]
    assert [(m["capCode"], m["message"]) for m in outs[0]] == expected[0]


def test_default_device_needs_cuda(capture):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.ReceivePipeline(capture["lpf"], CENTER, FS, DECIM,
                              _specs(tpipe))


def test_push_refuses_wide_input_on_8bit_wire(capture):
    pipe = _port(capture, wire_fmt="rtl_u8")
    with pytest.raises(ValueError, match="8-bit wire bytes"):
        pipe.push(capture["iq"][:10_000])
    assert pipe.push(np.full(20_000, 127, np.uint8)) == [[], [], [], []]


def test_pipeline_decimation_50_frame_form_group():
    """fs 1,228,800 / 50 gives 24,576 Hz channels and a POCSAG ratio of
    25/16, whose resampler plan has no packed-row form (lcm(25, 128) >
    1024): the group runs the frame-form resampler (K4). Same messages as
    the JAX pipeline, which runs its transposed-residue tier there."""
    fs, decim = 1_228_800, 50
    bursts = [(200_000, 777001, "DECIM 50 A"), (-300_000, 777002,
                                                "DECIM 50 B")]
    iq = np.zeros((2_000_000, 2))
    for k, (off, cap, text) in enumerate(bursts):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=3, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        sig = fm_mod(bb, 38_400, off, fs, amp=9000)
        lo = 100_000 + 300_000 * k
        iq[lo:lo + len(sig)] += sig
    rng = np.random.default_rng(3)
    iq = (iq + rng.normal(scale=100, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 10_000, 6_000)
    res = {}
    for mod, kw in ((jpipe, {"exact": False}), (tpipe, {"device": "cpu"})):
        specs = [mod.ChannelSpec(CENTER + off, "pocsag", dc_block=k == 1)
                 for k, (off, _, _) in enumerate(bursts)]
        pipe = mod.ReceivePipeline(lpf, CENTER, fs, decim, specs,
                                   block_size=400_000, **kw)
        res[mod] = [[(m.capcode, m.data) for m in msgs]
                    for msgs in pipe.process_capture(iq)]
        if mod is tpipe:
            plan = pipe._program(pipe.block_size).plans[(25, 16)]
            assert plan.k_row == 0 and pipe._rs_groups == {(25, 16): [0, 1]}
    assert res[tpipe] == res[jpipe]
    assert [[(cap, data.rstrip(b"\0")) for cap, data in msgs]
            for msgs in res[tpipe]] == [[(777001, b"DECIM 50 A")],
                                        [(777002, b"DECIM 50 B")]]
