"""K1 on the RTL-SDR's 8-bit wire, on the CPU (the plain path; the kernel's
twin is in ``tests/test_torch_cuda.py``).

The production tier hands K1 a block of rtl_u8 bytes as uploaded, where
its tile body reads them (``ChainTaps.reads_wire``), and takes the int16
carry from the block's widened tail. Each check here holds that path to
the same block widened by ``utils.iq.widen_iq_bytes`` and run as int16, 0
LSB apart; then the receive pipeline on a tiny rtl_u8 band, one channel
tuned beyond fs/2, against the benchmark's plain float64 receiver; then
the benchmark's 20-minute mix, which has to carry the same traffic on
every seed.
"""

import itertools
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tsl_sdr_tpu_torch.models.channelizer import (MultifmChain,
                                                  MultifmFastState, step_raw,
                                                  widen_wire)
from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.utils.iq import widen_iq_bytes

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from sdrbench import bench, synth  # noqa: E402
from sdrbench.reference.receiver import firdes_low_pass  # noqa: E402

CELL_CFG = json.loads((REPO / "sdrbench/configs/rtlsdr-8ch.json").read_text())


def _cell_chain():
    offs = [c["chanCenterFreq"] - CELL_CFG["centerFreqHz"]
            for c in CELL_CFG["channels"]]
    return MultifmChain(CELL_CFG["lpfTaps"], offs, CELL_CFG["sampleRateHz"],
                        CELL_CFG["decimationFactor"], exact=False,
                        device="cpu")


def _tiny_chain():
    return MultifmChain(firdes_low_pass(1.0, 200_000, 10_000, 5_000),
                        [-60_000, 20_000, 260_000], 200_000, 8, exact=False,
                        device="cpu")


CHAINS = {"tiny": _tiny_chain, "cell": _cell_chain}


def _bytes(n: int, seed: int) -> np.ndarray:
    # every byte value, 0 and 255 included
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


def _widened(raw: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(widen_iq_bytes(raw, "rtl_u8"))


def test_the_device_widening_is_the_host_rule():
    raw = np.arange(256, dtype=np.uint8)
    got = k1.widen_rtl_u8(torch.from_numpy(raw))
    assert got.dtype == torch.int16
    assert torch.equal(got, _widened(raw))
    assert torch.equal(widen_wire(torch.from_numpy(raw), "rtl_u8"), got)


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_plain_k1_on_bytes_equals_k1_on_the_widened_block(which):
    """A uint8 block through ``chain_fm_plain`` (and the wrapper, which
    takes the plain path for a CPU tensor) equals the same block widened
    by the host rule and run as int16: PCM and the FM carry, 0 LSB."""
    ch = CHAINS[which]()
    plan = ch.packed_plan
    assert ch.taps.reads_wire("rtl_u8") and ch.taps.body == "tile"
    rows = 5
    carry = _widened(_bytes(plan.carry_vals, 1))
    raw = _bytes(rows * plan.row, 2)
    prev = torch.from_numpy(np.random.default_rng(3).normal(
        scale=1e5, size=(2, plan.nr_channels)).astype(np.float32))
    want, wprev = k1.chain_fm_plain(ch.taps, carry, prev, _widened(raw))
    for fn in (k1.chain_fm_plain, k1.chain_fm):
        got, gprev = fn(ch.taps, carry, prev, torch.from_numpy(raw),
                        "rtl_u8")
        assert got.dtype == torch.int16
        assert torch.equal(got, want) and torch.equal(gprev, wprev)


def test_k1_refuses_a_wire_it_does_not_read():
    ch = _tiny_chain()
    plan = ch.packed_plan
    carry = torch.zeros(plan.carry_vals, dtype=torch.int16)
    prev = torch.zeros((2, plan.nr_channels))
    block = torch.from_numpy(_bytes(plan.row, 4))
    with pytest.raises(ValueError, match="widen"):
        k1.chain_fm(ch.taps, carry, prev, block, "cu8")
    assert not ch.taps.reads_wire("cu8") and not ch.taps.reads_wire("cs8")


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_the_carry_straddles_blocks_as_on_the_widened_stream(which):
    """Three consecutive rtl_u8 blocks through ``step_raw``, the second
    shorter than the carry (so the carry is the old carry's end and the
    whole widened block): PCM, FM carry and int16 carry equal the run on
    the host-widened stream."""
    ch = CHAINS[which]()
    plan = ch.packed_plan
    q = plan.row
    lens = [4 * q, q, 3 * q]
    assert q < plan.carry_vals
    raw = _bytes(plan.carry_vals + sum(lens), 5)
    wide = _widened(raw)

    def state(carry):
        z = torch.zeros(plan.nr_channels)
        return MultifmFastState(carry_vals=carry, prev_r=z,
                                prev_i=z.clone(), out_index=0)

    s8 = state(wide[:plan.carry_vals].clone())
    s16 = state(wide[:plan.carry_vals].clone())
    at = plan.carry_vals
    for n in lens:
        s8, pcm8 = step_raw(ch.taps, s8, torch.from_numpy(raw[at:at + n]),
                            "rtl_u8")
        s16, pcm16 = step_raw(ch.taps, s16, wide[at:at + n])
        at += n
        assert torch.equal(pcm8, pcm16)
        assert s8.carry_vals.dtype == torch.int16
        assert torch.equal(s8.carry_vals, s16.carry_vals)
        assert torch.equal(s8.carry_vals, wide[at - plan.carry_vals:at])
        assert torch.equal(s8.prev_r, s16.prev_r)
        assert torch.equal(s8.prev_i, s16.prev_i)
        assert s8.out_index == s16.out_index


def test_the_pipeline_counts_the_blocks_k1_read_as_bytes():
    """A tiny rtl_u8 pipeline: every block's K1 reads the bytes
    (``stream_stats()["k1_wire8"]``), a cs16 one counts none, and the
    decoded pages are the same as those of the cs16 stream that the bytes
    widen to; a cu8 pipeline, whose bytes K1 does not read, counts none
    and decodes what its widened cs16 stream decodes."""
    fs, dec = 200_000, 8
    taps = firdes_low_pass(1.0, fs, 10_000, 5_000)
    specs = [ChannelSpec(929_500_000 + off, "pocsag", dc_block=True)
             for off in (-60_000, 20_000, 260_000)]

    def pipe(wire):
        return ReceivePipeline(taps, 929_500_000, fs, dec, specs,
                               exact=False, block_size=100_000,
                               inflight_depth=2, wire_fmt=wire, device="cpu",
                               drain_async=False)

    p8, p16 = pipe("rtl_u8"), pipe("cs16")
    raw = np.random.default_rng(6).integers(
        110, 145, size=(p8.chain.carry_len + 3 * p8.block_size, 2),
        dtype=np.uint8)
    got8 = p8.push(raw) + [p8.flush()]
    got16 = p16.push(widen_iq_bytes(raw.reshape(-1), "rtl_u8")
                     .reshape(-1, 2)) + [p16.flush()]
    assert p8.stream_stats["k1_wire8"] == p8.stream_stats["blocks"] == 3
    assert p16.stream_stats["k1_wire8"] == 0
    assert p16.stream_stats["blocks"] == 3
    assert repr(got8) == repr(got16)
    pu, pw = pipe("cu8"), pipe("cs16")
    got_u = pu.push(raw) + [pu.flush()]
    got_w = pw.push(widen_iq_bytes(raw.reshape(-1), "cu8")
                    .reshape(-1, 2)) + [pw.flush()]
    assert pu.stream_stats["k1_wire8"] == 0
    assert pu.stream_stats["blocks"] == 3
    assert repr(got_u) == repr(got_w)


def _aliased_root(dest: Path) -> tuple[Path, dict]:
    """``dest`` holding a copy of ``sdrbench/`` and a ``BENCHMARK.json`` of
    one tiny rtl_u8 cell (the shape of ``sdrbench/tests/conftest.py``'s
    ``make_root(wire="rtl_u8")``): 4 channels at 200 kHz, decimation 8,
    the last one tuned 260 kHz from the centre, beyond fs/2, which the
    digital mixer aliases to +60 kHz, 40 kHz from its neighbour."""
    shutil.copytree(REPO / "sdrbench", dest / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    offs = [-60_000, -20_000, 20_000, 260_000]
    cfg = {"source": "test", "sampleRateHz": 200_000,
           "centerFreqHz": 929_500_000, "decimationFactor": 8,
           "lpfTaps": [float(t) for t in
                       firdes_low_pass(1.0, 200_000, 10_000, 5_000)],
           "channels": [{"chanCenterFreq": 929_500_000 + o} for o in offs],
           "protocols": ["pocsag", "pocsag", "flex", "flex"],
           "dcBlock": True, "wire": "rtl_u8", "blockSize": 400_000,
           "inflightDepth": 2}
    (dest / "sdrbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "sdrbench/traffic/quiet.json").read_text())
    mix.update(meanIntervalS=8, minAirS=12)
    (dest / "sdrbench/traffic/tinymix.json").write_text(json.dumps(mix))
    shutil.copy(REPO / "sdrbench/reference/limits/rtlsdr-8ch.json",
                dest / "sdrbench/reference/limits/tiny.json")
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = dict(real)
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "sdrbench/configs/tiny.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [{"name": "tiny.quiet", "config": "tiny",
                          "traffic": "tinymix", "chips": 1, "why": "test"}]
    spec["per_layer"] = [m for m in real["per_layer"]
                         if m["name"] == "engine.k1_wire8_pct"]
    spec["per_layer"][0]["workloads"] = ["tiny.quiet"]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest, spec


def test_the_port_agrees_with_the_plain_receiver_on_an_aliased_channel(
        tmp_path, monkeypatch):
    """The benchmark's check on a tiny rtl_u8 band with a channel beyond
    fs/2, over the whole segment: every message due decoded on its
    channel, the aliased one's included, none invented, and K1's last PCM,
    the DC blockers' state and the FLEX rows' carried PCM within the
    cell's limits of the plain float64 receiver
    (``sdrbench/reference/receiver.py``)."""
    root, spec = _aliased_root(tmp_path)
    # the window is the segment's 6 blocks whatever the host's load: a
    # clock that reads a quarter second later at each reading, two a push
    ticks = itertools.count()
    monkeypatch.setattr(bench.time, "perf_counter",
                        lambda: 0.25 * next(ticks))
    keep = {}
    res = bench.run("tiny.quiet", 11, 3.0, False, device="cpu", bench=spec,
                    root=root, keep=keep)
    monkeypatch.undo()
    replay = keep["replay"]
    assert keep["blocks"] * replay.block == replay.n
    assert res["correct"], res["checks"]
    mix = json.loads((root / "sdrbench/traffic/tinymix.json").read_text())
    msgs = synth.schedule(bench.channel_table(keep["cfg"]), mix, 11,
                          200_000, replay.n)
    due = [m for m in msgs if m.end <= replay.pushed(keep["blocks"])]
    assert res["attempted"] == len(due) and res["failed"] == 0
    assert any(m.channel == 3 for m in due)


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 11, 4_000_000_007])
def test_the_20_minute_mix_carries_80_messages_on_every_seed(seed):
    """``quiet-20min`` on the cell's channels and blocks (72 of
    16,760,000 samples): 80 messages, 60 POCSAG and 20 FLEX, whatever the
    seed draws."""
    mix = json.loads((REPO / "sdrbench/traffic/quiet-20min.json")
                     .read_text())
    quiet = json.loads((REPO / "sdrbench/traffic/quiet.json").read_text())
    assert {k: v for k, v in mix.items() if k != "minAirS"} == \
        {k: v for k, v in quiet.items() if k != "minAirS"}
    fs = CELL_CFG["sampleRateHz"]
    block = 16_760_000
    n_blocks = synth.segment_blocks(mix, fs, block)
    assert n_blocks == 72
    msgs = synth.schedule(bench.channel_table(CELL_CFG), mix, seed, fs,
                          n_blocks * block)
    assert len(msgs) == 80
    assert sum(m.protocol == "pocsag" for m in msgs) == 60
    assert sum(m.protocol == "flex" for m in msgs) == 20
