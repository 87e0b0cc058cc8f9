"""The harness: cells found by name, files added without an edit, the
result line, the seed, the roofline counts, the imports."""

from __future__ import annotations

import ast
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from conftest import REPO, TINY, make_root

from sdrbench import bench, roofline, synth

FORBIDDEN = {"jax", "jaxlib", "flax", "tsl_sdr_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_every_cell_is_found_by_name():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["workloads"]
    for wl in spec["workloads"]:
        got, entry = bench.find_cell(spec, wl["name"])
        assert got is wl and entry["name"] == wl["config"]
        assert (REPO / entry["file"]).is_file()
        assert (REPO / "sdrbench/traffic" / f"{wl['traffic']}.json").is_file()
        assert (REPO / "sdrbench/reference/limits"
                / f"{wl['config']}.json").is_file()
    for m in spec["per_layer"]:
        assert hasattr(bench.metric_reader(m["name"]), "read")
    with pytest.raises(KeyError):
        bench.find_cell(spec, "no-such.cell")


def test_a_configuration_mix_metric_and_cell_are_added_as_files(tmp_path):
    root, spec = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "sdrbench").rglob("*.py")}
    cfg = json.loads((root / "sdrbench/configs/tiny.json").read_text())
    cfg["channels"][3]["chanCenterFreq"] -= 10_000
    (root / "sdrbench/configs/added.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "sdrbench/traffic/tinymix.json").read_text())
    mix["meanIntervalS"] = 10
    (root / "sdrbench/traffic/addedmix.json").write_text(json.dumps(mix))
    shutil.copy(root / "sdrbench/reference/limits/tiny.json",
                root / "sdrbench/reference/limits/added.json")
    (root / "sdrbench/metrics/added.blocks.py").write_text(
        "def read(ctx):\n    return float(ctx['blocks'])\n")
    spec["configs"].append({"name": "added", "source": "test",
                            "file": "sdrbench/configs/added.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "added.mix", "config": "added",
                              "traffic": "addedmix", "chips": 1,
                              "why": "test"})
    spec["per_layer"] = [{"name": "added.blocks", "unit": "blocks",
                          "better": "higher", "source": "program_counter",
                          "layer": "host engine", "moves": "msps",
                          "workloads": ["added.mix"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = bench.run("added.mix", 3, 1.0, True, device="cpu", bench=spec,
                    root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["added.blocks"]["value"] >= 1
    assert {p: p.read_bytes() for p in before} == before


def test_a_tiny_run_prints_the_result_line(tiny):
    from sdrbench import run

    root, spec = tiny
    res = bench.run(TINY, 2**31 + 12345, 1.0, False, device="cpu",
                    bench=spec, root=root)
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    assert set(line["metrics"]) == {"msps", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    lines = err.getvalue().splitlines()[-len(line["checks"]):]
    assert [x.split()[2].rstrip(":") for x in lines] == list(line["checks"])


def test_the_same_seed_gives_the_same_messages_and_samples(tiny):
    root, _ = tiny
    cfg = json.loads((root / "sdrbench/configs/tiny.json").read_text())
    mix = json.loads((root / "sdrbench/traffic/tinymix.json").read_text())
    chans = bench.channel_table(cfg)
    n = 6 * cfg["blockSize"]

    def make(seed):
        return synth.synthesize(chans, mix, seed, cfg["sampleRateHz"], n,
                                "cs16", "cpu")

    (a, ma), (b, mb), (c, mc) = make(7), make(7), make(8)
    assert ma == mb and np.array_equal(a, b)
    assert ma != mc and not np.array_equal(a, c)
    # another seed: other arrivals, the same amount of traffic
    assert [m.start for m in ma] != [m.start for m in mc]
    assert sorted((m.protocol, len(m.text)) for m in ma) == \
        sorted((m.protocol, len(m.text)) for m in mc)
    assert all(m.end <= n for m in ma)


def test_roofline_counts_by_hand():
    # 1,200 samples, 3 channels, 5 taps, decimation 4, cs16: 300 outputs a
    # channel, 4 real multiply-adds a complex tap
    macs = 300 * 3 * 4 * 5
    nbytes = 1200 * 4 + 300 * 3 * 2
    assert roofline.k1_least_s(1200, 3, 5, 4, "cs16") == max(
        8 * macs / 1979e12, nbytes / 3.35e12)
    # the Kaiser length int((7 / 0.1102 + 8.7) / (22 * 0.1 / 192)) = 6,302,
    # made odd; 125 inputs, 2 rows, 192/125: 192 outputs of 33 taps
    assert roofline.resampler_taps(192, 125) == 6303
    macs = 2 * 192 * 33
    nbytes = 2 * (125 + 192) * 2
    assert roofline.resample_least_s(125, 2, 192, 125, 6303) == max(
        8 * macs / 1979e12, nbytes / 3.35e12)


def test_nothing_imports_jax_or_the_jax_package():
    for path in (REPO / "sdrbench").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_takes_nothing_of_the_program():
    for path in (REPO / "sdrbench/reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"tsl_sdr_tpu_torch", "sdrbench"}, path
        names = {n.id for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(ast.parse(path.read_text()))
                  if isinstance(n, ast.Attribute)}
        assert not [n for n in names if n.endswith("_plain")], path


@pytest.mark.parametrize("gen", ["pocsag", "flex"])
def test_the_generators_are_the_programs(gen):
    from sdrbench import siggen
    from tsl_sdr_tpu_torch.testing import flex_gen, pocsag_gen

    text = "Hello pager 0123456789 ~!"
    if gen == "pocsag":
        for cap in (1_300_013, 8, 2_097_151):
            want = pocsag_gen.generate(
                [pocsag_gen.PocsagBurst(capcode=cap, function=2,
                                        kind="alpha", content=text)],
                baud=1200, amplitude=4096, tail_bits=256)
            got = siggen.pocsag_pcm(cap, 2, text.encode(), baud=1200,
                                    amplitude=4096)
            assert np.array_equal(got, want)
    else:
        for cap in (1, 123_456, 1_900_000):
            want, exp = flex_gen.generate(
                [flex_gen.FlexBurstMessage(capcode=cap, kind="alnum",
                                           content=text)],
                baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
            got = siggen.flex_pcm(cap, text.encode(), amplitude=6144)
            assert np.array_equal(got, want)
            assert exp[0]["text"] == siggen.flex_expected(text.encode())


def test_match_judges_answers_and_sets_noise_apart():
    m = synth.Message(channel=1, protocol="pocsag", start=1000, end=3000,
                      capcode=8, function=1, text=b"abc")
    seg = np.zeros((10_000, 2), np.int16)
    replay = bench.Replay(seg, 1000, 100)
    calls = [(float(i), i + 0.5) for i in range(25)]   # 24 pushes, flush
    key = m.key()
    other = ("pocsag", 9, 0, b"zz")
    far = np.full((3, 3), -30.0)
    np.fill_diagonal(far, 0.0)
    # 24,100 samples pushed: the message is due in three passes. Pass 0
    # decoded on time and leaked onto channel 0; pass 1 (ending at 13,000)
    # garbled while on air, with no contest; pass 2 lost; a page that
    # matches nothing on channel 2, which carried nothing
    decoded = [(1, key, 4), (0, key, 5), (1, other, 12), (2, other, 20)]
    res = bench.match([m], replay, decoded, calls, 2, far, 20.0, 40.0)
    assert res["attempted"] == 3 and res["jammed"] == 0
    assert res["missed"] == 2 and res["invented"] == 2
    assert res["leaked"] == 1 and res["garbled"] == 0
    assert res["latency_s"] == [calls[4][1] - calls[2][0]]
    # a neighbour 5 dB down on air at once jams both: neither is due, and
    # a page that matches nothing in their window is garbled, outside it
    # invented
    n = synth.Message(channel=2, protocol="pocsag", start=1500, end=2500,
                      capcode=16, function=0, text=b"de")
    near = far.copy()
    near[1, 2] = near[2, 1] = -5.0
    res = bench.match([m, n], replay,
                      [(1, key, 5), (0, other, 3), (0, other, 9)], calls,
                      2, near, 20.0, 40.0)
    assert res["attempted"] == 0 and res["jammed"] == 6
    assert res["jammed_decoded"] == 1
    assert res["missed"] == 0 and res["garbled"] == 1
    assert res["invented"] == 1


def test_leakage_is_the_channel_filters_gain_at_the_offset():
    from sdrbench.reference.receiver import firdes_low_pass

    cfg = {"sampleRateHz": 200_000, "centerFreqHz": 0,
           "lpfTaps": list(firdes_low_pass(1.0, 200_000, 10_000, 5_000)),
           "channels": [{"chanCenterFreq": f} for f in (0, 5_000, 60_000)],
           "protocols": ["pocsag"] * 3}
    db = bench.leakage_db(cfg, 1_000)
    assert np.allclose(db, db.T) and np.all(np.diag(db) == 0)
    assert -1.0 < db[0, 1] <= 0.5          # inside the passband
    assert db[0, 2] < -40                  # far in the stopband
    # upstream's Airspy filter passes every channel into every other, and
    # its two closest channels (929.362 and 929.388 MHz) into each other
    # above their own level
    cfg = json.loads((REPO / "sdrbench/configs/airspy-8ch.json").read_text())
    db = bench.leakage_db(cfg, 6_000)
    assert db[2, 4] > 0 and db.min() > -40


def test_a_busy_share_puts_messages_back_to_back(tiny):
    root, _ = tiny
    cfg = json.loads((root / "sdrbench/configs/tiny.json").read_text())
    mix = json.loads((root / "sdrbench/traffic/tinymix.json").read_text())
    mix.update(busyShare=0.5, meanIntervalS=40)     # channels 0 and 2 busy
    fs = cfg["sampleRateHz"]
    msgs = synth.schedule(bench.channel_table(cfg), mix, 3, fs,
                          6 * cfg["blockSize"])
    gap = int(mix["gapS"] * fs)
    for ch in (0, 2):
        mine = [m for m in msgs if m.channel == ch]
        assert len(mine) > 3
        assert all(b.start == a.end + gap for a, b in zip(mine, mine[1:]))
    assert any(m.channel in (1, 3) for m in msgs)
