"""The check that decides ``correct``: the program passes it, and the
control and the faults that a cell can have fail it."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO, TINY

from sdrbench import bench

LIMITS = json.loads((REPO / "sdrbench/reference/limits/airspy-8ch.json")
                    .read_text())


def _run(tiny, seed=5, seconds=1.0, keep=None):
    root, spec = tiny
    return bench.run(TINY, seed, seconds, False, device="cpu", bench=spec,
                     root=root, keep=keep)


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_the_program_passes_and_the_control_fails(tiny, seed):
    keep = {}
    res = _run(tiny, seed, keep=keep)
    assert res["correct"], res["checks"]
    ref = bench.reference_state(keep["cfg"], keep["replay"], keep["blocks"],
                                "cpu")
    ctl = bench.reference_state(keep["cfg"], keep["replay"], keep["blocks"],
                                "cpu", precision="bf16")
    readings = bench.compare(ctl["values"], ref)
    assert any(v > LIMITS[k] for k, v in readings.items()), readings
    assert bench.compare(ref["values"], ref) == {"k1_gap_lsb": 0.0,
                                                 "dc_state_gap_lsb": 0.0,
                                                 "flex_tail_gap_lsb": 0.0}


def test_an_answer_altered_where_it_is_produced_fails(tiny, monkeypatch):
    from tsl_sdr_tpu_torch.models import pocsag

    scan = pocsag.PocsagDecoder.scan

    def altered(self, pcm):
        out = scan(self, pcm)
        for m in out:
            m.data = m.data[:-1] + b"?"
        return out

    monkeypatch.setattr(pocsag.PocsagDecoder, "scan", altered)
    res = _run(tiny)
    assert not res["correct"]
    assert res["checks"]["missed"]["value"] > 0
    assert res["checks"]["invented"]["value"] > 0


def test_a_step_that_returns_its_state_unchanged_fails(tiny, monkeypatch):
    from tsl_sdr_tpu_torch.parallel import pipeline

    step = pipeline.MeshEngine.step

    def frozen(self, st, flat, stats):
        _, outs = step(self, st, flat, stats)
        return st, outs

    monkeypatch.setattr(pipeline.MeshEngine, "step", frozen)
    res = _run(tiny)
    assert not res["correct"]
    assert res["checks"]["k1_gap_lsb"]["value"] > LIMITS["k1_gap_lsb"]


def test_half_of_the_rows_left_out_fails(tiny, monkeypatch):
    from tsl_sdr_tpu_torch.ops import gate

    egress = gate.egress_gate

    def half(mode, rows, tail):
        rows = list(rows)
        keep = (len(rows) + 1) // 2
        rows = rows[:keep] + [torch.zeros_like(r) for r in rows[keep:]]
        return egress(mode, rows, tail)

    monkeypatch.setattr(gate, "egress_gate", half)
    res = _run(tiny)
    assert not res["correct"]
    assert res["checks"]["flex_tail_gap_lsb"]["value"] > \
        LIMITS["flex_tail_gap_lsb"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda):
    import subprocess
    import sys

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for wl in spec["workloads"]:
        out = subprocess.run(
            [sys.executable, "sdrbench/run.py", "--workload", wl["name"],
             "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.splitlines()[-1])
        assert line["correct"], line["checks"]
