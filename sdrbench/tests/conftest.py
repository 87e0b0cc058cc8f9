"""Fixtures of the benchmark's own tests: a copy of ``sdrbench/`` with a
tiny cell that the CPU runs in seconds (the program's plain versions stand
in for its kernels there)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TINY = "tiny.quiet"


def make_root(dest: Path, wire: str = "cs16") -> tuple[Path, dict]:
    """``dest`` holding a copy of ``sdrbench/`` and a ``BENCHMARK.json``
    of one tiny cell: 4 channels 40 kHz apart at 200 kHz (2 POCSAG, 2
    FLEX, so each gate group has two rows), decimation 8
    (25 kHz channels, so the cells' resampler ratios), 2 s blocks, a
    message a channel per 8 s of air, the limits of ``airspy-8ch``."""
    from sdrbench.reference.receiver import firdes_low_pass

    shutil.copytree(REPO / "sdrbench", dest / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = {"source": "test", "sampleRateHz": 200_000,
           "centerFreqHz": 929_500_000, "decimationFactor": 8,
           "lpfTaps": [float(t) for t in
                       firdes_low_pass(1.0, 200_000, 10_000, 5_000)],
           "channels": [{"chanCenterFreq": 929_440_000 + 40_000 * i}
                        for i in range(4)],
           "protocols": ["pocsag", "pocsag", "flex", "flex"],
           "dcBlock": True,
           "wire": wire, "blockSize": 400_000, "inflightDepth": 2}
    (dest / "sdrbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "sdrbench/traffic/quiet.json").read_text())
    mix.update(meanIntervalS=8, minAirS=12)
    (dest / "sdrbench/traffic/tinymix.json").write_text(json.dumps(mix))
    shutil.copy(REPO / "sdrbench/reference/limits/airspy-8ch.json",
                dest / "sdrbench/reference/limits/tiny.json")
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = dict(real)
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "sdrbench/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": TINY, "config": "tiny",
                           "traffic": "tinymix", "chips": 1, "why": "test"}]
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in real["per_layer"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest, bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
