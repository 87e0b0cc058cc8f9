#!/usr/bin/env python3
"""Where a benchmark cell's host time and the device's idle time go, by the
engine's spans (``tsl_sdr_tpu_torch.models.pipeline``, "Tracing").

Run from the root of a checkout on a machine with the cell's CUDA GPUs:

    python3 bench/torch_span_breakdown.py --workload airspy-8ch.quiet \\
        --seed <n> --seconds 50 --trace <0|1>

It runs the cell once through ``sdrbench.bench.run``, as
``sdrbench/run.py`` does, and prints one JSON line: the run's ``msps`` and
host milliseconds a block (from the harness's own clock, traced or not),
its metrics and ``correct``, and, with ``--trace 1``, each ``pipe.timing``
key in milliseconds a block, the device's idle seconds credited to each
span (``sdrbench/spans.py``), the ten longest idle gaps named by the
innermost span open at their start, and the program's spans a block. The result line of a traced run has no
``msps``; this one has, so a traced run's cost shows beside an untraced
one's. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "sdrbench"      # sdrbench/run.py's caches
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    sys.path.insert(0, str(ROOT))

    import torch

    from sdrbench import bench

    # the readers' context (pipe.timing, the reduced trace, the spans'
    # attribution once a span reader has made it), kept as they read it
    seen = {}
    load = bench.metric_reader

    class Kept:
        def __init__(self, mod):
            self.mod = mod

        def read(self, ctx):
            seen.update(ctx)
            return self.mod.read(ctx)

    bench.metric_reader = lambda name, root=ROOT: Kept(load(name, root))
    keep = {}
    res = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                    device="cuda", keep=keep, t_start=T_START)
    calls, blocks = keep["calls"], keep["blocks"]
    wall = calls[-1][1] - calls[0][0]
    out = {"workload": args.workload, "seed": args.seed,
           "trace": bool(args.trace),
           "device": torch.cuda.get_device_name(0), "blocks": blocks,
           "msps": keep["replay"].pushed(blocks) / wall / 1e6,
           "host_ms_per_block": 1e3 * wall / blocks,
           "correct": res["correct"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
    if args.trace:
        red = seen["trace"]
        got = seen.get("program_spans") or {}
        out.update(
            timing_ms={k: 1e3 * v / blocks
                       for k, v in sorted(seen["timing"].items())},
            window_s=red["window_s"], busy_s=red["busy_s"],
            idle_by_span_s=dict(sorted(got.get("idle_by_span", {}).items(),
                                       key=lambda kv: -kv[1])),
            idle_gaps=got.get("idle_gaps"),
            spans_per_block=got.get("spans", 0) / blocks,
            device_ops=res["breakdown"]["device_ops"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
