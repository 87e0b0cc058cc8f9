#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 sdrbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA GPUs the cell
asks for. ``--trace 0`` measures the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics under ``torch.profiler``. The last
line on standard output is one JSON object; the numbers that decided
``correct`` are the last lines on standard error. Exits 2 without a result
where the GPUs are missing, 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tsl_sdr_tpu")


def loaded_forbidden() -> list[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def emit(res: dict, out=None, err=None) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for line in res.pop("examples", []):
        print(f"sdrbench: {line}", file=err or sys.stderr)
    for name, c in res["checks"].items():
        print(f"sdrbench check {name}: {c['value']} (limit {c['limit']})",
              file=err or sys.stderr)
    print(json.dumps(res), file=out or sys.stdout, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build caches at fixed paths inside the checkout, so that only a
    # checkout's first run builds; few threads, one process
    cache = ROOT / "build" / "sdrbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    sys.path.insert(0, str(ROOT))

    import torch

    from sdrbench import bench

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl, _ = bench.find_cell(spec, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(f"sdrbench: {args.workload} needs {wl['chips']} CUDA GPU(s), "
              f"found {have}", file=sys.stderr)
        return 2
    res = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                    device="cuda", bench=spec, t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"sdrbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
