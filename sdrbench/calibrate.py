#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell.

    python3 sdrbench/calibrate.py --workload <cell> --seeds 101-112 \\
        --control 3 --seconds 8

runs the cell's timed path (set-up, a window of ``--seconds`` at the
cell's load, the check) once for each seed in one process, and prints each
run's numbers compared. For the first ``--control`` seeds it also puts the
control in the program's place: the plain chain in bfloat16 against the
plain chain in float64 on the same stream, read at the same points. The
benchmark's own runs never run the control. One JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from sdrbench import bench

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA GPU", file=sys.stderr)
        return 2
    for i, seed in enumerate(seeds(args.seeds)):
        keep = {}
        res = bench.run(args.workload, seed, args.seconds, False,
                        device=args.device, keep=keep)
        line = {"seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "msps": res["metrics"].get("msps", {}).get("value")}
        if i < args.control:
            ref = bench.reference_state(keep["cfg"], keep["replay"],
                                        keep["blocks"], args.device)
            ctl = bench.reference_state(keep["cfg"], keep["replay"],
                                        keep["blocks"], args.device,
                                        precision="bf16")
            line["control"] = bench.compare(ctl["values"], ref)
        print(json.dumps(line), flush=True)
        del keep
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
