#!/usr/bin/env python3
"""The copy of a block into a pinned upload slot, by the number of parts.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 bench/torch_pin_copy.py [--rounds 40] [--out FILE]

It copies blocks of a replay held in host memory (11 blocks of the
``airspy-8ch`` cell's 16,680,000 cs16 samples, 734 MB, as the benchmark
replays them) into one pinned buffer of a block, as
``ReceivePipeline._upload`` does: in one part with ``np.copyto``, and in 2,
3, 4, 6 and 8 parts with ``tsl_sdr_tpu_torch.runtime.native.pin_copy``
(the calling thread and the pool's threads), each round over the counts in
turns; then 4, 8, 16 and 32 MiB in one part and in two.
It prints one JSON line: per count and size the median and quartiles of the
copy in milliseconds and GB/s, with the card's name and power limit, the
process's CPUs and torch's version. Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCK_VALUES = 2 * 16_680_000          # the airspy-8ch cell's block, cs16
REPLAY_BLOCKS = 11
PARTS = (1, 2, 3, 4, 6, 8)
SIZES_MIB = (4, 8, 16, 32)


def card() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return {"nvidia_smi": out}


def summary(times_s: list, nbytes: int) -> dict:
    q1, med, q3 = statistics.quantiles(times_s, n=4)
    return {"ms_median": 1e3 * med, "ms_q1": 1e3 * q1, "ms_q3": 1e3 * q3,
            "gb_s_median": nbytes / med / 1e9, "n": len(times_s)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.runtime import native

    def copy(dst, src, parts):
        if parts == 1:
            np.copyto(dst, src)
        else:
            native.pin_copy(dst, src, parts)

    if not torch.cuda.is_available():
        print("torch_pin_copy: needs a CUDA GPU (pinned memory)",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(1)
    replay = rng.integers(-2048, 2048, size=REPLAY_BLOCKS * BLOCK_VALUES,
                          dtype=np.int16)
    blocks = replay.reshape(REPLAY_BLOCKS, BLOCK_VALUES)
    slot = torch.empty(BLOCK_VALUES, dtype=torch.int16,
                       pin_memory=True).numpy()
    copy(slot, blocks[0], max(PARTS))      # start the pool's threads

    times = {p: [] for p in PARTS}
    k = 0
    for r in range(args.rounds):
        for p in (PARTS if r % 2 == 0 else PARTS[::-1]):
            src = blocks[k % REPLAY_BLOCKS]
            k += 1
            t0 = time.perf_counter()
            copy(slot, src, p)
            times[p].append(time.perf_counter() - t0)
    if not np.array_equal(slot, blocks[(k - 1) % REPLAY_BLOCKS]):
        raise RuntimeError("the last copy does not equal its block")
    block = {str(p): summary(t, slot.nbytes) for p, t in times.items()}

    sized = {}
    for mib in SIZES_MIB:
        n = (mib << 20) // 2
        got = {1: [], 2: []}
        for r in range(args.rounds):
            for p in ((1, 2) if r % 2 == 0 else (2, 1)):
                src = blocks[k % REPLAY_BLOCKS][:n]
                k += 1
                t0 = time.perf_counter()
                copy(slot[:n], src, p)
                got[p].append(time.perf_counter() - t0)
        sized[str(mib)] = {str(p): summary(t, 2 * n) for p, t in got.items()}

    res = {"block_bytes": slot.nbytes, "cpus": len(os.sched_getaffinity(0)),
           "torch": torch.__version__, **card(), "rounds": args.rounds,
           "block_by_parts": block, "size_mib_by_parts": sized}
    line = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
