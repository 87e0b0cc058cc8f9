#!/usr/bin/env python3
"""Where ``multifm-torch``'s wall goes on the card, at
``etc/multifm_rtlsdr_8ch.json`` (1 Msps, decimation 40, 365 taps, 8
channels, 262,080-sample blocks).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 bench/torch_multifm_profile.py [--turns 3] [--seconds 60]

It feeds ``chip_smoke.py``'s synthetic rtl_u8 capture (one POCSAG burst a
channel, 2.95 M samples), followed by noise up to ``--seconds`` seconds at
the config's rate, through ``--iq-file``, in process. A run of tens of
seconds is needed for the work of each block to outweigh the run's set-up
and the host's noise. It prints:

* the wall of each run, in turns: the kernels' run, then the same run with
  every kernel swapped for its plain version (``chip_smoke.plain_kernels``),
  ``--turns`` times, for both tiers under both I/O runtimes; the first run
  of the process carries its one-time costs and is printed apart;
* one ``torch.profiler`` table (CPU and CUDA) of a bit-exact
  ``--runtime python`` run: its operators by host time, with the run's
  host (self CPU) and device (self CUDA) totals in the table's footer, and
  the card's busy share: that device total over the median wall of the
  unprofiled exact python runs.

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=60.0,
                    help="capture length in seconds at the config's rate")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for name in ("jax", "jaxlib", "tsl_sdr_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tsl_sdr_tpu_torch.cli import multifm
    from tsl_sdr_tpu_torch.kernels import build
    from tsl_sdr_tpu_torch.testing import pager
    from tsl_sdr_tpu_torch.utils.config import MultifmConfig

    if not torch.cuda.is_available():
        print("torch_multifm_profile: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    build.load()
    base = ROOT / "etc" / "multifm_rtlsdr_8ch.json"
    cfg = MultifmConfig.load(base)
    wire, _ = cs.multifm_capture(cfg)
    tmp = Path(tempfile.mkdtemp())
    n = max(int(args.seconds * cfg.sample_rate_hz), wire.shape[0])
    rng = np.random.default_rng(13)
    with open(tmp / "cap.u8", "wb") as f:
        f.write(wire.tobytes())
        # noise as multifm_capture's, made and written in chunks
        for lo in range(wire.shape[0], n, 1 << 22):
            k = min(1 << 22, n - lo)
            f.write(pager.to_rtl_u8(rng.normal(scale=60, size=(k, 2)))
                    .tobytes())
    (tmp / "over.json").write_text(json.dumps({"channels": [
        {"outFifo": str(tmp / f"ch{k}.pcm"),
         "chanCenterFreq": ch.chan_center_freq}
        for k, ch in enumerate(cfg.channels)]}))

    def run(flags, plain=False, prof=None) -> float:
        argv = [str(base), str(tmp / "over.json"), "--device", "cuda",
                "--iq-file", str(tmp / "cap.u8"), "--iq-format", "rtl_u8",
                *flags]
        err = io.StringIO()
        swap = cs.plain_kernels() if plain else contextlib.nullcontext()
        trace = prof if prof is not None else contextlib.nullcontext()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), swap, trace:
            rc = multifm.main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"multifm-torch {flags} exited {rc}: "
                             f"{err.getvalue()}")
        return wall

    print(f"capture: {n} samples ({n / cfg.sample_rate_hz:.1f} s); first run of the process (exact, python "
          f"runtime): {run(['--exact', '--runtime', 'python']):.4f} s",
          flush=True)
    medians = {}
    for tier in ("exact", "production"):
        for runtime in ("python", "native"):
            flags = [*(["--exact"] if tier == "exact" else []),
                     "--runtime", runtime]
            walls = {"kernels": [], "plain": []}
            for _ in range(args.turns):
                for key in ("kernels", "plain"):
                    walls[key].append(run(flags, plain=key == "plain"))
            med = {k: sorted(v)[args.turns // 2] for k, v in walls.items()}
            medians[tier, runtime] = med["kernels"]
            print(f"{card} | multifm-torch {tier} {runtime}, in turns: "
                  f"{json.dumps(walls)}; medians: kernels {med['kernels']} s "
                  f"= {n / med['kernels'] / 1e6} Msps, plain {med['plain']} "
                  f"s = {n / med['plain'] / 1e6} Msps", flush=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = run(["--exact", "--runtime", "python"], prof=prof)
    # the wall includes the profiler's own start-up; the table's footer
    # gives the run's host (self CPU) and device (self CUDA) totals
    print(f"{card} | profiled exact python run (wall {wall:.4f} s):",
          flush=True)
    events = prof.key_averages()
    print(events.table(sort_by="cpu_time_total", row_limit=12), flush=True)
    # the footer's sum: device kernels, not the host operators' share
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    print(f"{card} | exact python: device busy {dev_us / 1e6} s of the "
          f"unprofiled median wall {medians['exact', 'python']} s = "
          f"{dev_us / 1e6 / medians['exact', 'python']:.2%}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
