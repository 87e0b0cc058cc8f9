"""Worker process of the multi-process receive-pipeline self-test.

Run as ``python -m tsl_sdr_tpu_torch.parallel._mh_pipeline_worker`` through
:func:`tsl_sdr_tpu_torch.parallel.multihost.launch_workers` (port of
``tsl_sdr_tpu/parallel/_mh_pipeline_worker.py``). Each worker joins the
gloo group, builds a global mesh over every rank's ``--n-local`` devices,
runs the whole :class:`~tsl_sdr_tpu_torch.models.pipeline.ReceivePipeline`
on it over a deterministic two-burst POCSAG capture (each rank uploads its
own spans; halos and the per-block gather cross the process boundary) and
saves what it decoded and its counters; the launcher checks every rank
decodes the messages of a single-process run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _capture(fs: int, decim: int):
    """Deterministic two-burst POCSAG capture (NBFM at +250 kHz)."""
    import numpy as np

    from tsl_sdr_tpu_torch.testing import pocsag_gen

    def burst(cap, txt):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=txt)],
            baud=1200, amplitude=4096, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 4500
        rep = fs // 38400
        inst = np.repeat(250_000 + dev, rep)
        ph = np.cumsum(2 * np.pi * inst / fs)
        return (np.stack([np.cos(ph), np.sin(ph)], -1) * 8000).astype(
            np.int16)

    rng = np.random.default_rng(9)
    pad = rng.integers(-300, 300, size=(500_000, 2)).astype(np.int16)
    iq = np.concatenate([pad, burst(7001, "MH PIPE ONE"), pad,
                         burst(7002, "MH PIPE TWO"), pad])
    return (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)


def run_pipeline(mesh, device="cpu"):
    """Build and run the deterministic pipeline (on ``mesh``, or on
    ``device`` without one); returns (message tuples, stream stats)."""
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    decim, fs, center = 32, 38400 * 32, 929_500_000
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    pipe = ReceivePipeline(
        lpf, center, fs, decim,
        [ChannelSpec(center + 250_000, "pocsag"),
         ChannelSpec(center - 250_000, "pocsag")],  # silent: gated
        exact=False, block_size=393_216, device=device, mesh=mesh)
    res = pipe.process_capture(_capture(fs, decim))
    msgs = [[(m.capcode, bytes(m.data).decode("latin-1")) for m in ch]
            for ch in res]
    return msgs, pipe.stream_stats


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--n-local", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--channels", type=int, default=1,
                    help="mesh channel-axis size (time axis gets the rest)")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args()

    from tsl_sdr_tpu_torch.parallel import multihost
    from tsl_sdr_tpu_torch.parallel._mh_worker import local_devices

    multihost.init(f"127.0.0.1:{args.port}", num_processes=args.nproc,
                   process_id=args.pid)
    assert multihost.world_size() == args.nproc, multihost.world_size()
    mesh = multihost.make_global_mesh(
        args.channels, local_devices=local_devices(args.device, args.n_local))
    msgs, stats = run_pipeline(mesh)
    with open(os.path.join(args.outdir, f"mhp_out_{args.pid}.json"),
              "w") as f:
        json.dump({"msgs": msgs, "blocks": int(stats["blocks"]),
                   "fetched": [int(v) for v in stats["fetched"]],
                   "upload_elems": int(stats["upload_elems"]),
                   "halo_bytes": int(stats["halo_bytes"])}, f)
    print(json.dumps({"pid": args.pid, "procs": multihost.world_size(),
                      "mesh": list(mesh.devices.shape), "msgs": msgs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
