"""Worker process of the multi-process WEAK-SCALING witness.

Port of ``tsl_sdr_tpu/parallel/_mh_scaling_worker.py``. Run as
``python -m tsl_sdr_tpu_torch.parallel._mh_scaling_worker`` by
:func:`tsl_sdr_tpu_torch.parallel.multihost.run_scaling_witness`, one OS
process a rank (gloo over loopback; ``--device cpu`` stands one CPU in for
each of ``--n-local`` devices, ``cuda`` takes the CUDA devices it sees in
turn). The group runs the time-sharded channelizer
(:func:`~tsl_sdr_tpu_torch.parallel.channelizer.make_sharded_multifm`, K1
once a span on the card) on :func:`~tsl_sdr_tpu_torch.parallel.multihost.
selftest_chain`'s 2-channel bank with a FIXED span a process while the
process count grows: weak scaling.

What it witnesses is the communication structure: each rank uploads only
its own span (1/P of the global block), and the halo bytes that crossed
the process boundaries, counted by
:func:`~tsl_sdr_tpu_torch.parallel.multihost.neighbor_exchange`, are
written beside the formula's :func:`~tsl_sdr_tpu_torch.parallel.multihost.
dcn_halo_bytes`. The median step wall is recorded as the JAX worker
records it; on one box (or one card shared by the ranks) it is overhead,
not a scaling figure.

    python -m tsl_sdr_tpu_torch.parallel._mh_scaling_worker --pid 0 \\
        --nproc 1 --n-local 1 --port 29500 --outdir /tmp/w --device cpu

writes ``mhs_out_<pid>.json`` into ``--outdir`` and prints the record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--n-local", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--rows-per-shard", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops.chain import chain_fm
    from tsl_sdr_tpu_torch.parallel import multihost
    from tsl_sdr_tpu_torch.parallel._mh_worker import local_devices
    from tsl_sdr_tpu_torch.parallel.channelizer import make_sharded_multifm

    multihost.init(f"127.0.0.1:{args.port}", num_processes=args.nproc,
                   process_id=args.pid)
    assert multihost.world_size() == args.nproc, multihost.world_size()
    devs = local_devices(args.device, args.n_local)
    mesh = multihost.make_global_mesh(1, local_devices=devs)  # time only
    chain = multihost.selftest_chain(nr_channels=2, device=devs[0])
    plan = chain.packed_plan
    n_time = mesh.devices.shape[0]

    # weak scaling: a FIXED span a process; the global block grows with
    # the process count
    rng = np.random.default_rng(100 + args.pid)
    span = args.rows_per_shard * plan.row * args.n_local
    local_vals = rng.integers(-8000, 8000, size=span,
                              dtype=np.int64).astype(np.int16)

    pieces = multihost.distribute_iq(mesh, local_vals)
    upload = sum(p.numel() for p in pieces.values())
    fn = make_sharded_multifm(plan, mesh)

    def sync():
        if devs[0].type == "cuda":
            torch.cuda.synchronize(devs[0])

    out = fn(pieces)   # first run: K1 builds, the taps upload
    sync()
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = fn(pieces)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    calls = args.reps + 1
    if fn.sent_bytes % calls:
        raise AssertionError(f"{fn.sent_bytes} halo bytes over {calls} "
                             "calls is not the same count a call")
    sent = fn.sent_bytes // calls
    # every rank's count, so each record holds the group's
    counts = multihost.all_gather_bytes(np.array([sent], np.int64),
                                        [8] * args.nproc)
    group = sum(int(b.view(np.int64)[0]) for b in counts)

    rec = {
        "pid": args.pid,
        "procs": args.nproc,
        "n_time": int(n_time),
        "samples_per_host": int(span // 2),
        "global_block_samples": int(span // 2 * args.nproc),
        "step_ms_median": round(med * 1e3, 2),
        # counted: the bytes the ranks sent their neighbours, a block
        "dcn_halo_bytes_per_block": int(group),
        "halo_bytes_sent_per_block": int(sent),   # by this rank
        # the formula's count for the group, a block
        "dcn_halo_bytes_formula": int(multihost.dcn_halo_bytes(
            plan, args.nproc)),
        "upload_elems_per_host": int(upload),
        "out_shape": list(out.shape),
        "chain_fm_launches": int(chain_fm.launches),   # K1, on the card
        "device": str(devs[0]),
    }
    with open(os.path.join(args.outdir, f"mhs_out_{args.pid}.json"),
              "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
