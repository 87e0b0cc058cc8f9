"""Worker process of the multi-process channelizer self-test.

Run as ``python -m tsl_sdr_tpu_torch.parallel._mh_worker`` by
:func:`tsl_sdr_tpu_torch.parallel.multihost.run_multiprocess_selftest`
(port of ``tsl_sdr_tpu/parallel/_mh_worker.py``). Each worker joins the
gloo group, builds the global ``(time, channels)`` mesh over every rank's
``--n-local`` devices (``--device cpu`` stands one CPU in for each;
``cuda`` takes the CUDA devices it sees in turn), runs the sharded
channelizer on its own contiguous span of the self-test capture and saves
the gathered global PCM, so the launcher can check every rank agrees and
diff a single-process run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def local_devices(kind: str, n_local: int) -> list:
    """``n_local`` devices of ``kind``: the CPU repeated, or the CUDA
    devices this process sees, in turn."""
    import torch

    if kind == "cpu":
        # the ranks share one host's cores: one thread each
        torch.set_num_threads(1)
        return [torch.device("cpu")] * n_local
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("--device cuda but no CUDA device is visible")
    return [torch.device("cuda", k % n) for k in range(n_local)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--n-local", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--channels", type=int, default=2,
                    help="mesh channel-axis size (channel shards a rank)")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args()

    import numpy as np

    from tsl_sdr_tpu_torch.parallel import multihost
    from tsl_sdr_tpu_torch.parallel.channelizer import make_sharded_multifm

    multihost.init(f"127.0.0.1:{args.port}", num_processes=args.nproc,
                   process_id=args.pid)
    assert multihost.world_size() == args.nproc, multihost.world_size()
    devs = local_devices(args.device, args.n_local)
    mesh = multihost.make_global_mesh(args.channels, local_devices=devs)
    chain = multihost.selftest_chain(nr_channels=2 * args.channels,
                                     device=devs[0])
    plan = chain.packed_plan
    n_time = mesh.devices.shape[0]
    vals_full = multihost.selftest_capture(plan, n_time)
    span = vals_full.size // args.nproc
    local = vals_full[args.pid * span:(args.pid + 1) * span]
    fn = make_sharded_multifm(plan, mesh)
    pcm = fn(multihost.distribute_iq(mesh, local)).cpu().numpy()
    halo = multihost.dcn_halo_bytes(plan, args.nproc)
    np.savez(os.path.join(args.outdir, f"mh_out_{args.pid}.npz"), pcm=pcm,
             halo_bytes=halo, sent_bytes=fn.sent_bytes)
    print(json.dumps({"pid": args.pid, "procs": multihost.world_size(),
                      "mesh": list(mesh.devices.shape),
                      "pcm_shape": list(pcm.shape),
                      "dcn_halo_bytes_per_block": halo,
                      "sent_bytes": fn.sent_bytes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
