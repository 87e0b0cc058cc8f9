"""Multi-process deployment over ``torch.distributed``.

Port of ``tsl_sdr_tpu/parallel/multihost.py``. Each process runs
:func:`init` (a gloo process group; every rank is told the coordinator's
address, the world size and its rank), then :func:`make_global_mesh` lays
the ``(time, channels)`` mesh over every rank's local devices: the channel
axis stays inside one rank, and the time axis walks the ranks in order, so
each rank owns one contiguous stretch of every block. A rank uploads only
its own rows; what crosses a rank boundary moves by point-to-point
messages between neighbours (:func:`neighbor_exchange`) and one gather a
block (:func:`all_gather_bytes`).

Transport: gloo, staged through host memory, every message as bytes. Gloo's
``all_gather`` refuses int16 tensors, and the halos are int16 rows, so
every array travels as its ``uint8`` view. NCCL (device memory, no host
staging) needs a card a rank, which one card cannot exercise.

Two rules every caller keeps, or the ranks deadlock or disagree:

1. every rank makes the same collective calls in the same order, from one
   thread (the pipeline's dispatch thread, never its drain worker);
2. the size of everything gathered is a function of the configuration and
   the block length alone, never of a rank's timing or of what its
   decoders have seen (see ``ReceivePipeline``'s egress gating).

The executed form: :func:`launch_workers` starts real processes on one
box (``_mh_worker`` for the sharded channelizer, ``_mh_pipeline_worker``
for the receive pipeline, ``_mh_scaling_worker`` for the weak-scaling
witness, :func:`run_scaling_witness`), the CPU standing in for devices in
the tests and ``cuda:0`` shared by the ranks on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.parallel.mesh import Mesh, cuda_devices


def init(coordinator_address: str | None = None,
         num_processes: int | None = None, process_id: int | None = None):
    """Join the gloo process group at ``tcp://coordinator_address``. Does
    nothing without an address, for one process, or when the group
    exists."""
    import torch.distributed as dist

    if coordinator_address is None or (num_processes or 1) <= 1:
        return
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The process group's size (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def layout_devices(devs, n_local: int, channels_per_host: int):
    """The layout math behind :func:`make_global_mesh` (a copy of the JAX
    package's): ``devs`` in rank-major order -> a ``[time, channels]``
    object array in which every time row lives on one rank and the time
    axis walks the ranks in order."""
    devs = np.asarray(devs, dtype=object)
    if n_local % channels_per_host:
        raise ValueError(
            f"{n_local} local devices not divisible by {channels_per_host}")
    if devs.size % n_local:
        raise ValueError(
            f"{devs.size} devices not divisible by {n_local} per host")
    time_per_host = n_local // channels_per_host
    n_proc = devs.size // n_local
    return devs.reshape(n_proc * time_per_host, channels_per_host)


def global_device_count(local_devices) -> int:
    """Devices over every rank (each rank passes its own list)."""
    counts = all_gather_bytes(np.array([len(local_devices)], np.int64),
                              [8] * world_size())
    return int(sum(c.view(np.int64)[0] for c in counts))


def make_global_mesh(channels_per_host: int = 1,
                     local_devices=None) -> Mesh:
    """A ``(time, channels)`` mesh over every rank's devices: this rank's
    are ``local_devices`` (default :func:`~tsl_sdr_tpu_torch.parallel.
    mesh.cuda_devices`, the CUDA devices it sees); the ranks' counts are
    gathered, and must be equal."""
    local = [torch.device(d) for d in (cuda_devices() if local_devices is None
                                       else local_devices)]
    n = world_size()
    names = all_gather_bytes(
        np.frombuffer(",".join(map(str, local)).encode(), np.uint8), None)
    per_rank = [bytes(b).decode().split(",") for b in names]
    if any(len(d) != len(local) for d in per_rank):
        raise ValueError(f"ranks see different device counts: "
                         f"{[len(d) for d in per_rank]}")
    grid = layout_devices([d for devs in per_rank for d in devs], len(local),
                          channels_per_host)
    time_per_host = len(local) // channels_per_host
    ranks = np.repeat(np.arange(n), time_per_host)
    return Mesh(grid, ranks=ranks, rank=rank())


def distribute_iq(mesh: Mesh, local_vals) -> dict:
    """This rank's contiguous span of flat interleaved int16 values (ranks
    in order = stream order), cut into equal pieces, one for each of its
    time rows, each on that row's first device: ``{time row: tensor}``."""
    vals = torch.as_tensor(np.ascontiguousarray(local_vals)).reshape(-1)
    rows = mesh.local_rows
    if vals.numel() % len(rows):
        raise ValueError(f"{vals.numel()} values do not split evenly over "
                         f"{len(rows)} local time rows")
    n = vals.numel() // len(rows)
    return {t: vals[k * n:(k + 1) * n].to(mesh.devices[t, 0])
            for k, t in enumerate(rows)}


def dcn_halo_bytes(plan, n_processes: int) -> int:
    """Bytes a block moves across rank boundaries in the sharded
    channelizer (:func:`~tsl_sdr_tpu_torch.parallel.channelizer.
    make_sharded_multifm`): at each of the ``n_processes - 1`` boundaries
    the left rank's last ``1 + cr`` rows go right (K1's carry) and the
    right rank's first ``cr`` rows go left (the window spill), int16, once
    whatever the channel axis (the port sends a rank's rows once, not once
    a channel shard)."""
    return (n_processes - 1) * (2 * plan.cr_rows + 1) * plan.row * 2


# -- transport: bytes between ranks ------------------------------------------

def _as_bytes(arr: np.ndarray) -> torch.Tensor:
    """A contiguous array's bytes as a uint8 tensor sharing its memory."""
    return torch.from_numpy(arr.reshape(-1).view(np.uint8))


def neighbor_exchange(to_left=None, to_right=None, from_left=None,
                      from_right=None) -> int:
    """Send ``to_left`` to rank - 1 and ``to_right`` to rank + 1, and fill
    the contiguous arrays ``from_left`` / ``from_right`` from them (None:
    no message that way). Sends are posted first, so a chain of ranks
    cannot deadlock. Returns the bytes this rank sent."""
    import torch.distributed as dist

    r = dist.get_rank()
    pending = []
    sent = 0
    for arr, peer, tag in ((to_left, r - 1, 1), (to_right, r + 1, 2)):
        if arr is not None:
            buf = _as_bytes(np.ascontiguousarray(arr))
            pending.append((dist.isend(buf, peer, tag=tag), buf))
            sent += buf.numel()
    for arr, peer, tag in ((from_left, r - 1, 2), (from_right, r + 1, 1)):
        if arr is not None:
            dist.recv(_as_bytes(arr), peer, tag=tag)
    for req, _buf in pending:
        req.wait()
    return sent


def all_gather_bytes(mine: np.ndarray, sizes) -> list:
    """Every rank's ``mine`` (its bytes) on every rank, as uint8 arrays in
    rank order. ``sizes``: each rank's byte count, known alike on every
    rank; None gathers the sizes first (one more collective)."""
    import torch.distributed as dist

    mine = np.ascontiguousarray(mine).reshape(-1).view(np.uint8)
    if not dist.is_initialized():
        return [mine.copy()]
    if sizes is None:
        sizes = [int(b.view(np.int64)[0]) for b in all_gather_bytes(
            np.array([mine.size], np.int64), [8] * dist.get_world_size())]
    width = max(max(sizes), 1)
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[:mine.size] = torch.from_numpy(mine)
    out = [torch.empty(width, dtype=torch.uint8) for _ in sizes]
    dist.all_gather(out, buf)
    return [o.numpy()[:s] for o, s in zip(out, sizes)]


# -- the executed multi-process self-test ------------------------------------
#
# Real processes on one box: each joins the group, builds the global mesh,
# runs the sharded channelizer on its own span and gathers the global
# result; the caller checks every rank agrees and diffs a single-process
# run of the same capture.

_SELFTEST = dict(fs=64_000, decim=4, taps=17, rows_per_shard=64, seed=7)


def selftest_chain(nr_channels: int = 4, device="cpu"):
    """The small deterministic chain the workers and the single-process
    expectation share (the JAX package's)."""
    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = _SELFTEST["fs"]
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[: _SELFTEST["taps"]]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=nr_channels)
    return MultifmChain(lpf, offsets, fs, _SELFTEST["decim"], exact=False,
                        device=device)


def selftest_capture(plan, n_time_shards: int) -> np.ndarray:
    """The whole deterministic capture as flat interleaved int16 values."""
    rows_total = _SELFTEST["rows_per_shard"] * n_time_shards
    rng = np.random.default_rng(_SELFTEST["seed"])
    return rng.integers(-8000, 8000, size=rows_total * plan.row,
                        dtype=np.int64).astype(np.int16)


def launch_workers(module: str, n_processes: int, n_local: int,
                   timeout: float = 600.0, attempts: int = 3,
                   extra_args: tuple = ()):
    """Run ``python -m module`` as ``n_processes`` processes with the
    ``--pid/--nproc/--n-local/--port/--outdir`` arguments (and
    ``extra_args``), wait for all of them and raise on a nonzero exit.
    Returns ``(tempdir, logs)``; the caller reads the workers' files from
    ``tempdir.name`` and cleans it up. A launch is retried whole where the
    probed free port was taken meanwhile."""
    import os
    import socket
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    last_err = None
    for _attempt in range(attempts):
        td = tempfile.TemporaryDirectory()
        try:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            procs = [
                subprocess.Popen(
                    [sys.executable, "-m", module, "--pid", str(pid),
                     "--nproc", str(n_processes), "--n-local", str(n_local),
                     "--port", str(port), "--outdir", td.name, *extra_args],
                    env=env, cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT)
                for pid in range(n_processes)
            ]
            logs = []
            try:
                for p in procs:
                    out, _ = p.communicate(timeout=timeout)
                    logs.append(out.decode(errors="replace"))
            finally:
                for p in procs:   # reap: no process outlives a failure
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for p, log in zip(procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"worker rc={p.returncode}:\n{log[-4000:]}")
            return td, logs
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            td.cleanup()
            last_err = e
    raise last_err


def _run_selftest_once(n_processes: int, n_local: int,
                       channels_per_host: int, timeout: float,
                       device: str = "cpu") -> dict:
    """One launch of the channelizer self-test (:mod:`._mh_worker`)."""
    from pathlib import Path

    td, _logs = launch_workers(
        "tsl_sdr_tpu_torch.parallel._mh_worker", n_processes, n_local,
        timeout=timeout, attempts=1,
        extra_args=("--channels", str(channels_per_host),
                    "--device", device))
    with td:
        outs = [np.load(Path(td.name) / f"mh_out_{pid}.npz")
                for pid in range(n_processes)]
        pcm0 = outs[0]["pcm"]
        for pid in range(1, n_processes):
            if not np.array_equal(pcm0, outs[pid]["pcm"]):
                raise AssertionError(
                    f"process {pid} gathered a different global result")
        n_time = n_processes * (n_local // channels_per_host)
        return {"pcm": pcm0,
                "dcn_halo_bytes": int(outs[0]["halo_bytes"]),
                "sent_bytes": [int(o["sent_bytes"]) for o in outs],
                "mesh_shape": (n_time, channels_per_host)}


def run_multiprocess_selftest(n_processes: int, n_local: int,
                              channels_per_host: int = 2,
                              timeout: float = 600.0,
                              device: str = "cpu") -> dict:
    """Run the sharded channelizer across ``n_processes`` real processes of
    ``n_local`` devices each and check every rank gathered the same global
    result. Returns ``{"pcm", "dcn_halo_bytes", "sent_bytes",
    "mesh_shape"}``; the caller diffs ``pcm`` against one process."""
    import subprocess

    last_err = None
    for _attempt in range(3):
        try:
            return _run_selftest_once(n_processes, n_local,
                                      channels_per_host, timeout, device)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            last_err = e
    raise last_err


def run_scaling_witness(n_processes: int, n_local: int = 1,
                        device: str = "cpu", reps: int = 3,
                        rows_per_shard: int = 512,
                        timeout: float = 600.0) -> list:
    """Run the weak-scaling witness (:mod:`._mh_scaling_worker`) across
    ``n_processes`` real processes of ``n_local`` devices each; returns
    every rank's record, in rank order."""
    import json
    from pathlib import Path

    td, _logs = launch_workers(
        "tsl_sdr_tpu_torch.parallel._mh_scaling_worker", n_processes,
        n_local, timeout=timeout,
        extra_args=("--reps", str(reps), "--rows-per-shard",
                    str(rows_per_shard), "--device", device))
    with td:
        return [json.loads((Path(td.name) / f"mhs_out_{pid}.json")
                           .read_text()) for pid in range(n_processes)]
