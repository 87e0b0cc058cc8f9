"""The rational resampler over the time axis of a mesh: K3 or K4 a shard.

Port of ``tsl_sdr_tpu/parallel/resampler.py:86-169``. For a plan with
``phase0 == 0`` the output phase is an affine function of the absolute
output index, and every shard starts on a whole ``D_rep`` input frame, so
a shard needs no serial state: its only input from outside is the forward
window spill, the right neighbour's first ``carry_len`` samples (the
packed-row form's ``plan.spill``; zeros for the last shard).

Each shard runs the plan's kernels in their streaming form over ``T =
x[:L] ++ (x ++ spill)[L:L+n]`` (``L = carry_len``, ``n`` the shard's
length), which makes output ``k`` the window at input offset
``k*D // I``: kernel K3 (:func:`~tsl_sdr_tpu_torch.ops.row_resampler.
row_resample`) where the shard length is a multiple of ``ROW_IN``, kernel
K4 (:func:`~tsl_sdr_tpu_torch.ops.frame_resampler.frame_resample`)
otherwise, as ``plan_taps``/``resample_step`` choose. Both sum exact
int16 products in int32 and scale once, so every output equals the
single-device run's bit for bit (the JAX form re-partitions float32 sums
and agrees to its tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops.frame_resampler import frame_resample, frame_taps
from tsl_sdr_tpu_torch.ops.polyphase import ResamplerPlan, row_taps
from tsl_sdr_tpu_torch.ops.row_resampler import row_resample
from tsl_sdr_tpu_torch.parallel.mesh import TIME_AXIS, Mesh


def make_sharded_resampler(plan: ResamplerPlan, mesh: Mesh):
    """``fn(pcm [N] int16) -> float32 [N * I/D]``, ``N`` split evenly over
    the time axis (in a multi-process mesh, ``pcm`` is this rank's
    contiguous part and the result is gathered from every rank). ``N``
    must be a multiple of ``time_shards * D_rep``. The result lies on the
    first device of this process's first time row."""
    from tsl_sdr_tpu_torch.parallel import multihost

    if plan.phase0 != 0:
        raise ValueError("sharded resampler supports phase0 == 0 plans")
    n_t = mesh.shape[TIME_AXIS]
    rows = mesh.local_rows
    halo = plan.carry_len
    cache = {}

    def taps(kind: str, device):
        key = (kind, device)
        if key not in cache:
            cache[key] = (row_taps(plan, device=device) if kind == "row"
                          else frame_taps(plan, device=device))
        return cache[key]

    def process(pcm) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(pcm)).reshape(-1)
        n_all = x.numel() * (n_t // len(rows))
        q = n_t * plan.d_rep
        if n_all % q:
            raise ValueError(
                f"input length {n_all} must be a multiple of "
                f"time_shards*D_rep = {q} (pad or trim the capture)")
        n = x.numel() // len(rows)
        if n < halo:
            raise ValueError(f"shard of {n} samples is shorter than the "
                             f"{halo}-sample window spill")
        row_form = bool(plan.k_row) and n % plan.row_in == 0
        spill = np.zeros(halo, np.int16)
        if mesh.multiprocess:
            first, last = rows[0], rows[-1]
            multihost.neighbor_exchange(
                to_left=x[:halo].numpy() if first > 0 else None,
                from_right=spill if last < n_t - 1 else None)
        outs = []
        for k, t in enumerate(rows):
            dev = mesh.devices[t, 0]
            nxt = (x[(k + 1) * n:(k + 1) * n + halo] if k + 1 < len(rows)
                   else torch.from_numpy(spill))
            total = torch.cat([x[k * n:(k + 1) * n], nxt]).to(dev)
            carry, block = total[None, :halo], total[None, halo:halo + n]
            if row_form:
                out = row_resample(carry.contiguous(), block.contiguous(),
                                   taps("row", dev), row_in=plan.row_in)
            else:
                out = frame_resample(carry.contiguous(), block.contiguous(),
                                     taps("frame", dev),
                                     frames=n // plan.d_rep)
            outs.append(out.reshape(-1))
        home = mesh.devices[rows[0], 0]
        out = torch.cat([o.to(home) for o in outs])
        if not mesh.multiprocess:
            return out
        got = multihost.all_gather_bytes(out.cpu().numpy(), None)
        return torch.from_numpy(np.concatenate(
            [g.view(np.float32) for g in got])).to(home)

    return process
