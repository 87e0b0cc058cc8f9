"""The channelizer over a ``(time, channels)`` mesh: K1 once for each shard.

Port of ``tsl_sdr_tpu/parallel/channelizer.py``: ``make_sharded_multifm``
(``:185-285``) and ``make_sharded_multifm_pallas`` (``:112-182``) are one
function here, because kernel K1 (:func:`~tsl_sdr_tpu_torch.ops.chain.
chain_fm`) serves both of their forms.

* Channel axis: shard ``c`` takes channels ``[c*C/n, (c+1)*C/n)``, their
  columns of every tap chunk (:func:`~tsl_sdr_tpu_torch.ops.packed_fir.
  sub_plan`), and builds its own :class:`~tsl_sdr_tpu_torch.ops.chain.
  ChainTaps` over that sub-bank, so K1's body and its grouped form are
  chosen for the shard's width, as the JAX package chooses the grouped form
  for each shard. The input is the same for every shard of a time row.
* Time axis: the flat IQ splits into contiguous spans of whole packed
  rows. Each span runs K1 over its own rows with two halos: the left
  neighbour's last ``1 + cr`` rows (K1's ``cr`` history rows and one
  look-back row whose outputs seed the discriminator; zeros for the first
  span) and the right neighbour's first ``cr`` rows (the window spill;
  zeros for the last). Output row ``r`` of a call ends at its input row
  ``r``, so the first ``1 + cr`` output rows belong to the left span and
  are dropped; output ``k`` is then the window at global input row ``k``,
  as in the JAX package (output 0 = input samples ``[0, T)``).

Within a process a halo is a slice of the neighbour's span, moved with
``.to(device)``; across processes it is a message between neighbouring
ranks (:func:`~tsl_sdr_tpu_torch.parallel.multihost.neighbor_exchange`).
The JAX ``_pallas`` form's restriction to ``(time, 1)`` meshes falls away:
its kernel's tap stack was built for the whole bank, while K1 takes any
sub-bank. The bit-exact tier is not sharded (its Q.14 rotator is serial in
time by construction, ``filter/direct_fir.c:152-172``).
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops.chain import ChainTaps, chain_fm
from tsl_sdr_tpu_torch.ops.packed_fir import (PackedFirPlan, reduced_omega,
                                             sub_plan)
from tsl_sdr_tpu_torch.parallel.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh


class ShardTaps:
    """Each channel shard's :class:`ChainTaps`, built once for each device
    the shard runs on (``taps(c, device)``)."""

    def __init__(self, plan: PackedFirPlan, n_shards: int, omega_reduced):
        if plan.nr_channels % n_shards:
            raise ValueError(f"{plan.nr_channels} channels not divisible by "
                             f"{n_shards}")
        self.width = plan.nr_channels // n_shards
        self.plans = [sub_plan(plan, c * self.width, (c + 1) * self.width)
                      for c in range(n_shards)]
        self.omega = np.asarray(omega_reduced, np.float32).reshape(
            n_shards, self.width)
        self._built = {}

    def taps(self, c: int, device) -> ChainTaps:
        key = (c, torch.device(device))
        if key not in self._built:
            self._built[key] = ChainTaps(self.plans[c], self.omega[c],
                                         device=key[1])
        return self._built[key]


def make_sharded_multifm(plan: PackedFirPlan, mesh: Mesh,
                         omega_reduced=None):
    """``fn(vals) -> pcm [C, S // D]`` int16 over ``mesh``.

    ``vals``: the capture as flat interleaved int16 IQ values (``[2S]`` or
    ``[S, 2]``, host array or tensor); in a multi-process mesh, this rank's
    contiguous span of it, or :func:`~tsl_sdr_tpu_torch.parallel.
    multihost.distribute_iq`'s pieces. The values split into equal spans of
    whole ``plan.row``-value rows, one a time row, each at least ``1 + cr``
    rows long. The result is the whole capture's, on the first device of
    this process's first time row (gathered from every rank in a
    multi-process mesh); output ``k`` is the global decimated index.

    This is also the JAX package's ``make_sharded_multifm_pallas`` (an
    alias below): that form's restriction to ``(time, 1)`` meshes falls
    away, because K1 serves every channel shard's sub-bank."""
    from tsl_sdr_tpu_torch.parallel import multihost

    if not isinstance(plan, PackedFirPlan):
        raise TypeError("make_sharded_multifm takes a PackedFirPlan "
                        "(use MultifmChain.packed_plan)")
    n_c = mesh.shape[CHANNEL_AXIS]
    shards = ShardTaps(plan, n_c, reduced_omega(plan)
                       if omega_reduced is None else omega_reduced)
    row, cr, opr = plan.row, plan.cr_rows, plan.opr
    rows_local = mesh.local_rows
    n_t = mesh.shape[TIME_AXIS]

    def process(vals) -> torch.Tensor:
        pieces = vals if isinstance(vals, dict) else \
            multihost.distribute_iq(mesh, vals)
        for t in rows_local:
            n = pieces[t].numel()
            if n % row or n // row < 1 + cr:
                raise ValueError(
                    f"time span of {n} values is not a whole number of "
                    f"{row}-value rows, at least {1 + cr} of them")
        first, last = rows_local[0], rows_local[-1]
        before = {first: np.zeros((1 + cr) * row, np.int16)}
        after = {last: np.zeros(cr * row, np.int16)}
        if mesh.multiprocess:
            # the ranks at the ends keep their zero halos
            process.sent_bytes += multihost.neighbor_exchange(
                to_left=(pieces[first][:cr * row].cpu().numpy()
                         if first > 0 else None),
                to_right=(pieces[last][-(1 + cr) * row:].cpu().numpy()
                          if last < n_t - 1 else None),
                from_left=before[first] if first > 0 else None,
                from_right=after[last] if last < n_t - 1 else None)
        outs = []
        for k, t in enumerate(rows_local):
            piece = pieces[t]
            dev = piece.device
            left = (torch.from_numpy(before[t]).to(dev) if t == first else
                    pieces[rows_local[k - 1]][-(1 + cr) * row:].to(dev))
            right = (torch.from_numpy(after[t]).to(dev) if t == last else
                     pieces[rows_local[k + 1]][:cr * row].to(dev))
            parts = []
            for c in range(n_c):
                d = mesh.devices[t, c]
                taps = shards.taps(c, d)
                block = torch.cat([left[cr * row:], piece, right]).to(d)
                prev = torch.zeros((2, shards.width), dtype=torch.float32,
                                   device=d)
                pcm, _ = chain_fm(taps, left[:cr * row].to(d).contiguous(),
                                  prev, block)
                # output row r ends at input row r - 1 - cr of the span
                parts.append(pcm[(1 + cr):].reshape(-1, shards.width).T
                             .to(dev))
            outs.append(torch.cat(parts))
        home = mesh.devices[first, 0]
        out = torch.cat([o.to(home) for o in outs], dim=1)
        if not mesh.multiprocess:
            return out
        got = multihost.all_gather_bytes(out.cpu().numpy(), None)
        return torch.from_numpy(np.concatenate(
            [g.view(np.int16).reshape(plan.nr_channels, -1) for g in got],
            axis=1)).to(home)

    process.sent_bytes = 0   # halo bytes this rank sent, over all calls
    return process


make_sharded_multifm_pallas = make_sharded_multifm
