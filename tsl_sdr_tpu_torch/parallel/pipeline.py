"""``ReceivePipeline``'s production step over a ``(time, channels)`` mesh.

The JAX package annotates the fused block program with shardings and lets
GSPMD partition it (``tsl_sdr_tpu/models/pipeline.py:132-161``); here the
partition is written out, and decodes what the pipeline without a mesh
decodes.

* Channel axis: shard ``c`` owns channels ``[c*C/n, (c+1)*C/n)`` (a
  :class:`~tsl_sdr_tpu_torch.models.pipeline._Bank` with its own K1
  constants for the sub-bank) and runs the block program for them on the
  devices of its mesh column. A channel count the axis does not divide
  leaves the axis unused (every channel in column 0), as in JAX.
* Time axis: each block is cut into contiguous spans of whole block quanta,
  one for each time row (85 quanta over 2 rows: 43 + 42). A span runs the
  stages whose cost grows with the block, K1 and each ratio group's
  resampler (K3 or K4), on its row's devices. Every carried stage gets the
  state at its span's start:

  - K1's ``cr`` history rows come from the input, with ``look`` rows more
    before them: the first of those seeds the discriminator (its first
    output, from a zero history, is dropped), the outputs of the rest are
    the span's resampler carry, the last ``carry_len`` channel samples of
    the span before, computed again bit for bit instead of exchanged. So
    the only halo is input rows, ``look + cr`` of them; the first span
    takes the stream's state as the pipeline without a mesh does.
  - The stages after the resamplers (fast DC blocker, sign slice, sync
    prefilters, bit packing) run over the whole block's rows, concatenated
    in time order on the column's first device. The DC blocker is a
    first-order IIR whose float tier rounds its carried state to integers
    at every call; running it a span at a time would round at every span
    boundary too, and chaining the spans' affine end states would re-sum
    the recurrence in another order. Over the whole row it is the
    unmeshed pipeline's arithmetic exactly, so the PCM of every channel,
    DC-blocked or not, the prefilter flags and the ``fetched`` counters
    equal the run without a mesh. These stages read the block's rows after
    the resamplers, about an eighth of the bytes K1 reads at the pager
    deployment (2.0 of 16.7 MB a block).

  The block's end state is the last span's (K1, resamplers) and the
  column's (DC, tails); the next block's first span takes it.

Across processes (:mod:`~tsl_sdr_tpu_torch.parallel.multihost`): a rank
uploads only its own spans; the ``look + cr`` halo rows go to the next rank
as a message; and each rank's span outputs after the resamplers, with the
end state of its last span, are gathered to every rank (one gather a
block), which then runs the same finishing stages on the same rows and
decodes identically. The gather moves whole rows, so its size is fixed by
the configuration: egress gating (``hot``, set by each rank's drain) never
decides what is gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.models.channelizer import MultifmFastState, widen_wire
from tsl_sdr_tpu_torch.models.pipeline import _Bank, cat_on
from tsl_sdr_tpu_torch.parallel.channelizer import ShardTaps
from tsl_sdr_tpu_torch.parallel.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh


def span_bounds(n: int, quantum: int, n_spans: int) -> list:
    """``[(a, b)]`` sample bounds of ``n_spans`` contiguous spans of whole
    ``quantum``s covering ``n`` samples, the first ones a quantum longer
    where they do not divide evenly."""
    units = n // quantum
    if units < n_spans:
        raise ValueError(
            f"a block of {units} quanta of {quantum} samples cannot be cut "
            f"into {n_spans} time spans (raise block_size)")
    base, extra = divmod(units, n_spans)
    ends = np.cumsum([(base + (t < extra)) * quantum for t in range(n_spans)])
    return [(int(a), int(b)) for a, b in zip(np.r_[0, ends[:-1]], ends)]


class MeshEngine:
    """A production pipeline's block step over ``mesh``: see the module
    docstring. A pipeline without a mesh has a ``(1, 1)`` mesh of its
    device, whose one bank is the pipeline's own (the chain's constants),
    and then nothing is split or merged. ``step`` is called from the
    pipeline's dispatch thread only (the collectives of a multi-process
    mesh must be made in the same order on every rank)."""

    def __init__(self, pipe, mesh: Mesh):
        self.pipe = pipe
        self.mesh = mesh
        n_ch = len(pipe.channels)
        n_c = mesh.shape[CHANNEL_AXIS]
        self.cols = n_c if n_c > 1 and n_ch % n_c == 0 else 1
        self.shards = ShardTaps(pipe.chain.packed_plan, self.cols,
                                pipe.chain._omega_reduced)
        # one column on the pipeline's device: its own bank
        self._banks = {(0, pipe.device): pipe._bank} if self.cols == 1 \
            else {}
        # whether every bank's K1 reads the rtl_u8 bytes as uploaded: a
        # block then counts in stream_stats()["k1_wire8"]
        self._wire8 = None
        plan = pipe.chain.packed_plan
        self.row, self.cr, self.opr = plan.row, plan.cr_rows, plan.opr
        self.spans = span_bounds(pipe.block_size, pipe.block_quantum,
                                 mesh.shape[TIME_AXIS])
        # a phase-0 plan's carry is P - ceil(D/I) samples whatever its
        # block length, so spans and blocks carry alike
        carry = max([p.carry_len for p in
                     pipe._rs_plans(pipe.block_size).values()] or [0])
        # look-back rows before K1's history: one seeds the discriminator,
        # the rest give the resampler carry
        self.look = 1 + -(-carry // self.opr)
        self.halo_vals = (self.look + self.cr) * self.row
        for a, b in self.spans[:-1]:
            if 2 * (b - a) < self.halo_vals:
                raise ValueError(
                    f"a time span of {b - a} samples is shorter than the "
                    f"{self.halo_vals // 2}-sample halo the next span "
                    f"needs (raise block_size or use fewer time shards)")

    def bank(self, c: int, device):
        """Channel shard ``c`` on ``device`` (built at first use)."""
        key = (c, torch.device(device))
        if key not in self._banks:
            lo = c * len(self.pipe.channels) // self.cols
            hi = (c + 1) * len(self.pipe.channels) // self.cols
            self._banks[key] = _Bank(self.pipe, lo, hi, key[1],
                                     self.shards.taps(c, key[1]))
        return self._banks[key]

    def step(self, st: dict, flat: np.ndarray, stats: dict):
        """One block of flat wire values: (state, values) -> (state,
        (pack_out, raw_out)), both on the pipeline's device; adds this
        process's uploads and halos to ``stats`` (the stream dict). The
        spans ``engine.upload`` and ``engine.step.launch`` split it (the
        pipeline module's docstring, "Tracing")."""
        pipe, mesh = self.pipe, self.mesh
        if flat.size != 2 * pipe.block_size:
            raise ValueError(f"blocks are {pipe.block_size} samples, "
                             f"got {flat.size // 2}")
        rows = mesh.local_rows
        first, last = rows[0], rows[-1]
        n_t = mesh.shape[TIME_AXIS]
        a0, b1 = 2 * self.spans[first][0], 2 * self.spans[last][1]
        halo = self.halo_vals
        if mesh.multiprocess:
            from tsl_sdr_tpu_torch.parallel import multihost

            # this rank's values, after the look-back rows of the rank
            # before it (a message; the first rank has the stream state)
            base = a0 - halo if first > 0 else a0
            ext = np.empty(b1 - base, flat.dtype)
            ext[a0 - base:] = flat[a0:b1]
            multihost.neighbor_exchange(
                to_right=flat[b1 - halo:b1] if last < n_t - 1 else None,
                from_left=ext[:halo] if first > 0 else None)
        else:
            base, ext = 0, flat
        home = [mesh.devices[first, c] for c in range(self.cols)]
        start = [self.bank(c, home[c]).state_of(st) for c in range(self.cols)]
        pieces = {}
        ends = {}
        for t in rows:
            a, b = 2 * self.spans[t][0], 2 * self.spans[t][1]
            lo = a if t == 0 else a - halo
            host = ext[lo - base:b - base]
            stats["upload_elems"] += b - a
            stats["upload_bytes"] += (b - a) * flat.itemsize
            stats["halo_bytes"] += (a - lo) * flat.itemsize
            # each device's values of the span by wire: as uploaded, and
            # widened once where a bank's K1 does not read them
            uploaded = {}
            for c in range(self.cols):
                dev = mesh.devices[t, c]
                if dev not in uploaded:
                    with pipe._trace("engine.upload", "upload_s"):
                        uploaded[dev] = {
                            pipe.wire_fmt: pipe._upload(host, dev, stats)}
                bank = self.bank(c, dev)
                vals = uploaded[dev]
                with pipe._trace("engine.step.launch", "launch_s"):
                    if bank.k1_wire not in vals:
                        vals[bank.k1_wire] = widen_wire(vals[pipe.wire_fmt],
                                                        pipe.wire_fmt)
                    pieces[c, t], end = self._span(
                        c, t, dev, vals[bank.k1_wire], (b - a) // 2,
                        start[c] if t == 0 else None)
                if t == n_t - 1:
                    ends[c] = end
        if self._wire8 is None:   # fixed once a block has built its banks
            self._wire8 = all(bank.k1_wire == "rtl_u8"
                              for bank in self._banks.values())
        if self._wire8:
            stats["k1_wire8"] += 1
        if mesh.multiprocess:
            # whole rows, a size fixed by the configuration: what a rank's
            # drain saw (egress gating's "hot") never changes it
            pieces, ends = self._gather(pieces, ends)
        with pipe._trace("engine.step.launch", "launch_s"):
            states, pack, raw = [], {}, {}
            for c in range(self.cols):
                bank = self.bank(c, home[c])
                ch_rows = {i: cat_on([pieces[c, t][i] for t in range(n_t)],
                                     home[c])
                           for i in range(bank.lo, bank.hi)}
                prog = pipe._program(pipe.block_size, bank)
                dc2, tails2, (pack_c, raw_c) = prog.finish(
                    start[c]["dc"], start[c]["tails"], ch_rows)
                chain_end, rs_end = ends[c]
                states.append({
                    "chain": chain_end._replace(
                        carry_vals=chain_end.carry_vals.to(home[c]),
                        prev_r=chain_end.prev_r.to(home[c]),
                        prev_i=chain_end.prev_i.to(home[c]),
                        out_index=st["chain"].out_index
                        + pipe.block_size // pipe.chain.decimation),
                    "rs": {g: v.to(home[c]) for g, v in rs_end.items()},
                    "dc": dc2, "tails": tails2})
                for out, part in ((pack, pack_c), (raw, raw_c)):
                    for key, v in part.items():
                        out.setdefault(key, []).append(v.to(pipe.device))
            st2 = _Bank.merge_states(
                [self.bank(c, home[c]) for c in range(self.cols)], states,
                pipe.device)
            outs = ({k: cat_on(v, pipe.device) for k, v in pack.items()},
                    {k: cat_on(v, pipe.device) for k, v in raw.items()})
        return st2, outs

    def _span(self, c: int, t: int, dev, vals: torch.Tensor, n: int,
              start):
        """K1 and the resamplers for channel shard ``c`` over time span
        ``t`` (``n`` samples; ``vals`` its values of the wire the bank's
        K1 reads, after the look-back rows for ``t > 0``, whose history
        rows are widened into K1's int16 carry; ``start`` the block-start
        state for
        ``t == 0``). Returns ({channel: row after the resampler}, (chain
        state, resampler carries) at the span's end)."""
        pipe = self.pipe
        bank = self.bank(c, dev)
        prog = pipe._program(n, bank)
        if start is not None:
            chain_st, pcm = prog.channelize(start["chain"], vals)
            rs_in = start["rs"]
        else:
            cut = self.cr * self.row
            zero = torch.zeros(bank.hi - bank.lo, dtype=torch.float32,
                               device=dev)
            st0 = MultifmFastState(carry_vals=widen_wire(
                                       vals[:cut], bank.k1_wire).contiguous(),
                                   prev_r=zero, prev_i=zero.clone(),
                                   out_index=0)
            chain_st, pcm = prog.channelize(st0, vals[cut:])
            k_look = self.look * self.opr
            rs_in = {gid: pcm[prog.rs_idx[gid],
                              k_look - prog.plans[gid].carry_len:k_look]
                     .contiguous() for gid in bank.rs_groups}
            pcm = pcm[:, k_look:]
        rs_end, ch_rows = prog.resample(rs_in, pcm)
        return ch_rows, (chain_st, rs_end)

    def _gather(self, pieces: dict, ends: dict):
        """Every rank's span rows and the last span's end state, on every
        rank: one gather of bytes whose sizes follow from the
        configuration alone (every rank computes every rank's layout)."""
        from tsl_sdr_tpu_torch.parallel import multihost

        pipe, mesh = self.pipe, self.mesh
        n_t = mesh.shape[TIME_AXIS]
        banks = [self.bank(c, mesh.devices[mesh.local_rows[0], c])
                 for c in range(self.cols)]

        def layout(rank: int) -> list:
            """(key, dtype, shape) of a rank's contribution, in order."""
            items = []
            for c, bank in enumerate(banks):
                for t in np.nonzero(mesh.ranks == rank)[0]:
                    k = (self.spans[t][1] - self.spans[t][0]) \
                        // pipe.chain.decimation
                    for i in range(bank.lo, bank.hi):
                        gid = pipe._ratio_gid[i]
                        items.append(((c, int(t), i), np.float32 if gid
                                      else np.int16,
                                      (k * gid[0] // gid[1] if gid else k,)))
            plan0 = pipe._rs_plans(self.spans[-1][1] - self.spans[-1][0])
            items.append((("carry",), np.int16, (self.cr * self.row,)))
            for c, bank in enumerate(banks):
                w = (bank.hi - bank.lo,)
                items += [(("prev_r", c), np.float32, w),
                          (("prev_i", c), np.float32, w)]
                items += [(("rs", c, gid), np.int16,
                           (len(idxs), plan0[gid].carry_len))
                          for gid, idxs in bank.rs_groups.items()]
            return items

        mine = {}
        for (c, t), rows in pieces.items():
            for i, v in rows.items():
                mine[c, t, i] = v
        if ends:
            for c, (chain_st, rs_end) in ends.items():
                mine["carry",] = chain_st.carry_vals
                mine["prev_r", c] = chain_st.prev_r
                mine["prev_i", c] = chain_st.prev_i
                for gid, v in rs_end.items():
                    mine["rs", c, gid] = v
        me = mesh.rank
        parts = []
        for key, dtype, shape in layout(me):
            v = mine.get(key)
            parts.append(np.zeros(shape, dtype) if v is None else
                         np.ascontiguousarray(v.cpu().numpy(), dtype))
        blob = np.concatenate([p.reshape(-1).view(np.uint8) for p in parts])
        n_ranks = int(mesh.ranks.max()) + 1
        sizes = [sum(int(np.prod(s)) * np.dtype(d).itemsize
                     for _, d, s in layout(r)) for r in range(n_ranks)]
        got = multihost.all_gather_bytes(blob, sizes)
        owner = int(mesh.ranks[n_t - 1])
        out_pieces, out_ends = {}, {}
        for r in range(n_ranks):
            off = 0
            for key, dtype, shape in layout(r):
                nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
                arr = got[r][off:off + nb].view(dtype).reshape(shape)
                off += nb
                if len(key) == 3 and isinstance(key[0], int):
                    c, t, i = key
                    out_pieces.setdefault((c, t), {})[i] = (
                        pieces[c, t][i] if r == me
                        else torch.from_numpy(arr.copy()))
                elif r == owner:
                    out_ends[key] = torch.from_numpy(arr.copy())
        ends_all = {
            c: (MultifmFastState(carry_vals=out_ends["carry",],
                                 prev_r=out_ends["prev_r", c],
                                 prev_i=out_ends["prev_i", c], out_index=0),
                {gid: out_ends["rs", c, gid] for gid in bank.rs_groups})
            for c, bank in enumerate(banks)}
        return out_pieces, ends_all
