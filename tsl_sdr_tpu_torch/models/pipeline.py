"""End-to-end receive pipeline: channelize -> resample -> protocol decode.

Port of ``tsl_sdr_tpu/models/pipeline.py``: the production streaming
engine with its drain worker and its checkpoint/restore, and the bit-exact
engine (``exact=True``, see "Bit-exact engine" below). On the production
tier every device stage of a block runs in one call,
:meth:`tsl_sdr_tpu_torch.parallel.pipeline.MeshEngine.step` (a pipeline
without a mesh has a one-device mesh: one time span, one bank):

1. widen 8-bit wire bytes;
2. channelize + FM-demodulate (kernel K1, ``ops.chain``);
3. invert polarity;
4. resample each ratio group, one launch for all channels of the group:
   kernel K3 (``ops.row_resampler``) for a plan with a packed-row form,
   kernel K4 (``ops.frame_resampler``) for one without (25/16 at
   decimation 50, say), as the JAX pipeline's ``resample_step`` picks;
5. DC-block, one launch for the DC-blocked rows of one length (kernel
   K8, ``ops.dc_blocker.dc_block_fast``);
6. sign-slice, sync prefilter and bit-pack, one launch a pack group
   (kernel K7, ``ops.gate``).

The host uploads each block from pinned memory, starts the device->host
copies of the small gated outputs as soon as the block is queued, keeps
``inflight_depth`` blocks in flight, and drains the oldest into the
POCSAG/FLEX/AIS decoders (``models.{pocsag,flex,ais}``, each on its native
C++ state machine), inline or on a drain worker thread (``drain_async``).
The egress buffers keep the JAX engine's layout byte for byte, so the
drain logic is the same code.

Egress gating: a channel whose block raised no sync candidate sends only its
flag and carried tail; its decoder does no work.

Mesh (``mesh=``, production tier): the block's channels split over the
mesh's channel axis and its samples over the time axis, each shard a
:class:`_Bank` running :meth:`_SizedProgram.channelize` and
:meth:`~_SizedProgram.resample` on its devices, the rest
(:meth:`~_SizedProgram.finish`) over the whole block on the first device
(:mod:`tsl_sdr_tpu_torch.parallel.pipeline`); the stream state and the
outputs keep the layout of the pipeline without a mesh, so the drain, the
checkpoints and the decoders do not change.

Bit-exact engine: per block, the channelizer's exact step (kernel K5, the
host rotator, kernel K9's derotation and LUT discriminator) with
``inflight_depth`` blocks in flight; then, in dispatch order (inline or on
the drain worker), polarity inversion, each ratio group's exact resampler
(K3 or K4 with Q.14 output, one launch for the group's rows), the exact
DC blocker (its kernel) and the decoders, every carry threaded. No
prefilter or gating: its contract is the reference's PCM, bit for bit, at
any push split. It cannot checkpoint (as in the JAX package).

Tracing: ``pipe.timing = {}`` turns on the engine's spans
(:meth:`ReceivePipeline._trace`), from every thread that runs them. Each
adds its host seconds to a key of ``pipe.timing``; while a
``torch.profiler`` records, each is also a ``record_function`` of its
name, so the profiler's record holds it on the clock of the device's
events. A key is its spans' self time (their duration less their child
spans'), except that a span whose key lies inside its parent's key, as
marked below, leaves its time in the parent's key too. With ``pipe.timing = None``, the default, a span costs
one attribute test. Production tier, by nesting:

====================================  ==============  ====================
span                                  key             covers
====================================  ==============  ====================
``engine.pump``                       pump_s          ``_pump_blocks``'
                                                      buffering
``engine.dispatch``                   dispatch_s      ``MeshEngine.step``
                                                      less the upload
``engine.upload``                     upload_s        the whole of
                                                      ``_upload``
``engine.upload.ring_wait``           ring_wait_s     the ring slot's last
                                      (in upload_s)   copy, on the card
``engine.upload.pin_copy``            pin_copy_s      the copy into the
                                      (in upload_s)   pinned slot, the H2D
                                                      enqueue
``engine.step.launch``                launch_s        widen, K1, the
                                      (in dispatch_s) resamplers, finish,
                                                      state merges
``engine.egress_start``               egress_start_s  the ``HostCopy``
                                                      starts
``engine.queue_wait``                 queue_wait_s    handing a block to
                                                      the drain worker
``engine.drain``                      --              a block's drain
``engine.drain.wait``                 drain_wait_s    each
                                                      ``HostCopy.numpy``
``engine.drain.unpack``               unpack_s        unpacking a fetched
                                                      row, splicing gaps
``decoders.<protocol>``               decode_s        a decoder's scan
``engine.drain.tails``                tails_s         the gated rows'
                                                      tails, ``lead_drop``
====================================  ==============  ====================

``engine.dispatch`` holds the upload, the launches and the egress start;
``engine.drain`` the waits, unpacks, decoders and tails. The bit-exact tier
has ``engine.dispatch`` (dispatch_s) and ``engine.drain`` holding
``engine.drain.fir_end`` (fir_end_s), ``engine.drain.resample`` (rs_s) and
the decoders' spans.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import queue
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from tsl_sdr_tpu_torch.models.ais import AisDecoder
from tsl_sdr_tpu_torch.models.channelizer import (HostCopy, MultifmChain,
                                                   step_raw, widen_wire)
from tsl_sdr_tpu_torch.models.flex import FlexDecoder
from tsl_sdr_tpu_torch.models.pocsag import PocsagDecoder
from tsl_sdr_tpu_torch.models.resampler import ResamplerChain
from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
from tsl_sdr_tpu_torch.ops import gate, polyphase, q14, sync_prefilter
from tsl_sdr_tpu_torch.ops.q14 import to_int16
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter)
from tsl_sdr_tpu_torch.utils.iq import WIRE_DTYPES, WIRE_ZERO, widen_iq_bytes

PROTOCOL_RATES = {"pocsag": 38_400, "flex": 16_000, "ais": 48_000}

_TORCH_WIRE = {np.dtype(np.int16): torch.int16,
               np.dtype(np.int8): torch.int8,
               np.dtype(np.uint8): torch.uint8}

# keys whose spans' time also counts in the key of the span they nest in
_INSIDE = {"ring_wait_s": "upload_s", "pin_copy_s": "upload_s",
           "launch_s": "dispatch_s"}
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """One span of :meth:`ReceivePipeline._trace` while tracing is on;
    ``seconds`` is what it added to its key."""

    __slots__ = ("pipe", "name", "key", "up", "inner", "rec", "t0",
                 "seconds")

    def __init__(self, pipe, name: str, key):
        self.pipe, self.name, self.key = pipe, name, key

    def __enter__(self):
        top = self.pipe._trace_top
        self.up = getattr(top, "span", None)
        top.span = self
        self.inner = 0.0
        self.rec = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rec = torch.autograd.profiler.record_function(self.name)
            self.rec.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        if self.rec is not None:
            self.rec.__exit__(*exc)
        pipe, up = self.pipe, self.up
        pipe._trace_top.span = up
        if up is not None:
            inside = up.key is not None and _INSIDE.get(self.key) == up.key
            up.inner += self.inner if inside else dur
        self.seconds = dur - self.inner
        if self.key is not None:
            with pipe._timing_lock:
                tm = pipe.timing
                if tm is not None:
                    tm[self.key] = tm.get(self.key, 0.0) + self.seconds
        return False


def _make_decoder(protocol: str, freq_hz: int, ais_packet_hook=None):
    if protocol == "pocsag":
        return PocsagDecoder()
    if protocol == "flex":
        return FlexDecoder(freq_hz=freq_hz)
    if protocol == "ais":
        hook = None
        if ais_packet_hook is not None:
            # pipeline hook contract: callable(packet, center_freq_hz)
            def hook(packet, _f=freq_hz, _h=ais_packet_hook):
                _h(packet, _f)
        return AisDecoder(packet_hook=hook)
    raise ValueError(f"unknown protocol {protocol!r}")


@dataclass
class ChannelSpec:
    """One narrowband channel: where it sits and what it speaks (the JAX
    package's ``ChannelSpec``, whose module imports jax)."""

    center_freq_hz: int
    protocol: str  # pocsag | flex | ais | pcm (raw demodulated audio)
    invert: bool = False
    dc_block: bool = False       # decoder -b flag (decoder/decoder.c:648-656)
    dc_block_pole: float = 0.9999
    db_gain: float | None = None  # per-channel dBGain (receiver.c:218-221)


def _leaf_key(k) -> str:
    return "_".join(map(str, k)) if isinstance(k, tuple) else str(k)


def _map_state(v, fn, name: str = ""):
    """Rebuild the stream's device state (dicts and NamedTuples of tensors
    and host ints) with ``fn(name, leaf)`` applied to every leaf. Names are
    dotted paths: ``chain.carry_vals``, ``rs.5_12``, ``dc.7.acc``,
    ``tails.pocsag``."""
    if isinstance(v, dict):
        return {k: _map_state(x, fn, f"{name}.{_leaf_key(k)}" if name
                              else _leaf_key(k)) for k, x in v.items()}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_map_state(getattr(v, f), fn, f"{name}.{f}")
                         for f in v._fields))
    return fn(name, v)


def _leaf_meta(v) -> tuple:
    """(shape, numpy dtype name) of a state leaf, read from its metadata
    alone: a device tensor is not fetched."""
    if isinstance(v, torch.Tensor):
        return (list(v.shape),
                str(torch.empty((), dtype=v.dtype).numpy().dtype))
    return [], "int64"


def cat_on(parts: list, device) -> torch.Tensor:
    """``parts`` concatenated on ``device``; one part is returned as it
    is (moved, not copied, where it lies elsewhere)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


class _Bank:
    """Channels ``[lo, hi)`` of a pipeline on one device, with K1's
    constants for them (``taps``): one channel shard of a mesh
    (:mod:`tsl_sdr_tpu_torch.parallel.pipeline`), or every channel on the
    pipeline's device. Channel numbers stay the pipeline's; each group
    keeps the pipeline's order, so a group's rows of consecutive banks
    follow one another."""

    def __init__(self, pipe: "ReceivePipeline", lo: int, hi: int, device,
                 taps):
        self.lo, self.hi = lo, hi
        self.device = torch.device(device)
        self.taps = taps

        def mine(idxs):
            return [i for i in idxs if lo <= i < hi]

        self.rs_groups = {gid: mine(idxs) for gid, idxs in
                          pipe._rs_groups.items() if mine(idxs)}
        self.dc_items = [(i, p) for i, p in pipe._dc_items if lo <= i < hi]
        self.pack_groups = {pgid: dict(pg, idx=mine(pg["idx"])) for pgid, pg
                            in pipe._pack_groups.items() if mine(pg["idx"])}
        self.raw_groups = {rgid: mine(idxs) for rgid, idxs in
                           pipe._raw_groups.items() if mine(idxs)}

        def rows(idxs, sub):
            j = idxs.index(sub[0])
            return slice(j, j + len(sub))

        # each group's rows of the pipeline's state that are this bank's
        # (ratio groups by gid, pack groups by protocol)
        self.rows = {gid: rows(pipe._rs_groups[gid], sub)
                     for gid, sub in self.rs_groups.items()}
        self.rows.update({pgid: rows(pipe._pack_groups[pgid]["idx"],
                                     pg["idx"])
                          for pgid, pg in self.pack_groups.items()})
        inv = [pipe.channels[i].invert for i in range(lo, hi)]
        self.inv_mask = (torch.tensor(inv, device=self.device)[:, None]
                         if any(inv) else None)

    def state_of(self, st: dict) -> dict:
        """This bank's part of the pipeline's stream state, on its
        device (no copy where the device is the state's)."""
        dev, lo, hi = self.device, self.lo, self.hi
        ch = st["chain"]
        return {
            "chain": ch._replace(carry_vals=ch.carry_vals.to(dev),
                                 prev_r=ch.prev_r[lo:hi].to(dev),
                                 prev_i=ch.prev_i[lo:hi].to(dev)),
            "rs": {gid: st["rs"][gid][self.rows[gid]].to(dev)
                   for gid in self.rs_groups},
            "dc": {i: dcb.DcBlockerState(*(v.to(dev) for v in st["dc"][i]))
                   for i, _ in self.dc_items},
            "tails": {pgid: st["tails"][pgid][self.rows[pgid]].to(dev)
                      for pgid in self.pack_groups},
        }

    @staticmethod
    def merge_states(banks: list, states: list, device) -> dict:
        """The pipeline's stream state on ``device`` from its banks'
        (the inverse of :meth:`state_of` over banks covering every
        channel in order)."""
        def cat(parts):
            return cat_on(parts, device)

        ch = states[0]["chain"]
        return {
            "chain": ch._replace(
                carry_vals=ch.carry_vals.to(device),
                prev_r=cat([s["chain"].prev_r for s in states]),
                prev_i=cat([s["chain"].prev_i for s in states])),
            "rs": {gid: cat([s["rs"][gid] for s in states if gid in s["rs"]])
                   for gid in dict.fromkeys(g for s in states
                                            for g in s["rs"])},
            "dc": {i: dcb.DcBlockerState(*(v.to(device) for v in d))
                   for s in states for i, d in s["dc"].items()},
            "tails": {pgid: cat([s["tails"][pgid] for s in states
                                 if pgid in s["tails"]])
                      for pgid in dict.fromkeys(g for s in states
                                                for g in s["tails"])},
        }


class _SizedProgram:
    """Everything bound to one block length and one bank of channels:
    per-ratio-group resampler plans with ``block_in`` equal to the block's
    per-channel span (one resample step consumes the block), their device
    taps, and the per-block device step in its three stages
    (:meth:`channelize`, :meth:`resample`, :meth:`finish`)."""

    def __init__(self, pipe: "ReceivePipeline", n: int, bank: _Bank):
        self.plans = pipe._rs_plans(n)
        self.bank = bank
        dev = bank.device
        self.rs_taps = {gid: polyphase.plan_taps(self.plans[gid], device=dev)
                        for gid in bank.rs_groups}
        k_chain = n // pipe.chain.decimation
        self.k_out = {
            i: (self.plans[pipe._ratio_gid[i]].block_out
                if pipe._ratio_gid[i] is not None else k_chain)
            for i in range(len(pipe.channels))
        }
        # each group's rows of the bank's [C_bank, K] PCM
        self.rs_idx = {gid: torch.tensor([i - bank.lo for i in idxs],
                                         device=dev)
                       for gid, idxs in bank.rs_groups.items()}
        self.pipe = pipe
        # combined pack payload layout, in ELEMENTS of the group's dtype:
        # bits kind [flags u8 | packed tail bytes | packed bits], pcm kind
        # [flags i16 | tail pcm samples | pcm samples]
        self.meta_bytes = {
            pgid: (1 + pipe._tail_bits[pgid] if pg["kind"] == "pcm"
                   else 1 + pipe._tail_bits[pgid] // 8)
            for pgid, pg in pipe._pack_groups.items()
        }

    def init_rs_states(self) -> dict:
        return {gid: polyphase.init_resampler_carry(
                    self.plans[gid], len(idxs), device=self.bank.device)
                for gid, idxs in self.bank.rs_groups.items()}

    def channelize(self, chain_st, vals: torch.Tensor):
        """K1 and the polarity flip: (chain state, flat int16 values) ->
        (state, pcm [C_bank, K] int16)."""
        bank = self.bank
        chain_st, pcm_flat = step_raw(bank.taps, chain_st, vals)
        pcm = pcm_flat.reshape(-1, bank.hi - bank.lo).T  # [C, K]
        if bank.inv_mask is not None:
            flipped = torch.clamp(-pcm.to(torch.int32), -32768,
                                  32767).to(torch.int16)
            pcm = torch.where(bank.inv_mask, flipped, pcm)
        return chain_st, pcm

    def resample(self, rs: dict, pcm: torch.Tensor):
        """Each ratio group through its resampler, one launch for the
        group's rows: -> (carries, {channel: its row after the
        resampler})."""
        bank = self.bank
        ch_rows = {}
        rs2 = {}
        for gid, idxs in bank.rs_groups.items():
            rows = pcm[self.rs_idx[gid]]  # [G, K]
            rs2[gid], outs = polyphase.resample_step(
                self.plans[gid], rs[gid], rows, self.rs_taps[gid])
            for j, i in enumerate(idxs):
                ch_rows[i] = outs[j]
        for i in range(bank.lo, bank.hi):
            if i not in ch_rows:
                ch_rows[i] = pcm[i - bank.lo]
        return rs2, ch_rows

    def finish(self, dc: dict, tails: dict, ch_rows: dict):
        """DC block (K8, one launch for the rows of one length), then the
        sign slice, sync prefilter and bit pack (K7, one launch a pack
        group): -> (DC states, prefilter tails, (pack_out, raw_out))."""
        bank = self.bank
        dc2 = {}
        by_len = {}
        for i, coeff in bank.dc_items:
            by_len.setdefault(ch_rows[i].shape[-1], []).append((i, coeff))
        for items in by_len.values():
            states, out = dcb.dc_block_fast(
                [dc[i] for i, _ in items], [ch_rows[i] for i, _ in items],
                [coeff for _, coeff in items])
            for j, (i, _) in enumerate(items):
                dc2[i], ch_rows[i] = states[j], out[j]
        tails2 = {}
        pack_out = {}
        for pgid, pg in bank.pack_groups.items():
            # ONE output buffer a group, the unit of its device->host copy
            pack_out[pgid], tails2[pgid] = gate.egress_gate(
                pgid, [ch_rows[i] for i in pg["idx"]], tails[pgid])
        raw_out = {rgid: to_int16(torch.stack([ch_rows[i] for i in idxs]))
                   for rgid, idxs in bank.raw_groups.items()}
        return dc2, tails2, (pack_out, raw_out)


class ReceivePipeline:
    """Wideband IQ in, decoded protocol messages (or raw PCM) out.

    Parameters
    ----------
    lpf_taps : channel-select LPF for the channelizer (shared, real)
    center_freq_hz : capture center frequency
    sample_rate : wideband sample rate (Hz)
    decimation : channelizer decimation; channel rate = fs / decimation
    channels : list of :class:`ChannelSpec`
    exact : bit-exact integer tier (True) or production tier (False)
    backend : the JAX package's production form ("auto", "xla", "pallas",
        "pallas-high"), accepted and ignored as :class:`MultifmChain` does
    max_ratio : largest allowed resampler interpolation/decimation term
    block_size : streaming block length in wideband samples (rounded to the
        pipeline quantum); default ~4M
    inflight_depth : blocks kept in flight before the oldest is drained
    ais_packet_hook : callable(packet_bytes, center_freq_hz) for every
        CRC-valid AIS packet
    wire_fmt : input wire format; 8-bit formats take raw wire bytes and
        widen on the device
    device : "cuda" (default) or "cpu"; CUDA must be present when asked for
    mesh : a :class:`~tsl_sdr_tpu_torch.parallel.mesh.Mesh` to run the
        production tier's blocks over (channel shards and time spans, see
        :mod:`tsl_sdr_tpu_torch.parallel.pipeline`), which decodes what the
        pipeline without one decodes; the pipeline's state and outputs
        then live on the first device of this process's first time row,
        which replaces ``device``. The bit-exact tier ignores the mesh
        and runs on that one device, as the JAX package's does.
    drain_async : drain blocks (device->host wait, bit unpack, decoder
        scans) on a worker thread, so block k's drain overlaps block k+1's
        upload and dispatch. Messages may then surface on a later push()
        (flush() always waits for all of them); per-channel order is
        unchanged (one worker, FIFO), and a worker error raises on the
        next push(). ``pipeline-torch --follow`` turns it on.
    """

    # protocols whose decoders consume ONLY a sign predicate of the PCM, so
    # the device slices + bit-packs before transfer. FLEX is gated too but
    # with an int16 payload ("pcm" kind). value = is_gt: True slices
    # pcm > 0 (ais_demod.c:126), False pcm < 0 (pager_pocsag.c:91)
    _PACK_PREDICATE = {"pocsag": False, "ais": True}

    def __init__(self, lpf_taps, center_freq_hz: int, sample_rate: float,
                 decimation: int, channels, *, exact: bool = False,
                 backend: str = "auto", max_ratio: int = 256,
                 block_size: int | None = None,
                 inflight_depth: int = 2, ais_packet_hook=None,
                 wire_fmt: str = "cs16", device="cuda",
                 drain_async: bool = False, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.devices[mesh.local_rows[0], 0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        if wire_fmt not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_fmt {wire_fmt!r}; expected one "
                             f"of {tuple(WIRE_DTYPES)}")
        self.wire_fmt = wire_fmt
        self._wire_dtype = np.dtype(WIRE_DTYPES[wire_fmt])
        self._wire_zero = WIRE_ZERO[wire_fmt]
        # the spans' seconds by key (module docstring, "Tracing"); None:
        # spans off. With the drain worker its spans overlap the dispatch
        # thread's, so the keys sum to more than the wall time
        self.timing = None
        self._timing_lock = threading.Lock()
        self._trace_top = threading.local()   # each thread's open span
        self.drain_async = bool(drain_async)
        self._ais_packet_hook = ais_packet_hook
        # what the checkpoint fingerprint hashes beside the chain's own
        self._fp_taps = np.asarray(lpf_taps, np.float64)
        self._fp_center = int(center_freq_hz)
        self.inflight_depth = int(inflight_depth)
        self.channels = list(channels)
        offsets = [c.center_freq_hz - center_freq_hz for c in self.channels]
        gains = [
            10.0 ** (c.db_gain / 10.0) if c.db_gain is not None else 1.0
            for c in self.channels
        ]
        self.chain = MultifmChain(lpf_taps, offsets, sample_rate, decimation,
                                  gains=gains, exact=exact, backend=backend,
                                  device=self.device)
        ch_rate = self.chain.channel_rate

        self._decoders = []
        self._ratio_gid = []
        self._rs_coeffs = {}
        self._rs_chains = {}
        for spec in self.channels:
            if spec.protocol == "pcm":
                self._decoders.append(None)
                self._ratio_gid.append(None)
                continue
            target = PROTOCOL_RATES[spec.protocol]
            ratio = Fraction(target, int(round(ch_rate)))
            if ratio.numerator > max_ratio or ratio.denominator > max_ratio:
                raise ValueError(
                    f"channel rate {ch_rate:.0f} Hz -> {target} Hz needs "
                    f"{ratio.numerator}/{ratio.denominator}; pick a "
                    "decimation giving a simpler ratio")
            if ratio == 1:
                self._ratio_gid.append(None)
            else:
                gid = (ratio.numerator, ratio.denominator)
                if gid not in self._rs_coeffs:
                    self._rs_coeffs[gid] = design_rational_resampler_filter(
                        ratio.numerator, ratio.denominator, 0.4)
                    if exact:
                        # the exact engine's resampler (the production
                        # engine sizes its own plans; its host path makes
                        # its chains at first use, _host_resampler)
                        self._rs_chains[gid] = ResamplerChain(
                            self._rs_coeffs[gid], ratio.numerator,
                            ratio.denominator, exact=True,
                            device=self.device)
                self._ratio_gid.append(gid)
            self._decoders.append(_make_decoder(
                spec.protocol, spec.center_freq_hz, self._ais_packet_hook))
        self._decode_spans = [f"decoders.{c.protocol}" for c in self.channels]

        self._setup_stream(block_size)
        self._engine = None
        if not exact:
            from tsl_sdr_tpu_torch.parallel.mesh import Mesh
            from tsl_sdr_tpu_torch.parallel.pipeline import MeshEngine

            self._engine = MeshEngine(self, mesh or Mesh([[self.device]]))

    @property
    def primed(self) -> bool:
        """Whether a stream (of either engine) has started."""
        return self._stream is not None or self._xstream is not None

    @property
    def decoder_tiers(self) -> set:
        """{"native"} when every protocol decoder runs its C++ state
        machine; "numpy" appears for any built with ``native=False``."""
        return {"native" if d._nat is not None else "numpy"
                for d in self._decoders if d is not None}

    # -- streaming engine ---------------------------------------------------

    def _setup_stream(self, block_size):
        decim = self.chain.decimation
        self._rs_groups: dict = {}
        for i, gid in enumerate(self._ratio_gid):
            if gid is not None:
                self._rs_groups.setdefault(gid, []).append(i)
        self._dc_items = [(i, dcb.make_pole_coeff(spec.dc_block_pole))
                          for i, spec in enumerate(self.channels)
                          if spec.dc_block]
        self._pack_groups: dict = {}
        self._raw_groups: dict = {}
        for i, spec in enumerate(self.channels):
            if spec.protocol in self._PACK_PREDICATE:
                pg = self._pack_groups.setdefault(
                    spec.protocol,
                    {"idx": [], "kind": "bits",
                     "is_gt": self._PACK_PREDICATE[spec.protocol]})
                pg["idx"].append(i)
            elif spec.protocol == "flex":
                pg = self._pack_groups.setdefault(
                    spec.protocol, {"idx": [], "kind": "pcm"})
                pg["idx"].append(i)
            else:
                self._raw_groups.setdefault(spec.protocol, []).append(i)
        self._tail_bits = {
            "pocsag": sync_prefilter.POCSAG_TAIL,
            "ais": sync_prefilter.AIS_TAIL,
            "flex": sync_prefilter.FLEX_TAIL,
        }

        # block quantum: chain quantum, every resampler's input grid, each
        # group's packed-row input grid, and a whole number of channel
        # samples per byte of packed bits
        q = self.chain.block_quantum
        for (i_, d_) in self._rs_groups:
            q = math.lcm(q, decim * d_)
            k_row = math.lcm(i_, 128)
            if k_row <= 1024:
                row_in = (k_row // i_) * d_
                q = math.lcm(q, decim * row_in)
        q = math.lcm(q, decim * 8)
        self.block_quantum = q
        bs = block_size or 4_194_304
        self.block_size = max(q, bs // q * q)
        # gap-tail soundness: every pack channel's per-block output must
        # cover the carried prefilter tail
        min_n = 0
        for pgid, pg in self._pack_groups.items():
            tail = self._tail_bits[pgid]
            for i in pg["idx"]:
                gid = self._ratio_gid[i]
                if gid is None:
                    need = tail * decim
                else:
                    i_, d_ = gid
                    need = -(-tail * d_ // i_) * decim
                min_n = max(min_n, need)
        if min_n:
            self.block_size = max(self.block_size, -(-min_n // q) * q)

        self._programs: dict = {}
        self._plans: dict = {}
        self._bank = _Bank(self, 0, len(self.channels), self.device,
                           self.chain.taps)
        self._stream = None
        self._xstream = None
        self._last_stream_stats = None
        self._pending_prefix = np.zeros((0, 2), self._wire_dtype)
        # pinned staging rings: (values, dtype, device) -> [next slot,
        # [buffer, event] pairs]
        self._uploads = {}

    def _rs_plans(self, n: int) -> dict:
        """Each ratio group's resampler plan for blocks of ``n`` samples,
        its ``block_in`` the block's per-channel span."""
        if n not in self._plans:
            k_chain = n // self.chain.decimation
            plans = {}
            for gid in self._rs_groups:
                i_, d_ = gid
                plan = polyphase.make_resampler_plan(
                    q14.quantize_q14(self._rs_coeffs[gid]), i_, d_,
                    block_out_target=k_chain * i_ // d_,
                    align_k_row=False)  # n_in must equal k_chain exactly
                if plan.block_in != k_chain:
                    raise ValueError(
                        f"resampler plan consumes {plan.block_in} samples "
                        f"per block, the chain gives {k_chain}")
                plans[gid] = plan
            self._plans[n] = plans
        return self._plans[n]

    def _program(self, n: int, bank: _Bank | None = None) -> _SizedProgram:
        """The program for blocks of ``n`` samples of ``bank`` (default:
        every channel on the pipeline's device)."""
        bank = bank or self._bank
        if n % self.block_quantum:
            raise ValueError(f"block of {n} samples is not a multiple of "
                             f"the {self.block_quantum}-sample quantum")
        key = (n, id(bank))
        if key not in self._programs:
            self._programs[key] = _SizedProgram(self, n, bank)
        return self._programs[key]

    def stream_reset(self):
        """Forget all streaming state (device carries, input buffer,
        in-flight blocks). Decoder instances persist. The drain worker, if
        any, finishes the blocks already handed to it (a synchronous drain
        would have decoded them by now) and is joined before the stream is
        forgotten, so no old block reaches a later stream."""
        self._drain_shutdown()
        self._stream = None
        self._xstream = None
        self._pending_prefix = np.zeros((0, 2), self._wire_dtype)

    # -- wire-format helpers -------------------------------------------------

    def _coerce_wire(self, iq) -> np.ndarray:
        """Raw wire bytes (bytes / flat or [N, 2] 8-bit array) -> [N, 2]
        wire-dtype view. Only 8-bit input is reinterpreted: anything wider
        (a host-widened int16 capture, say) raises instead of turning into
        twice as many garbage samples."""
        if isinstance(iq, (bytes, bytearray, memoryview)):
            iq = np.frombuffer(iq, np.uint8)
        flat = np.asarray(iq).reshape(-1)
        if flat.dtype.itemsize != 1 or flat.dtype.kind not in "iu":
            raise ValueError(
                f"wire_fmt {self.wire_fmt!r} takes raw 8-bit wire bytes, "
                f"got {flat.dtype}")
        return flat.view(self._wire_dtype).reshape(-1, 2)

    def _widen_host(self, arr) -> np.ndarray:
        """[N, 2] wire-dtype -> [N, 2] int16 by the host rules."""
        if self.wire_fmt == "cs16":
            return np.asarray(arr, np.int16)
        flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        return widen_iq_bytes(flat, self.wire_fmt).reshape(-1, 2)

    def _stream_init(self, prefix: np.ndarray | None):
        self._stream = self._new_stream(prefix)
        if self.drain_async:
            self._start_drain_worker(self._stream, self._drain)

    def _new_stream(self, prefix: np.ndarray | None) -> dict:
        """A fresh production stream dict (not installed, no worker)."""
        if prefix is not None and self.wire_fmt != "cs16":
            # the chain's carry prefix is tiny (carry_len samples); widen
            # it on the host — the bulk blocks widen on the device
            prefix = self._widen_host(prefix)
        prog = self._program(self.block_size)
        dev = self.device
        st = {
            "chain": self.chain.init_state(prefix=prefix),
            "rs": prog.init_rs_states(),
            "dc": {i: dcb.init_dc_blocker_state(device=dev)
                   for i, _ in self._dc_items},
            "tails": {
                pgid: torch.zeros((len(pg["idx"]), self._tail_bits[pgid]),
                                  dtype=torch.uint8, device=dev)
                for pgid, pg in self._pack_groups.items()
            },
        }
        return {
            "st": st,
            "drain_one": self._drain,
            "buf": [],
            "buf_len": 0,
            "inflight": deque(),
            # zero-primed resampler carries time-shift the output grid by
            # carry_len channel samples vs the head-primed host path; the
            # first ceil(carry_len*I/D) outputs are zero-history transient
            # and are dropped so decoders never see fabricated samples
            "lead_drop": {
                i: -(-prog.plans[gid].carry_len
                     * prog.plans[gid].interpolation
                     // prog.plans[gid].decimation)
                for gid, idxs in self._rs_groups.items()
                for i in idxs
            },
            # host-side per-pack-channel gating state
            "gap": {i: False for pg in self._pack_groups.values()
                    for i in pg["idx"]},
            "tail_pcm": {i: None for pg in self._pack_groups.values()
                         for i in pg["idx"]},
            "blocks": 0,
            "fetched": np.zeros(len(self.channels), np.int64),
            "upload_elems": 0,
            "upload_bytes": 0,
            # look-back rows each time span of a mesh took from the span
            # before it (host slices, or messages between ranks)
            "halo_bytes": 0,
            # a pack group that fetched rows last block is "hot": its next
            # payload streams to the host whole; cold groups send only the
            # flags + tail head (egress gating)
            "hot": {pgid: True for pgid in self._pack_groups},
        }

    # -- drain worker ---------------------------------------------------------

    def _start_drain_worker(self, s: dict, drain_one):
        """Attach a drain worker to stream dict ``s``: entries queued by
        :meth:`_drain_entry` are drained by ``drain_one(s, entry, new)``
        into ``s`` (never into a later stream) on one thread, in order.
        ``drain_one`` is :meth:`_drain` (production) or
        :meth:`_drain_exact_fir` (bit-exact), each in an ``engine.drain``
        span."""
        s["drain_one"] = drain_one
        # bounded: a lagging worker holds push() back instead of letting
        # undrained device buffers pile up
        s["dq"] = queue.Queue(maxsize=max(2, self.inflight_depth))
        s["dres"] = [[] for _ in self.channels]
        s["dlock"] = threading.Lock()
        s["derr"] = None
        cuda_index = (torch.cuda.current_device()
                      if self.device.type == "cuda"
                      and self.device.index is None else self.device.index)

        def worker():
            if cuda_index is not None:
                # the device (and the current stream) is per thread
                torch.cuda.set_device(cuda_index)
            while True:
                entry = s["dq"].get()
                if entry is None:
                    return
                if isinstance(entry, threading.Event):
                    entry.set()  # barrier: everything before it is drained
                    continue
                if s["derr"] is not None:
                    continue  # poisoned: discard, the error surfaces on push
                try:
                    part = [[] for _ in self.channels]
                    with self._trace("engine.drain"):
                        drain_one(s, entry, part)
                    with s["dlock"]:
                        for c, msgs in enumerate(part):
                            s["dres"][c].extend(msgs)
                except BaseException as e:  # noqa: BLE001 - re-raised on push
                    s["derr"] = e

        s["dthread"] = threading.Thread(target=worker, daemon=True,
                                        name="tsl-drain")
        s["dthread"].start()

    def _collect(self, s: dict, new: list):
        """Move the worker's finished results into ``new``; raise its
        error, if it had one."""
        if s["derr"] is not None:
            raise s["derr"]
        with s["dlock"]:
            for c, msgs in enumerate(s["dres"]):
                if msgs:
                    new[c].extend(msgs)
                    s["dres"][c] = []

    def _drain_entry(self, s: dict, entry, new: list):
        """Drain one in-flight block of stream ``s``: inline, or queued to
        its worker (results ready so far fold into ``new``)."""
        if s.get("dthread") is None:
            with self._trace("engine.drain"):
                s["drain_one"](s, entry, new)
            return
        self._collect(s, new)
        with self._trace("engine.queue_wait", "queue_wait_s"):
            s["dq"].put(entry)

    def _drain_barrier(self, s: dict, new: list):
        """Wait until every block queued to ``s``'s worker is drained and
        collect the results."""
        if s.get("dthread") is None:
            return
        done = threading.Event()
        s["dq"].put(done)
        done.wait()
        self._collect(s, new)

    def _drain_shutdown(self):
        """Stop the current streams' workers and join them."""
        for s in (self._stream, self._xstream):
            if s is None or s.get("dthread") is None:
                continue
            s["dq"].put(None)
            s["dthread"].join()
            s["dthread"] = None

    @property
    def stream_stats(self) -> dict:
        """{"blocks": drained blocks, "fetched": per-channel full-row fetch
        counts, "upload_elems", "upload_bytes", "halo_bytes"}: the
        wire values and bytes this process uploaded, and the bytes of
        look-back rows a mesh's time spans took from their neighbours."""
        s = self._stream
        if s is None:
            if self._last_stream_stats is not None:
                return dict(self._last_stream_stats)
            return {"blocks": 0,
                    "fetched": np.zeros(len(self.channels), np.int64),
                    "upload_elems": 0, "upload_bytes": 0, "halo_bytes": 0}
        return {"blocks": s["blocks"], "fetched": s["fetched"].copy(),
                "upload_elems": s["upload_elems"],
                "upload_bytes": s["upload_bytes"],
                "halo_bytes": s["halo_bytes"]}

    def push(self, iq) -> list:
        """Feed wideband IQ (any length); decode what completes.

        Returns a per-channel list of messages (or raw PCM arrays for
        ``pcm`` channels) completed during this call. State carries across
        calls (reference run-forever semantics, multifm/multifm.c:163-165).
        """
        new = [[] for _ in self.channels]
        if self.chain.exact:
            attr, init, dispatch = ("_xstream", self._xstream_init,
                                    self._dispatch_exact)
        else:
            attr, init, dispatch = "_stream", self._stream_init, self._dispatch
        for block in self._pump_blocks(iq, attr, init):
            dispatch(block)
            s = getattr(self, attr)
            while len(s["inflight"]) > self.inflight_depth:
                self._drain_entry(s, s["inflight"].popleft(), new)
        # hand back what the worker finished meanwhile, even on a push too
        # short to complete a block (live latency)
        s = getattr(self, attr)
        if s is not None and s.get("dthread") is not None:
            self._collect(s, new)
        return new

    def _pump_blocks(self, iq, attr: str, init_fn):
        """The input path of both engines: hold data until the chain prefix
        is covered, prime the stream ``self.<attr>`` with ``init_fn``,
        buffer, and yield full block_size blocks."""
        s = getattr(self, attr)
        with self._trace("engine.pump", "pump_s"):
            if self.wire_fmt == "cs16":
                iq = np.asarray(iq, np.int16).reshape(-1, 2)
            else:
                iq = self._coerce_wire(iq)
            if s is None:
                c_len = self.chain.carry_len
                pend = np.concatenate([self._pending_prefix, iq])
                if pend.shape[0] < c_len + 1:
                    self._pending_prefix = pend
                    return
                init_fn(pend[:c_len] if c_len else None)
                self._pending_prefix = np.zeros((0, 2), self._wire_dtype)
                iq = pend[c_len:]
                s = getattr(self, attr)
            s["buf"].append(iq)
            s["buf_len"] += iq.shape[0]
        while s["buf_len"] >= self.block_size:
            with self._trace("engine.pump", "pump_s"):
                buf = (np.concatenate(s["buf"]) if len(s["buf"]) > 1
                       else s["buf"][0])
                block = buf[: self.block_size]
                rest = buf[self.block_size:]
                s["buf"] = [rest] if rest.shape[0] else []
                s["buf_len"] = rest.shape[0]
            yield block

    def _flush_unprimed(self) -> list:
        """Flush before the stream ever primed: error if data was pushed."""
        if self._pending_prefix.shape[0]:
            raise ValueError(
                f"capture shorter than the pipeline prefix "
                f"({self._pending_prefix.shape[0]} <= "
                f"{self.chain.carry_len} samples); nothing processed")
        return [[] for _ in self.channels]

    def _trace(self, name: str, key: str | None = None):
        """A span of the engine (module docstring, "Tracing") as a context
        manager: ``name`` in the profiler's record, its self time added to
        ``self.timing[key]`` (no key: none). A shared no-op while
        ``self.timing`` is None."""
        if self.timing is None:
            return _NO_SPAN
        return _Span(self, name, key)

    def _upload(self, flat: np.ndarray, device=None) -> torch.Tensor:
        """Host values -> tensor on ``device`` (default the pipeline's).
        On the card: through a ring of two pinned staging buffers for each
        length and device, copied with ``non_blocking=True``; a buffer is
        refilled only after its previous copy has completed."""
        device = self.device if device is None else torch.device(device)
        if device.type == "cpu":
            return torch.from_numpy(flat)
        key = (flat.shape[0], flat.dtype, device)
        if key not in self._uploads:
            self._uploads[key] = [0, [
                [torch.empty(flat.shape[0], dtype=_TORCH_WIRE[flat.dtype],
                             pin_memory=True), None] for _ in range(2)]]
        ring = self._uploads[key]
        slot = ring[1][ring[0]]
        ring[0] = (ring[0] + 1) % len(ring[1])
        if slot[1] is not None:
            with self._trace("engine.upload.ring_wait", "ring_wait_s"):
                slot[1].synchronize()
        with self._trace("engine.upload.pin_copy", "pin_copy_s"):
            np.copyto(slot[0].numpy(), flat)
            vals = slot[0].to(device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(device))
        return vals

    def _dispatch(self, block: np.ndarray, valid_n: int | None = None):
        s = self._stream
        prog = self._program(block.shape[0])
        flat = np.ascontiguousarray(block).reshape(-1)
        with self._trace("engine.dispatch", "dispatch_s"):
            # uploads, K1 and the resamplers a time span at a time, the
            # rest on the first device (one span and one bank without a
            # mesh). Over a multi-process mesh this is where the ranks'
            # messages and gather happen: here, on the dispatch thread, in
            # the same order on every rank, never on the drain worker
            s["st"], outs = self._engine.step(s["st"], flat, s)
            # start device->host copies now so they overlap the next
            # block's compute. Hot groups stream their whole payload; cold
            # (idle) groups only the small flags+tail head (egress gating).
            with self._trace("engine.egress_start", "egress_start_s"):
                pack_out, raw_out = outs
                pre = {}
                for pgid, combined in pack_out.items():
                    if s["hot"][pgid]:
                        pre[pgid] = ("full", HostCopy(combined))
                    else:
                        pre[pgid] = ("head", HostCopy(
                            combined[:, :prog.meta_bytes[pgid]]))
                raws = {rgid: HostCopy(rows)
                        for rgid, rows in raw_out.items()}
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        s["inflight"].append((prog, pack_out, pre, raws, valid_n, stream))

    def _valid_k(self, prog, i: int, valid_n: int | None) -> int:
        """Real (non-pad) output samples of channel ``i`` for a block whose
        first ``valid_n`` wideband samples are real."""
        if valid_n is None:
            return prog.k_out[i]
        k_chain = valid_n // self.chain.decimation
        gid = self._ratio_gid[i]
        if gid is None:
            return min(k_chain, prog.k_out[i])
        i_, d_ = gid
        return min(k_chain * i_ // d_, prog.k_out[i])

    def _drain(self, s: dict, entry, new: list):
        """Decode one block of stream ``s`` into ``new``: wait for its
        device->host copies, unpack, splice gaps, scan."""
        prog, pack_out, pre, raw_copies, valid_n, stream = entry
        with self._trace("engine.drain.wait", "drain_wait_s"):
            raws = {rgid: cp.numpy() for rgid, cp in raw_copies.items()}

        s["blocks"] += 1
        for pgid, pg in self._pack_groups.items():
            mb = prog.meta_bytes[pgid]
            kind, copy = pre[pgid]
            with self._trace("engine.drain.wait", "drain_wait_s"):
                host = copy.numpy()
            meta = host[:, :mb]
            flags = meta[:, 0].astype(bool)
            tail_cols = meta[:, 1:mb]
            pcm_kind = pg["kind"] == "pcm"
            is_gt = pg.get("is_gt")
            # rows needing a full fetch: flagged, or decoder mid-message,
            # or gating unsupported
            need_rows = []
            for row, i in enumerate(pg["idx"]):
                dec = self._decoders[i]
                gate = getattr(dec, "supports_gating", False)
                if flags[row] or not gate or not dec.in_search:
                    need_rows.append(row)
            if need_rows:
                if kind == "full":
                    packed = host[np.asarray(need_rows), mb:]
                else:
                    # cold group turning active: fetch the whole payload
                    # once (a rare edge) and index on the host
                    with self._trace("engine.drain.wait", "drain_wait_s"):
                        full = HostCopy(pack_out[pgid], stream).numpy()
                        packed = full[np.asarray(need_rows), mb:]
            s["hot"][pgid] = bool(need_rows)
            # the zero-history resampler transient (lead_drop) is consumed
            # by EVERY block's outputs, fetched or gated
            ld0 = {i: s["lead_drop"].get(i, 0) for i in pg["idx"]}
            for row, i in enumerate(pg["idx"]):
                if ld0[i]:
                    vk = self._valid_k(prog, i, valid_n)
                    s["lead_drop"][i] = max(ld0[i] - vk, 0)
            for j, row in enumerate(need_rows):
                i = pg["idx"][row]
                dec = self._decoders[i]
                with self._trace("engine.drain.unpack", "unpack_s"):
                    s["fetched"][i] += 1
                    vk = self._valid_k(prog, i, valid_n)
                    if pcm_kind:
                        pcm = packed[j][:vk].astype(np.int16)
                    else:
                        bits = np.unpackbits(packed[j])[:vk]
                        pcm = (np.where(bits, 1, -1) if is_gt
                               else np.where(bits, -1, 1)).astype(np.int16)
                    if ld0[i]:
                        pcm = pcm[min(ld0[i], len(pcm)):]
                    if s["gap"][i]:
                        dec.notify_gap()
                        tp = s["tail_pcm"][i]
                        if tp is not None:
                            pcm = np.concatenate([tp, pcm])
                        s["gap"][i] = False
                with self._trace(self._decode_spans[i], "decode_s"):
                    new[i].extend(dec.scan(pcm))
            with self._trace("engine.drain.tails", "tails_s"):
                for row, i in enumerate(pg["idx"]):
                    if row not in need_rows:
                        s["gap"][i] = True
                    if pcm_kind:
                        tail = tail_cols[row].astype(np.int16)
                    else:
                        tb = np.unpackbits(tail_cols[row])
                        tail = (np.where(tb, 1, -1) if is_gt
                                else np.where(tb, -1, 1)).astype(np.int16)
                    if ld0[i]:
                        # the tail covers output positions [vk-T, vk); if
                        # the transient reaches into it, its head is
                        # fabricated
                        vk = self._valid_k(prog, i, valid_n)
                        cut = min(ld0[i], vk) - (vk - len(tail))
                        if cut > 0:
                            tail = tail[cut:]
                    s["tail_pcm"][i] = tail

        for rgid, idxs in self._raw_groups.items():
            rows = raws[rgid]
            for j, i in enumerate(idxs):
                audio = rows[j].astype(np.int16)[
                    : self._valid_k(prog, i, valid_n)]
                ld = s["lead_drop"].get(i, 0)
                if ld:
                    take = min(ld, len(audio))
                    audio = audio[take:]
                    s["lead_drop"][i] = ld - take
                dec = self._decoders[i]
                with self._trace(self._decode_spans[i], "decode_s"):
                    if dec is None:
                        new[i].append(audio)
                    else:
                        new[i].extend(dec.scan(audio))

    def flush(self) -> list:
        """Drain in-flight blocks (waiting for the drain worker, if any)
        and process the buffered tail.

        The tail is padded with the wire format's zero level up to the full
        block size (reusing the block's program) and the pad-derived output
        samples are trimmed before any decoder or pcm channel sees them."""
        if self.chain.exact:
            return self._flush_exact()
        s = self._stream
        if s is None:
            return self._flush_unprimed()
        new = [[] for _ in self.channels]
        padded = False
        if s["buf_len"]:
            valid = s["buf_len"]
            buf = (np.concatenate(s["buf"]) if len(s["buf"]) > 1
                   else s["buf"][0])
            block = np.full((self.block_size, 2), self._wire_zero,
                            self._wire_dtype)
            block[:valid] = buf
            s["buf"] = []
            s["buf_len"] = 0
            self._dispatch(block, valid_n=valid)
            padded = True
        self._drain_all(s, new)
        if padded:
            # the device carries have consumed pad zeros; a later push()
            # must not splice real samples onto that history
            self._last_stream_stats = self.stream_stats
            self.stream_reset()
        return new

    def warm_device(self) -> float:
        """Pre-pay this process's device start-up (CUDA context, kernel
        build and load, allocator growth) on one throwaway block of the
        wire format's zero level. Stream state and decoders end untouched
        (silence keeps every decoder in SEARCH; the stream is reset).
        No-op on an already-primed stream. Returns wall seconds spent."""
        if self.primed or self._pending_prefix.shape[0]:
            return 0.0
        t0 = time.monotonic()
        n = self.chain.carry_len + self.block_size + 1024
        self.push(np.full((n, 2), self._wire_zero, self._wire_dtype))
        self.flush()
        self.stream_reset()
        self._last_stream_stats = None
        return time.monotonic() - t0

    def _drain_all(self, s: dict, new: list):
        """Drain every in-flight block of ``s`` and wait for the worker."""
        while s["inflight"]:
            self._drain_entry(s, s["inflight"].popleft(), new)
        self._drain_barrier(s, new)

    # -- bit-exact streaming engine ------------------------------------------

    def _xstream_init(self, prefix):
        if prefix is not None and self.wire_fmt != "cs16":
            prefix = self._widen_host(prefix)
        self._xstream = {
            "st": self.chain.init_state(prefix=prefix),
            "drain_one": self._drain_exact_fir,
            "buf": [],
            "buf_len": 0,
            # dispatched blocks (K5 + derotation + discriminator queued,
            # their PCM on its way to the host), drained in order
            "inflight": deque(),
            # per ratio group: the resampler carry [G, carry_len] on the
            # device (None until the group's head has primed it) and the
            # channel-rate samples waiting for a whole resampler step
            "g_rs_st": {gid: None for gid in self._rs_groups},
            "g_abuf": {gid: np.zeros((len(idxs), 0), np.int16)
                       for gid, idxs in self._rs_groups.items()},
            "dc_st": {i: torch.zeros((1, 3), dtype=torch.int32,
                                     device=self.device)
                      for i, _ in self._dc_items},
        }
        if self.drain_async:
            self._start_drain_worker(self._xstream, self._drain_exact_fir)

    def _dispatch_exact(self, block: np.ndarray):
        # 8-bit wire blocks upload raw and widen on the device, by the host
        # rules bit for bit (only the tiny stream prefix widens on the host)
        x = self._xstream
        with self._trace("engine.dispatch", "dispatch_s"):
            x["st"], pending = self.chain.step_exact_packed_begin(
                x["st"], block, wire_fmt=self.wire_fmt)
        x["inflight"].append(pending)

    def _drain_exact_fir(self, x: dict, pending, new: list):
        """Finish one dispatched exact block of stream ``x`` and run the
        stages after the channelizer on its PCM."""
        with self._trace("engine.drain.fir_end", "fir_end_s"):
            pcm = self.chain.step_exact_packed_end(pending)
        self._drain_exact(x, pcm, new)

    def _stack_rs_states(self, gid, prefixes: np.ndarray) -> torch.Tensor:
        """Head-prime every channel of a ratio group from its [G, c_len]
        prefix rows: the group's resampler carry on the device."""
        return polyphase.init_resampler_carry(
            self._rs_chains[gid].plan, prefixes.shape[0], device=self.device,
            prefix=torch.from_numpy(np.ascontiguousarray(prefixes)))

    def _exact_polarity(self, pcm: np.ndarray) -> list:
        """Per channel, its PCM row of ``pcm`` [C, K], inverted (saturating)
        where the channel says so."""
        return [np.clip(-(a.astype(np.int32)), -32768, 32767).astype(np.int16)
                if spec.invert else a for a, spec in zip(pcm, self.channels)]

    def _exact_dc(self, st: torch.Tensor, i: int, audio: np.ndarray):
        """Channel ``i``'s exact DC blocker (its kernel) over ``audio``,
        carrying ``st`` [1, 3] int32."""
        return dcb.dc_block_exact(
            st, torch.from_numpy(np.ascontiguousarray(audio)[None]).to(
                self.device),
            dcb.make_pole_coeff(self.channels[i].dc_block_pole))[0] \
            .cpu().numpy()

    def _drain_exact(self, x: dict, pcm: np.ndarray, new: list):
        audio = self._exact_polarity(pcm)
        for gid, idxs in self._rs_groups.items():
            rows = np.stack([audio[i] for i in idxs])  # [G, K]
            buf = (np.concatenate([x["g_abuf"][gid], rows], axis=1)
                   if x["g_abuf"][gid].shape[1] else rows)
            rs = self._rs_chains[gid]
            if x["g_rs_st"][gid] is None:
                c_len = rs.plan.carry_len
                if buf.shape[1] < c_len + 1:
                    x["g_abuf"][gid] = buf
                    continue
                x["g_rs_st"][gid] = self._stack_rs_states(gid, buf[:, :c_len])
                buf = buf[:, c_len:]
            n_in = rs.plan.block_in
            chunks = buf.shape[1] // n_in
            if chunks:
                # every whole step of the group's rows in one launch
                with self._trace("engine.drain.resample", "rs_s"):
                    x["g_rs_st"][gid], out = rs.steps(
                        x["g_rs_st"][gid],
                        torch.from_numpy(np.ascontiguousarray(
                            buf[:, :chunks * n_in])).to(self.device))
                    outs = out.cpu().numpy()
                    buf = buf[:, chunks * n_in:]
            else:
                outs = np.zeros((len(idxs), 0), np.int16)
            x["g_abuf"][gid] = buf
            for j, i in enumerate(idxs):
                self._exact_channel_out(x, i, outs[j], new)
        for i in range(len(self.channels)):
            if self._ratio_gid[i] is None:
                self._exact_channel_out(x, i, audio[i], new)

    def _exact_channel_out(self, x: dict, i: int, audio: np.ndarray,
                           new: list):
        """Post-resampler per-channel stages: DC block -> decode/collect."""
        if audio.size == 0:
            return
        if self.channels[i].dc_block:
            audio = self._exact_dc(x["dc_st"][i], i, audio)
        with self._trace(self._decode_spans[i], "decode_s"):
            dec = self._decoders[i]
            if dec is None:
                new[i].append(np.asarray(audio, np.int16))
            else:
                new[i].extend(dec.scan(np.asarray(audio)))

    def _flush_exact(self) -> list:
        x = self._xstream
        if x is None:
            return self._flush_unprimed()
        new = [[] for _ in self.channels]
        # drain the in-flight blocks first and quiesce the worker: the tail
        # legs below touch the resampler and DC state it owns meanwhile
        self._drain_all(x, new)
        if x["buf_len"]:
            buf = (np.concatenate(x["buf"]) if len(x["buf"]) > 1
                   else x["buf"][0])
            q = self.chain.block_quantum
            usable = buf.shape[0] // q * q
            if usable:
                x["st"], pending = self.chain.step_exact_packed_begin(
                    x["st"], self._widen_host(buf[:usable]))
                with self._trace("engine.drain"):
                    self._drain_exact_fir(x, pending, new)
            x["buf"] = []
            x["buf_len"] = 0
        # sub-block_in resampler tails: one shorter step per group, chained
        # through the live carry
        for gid, idxs in self._rs_groups.items():
            rs = self._rs_chains[gid]
            buf = x["g_abuf"][gid]
            st_g = x["g_rs_st"][gid]
            if st_g is None:
                c_len = rs.plan.carry_len
                if buf.shape[1] < c_len + 1:
                    continue
                st_g = self._stack_rs_states(gid, buf[:, :c_len])
                buf = buf[:, c_len:]
            tail_use = buf.shape[1] // rs.plan.d_rep * rs.plan.d_rep
            if not tail_use:
                continue
            outs = rs.tail(st_g, torch.from_numpy(np.ascontiguousarray(
                buf[:, :tail_use])).to(self.device)).cpu().numpy()
            for j, i in enumerate(idxs):
                self._exact_channel_out(x, i, outs[j], new)
        # the stream consumed off-grid residue; a later push must re-prime
        self.stream_reset()
        return new

    # -- streaming checkpoint/resume ----------------------------------------

    def checkpoint_stream(self, path, user_meta: dict | None = None) -> list:
        """Drain the in-flight blocks and save the streaming state to
        ``path`` (.npz): the device carries (channelizer history, resampler
        carries, DC states, prefilter tails) fetched to the host, the host
        gating state and the buffered input. Returns the messages decoded
        while draining.

        Decoder state machines are not saved: :meth:`restore_stream`
        restarts them in SEARCH with a gap on every gated channel, so a
        burst on air across the checkpoint is lost and everything after it
        decodes (the protocols synchronise themselves). The file is written
        to ``path.tmp``, synced, and renamed over ``path``: a crash
        mid-save leaves the previous checkpoint whole. Production tier only,
        as in the JAX package: the bit-exact tier is a parity oracle."""
        if self.chain.exact:
            raise NotImplementedError(
                "checkpoint_stream covers the production streaming engine")
        s = self._stream
        if s is None:
            raise ValueError("no streaming state yet (push something first)")
        new = [[] for _ in self.channels]
        self._drain_all(s, new)
        leaves = []
        arrays = {}

        def save(name, v):
            leaves.append([name, *_leaf_meta(v)])
            arrays[f"state.{name}"] = (v.cpu().numpy()
                                       if isinstance(v, torch.Tensor)
                                       else np.asarray(v, np.int64))

        _map_state(s["st"], save)
        arrays["buf"] = (np.concatenate(s["buf"]) if s["buf"]
                         else np.zeros((0, 2), self._wire_dtype))
        arrays["fetched"] = s["fetched"]
        tail_rows = {}
        for i, tp in s["tail_pcm"].items():
            if tp is not None:
                arrays[f"tailpcm_{i}"] = tp
                tail_rows[str(i)] = True
        meta = {
            "fingerprint": self._stream_fingerprint(),
            "leaves": leaves,
            "lead_drop": {str(k): int(v) for k, v in s["lead_drop"].items()},
            "hot": {str(k): bool(v) for k, v in s["hot"].items()},
            "blocks": s["blocks"],
            "tail_rows": tail_rows,
            "user": user_meta or {},
        }
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return new

    def restore_stream(self, path) -> dict:
        """Rebuild the streaming state from a :meth:`checkpoint_stream`
        file and return the ``user_meta`` it was saved with. The pipeline
        must be configured as the one that wrote it (the fingerprint and
        every saved array's name, shape and dtype are checked against a
        fresh stream's before anything changes: a file that fails leaves
        the current stream, or none, as it was); the file may come from
        either device. Decoders are recreated in SEARCH and every gated
        channel is marked gapped, so its next fetched block splices the
        saved tail and notifies the gap."""
        if self.chain.exact:
            raise NotImplementedError(
                "checkpoint_stream covers the production streaming engine")
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
        if meta["fingerprint"] != self._stream_fingerprint():
            raise ValueError(
                "checkpoint was written by a differently-configured "
                f"pipeline: {meta['fingerprint']} != "
                f"{self._stream_fingerprint()}")
        s = self._new_stream(None)
        want = []
        _map_state(s["st"], lambda n, v: want.append([n, *_leaf_meta(v)]))
        if meta["leaves"] != want:
            raise ValueError(f"checkpoint state {meta['leaves']} does not "
                             f"match this pipeline's {want}")

        def saved(key, shape, dtype):
            arr = arrays.get(key)
            if arr is None:
                raise ValueError(f"checkpoint has no {key!r} array")
            if ((shape is not None and list(arr.shape) != list(shape))
                    or arr.dtype != np.dtype(dtype)):
                raise ValueError(
                    f"checkpoint array {key!r} is {arr.dtype}"
                    f"{list(arr.shape)}, this pipeline's is {np.dtype(dtype)}"
                    f"{list(shape) if shape is not None else ''}")
            return arr

        st_arrays = {name: saved(f"state.{name}", shape, dtype)
                     for name, shape, dtype in want}
        buf = saved("buf", None, self._wire_dtype)
        if buf.ndim != 2 or buf.shape[1] != 2:
            raise ValueError(f"checkpoint buffer is {list(buf.shape)}, not "
                             "[n, 2]")
        fetched = saved("fetched", [len(self.channels)], np.int64)
        tails = {i: (saved(f"tailpcm_{i}", None, np.int16)
                     if meta["tail_rows"].get(str(i)) else None)
                 for i in s["gap"]}

        def load(name, tmpl):
            arr = st_arrays[name]
            if isinstance(tmpl, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(self.device)
            return int(arr)

        s["st"] = _map_state(s["st"], load)
        s["buf"] = [buf] if buf.shape[0] else []
        s["buf_len"] = int(buf.shape[0])
        s["lead_drop"] = {int(k): int(v) for k, v in meta["lead_drop"].items()}
        s["hot"] = dict(meta["hot"])
        s["blocks"] = int(meta["blocks"])
        s["fetched"] = np.array(fetched)
        for i in s["gap"]:
            s["gap"][i] = True
            s["tail_pcm"][i] = tails[i]
        # everything read and checked: swap the new stream in
        self.stream_reset()
        self._stream = s
        if self.drain_async:
            self._start_drain_worker(s, self._drain)
        # the state machines were not saved: recreate them, so they do
        # restart in SEARCH (notify_gap is only valid there)
        for i, spec in enumerate(self.channels):
            if self._decoders[i] is not None:
                self._decoders[i] = _make_decoder(
                    spec.protocol, spec.center_freq_hz, self._ais_packet_hook)
        return meta.get("user", {})

    def _stream_fingerprint(self) -> str:
        """Every constant that changes what the saved carries mean: restored
        under another filter, gain, rate or pole they would decode wrongly
        with no error. The JAX package's fields, with ``engine=torch`` in
        place of its ``backend=``, so its checkpoints are refused here."""
        taps_crc = zlib.crc32(self._fp_taps.tobytes())
        return (
            f"bs={self.block_size};engine=torch;"
            f"fc={self._fp_center};fs={self.chain.sample_rate:.6f};"
            f"decim={self.chain.decimation};taps={taps_crc:08x};"
            + (f"wire={self.wire_fmt};" if self.wire_fmt != "cs16" else "")
            + ";".join(
                f"{c.center_freq_hz}:{c.protocol}:{int(c.invert)}:"
                f"{int(c.dc_block)}:{c.dc_block_pole!r}:{c.db_gain!r}"
                for c in self.channels)
        )

    # -- whole-capture API ---------------------------------------------------

    def process_capture(self, iq, *, device_decode: bool = True):
        """Run a whole capture. Returns a list (one entry per channel) of
        decoded message lists, or the raw int16 PCM for ``pcm`` channels.

        The production tier with ``device_decode`` (the default) streams it
        through :meth:`push`/:meth:`flush`. ``device_decode=False``, and
        the bit-exact tier always, take the stage-by-stage path
        (:meth:`_process_capture_host`), the oracle for the streaming
        engine, as in the JAX package."""
        if device_decode and not self.chain.exact:
            self.stream_reset()
            results = self.push(iq)
            for i, part in enumerate(self.flush()):
                results[i].extend(part)
            for i, spec in enumerate(self.channels):
                if spec.protocol == "pcm":
                    results[i] = (np.concatenate(results[i]) if results[i]
                                  else np.zeros(0, np.int16))
            return results
        return self._process_capture_host(iq, device_decode=device_decode)

    def _host_resampler(self, gid) -> ResamplerChain:
        """Ratio group ``gid``'s :class:`ResamplerChain` on the pipeline's
        tier (the exact engine's own, or made at first use)."""
        if gid not in self._rs_chains:
            self._rs_chains[gid] = ResamplerChain(
                self._rs_coeffs[gid], gid[0], gid[1],
                exact=self.chain.exact, device=self.device)
        return self._rs_chains[gid]

    def _process_capture_host(self, iq, *, device_decode: bool = False):
        """Stage by stage over the whole capture: the channelizer's
        ``process_array``, polarity, each channel's
        ``ResamplerChain.process_array``, the exact DC blocker (its kernel
        on the card), the decoders. ``device_decode`` keeps the arrays on
        the device between the stages (``process_array_device``); without
        it they are host arrays between them."""
        if self.wire_fmt != "cs16":
            iq = self._widen_host(self._coerce_wire(iq))
        iq = np.asarray(iq, np.int16)
        if device_decode:
            pcm = self.chain.process_array_device(iq)
        else:
            pcm = torch.from_numpy(self.chain.process_array(iq))
        results = []
        for i, spec in enumerate(self.channels):
            audio = pcm[i]
            if spec.invert:
                audio = torch.clamp(-audio.to(torch.int32), -32768,
                                    32767).to(torch.int16)
            gid = self._ratio_gid[i]
            if gid is not None:
                rs = self._host_resampler(gid)
                audio = (rs.process_array_device(audio) if device_decode
                         else torch.from_numpy(rs.process_array(audio)))
            if spec.dc_block:
                # the production tier's float samples enter truncated
                # toward zero (the JAX host path's astype)
                audio = dcb.dc_block_exact(
                    torch.zeros((1, 3), dtype=torch.int32,
                                device=self.device),
                    to_int16(audio).to(self.device).contiguous()[None],
                    dcb.make_pole_coeff(spec.dc_block_pole))[0]
            audio = audio.cpu().numpy()
            dec = self._decoders[i]
            results.append(audio.astype(np.int16) if dec is None
                           else dec.scan(audio))
        return results
