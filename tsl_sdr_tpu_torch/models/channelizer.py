"""multifm: the N-channel NBFM channelizer, both tiers.

Port of ``tsl_sdr_tpu/models/channelizer.py``: one wideband IQ stream in;
per channel a complex-bandpass FIR + decimate, derotation and an FM
discriminator; 16-bit PCM out (reference ``multifm/demod.c:49-121``).

* ``exact=False``, the production tier: every block is one call of
  :func:`tsl_sdr_tpu_torch.ops.chain.chain_fm`, kernel K1 on the card (the
  packed FIR fused with the oscillator-free discriminator).
* ``exact=True``, the bit-exact tier (the JAX package's packed exact tier):
  the packed FIR's int32 sums, rounded Q.28 -> Q.14, from kernel K5
  (:func:`tsl_sdr_tpu_torch.ops.exact_fir.exact_fir`); the reference's
  serial Q.14 rotator, precomputed on the host by the native helper and
  uploaded (4.18 MB a block at the pager width); then derotation, rounding
  and the LUT discriminator in one launch, kernel K9
  (:func:`tsl_sdr_tpu_torch.ops.fm.exact_fm`). Its PCM is the reference
  C's, byte for byte.

As in the JAX package the chain defaults to ``exact=True``. Unlike it, the
port runs the exact tier's derotation and discriminator on the device in
the dispatch half of a step, so the FM carry advances there (in dispatch
order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import fm, packed_fir, q14
from tsl_sdr_tpu_torch.ops.chain import ChainTaps, chain_fm, widen_rtl_u8
from tsl_sdr_tpu_torch.ops.exact_fir import exact_fir
from tsl_sdr_tpu_torch.runtime.native import rotator_seq
from tsl_sdr_tpu_torch.utils.iq import WIRE_DTYPES

class MultifmFastState(NamedTuple):
    """Streaming state, field for field the JAX XLA tier's."""

    carry_vals: torch.Tensor  # [cr*ROW] int16 interleaved history
    prev_r: torch.Tensor      # [C] float32 last baseband output (re)
    prev_i: torch.Tensor      # [C] float32 last baseband output (im)
    out_index: int            # absolute output index


class ExactPackedState(NamedTuple):
    """Streaming state of the bit-exact tier (the JAX package's fields)."""

    carry: torch.Tensor       # [cr*ROW] int16 packed input history (device)
    rot: np.ndarray           # [C, 2] int16 current rotator values (host)
    fm_last: torch.Tensor     # [C, 2] int32 last channelized sample (device)


def widen_wire(vals: torch.Tensor, wire_fmt: str) -> torch.Tensor:
    """Raw wire values -> int16 IQ values, on the device. An 8-bit block
    ships 2 B/sample instead of int16's 4 and widens here, bit-identical to
    the host rules in ``utils.iq.widen_iq_bytes`` (reference
    ``multifm/rtl_sdr_if.c:118-147``, ``file_if.c:85-157``).

    The production tier's K1 reads rtl_u8 blocks itself in its tile body
    (:meth:`ChainTaps.reads_wire`), so this serves the blocks K1 does not
    read as they are: the bank body's (wide banks) and the other 8-bit
    wires', the bit-exact tier's, and the int16 carry taken from a
    block's tail."""
    if wire_fmt == "cs16":
        return vals
    if wire_fmt == "cs8":
        return vals.to(torch.int16)
    if wire_fmt in ("cu8", "cu8_unbiased"):
        return vals.to(torch.int16) - 127
    if wire_fmt == "rtl_u8":
        return widen_rtl_u8(vals)
    raise ValueError(f"unknown wire_fmt {wire_fmt!r}")


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and an
    asynchronous copy on the card, the array itself on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def capture_blocks(iq, block_size: int, quantum: int, carry_len: int):
    """(prefix or None, blocks): an [n, 2] int16 capture cut as the JAX
    package cuts it — the first ``carry_len`` samples as the prefix, full
    ``block_size`` blocks, then the sub-block tail as one shorter block;
    only the residue below one ``quantum`` falls off."""
    iq = np.asarray(iq, dtype=np.int16)
    usable = (iq.shape[0] - carry_len) // quantum * quantum
    if usable <= 0:
        raise ValueError("capture shorter than one block quantum")
    block_size = min(block_size - block_size % quantum, usable)
    if block_size <= 0:
        block_size = usable
    n_blocks = usable // block_size
    bounds = [carry_len + j * block_size for j in range(n_blocks + 1)]
    if usable > n_blocks * block_size:
        bounds.append(carry_len + usable)
    blocks = [iq[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    return (iq[:carry_len] if carry_len else None), blocks


def step_raw(taps: ChainTaps, state: MultifmFastState, block: torch.Tensor,
             wire_fmt: str = "cs16"):
    """One production-tier block through K1 (:func:`chain_fm`) with the
    constants ``taps``: (state, flat interleaved block [2N] of
    ``wire_fmt`` values) -> (state, pcm [rows, opr*C] int16 in flat (k, c)
    order), for a wire K1 reads (``taps.reads_wire``; widen any other
    first, :func:`widen_wire`); the int16 carry is the widened tail."""
    block = block.reshape(-1)
    prev = torch.stack([state.prev_r, state.prev_i])
    pcm, prev2 = chain_fm(taps, state.carry_vals, prev, block, wire_fmt)
    n = taps.plan.carry_vals
    tail = widen_wire(block[max(0, block.numel() - n):], wire_fmt)
    carry = packed_fir.next_carry(state.carry_vals, tail, n)
    return MultifmFastState(
        carry_vals=carry, prev_r=prev2[0], prev_i=prev2[1],
        out_index=state.out_index + pcm.numel() // taps.plan.nr_channels,
    ), pcm


class HostCopy:
    """A device->host copy started now and waited for at :meth:`numpy`:
    into pinned memory with ``non_blocking=True`` and a CUDA event on the
    card, the tensor itself on the CPU. On the card the copy runs on
    ``stream`` (default: the current one), which must be the stream ``t``
    was made on: the caching allocator may hand ``t``'s memory out again
    once it is freed, ordered only against that stream."""

    def __init__(self, t: torch.Tensor, stream=None):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(stream):
                self._host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = t.contiguous()
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class MultifmChain:
    """Channelize + FM-demodulate a wideband IQ stream.

    Parameters
    ----------
    lpf_taps : baseband LPF (float, unity DC gain) shared by all channels
    offsets_hz : per-channel offsets from the capture center frequency
    sample_rate : wideband input sample rate (Hz)
    decimation : input->channel decimation factor
    gains : optional per-channel linear gains
    exact : bit-exact integer tier (True, the default, as in the JAX
        package) or production tier (False)
    backend : the JAX package's choice of production form ("auto", "xla",
        "pallas", "pallas-high"), accepted and ignored: the production tier
        has one form here, K1, whose int32 sums are the JAX XLA tier's and
        whose discriminator is the Pallas kernel's. Any other value raises
        ``ValueError``, as in the JAX package.
    exact_tier : the bit-exact tier's form: "packed" (the default and the
        only one ported). The JAX package's "scan", its readable
        ``lax.scan`` oracle, raises ``ValueError`` naming it.
    device : torch device the state and the taps live on
    """

    def __init__(self, lpf_taps, offsets_hz, sample_rate: float,
                 decimation: int, gains=None, *, exact: bool = True,
                 backend: str = "auto", exact_tier: str = "packed",
                 device="cuda"):
        if exact_tier == "scan":
            raise ValueError(
                "exact_tier='scan' is the JAX package's lax.scan oracle "
                "(tsl_sdr_tpu.models.channelizer.MultifmChain with "
                "exact_tier='scan') and is not ported; use "
                "exact_tier='packed'")
        if exact_tier != "packed":
            raise ValueError(f"unknown exact_tier {exact_tier!r}")
        if backend not in ("auto", "xla", "pallas", "pallas-high"):
            raise ValueError(f"unknown backend {backend!r}")
        self.exact_tier = exact_tier
        self.exact = bool(exact)
        self.device = torch.device(device)
        self.packed_plan = packed_fir.make_packed_fir_plan(
            lpf_taps, offsets_hz, sample_rate, decimation, gains)
        self.sample_rate = float(sample_rate)
        self.decimation = int(decimation)
        self._omega_reduced = packed_fir.reduced_omega(self.packed_plan)
        # wide banks take the phase-grouped form of the product (as the
        # JAX package chooses: grouped_fir_worthwhile); K1 and K5 then run
        # each tap tile's non-zero k-steps only
        self.taps = ChainTaps(self.packed_plan, self._omega_reduced,
                              device=self.device)
        self.grouped_plan = self.taps.grouped_plan
        self._omega_i32 = torch.from_numpy(packed_fir.omega_turns_i32(
            self.packed_plan.omega_d)).to(self.device)

    @classmethod
    def from_config(cls, config, *, exact: bool = True, backend: str = "xla",
                    device="cuda"):
        """From a :class:`tsl_sdr_tpu_torch.utils.config.MultifmConfig`
        (``backend`` as in the constructor)."""
        return cls(config.lpf_taps, config.channel_offsets_hz,
                   config.sample_rate_hz, config.decimation_factor,
                   gains=config.channel_gains, exact=exact, backend=backend,
                   device=device)

    @property
    def nr_channels(self) -> int:
        return self.packed_plan.nr_channels

    @property
    def channel_rate(self) -> float:
        return self.sample_rate / self.decimation

    @property
    def carry_len(self) -> int:
        """Stream-prefix length (samples)."""
        return self.packed_plan.carry_len

    @property
    def block_quantum(self) -> int:
        """Step block lengths must be a multiple of this many samples."""
        return self.packed_plan.block_quantum

    # -- streaming API ------------------------------------------------------

    def init_state(self, prefix=None):
        if self.exact:
            return self.init_exact_packed_state(prefix)
        c = self.nr_channels
        z = torch.zeros(c, dtype=torch.float32, device=self.device)
        return MultifmFastState(
            carry_vals=packed_fir.init_packed_carry(
                self.packed_plan, prefix, device=self.device),
            prev_r=z, prev_i=z.clone(), out_index=0)

    def init_exact_packed_state(self, prefix=None) -> ExactPackedState:
        c = self.nr_channels
        rot0 = np.zeros((c, 2), np.int16)
        rot0[:, 0] = q14.Q14_ONE   # direct_fir_init: rot_phase = 1<<14, 0
        return ExactPackedState(
            carry=packed_fir.init_packed_carry(self.packed_plan, prefix,
                                               device=self.device),
            rot=rot0,
            fm_last=torch.zeros((c, 2), dtype=torch.int32,
                                device=self.device))

    def _block_values(self, block, wire_fmt: str) -> torch.Tensor:
        """A host or device block of wire values -> flat int16 IQ values on
        the device (8-bit wire formats widen there)."""
        if isinstance(block, torch.Tensor):
            vals = block.reshape(-1).to(self.device)
        else:
            vals = upload(np.asarray(block, WIRE_DTYPES[wire_fmt])
                           .reshape(-1), self.device)
        return widen_wire(vals, wire_fmt)

    def step_exact_packed_begin(self, state: ExactPackedState, block,
                                wire_fmt: str = "cs16"):
        """Dispatch half of the bit-exact step: K5 on the block, the host
        rotator's next ``k`` values uploaded, then derotation, Q.14
        rounding and the LUT discriminator on the device, and the PCM's
        device->host copy started. Returns ``(state2, pending)``; ``state2``
        threads the carry, the rotator and the FM carry to the next begin
        at once (no device sync), so several blocks may be in flight; each
        ``pending`` is finished by :meth:`step_exact_packed_end`."""
        vals = self._block_values(block, wire_fmt)
        a_re, a_im = exact_fir(self.taps, state.carry, vals, "q14")
        carry = packed_fir.next_carry(state.carry, vals,
                                      self.packed_plan.carry_vals)
        c = self.nr_channels
        k = a_re.numel() // c
        # the rotator before each of the k outputs; ``rot`` ends as the
        # state after them (the reference advances once per decimated
        # output and never renormalises, filter/direct_fir.c:152-172)
        rot = state.rot.copy()
        seq = upload(rotator_seq(rot, self.packed_plan.rot_incr_i32, k),
                     self.device)
        pcm, ch, fm_last = fm.exact_fm(a_re.reshape(k, c), a_im.reshape(k, c),
                                       seq, state.fm_last)
        pending = (HostCopy(pcm), ch)
        return ExactPackedState(carry=carry, rot=rot, fm_last=fm_last), \
            pending

    def step_exact_packed_end(self, pending, want_ch: bool = False):
        """Finish one dispatched block: wait for its PCM on the host.
        Returns pcm [C, K] int16 (and the channelized IQ [K, C, 2] int16
        when ``want_ch``)."""
        copy, ch = pending
        pcm = copy.numpy()
        if want_ch:
            return pcm, ch.cpu().numpy()
        return pcm

    def step_exact_packed(self, state: ExactPackedState, block):
        """(state, block [N, 2] | [2N] int16) -> (state, pcm [C, K] int16):
        the streaming bit-exact tier."""
        state, pending = self.step_exact_packed_begin(state, block)
        return state, self.step_exact_packed_end(pending)

    def _step_raw(self, state: MultifmFastState, block: torch.Tensor):
        """(state, flat interleaved int16 block [2N]) -> (state, pcm
        [rows, opr*C] int16 in flat (k, c) order)."""
        return step_raw(self.taps, state, block)

    def step(self, state, block):
        """(state, block [N, 2] int16) -> (state, pcm [C, N//D] int16): a
        host array on the exact tier, a device tensor on the production
        tier."""
        if self.exact:
            return self.step_exact_packed(state, block)
        new_state, pcm = self._step_raw(
            state, self._block_values(block, "cs16"))
        return new_state, pcm.reshape(-1, self.nr_channels).T

    def step_debug(self, state, block):
        """Like :meth:`step` but also returns the channelized IQ, the
        reference's ``signalDebugFile`` tap (``multifm/demod.c:75-82``).
        Returns (state, pcm [C, K] int16, iq [C, K, 2] int16) as host
        arrays. The production tier takes the baseband from K5's raw
        epilogue (K1 never writes it), runs the plain discriminator on it
        (the same PCM as K1's) and rotates it with the integer NCO into
        sample units (K10, :func:`packed_fir.nco_derotate`)."""
        if self.exact:
            state, pending = self.step_exact_packed_begin(state, block)
            pcm, ch = self.step_exact_packed_end(pending, want_ch=True)
            return state, pcm, np.moveaxis(ch, 1, 0)
        c = self.nr_channels
        vals = self._block_values(block, "cs16")
        raw = exact_fir(self.taps, state.carry_vals, vals, "raw")
        p = raw.to(torch.float32)
        half = self.packed_plan.halfcols
        ar, ai = p[:, :half], p[:, half:]
        pcm, pr, pi_ = fm.fm_from_baseband(ar, ai, state.prev_r, state.prev_i,
                                           self.taps.omega_c)
        # the accumulators carry the Q.14 tap scale; the reference dumps
        # the baseband rounded to sample units
        iq = packed_fir.nco_derotate(raw, self._omega_i32, state.out_index,
                                     "int16").transpose(0, 1)
        new_state = MultifmFastState(
            carry_vals=packed_fir.next_carry(state.carry_vals, vals,
                                             self.packed_plan.carry_vals),
            prev_r=pr, prev_i=pi_, out_index=state.out_index + ar.numel() // c)
        return (new_state, pcm.reshape(-1, c).T.cpu().numpy(),
                iq.cpu().numpy())

    # -- whole-array API ----------------------------------------------------

    def _blocks(self, iq, block_size: int):
        return capture_blocks(iq, block_size, self.block_quantum,
                              self.carry_len)

    def process_array_exact_packed(self, iq, block_size: int = 4_194_304):
        """Bit-exact capture processing: pcm [C, K_total] int16, the same
        output as the JAX package's ``process_array_exact_packed`` (its FIR
        blocks, one rotator sequence and one discriminator pass over the
        capture: the carries threaded here make them the same)."""
        prefix, blocks = self._blocks(iq, block_size)
        state = self.init_exact_packed_state(prefix)
        parts = []
        for blk in blocks:
            state, pending = self.step_exact_packed_begin(state, blk)
            parts.append(pending)
        return np.concatenate([self.step_exact_packed_end(p) for p in parts],
                              axis=1)

    def process_array_device(self, iq, block_size: int = 4_194_304):
        """Like :meth:`process_array` but returns pcm [C, K_total] on the
        chain's device."""
        return self.process_array(iq, block_size=block_size, _device=True)

    def process_array(self, iq, block_size: int = 4_194_304, _device=False):
        """Process a whole in-memory capture. Returns pcm [C, K_total]
        int16."""
        if self.exact:
            pcm = self.process_array_exact_packed(iq, block_size=block_size)
            return torch.from_numpy(pcm).to(self.device) if _device else pcm
        prefix, blocks = self._blocks(iq, block_size)
        state = self.init_state(prefix=prefix)
        parts = []
        for blk in blocks:
            state, pcm = self._step_raw(state, self._block_values(blk, "cs16"))
            parts.append(pcm)
        pcm = torch.cat(parts).reshape(-1, self.nr_channels).T
        return pcm if _device else pcm.cpu().numpy()
