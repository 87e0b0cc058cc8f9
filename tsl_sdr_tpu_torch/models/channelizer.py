"""multifm: the N-channel NBFM channelizer, production tier.

Port of ``tsl_sdr_tpu/models/channelizer.py:42-48, 60-200, 327-375``: one
wideband IQ stream in; per channel a complex-bandpass FIR + decimate, then
the oscillator-free FM discriminator; 16-bit PCM out. Every block runs as
one call of :func:`tsl_sdr_tpu_torch.ops.chain.chain_fm` — kernel K1 on the
card. The bit-exact tier (``exact=True``) stays with the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import packed_fir
from tsl_sdr_tpu_torch.ops.chain import ChainTaps, chain_fm


class MultifmFastState(NamedTuple):
    """Streaming state, field for field the JAX XLA tier's."""

    carry_vals: torch.Tensor  # [cr*ROW] int16 interleaved history
    prev_r: torch.Tensor      # [C] float32 last baseband output (re)
    prev_i: torch.Tensor      # [C] float32 last baseband output (im)
    out_index: int            # absolute output index


class MultifmChain:
    """Channelize + FM-demodulate a wideband IQ stream.

    Parameters
    ----------
    lpf_taps : baseband LPF (float, unity DC gain) shared by all channels
    offsets_hz : per-channel offsets from the capture center frequency
    sample_rate : wideband input sample rate (Hz)
    decimation : input->channel decimation factor
    gains : optional per-channel linear gains
    exact : the bit-exact tier is not ported; must be False
    device : torch device the state and the taps live on
    """

    def __init__(self, lpf_taps, offsets_hz, sample_rate: float,
                 decimation: int, gains=None, *, exact: bool = False,
                 device="cuda"):
        if exact:
            raise NotImplementedError(
                "the bit-exact tier is not yet ported to tsl_sdr_tpu_torch")
        self.device = torch.device(device)
        self.packed_plan = packed_fir.make_packed_fir_plan(
            lpf_taps, offsets_hz, sample_rate, decimation, gains)
        self.sample_rate = float(sample_rate)
        self.decimation = int(decimation)
        # per-output derotation increment reduced to (-pi, pi] in float64
        w = self.packed_plan.omega_d.astype(np.float64)
        self._omega_reduced = (
            w - 2 * np.pi * np.round(w / (2 * np.pi))).astype(np.float32)
        self.taps = ChainTaps(self.packed_plan, self._omega_reduced,
                              device=self.device)

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

    def init_state(self, prefix=None) -> MultifmFastState:
        c = self.nr_channels
        z = torch.zeros(c, dtype=torch.float32, device=self.device)
        return MultifmFastState(
            carry_vals=packed_fir.init_packed_carry(
                self.packed_plan, prefix, device=self.device),
            prev_r=z, prev_i=z.clone(), out_index=0)

    def _step_raw(self, state: MultifmFastState, block: torch.Tensor):
        """(state, flat interleaved int16 block [2N]) -> (state, pcm
        [rows, opr*C] int16 in flat (k, c) order)."""
        block = block.reshape(-1)
        prev = torch.stack([state.prev_r, state.prev_i])
        pcm, prev2 = chain_fm(self.taps, state.carry_vals, prev, block)
        carry = packed_fir.next_carry(state.carry_vals, block,
                                      self.packed_plan.carry_vals)
        return MultifmFastState(
            carry_vals=carry, prev_r=prev2[0], prev_i=prev2[1],
            out_index=state.out_index + pcm.numel() // self.nr_channels,
        ), pcm
