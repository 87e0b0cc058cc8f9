"""Coherent (Costas-loop) channelizer: PSK-style channels to rotated IQ.

Port of ``tsl_sdr_tpu/models/costas_channel.py``. The reference builds a
Costas demodulator but never wires it to a config path (its demod thread
instantiates only FM, ``multifm/demod.c:318``); the JAX package made it a
chain of its own, and so does the port: wideband IQ -> the packed channel
FIR bank (kernel K5's raw int32 sums,
:func:`tsl_sdr_tpu_torch.ops.exact_fir.exact_fir`) -> integer-NCO
derotation and scaling (kernel K10,
:func:`tsl_sdr_tpu_torch.ops.packed_fir.nco_derotate`) -> one 2nd-order
Costas loop a channel (kernel K6,
:func:`tsl_sdr_tpu_torch.ops.costas.costas_block_planes`).

Output is phase-locked IQ per channel (int16, Q.14-scaled like the
reference's ``multifm_costas_demod_process`` output).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.models.channelizer import capture_blocks, upload
from tsl_sdr_tpu_torch.ops import costas, packed_fir, q14
from tsl_sdr_tpu_torch.ops.chain import ChainTaps
from tsl_sdr_tpu_torch.ops.exact_fir import exact_fir
from tsl_sdr_tpu_torch.runtime.native import costas_native


class CostasChainState(NamedTuple):
    carry_vals: torch.Tensor      # [cr*ROW] int16 packed FIR history
    out_index: int                # absolute output index (NCO)
    costas: costas.CostasState    # leaves [C]


class CostasChannelizer:
    """Channelize + coherently demodulate N PSK channels.

    The front end is :class:`~tsl_sdr_tpu_torch.models.channelizer.
    MultifmChain`'s (the same plan and K5 operands, grouped for wide banks
    as the JAX package chooses); the back end replaces the FM
    discriminator with per-channel Costas loops. ``device``: where the
    taps, the state and the work live (the card unless the caller asks for
    the CPU, which runs every kernel's plain version).
    """

    def __init__(self, lpf_taps, offsets_hz, sample_rate: float,
                 decimation: int, gains=None, *, alpha: float = 0.05,
                 beta: float = 0.002, e_max_q14: int = 8192,
                 f_shift: float = 0.0, device="cuda"):
        self.device = torch.device(device)
        self.packed_plan = packed_fir.make_packed_fir_plan(
            lpf_taps, offsets_hz, sample_rate, decimation, gains)
        self.taps = ChainTaps(self.packed_plan,
                              packed_fir.reduced_omega(self.packed_plan),
                              device=self.device)
        self.params = costas.make_costas_params(
            f_shift, alpha=alpha, beta=beta, e_max_q14=e_max_q14)
        self.sample_rate = float(sample_rate)
        self.decimation = int(decimation)
        self._omega_i32 = torch.from_numpy(packed_fir.omega_turns_i32(
            self.packed_plan.omega_d)).to(self.device)

    @property
    def nr_channels(self) -> int:
        return self.packed_plan.nr_channels

    @property
    def carry_len(self) -> int:
        return self.packed_plan.carry_len

    @property
    def block_quantum(self) -> int:
        return self.packed_plan.block_quantum

    def init_state(self, prefix=None) -> CostasChainState:
        return CostasChainState(
            carry_vals=packed_fir.init_packed_carry(
                self.packed_plan, prefix, device=self.device),
            out_index=0,
            costas=costas.init_costas_state(self.params, self.nr_channels,
                                            self.device))

    def _values(self, block) -> torch.Tensor:
        """A host array or tensor of int16 IQ -> flat values on the
        chain's device."""
        if isinstance(block, torch.Tensor):
            return block.reshape(-1).to(self.device)
        return upload(np.asarray(block, np.int16).reshape(-1), self.device)

    def _baseband(self, carry_vals, vals, out_index: int, out: str):
        """K5's raw sums of ``carry ++ vals`` derotated by the integer NCO
        from ``out_index`` and scaled, in one launch of K10
        (:func:`packed_fir.nco_derotate`): ``out="planes"``, the loop's
        (yr, yi) ``[K, C]`` float32; ``out="int16"``, the baseband in
        sample units, ``[K, C, 2]`` int16."""
        p = exact_fir(self.taps, carry_vals, vals, "raw")
        return packed_fir.nco_derotate(p, self._omega_i32, out_index, out)

    def step(self, state: CostasChainState, block, *, tier: str = "block"):
        """(state, block [N, 2] int16) -> (state, iq [C, N//D, 2] int16),
        the output a tensor on the chain's device. ``N`` must be a
        multiple of :attr:`block_quantum`.

        ``tier="block"`` is the chunked loop (K6 on the card). The JAX
        package's ``tier="scan"``, its serial ``lax.scan`` oracle, is not
        ported: the JAX package stays the oracle."""
        if tier == "scan":
            raise ValueError(
                "tier='scan' is the JAX package's serial oracle "
                "(tsl_sdr_tpu.ops.costas.costas_step) and is not ported; "
                "use tier='block'")
        if tier != "block":
            raise ValueError(f"tier must be 'block', not {tier!r}")
        vals = self._values(block)
        if vals.numel() % (2 * self.block_quantum):
            raise ValueError(f"block length {vals.numel() // 2} must be a "
                             f"multiple of {self.block_quantum}")
        # the loop's Q.14-normalized units (the JAX package's two scalings)
        yr, yi = self._baseband(state.carry_vals, vals, state.out_index,
                                "planes")
        st2, o_re, o_im = costas.costas_block_planes(
            self.params, state.costas, yr, yi)
        out = q14.to_int16(torch.trunc(torch.stack(
            [o_re.T * 16384.0, o_im.T * 16384.0], dim=-1)))   # [C, K, 2]
        new_state = CostasChainState(
            carry_vals=packed_fir.next_carry(state.carry_vals, vals,
                                             self.packed_plan.carry_vals),
            out_index=state.out_index + yr.shape[0],
            costas=st2)
        return new_state, out

    def process_array_native(self, iq, block_size: int = 4_194_240):
        """Whole-capture path with the native serial PLL: the chain's
        device does the sample-rate work (K5's raw sums, then K10's
        integer-NCO derotation rounded to sample units as int16) block by
        block, then the reference's per-sample loop runs in C a channel
        (:func:`~tsl_sdr_tpu_torch.runtime.native.costas_native`). Returns
        int16 IQ [C, K, 2]."""
        prefix, blocks = capture_blocks(iq, block_size, self.block_quantum,
                                        self.carry_len)
        carry = packed_fir.init_packed_carry(self.packed_plan, prefix,
                                             device=self.device)
        k0 = 0
        parts = []
        for blk in blocks:
            vals = self._values(blk)
            parts.append(self._baseband(carry, vals, k0, "int16"))
            carry = packed_fir.next_carry(carry, vals,
                                          self.packed_plan.carry_vals)
            k0 += parts[-1].shape[0]                           # [K, C, 2]
        rot = torch.cat(parts).cpu().numpy()
        c = self.nr_channels
        out = np.empty((c, rot.shape[0], 2), np.int16)
        for ci in range(c):
            out[ci], _ = costas_native(np.ascontiguousarray(rot[:, ci, :]),
                                       self.params)
        return out
