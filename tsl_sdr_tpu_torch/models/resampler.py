"""Rational resampler chain: polyphase FIR + optional DC blocker.

Port of ``tsl_sdr_tpu/models/resampler.py:26-234``, the model behind the
standalone resampler tool and the decoders' front end (reference
``resampler/resampler.c:204-263``, ``decoder/decoder.c:581-656``): int16 PCM
in at f_in, polyphase-resample by I/D, optionally DC-block, PCM out at
f_in * I / D. Both tiers: ``exact=True`` (int16, bit-identical to the
reference) and ``exact=False`` (float32 sample units; the DC blocker's float
tier then gives int16).

The resampler runs kernel K3 (packed-row plans) or K4 (frame-form plans)
on a CUDA device and their plain versions on the CPU; there is no backend
switch. :meth:`ResamplerChain.process_array` runs a capture's full blocks
in one kernel call and the capture's tail through a tail-sized plan, so its
output equals the JAX ``process_array`` (which scans the blocks).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import dc_blocker, polyphase, q14
from tsl_sdr_tpu_torch.ops.frame_resampler import (frame_resample,
                                                   resample_capture)
from tsl_sdr_tpu_torch.ops.packed_fir import next_carry
from tsl_sdr_tpu_torch.ops.row_resampler import row_resample


class ResamplerChainState(NamedTuple):
    resampler: torch.Tensor          # [carry_len] int16: the input history
    dc: dc_blocker.DcBlockerState


class ResamplerChain:
    def __init__(self, lpf_coeffs, interpolate: int, decimate: int, *,
                 dc_block_pole: float | None = None, block_out: int = 1024,
                 exact: bool = True, device="cuda"):
        """``lpf_coeffs``: float taps (quantized to Q.14 like
        ``resampler/resampler.c:145-151``). ``device``: "cuda" (default)
        or "cpu"; CUDA must be present when asked for."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available")
        self._coeffs_q14 = q14.quantize_q14(lpf_coeffs)
        self.plan = polyphase.make_resampler_plan(
            self._coeffs_q14, interpolate, decimate,
            block_out_target=block_out)
        self.exact = exact
        self.dc_pole = dc_block_pole
        self.dc_coeff = (dc_blocker.make_pole_coeff(dc_block_pole)
                         if dc_block_pole else None)
        # device taps of the main plan and of each tail plan, by block_in
        # (a tail plan's block_in is below the main plan's)
        self._taps = {self.plan.block_in: polyphase.plan_taps(
            self.plan, device=self.device)}
        self._tail_plans = {}

    @property
    def _out(self) -> str:
        return "q14" if self.exact else "f32"

    def init_state(self, prefix=None) -> ResamplerChainState:
        """Prime the carry with the first ``carry_len`` stream samples (or
        zeros)."""
        carry = polyphase.init_resampler_carry(
            self.plan, 1, device=self.device,
            prefix=None if prefix is None else torch.as_tensor(prefix))
        return ResamplerChainState(
            resampler=carry[0],
            dc=dc_blocker.init_dc_blocker_state(device=self.device))

    def _dc_block(self, dc, out: torch.Tensor):
        if self.dc_coeff is None:
            return dc, out
        if self.exact:
            return dc_blocker.dc_blocker_step_exact(dc, out, self.dc_coeff)
        return dc_blocker.dc_blocker_step_fast(dc, q14.to_int16(out),
                                               self.dc_coeff)

    def step(self, state: ResamplerChainState, block: torch.Tensor,
             plan=None):
        """(state, pcm [block_in] int16) -> (state, pcm [block_out]).

        ``plan`` overrides the block geometry (the capture-tail plan);
        taps and phase match, so the carry state chains."""
        plan = self.plan if plan is None else plan
        carry, out = polyphase.resample_step(
            plan, state.resampler[None], block[None],
            self._taps[plan.block_in], exact=self.exact)
        dc, out = self._dc_block(state.dc, out[0])
        return ResamplerChainState(resampler=carry[0], dc=dc), out

    def steps(self, carry: torch.Tensor, block: torch.Tensor):
        """``c`` chained :meth:`step` s of the main plan, without the DC
        blocker, for every channel of a ratio group in one K3 or K4 call:
        carry [G, carry_len] int16, block [G, c * block_in] int16 ->
        (carry, out [G, c * block_out]). The plan's windows tile the input
        (``block_in`` is a whole number of rows, or of frames), so one call
        over ``carry ++ block`` reads what the ``c`` steps read."""
        plan = self.plan
        n = block.shape[1]
        if n == 0 or n % plan.block_in:
            raise ValueError(f"{n} samples per channel is not a whole, "
                             f"nonzero number of {plan.block_in}-sample "
                             "steps")
        taps = self._taps[plan.block_in]
        if plan.k_row:
            out = row_resample(carry, block, taps, row_in=plan.row_in,
                               out=self._out)
        else:
            out = frame_resample(
                carry, block, taps,
                frames=n // plan.block_in * plan.block_out // plan.i_rep,
                out=self._out)
        return (next_carry(carry, block, plan.carry_len),
                out.reshape(block.shape[0], -1))

    def tail(self, carry: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
        """The last, shorter step of a stream, without the DC blocker:
        carry [G, carry_len] int16 (the live carry, or the trailing input
        history), block [G, n] int16 with ``n`` below ``block_in`` and a
        whole number of ``d_rep`` -> out [G, n * I / D]. Its plan has the
        main plan's taps, phase and carry length, so it chains from
        :meth:`steps` bit for bit."""
        tp = self._tail_plan(block.shape[1])
        _, out = polyphase.resample_step(tp, carry, block,
                                         self._taps[tp.block_in],
                                         exact=self.exact)
        return out

    def _tail_plan(self, tail_use: int) -> polyphase.ResamplerPlan:
        """Plan sized for the sub-block_in capture tail (``tail_use`` input
        samples on the d_rep grid). Same taps/phase0 as the main plan, so a
        step chains bit-exactly; align_k_row=False keeps k_out exact."""
        if tail_use not in self._tail_plans:
            p = self.plan
            tp = polyphase.make_resampler_plan(
                self._coeffs_q14, p.interpolation, p.decimation,
                block_out_target=tail_use * p.i_rep // p.d_rep,
                phase0=p.phase0, align_k_row=False)
            if tp.carry_len != p.carry_len:
                raise AssertionError(f"tail plan carries {tp.carry_len}, "
                                     f"the main plan {p.carry_len}")
            self._tail_plans[tail_use] = tp
            self._taps[tp.block_in] = polyphase.plan_taps(
                tp, device=self.device)
        return self._tail_plans[tail_use]

    def _run_blocks(self, pcm: torch.Tensor) -> torch.Tensor:
        """The whole capture: its full blocks in one K3 or K4 call, then
        the tail past them (down to the d_rep grid) through the tail plan,
        then the DC blocker over all of it with its state carried."""
        plan = self.plan
        c_len, n_in, d_rep = plan.carry_len, plan.block_in, plan.d_rep
        usable = pcm.shape[0] - c_len
        n_blocks = usable // n_in
        if n_blocks < 1:
            raise ValueError("stream shorter than one block")
        n_main = n_blocks * n_in
        taps = self._taps[n_in]
        if plan.k_row:
            out = row_resample(pcm[None, :c_len], pcm[None, c_len:c_len
                                                        + n_main],
                               taps, row_in=plan.row_in,
                               out=self._out).reshape(-1)
        else:
            # whole frames covering every full block's windows; zeros past
            # the capture only reach outputs beyond the full blocks
            n_cap = -(-(c_len + n_main) // d_rep) * d_rep
            cap = pcm[:n_cap]
            if cap.shape[0] < n_cap:
                cap = torch.nn.functional.pad(cap, (0, n_cap - cap.shape[0]))
            out = resample_capture(plan, cap, taps, out=self._out)
            out = out[:n_blocks * plan.block_out]
        outs = [out]
        tail_use = (usable - n_main) // d_rep * d_rep
        if tail_use:
            pos = c_len + n_main
            # the carry is pure trailing input history
            outs.append(self.tail(pcm[None, pos - c_len:pos],
                                  pcm[None, pos:pos + tail_use])[0])
        out = torch.cat(outs) if len(outs) > 1 else outs[0]
        if self.dc_coeff is None:
            return out
        dc = dc_blocker.init_dc_blocker_state(device=self.device)
        if self.exact:
            return self._dc_block(dc, out)[1]
        # the float tier block by block, as the JAX scan applies it (its
        # chunked scan's memory grows with the square of the length)
        parts = []
        for lo in range(0, out.shape[0], plan.block_out):
            dc, part = self._dc_block(dc, out[lo:lo + plan.block_out])
            parts.append(part)
        return torch.cat(parts)

    def process_array(self, pcm) -> np.ndarray:
        """Resample a whole in-memory PCM stream; returns int16 (exact tier,
        or any tier with the DC blocker) or float32 (fast tier)."""
        pcm = torch.from_numpy(np.array(pcm, dtype=np.int16))
        return self._run_blocks(pcm.to(self.device)).cpu().numpy()

    def process_array_device(self, pcm: torch.Tensor) -> torch.Tensor:
        """Device-resident variant of :meth:`process_array`: takes and
        returns tensors on the chain's device, no host round-trip."""
        return self._run_blocks(pcm.to(device=self.device,
                                       dtype=torch.int16).contiguous())
