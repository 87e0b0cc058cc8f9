"""Plans and stream state, to and from the JAX package's.

The port's plan tuples have the JAX plans' fields. A ``ResamplerChain``'s
state is the JAX ``ResamplerChainState(resampler=ResamplerState(carry),
dc=DcBlockerState(x_prev, y_prev, acc))`` with the carry as a tensor in
place of the ``ResamplerState``. The pipeline's stream state mirrors the JAX
pipeline's ``s["st"]`` tree on the XLA tier:

    {"chain": MultifmFastState(carry_vals, prev_r, prev_i, out_index),
     "rs":    {ratio: carry [G, carry_len] int16},
     "dc":    {channel: DcBlockerState(x_prev, y_prev, acc)},
     "tails": {protocol: [G, tail] uint8 prefilter bits}}

so a JAX pipeline's state converts one to one into the port's and back, and
both pipelines can start from the same mid-stream state. The bit-exact
tier's ``ExactPackedState(carry, rot, fm_last)`` converts the same way
(the rotator stays a host array in both packages), and so does the
Costas chain's ``CostasChainState(carry_vals, out_index, costas=
CostasState(last_phase, f_dev))``. The JAX side's
leaves are read through ``np.asarray`` and its tuple types come from the
caller (the JAX plan class, or a JAX state tree used as a template), so this
module never imports the JAX package's jax modules.
"""

from __future__ import annotations

import numpy as np
import torch

from tsl_sdr_tpu_torch.models.channelizer import (ExactPackedState,
                                                   MultifmFastState)
from tsl_sdr_tpu_torch.models.costas_channel import CostasChainState
from tsl_sdr_tpu_torch.models.resampler import ResamplerChainState
from tsl_sdr_tpu_torch.ops.costas import CostasState
from tsl_sdr_tpu_torch.ops.dc_blocker import DcBlockerState
from tsl_sdr_tpu_torch.ops.packed_fir import GroupedFirPlan, PackedFirPlan
from tsl_sdr_tpu_torch.ops.polyphase import ResamplerPlan

_PLANS = {"PackedFirPlan": PackedFirPlan, "GroupedFirPlan": GroupedFirPlan,
          "ResamplerPlan": ResamplerPlan}


def _np_field(v):
    if v is None or isinstance(v, (int, float, np.integer)):
        return v
    if isinstance(v, tuple):
        return tuple(np.asarray(x) for x in v)
    return np.asarray(v)


def plan_from_jax(plan):
    """A JAX ``PackedFirPlan``, ``GroupedFirPlan`` or ``ResamplerPlan`` ->
    the port's."""
    cls = _PLANS[type(plan).__name__]
    return cls(**{f: _np_field(getattr(plan, f)) for f in cls._fields})


def plan_to_jax(plan, jax_type):
    """The port's plan -> ``jax_type`` (the JAX package's plan class)."""
    return jax_type(**{f: getattr(plan, f) for f in jax_type._fields})


def _t(v, device, dtype=None) -> torch.Tensor:
    a = np.array(v, dtype=dtype)  # a copy: the port updates some in place
    return torch.from_numpy(a).to(device)


def stream_state_from_jax(st: dict, *, device="cpu") -> dict:
    """The JAX pipeline's ``s["st"]`` tree -> the port's, on ``device``."""
    ch = st["chain"]
    return {
        "chain": MultifmFastState(
            carry_vals=_t(ch.carry_vals, device, np.int16),
            prev_r=_t(ch.prev_r, device, np.float32),
            prev_i=_t(ch.prev_i, device, np.float32),
            out_index=int(np.asarray(ch.out_index))),
        "rs": {gid: _t(v.carry, device, np.int16)
               for gid, v in st["rs"].items()},
        "dc": {i: DcBlockerState(*(_t(x, device, np.int32) for x in v))
               for i, v in st["dc"].items()},
        "tails": {p: _t(v, device, np.uint8) for p, v in st["tails"].items()},
    }


def stream_state_to_jax(st: dict, like: dict) -> dict:
    """The port's state -> a JAX ``s["st"]`` tree of numpy leaves, with the
    tuple types of ``like`` (a JAX pipeline state of the same config)."""
    def n(t):
        return t.detach().cpu().numpy().copy()

    ch = st["chain"]
    rs_type = type(next(iter(like["rs"].values()))) if like["rs"] else None
    dc_type = type(next(iter(like["dc"].values()))) if like["dc"] else None
    return {
        "chain": type(like["chain"])(
            carry_vals=n(ch.carry_vals), prev_r=n(ch.prev_r),
            prev_i=n(ch.prev_i), out_index=np.int32(ch.out_index)),
        "rs": {gid: rs_type(carry=n(v)) for gid, v in st["rs"].items()},
        "dc": {i: dc_type(*(n(x) for x in v)) for i, v in st["dc"].items()},
        "tails": {p: n(v) for p, v in st["tails"].items()},
    }


def chain_state_from_jax(st, *, device="cpu") -> ResamplerChainState:
    """A JAX ``ResamplerChainState`` -> the port's, on ``device``."""
    return ResamplerChainState(
        resampler=_t(st.resampler.carry, device, np.int16),
        dc=DcBlockerState(*(_t(x, device, np.int32) for x in st.dc)))


def chain_state_to_jax(st: ResamplerChainState, like):
    """The port's chain state -> a JAX ``ResamplerChainState`` of numpy
    leaves, with the tuple types of ``like`` (a JAX chain state)."""
    def n(t):
        return t.detach().cpu().numpy().copy()

    return type(like)(
        resampler=type(like.resampler)(carry=n(st.resampler)),
        dc=type(like.dc)(*(n(x) for x in st.dc)))


def exact_state_from_jax(st, *, device="cpu") -> ExactPackedState:
    """A JAX ``ExactPackedState`` (between steps) -> the port's, on
    ``device``."""
    return ExactPackedState(
        carry=_t(st.carry, device, np.int16),
        rot=np.array(st.rot, dtype=np.int16),
        fm_last=_t(st.fm_last, device, np.int32))


def exact_state_to_jax(st: ExactPackedState, like):
    """The port's exact state -> a JAX ``ExactPackedState`` of numpy
    leaves, with the tuple type of ``like`` (a JAX exact state)."""
    return type(like)(carry=st.carry.detach().cpu().numpy().copy(),
                      rot=np.array(st.rot, dtype=np.int16),
                      fm_last=st.fm_last.detach().cpu().numpy().copy())


def costas_state_from_jax(st, *, device="cpu") -> CostasChainState:
    """A JAX ``CostasChainState`` (carry int16, ``out_index`` int32,
    ``last_phase``/``f_dev`` float32 ``[C]``) -> the port's, on
    ``device``."""
    return CostasChainState(
        carry_vals=_t(st.carry_vals, device, np.int16),
        out_index=int(np.asarray(st.out_index)),
        costas=CostasState(last_phase=_t(st.costas.last_phase, device,
                                         np.float32),
                           f_dev=_t(st.costas.f_dev, device, np.float32)))


def costas_state_to_jax(st: CostasChainState, like):
    """The port's Costas chain state -> a JAX ``CostasChainState`` of numpy
    leaves, with the tuple types of ``like`` (a JAX chain state)."""
    def n(t):
        return t.detach().cpu().numpy().copy()

    return type(like)(
        carry_vals=n(st.carry_vals), out_index=np.int32(st.out_index),
        costas=type(like.costas)(last_phase=n(st.costas.last_phase),
                                 f_dev=n(st.costas.f_dev)))
