"""The egress gate (kernel K7) behind one function on tensors.

:func:`egress_gate` takes one pack group's rows for a block and does what
the JAX package's block program does after the DC blocker
(``tsl_sdr_tpu/models/pipeline.py:219-262``): the sign slice, the
sync-candidate prefilter of :mod:`tsl_sdr_tpu_torch.ops.sync_prefilter`
over ``[carried tail | new bits]``, the new tail, and the group's one
output buffer, the unit of its device->host copy:

* ``"pocsag"`` (``pcm < 0``) and ``"ais"`` (``pcm > 0``): uint8 ``[G, 1 +
  T/8 + ceil(K/8)]``, ``[flag | packbits(new tail) | packbits(bits)]``;
* ``"flex"`` (``to_int16(pcm) >= 0``): int16 ``[G, 1 + min(K, T) + K]``,
  ``[flag | last T pcm | pcm]`` (the decoder needs amplitudes; the gate
  decides whether they are fetched).

Float rows are truncated before the sign test, as the host oracle and the
reference slice int16 PCM. On a CUDA tensor it launches ``csrc/gate.cu``
(one launch a group, reading the rows through a table of pointers); on a
CPU tensor it runs :func:`egress_gate_plain`, the torch ops the pipeline
ran before, byte for byte the JAX gate.
"""

from __future__ import annotations

import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import sync_prefilter
from tsl_sdr_tpu_torch.ops.q14 import to_int16

MODES = {"pocsag": 0, "ais": 1, "flex": 2}
MAX_ROWS = 128   # rows a launch (kRows in gate.cu)
# the first register position of each mode's tests, relative to the tail's
# end, less its reach back (the plain version's ValueError)
_REACH = {"pocsag": max(31 * spb + max(1, spb // 4) + 1
                        for spb in sync_prefilter.POCSAG_SPBS),
          "ais": 31 * sync_prefilter.AIS_DECIM + sync_prefilter.AIS_DECIM - 1,
          "flex": 31 * sync_prefilter.FLEX_SPB}
_scratch: dict = {}


def _scratch_for(device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 ticket and flag words for ``n`` rows, one buffer a
    (device, stream); the kernel leaves them zero for the next launch on
    the stream."""
    key = (str(device), stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < 2 * n:
        buf = torch.zeros(2 * max(n, MAX_ROWS), dtype=torch.int32,
                          device=device)
        _scratch[key] = buf
    return buf


def egress_gate(mode: str, rows, tail: torch.Tensor):
    """``rows``: the group's ``G`` rows, ``[K]`` int16 or float32 tensors
    (any stride); ``tail`` [G, T] uint8 carried bits. Returns (out, new
    tail [G, T] uint8), both new tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, not {mode!r}")
    if tail.device.type == "cpu":
        return egress_gate_plain(mode, rows, tail)
    if tail.device.type != "cuda":
        raise ValueError(f"egress_gate runs on cuda or cpu, not "
                         f"{tail.device}")
    g = len(rows)
    t = tail.shape[1] if tail.dim() == 2 else -1
    if tail.dtype != torch.uint8 or tail.shape != (g, t):
        raise ValueError(f"tail: expected uint8[{g}, T], got "
                         f"{tail.dtype}{list(tail.shape)}")
    if not tail.is_contiguous():
        raise ValueError("tail must be contiguous")
    if mode != "flex" and t % 8:
        raise ValueError(f"a {mode} tail of {t} bits is not whole bytes")
    if t < _REACH[mode]:
        raise ValueError(f"a {mode} tail of {t} bits is shorter than its "
                         f"registers' reach {_REACH[mode]}")
    k, ptrs, strides, f32 = build.row_table(rows, tail.device, "egress_gate")
    if g == 0 or k == 0:
        raise ValueError("egress_gate needs at least one row and sample")
    if mode == "flex":
        width = 1 + min(k, t) + k
        out = torch.empty((g, width), dtype=torch.int16, device=tail.device)
    else:
        width = 1 + t // 8 + -(-k // 8)
        out = torch.empty((g, width), dtype=torch.uint8, device=tail.device)
    new_tail = torch.empty_like(tail)
    stream = torch.cuda.current_stream(tail.device).cuda_stream
    scratch = _scratch_for(tail.device, stream, g)
    err = build.load().tsl_egress_gate(
        ptrs, strides, f32, g, k, tail.data_ptr(), t, out.data_ptr(), width,
        new_tail.data_ptr(), scratch.data_ptr(), MODES[mode], stream)
    build.check(err, "tsl_egress_gate")
    egress_gate.launches += -(-g // MAX_ROWS)
    return out, new_tail


egress_gate.launches = 0


def egress_gate_plain(mode: str, rows, tail: torch.Tensor):
    """Plain torch version of :func:`egress_gate` (the JAX gate's ops in
    its order), on any device."""
    rows = torch.stack(list(rows))
    t = tail.shape[1]
    k = rows.shape[1]
    if mode == "flex":
        rows = to_int16(rows)
        predu = (rows >= 0).to(torch.uint8)
        full = torch.cat([tail, predu], dim=1)
        flags = sync_prefilter.flex_any_candidate(full, k)
        return (torch.cat([flags.to(torch.int16)[:, None], rows[:, -t:],
                           rows], dim=1),
                full[:, -t:].contiguous())
    if rows.is_floating_point():
        rows = torch.trunc(rows)
    predu = ((rows > 0) if mode == "ais" else (rows < 0)).to(torch.uint8)
    full = torch.cat([tail, predu], dim=1)
    if mode == "pocsag":
        flags = sync_prefilter.pocsag_any_candidate(full, k)
    else:
        flags = sync_prefilter.ais_any_candidate(full, k)
    new_tail = full[:, -t:].contiguous()
    return (torch.cat([flags.to(torch.uint8)[:, None],
                       sync_prefilter.packbits(new_tail),
                       sync_prefilter.packbits(predu)], dim=1),
            new_tail)
