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
(one launch a group, reading the rows through a table of pointers, a CTA
a row and tile of :func:`launch_tile` positions); on a CPU tensor it runs
:func:`egress_gate_plain`, the torch ops the pipeline ran before, byte
for byte the JAX gate.
"""

from __future__ import annotations

from typing import NamedTuple

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
# gate.cu's launch geometry and register specs, the one copy the wrapper,
# the tests' emulation and chip_smoke.py use (a test holds it against
# gate.cu's constants)
TILES = (1024, 2048, 4096, 8192)   # positions a CTA (kMinTile..kMaxTile)
THREADS = 256                      # a CTA's (kThreads)
EARLY = 4   # tile 0 also tests pairs ending this far before t (kEarly)


class Spec(NamedTuple):
    """One register test (gate.cu's kSpecs): a register of 32 bits
    ``spb`` samples apart matches within ``max_ham`` of ``word``, from
    position ``mlo`` relative to t; pairs of matches ``dmin``..``dmax``
    apart flag (``dmax`` 0: a match alone)."""
    spb: int
    word: int
    max_ham: int
    mlo: int
    dmin: int
    dmax: int


_D = sync_prefilter.AIS_DECIM
SPECS = {"pocsag": [Spec(spb, sync_prefilter.POCSAG_SYNC,
                         sync_prefilter.POCSAG_MAX_HAM, -max(1, spb // 4) - 1,
                         max(1, spb // 4), max(1, spb // 4))
                    for spb in sync_prefilter.POCSAG_SPBS],
         "ais": [Spec(_D, sync_prefilter.AIS_PREAMBLE,
                      sync_prefilter.AIS_MAX_HAM, 1 - _D, 1, _D - 1)],
         "flex": [Spec(sync_prefilter.FLEX_SPB, sync_prefilter.FLEX_BS1, 0,
                       0, 0, 0)]}
# the reach back from a tile's first tested position that its window
# holds: the longest pair and register, and AIS's NRZI (kLook*)
LOOK = {mode: max(sp.dmax + 31 * sp.spb for sp in specs)
        + (_D if mode == "ais" else 0) for mode, specs in SPECS.items()}


def launch_tile(mode: str, g: int, k: int, sms: int) -> int:
    """New positions a K7 CTA takes: the largest tile that still gives
    each of the card's ``sms`` SMs two CTAs of the launch's (at most 128)
    rows, and no smaller than 2,048 for POCSAG (whose registers reach
    2,343 positions back) or 1,024 for the others. On an H100 (132 SMs):
    the pager's POCSAG group (6 x 130,560) 2,048, 384 CTAs; its FLEX group
    (2 x 54,400) 1,024, 108; AIS (1 x 163,200) 1,024, 160 (each with one
    more a row for the new tail)."""
    rows = min(g, MAX_ROWS)
    tile = TILES[-1]
    low = 2048 if mode == "pocsag" else TILES[0]
    while tile > low and rows * -(-k // tile) < 2 * sms:
        tile //= 2
    return tile


def launch_run(mode: str, tile: int) -> int:
    """Positions a K7 register run walks after its 31-bit warm-up: the
    shortest of 16, 32, 64 and 128 whose runs over a whole tile (each
    spec's positions in spb residue classes) fit the CTA's threads."""
    run = 16
    while run < 128 and sum(
            sp.spb * -(-(-(-(tile + sp.dmax + 1) // sp.spb)) // run)
            for sp in SPECS[mode]) > THREADS:
        run *= 2
    return run


def egress_gate(mode: str, rows, tail: torch.Tensor):
    """``rows``: the group's ``G`` rows, ``[K]`` int16 or float32 tensors
    (any stride); ``tail`` [G, T] uint8 carried bits. Returns (out, new
    tail [G, T] uint8), both new: on the card, views into one new
    buffer."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, not {mode!r}")
    dev = tail.device
    if dev.type == "cpu":
        return egress_gate_plain(mode, rows, tail)
    if dev.type != "cuda":
        raise ValueError(f"egress_gate runs on cuda or cpu, not {dev}")
    g = len(rows)
    shape = tail.shape
    t = shape[1] if len(shape) == 2 else -1
    if tail.dtype != torch.uint8 or shape != (g, t):
        raise ValueError(f"tail: expected uint8[{g}, T], got "
                         f"{tail.dtype}{list(shape)}")
    if not tail.is_contiguous():
        raise ValueError("tail must be contiguous")
    if mode != "flex" and t % 8:
        raise ValueError(f"a {mode} tail of {t} bits is not whole bytes")
    if t < _REACH[mode]:
        raise ValueError(f"a {mode} tail of {t} bits is shorter than its "
                         f"registers' reach {_REACH[mode]}")
    idx = dev.index
    k, table = build.row_table(rows, idx, "egress_gate")
    if g == 0 or k == 0:
        raise ValueError("egress_gate needs at least one row and sample")
    if mode == "flex":
        width = 1 + min(k, t) + k
        n_out = 2 * g * width
    else:
        width = 1 + t // 8 + -(-k // 8)
        n_out = g * width
    # one allocation: the output buffer, then the new tail
    out, new_tail = torch.empty(n_out + g * t, dtype=torch.uint8,
                                device=dev).split((n_out, g * t))
    if mode == "flex":
        out = out.view(torch.int16)
    out = out.view(g, width)
    new_tail = new_tail.view(g, t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # a 64-bit count of tiles done and tiles that hit, a row
    scratch = build.scratch("egress_gate", idx, stream, 8 * max(g, MAX_ROWS))
    tile = launch_tile(mode, g, k, build.sm_count(idx))
    build.check(build.load().tsl_egress_gate(
        table.buffer_info()[0], g, k, tail.data_ptr(), t, out.data_ptr(),
        width, new_tail.data_ptr(), scratch.data_ptr(), MODES[mode], tile,
        launch_run(mode, tile), stream), "tsl_egress_gate")
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
