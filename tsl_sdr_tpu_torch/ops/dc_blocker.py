"""DC blocker: the exact integer recurrence and the float fast tier.

Port of ``tsl_sdr_tpu/ops/dc_blocker.py:31-93``. The reference recurrence
(``filter/dc_blocker.h:72-93``), all int32,

    acc -= x_prev; x_prev = s << 14; acc += x_prev - p * y_prev;
    y_prev = acc >> 14; out = (int16) y_prev

is serial, and the ``>> 14`` makes it non-associative, so the exact tier
(:func:`dc_blocker_step_exact`, the default of the decoder's and the
resampler's ``-b``) is no torch op: on the card it is the hand kernel
``csrc/dc_blocker.cu``, one warp per stream, which stages the input,
computes ``d_n = (x_n << 14) - (x_{n-1} << 14)`` on all lanes and runs
only ``acc = (acc + d_n) - p * y; y = acc >> 14`` serially; on the CPU a
plain loop (:func:`dc_block_exact_plain`).

The fast tier (:func:`dc_block_fast` over a block's rows of one length,
the pipeline's; :func:`dc_blocker_step_fast` for one row) is the float
form of the recurrence, the first-order IIR

    y[n] = q * y[n-1] + (x[n] - x[n-1]),     q = 1 - p / 2^14

which the JAX package evaluates with ``lax.associative_scan``. On the card
it is kernel K8, ``csrc/dc_fast.cu`` (a single-pass float64 scan over
chunks of 2,048 samples, many CTAs a row, each finding the y entering its
chunk by looking back at its predecessors' published sums). The plain
version (:func:`dc_block_fast_plain`) is a two-level
chunked scan in float64 built from matrix products with non-negative
powers of ``q`` (no growing ``q^-n`` factor can overflow): within chunks of
``L`` samples, ``local = u @ Tq^T`` with ``Tq[i, j] = q^(i-j)``; across
chunks, the chunk-end values go through the same form with ``q^L``. The
two sum in other orders and agree within 1 LSB. Output tracks the exact
integer tier to a few LSB, like the JAX fast tier (the tests hold the two
within 2 LSB).
"""

from __future__ import annotations

import array
from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.ops import q14

_CHUNK = 256
_FAST_ROWS = 64     # rows a K8 launch (kRows in dc_fast.cu)
FAST_CHUNK = 2048   # samples a K8 CTA (kChunk)


class DcBlockerState(NamedTuple):
    x_prev: torch.Tensor  # [] int32, Q.28
    y_prev: torch.Tensor  # [] int32, Q.14
    acc: torch.Tensor     # [] int32, Q.28 (not tracked by the float tier)


def make_pole_coeff(pole: float) -> int:
    """p = (int16)((1.0 - pole) * 2^14) — C truncating cast."""
    return int(np.trunc((1.0 - pole) * q14.Q14_ONE).astype(np.int16))


def init_dc_blocker_state(*, device) -> DcBlockerState:
    def z():
        return torch.zeros((), dtype=torch.int32, device=device)

    return DcBlockerState(x_prev=z(), y_prev=z(), acc=z())


def _decay_matrix(q: torch.Tensor, n: int, device) -> torch.Tensor:
    """[G, n, n] lower-triangular ``q^(i-j)`` for i >= j, else 0, for each
    of the ``G`` poles ``q``."""
    k = torch.arange(n, device=device, dtype=torch.float64)
    e = k[:, None] - k[None, :]
    return torch.where(e >= 0, torch.pow(q[:, None, None], e.clamp(min=0)),
                       torch.zeros((), dtype=torch.float64, device=device))


def dc_blocker_step_fast(state: DcBlockerState, block: torch.Tensor, p: int):
    """block [K] PCM (int16, or float cast as :func:`q14.to_int16`) ->
    (new state, [K] int16): one row of :func:`dc_block_fast`."""
    states, out = dc_block_fast([state], [block], [p])
    return states[0], out[0]


def dc_block_fast(states, rows, coeffs):
    """The fast tier over ``G`` rows of one length (kernel K8): ``states``
    ``G`` :class:`DcBlockerState`, ``rows`` ``G`` ``[K]`` int16 or float32
    tensors (any stride; floats go through :func:`q14.to_int16`), ``coeffs``
    ``G`` pole coefficients ``p``. Returns (``G`` new states, out [G, K]
    int16); a new state's ``x_prev``/``y_prev`` are views into one new
    tensor and its ``acc`` the old state's. On a CUDA tensor it launches
    ``csrc/dc_fast.cu`` (one launch for up to 64 rows); on a CPU tensor it
    runs :func:`dc_block_fast_plain`."""
    dev = rows[0].device if rows else None
    if dev is not None and dev.type == "cpu":
        return dc_block_fast_plain(states, rows, coeffs)
    if dev is None or dev.type != "cuda":
        raise ValueError(f"dc_block_fast runs on cuda or cpu, not {dev}")
    g = len(rows)
    if len(states) != g or len(coeffs) != g:
        raise ValueError(f"{g} rows, {len(states)} states, {len(coeffs)} "
                         f"coefficients")
    idx = dev.index
    k, table = build.row_table(rows, idx, "dc_block_fast")
    if k == 0:
        raise ValueError("dc_block_fast needs at least one sample")
    ptrs = array.array("q")
    for st in states:
        for v in (st.x_prev, st.y_prev):
            if (v.dtype != torch.int32 or v.numel() != 1
                    or v.get_device() != idx):
                raise ValueError(f"state: expected int32 scalars on {dev}, "
                                 f"got {v.dtype}{list(v.shape)} on "
                                 f"{v.device}")
            ptrs.append(v.data_ptr())
    q = array.array("d", (1.0 - p / q14.Q14_ONE for p in coeffs))
    out = torch.empty((g, k), dtype=torch.int16, device=dev)
    st_out = torch.empty((g, 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load()
    nbytes = lib.tsl_dc_block_fast_scratch(k)
    scratch = build.scratch("dc_block_fast", idx, stream, nbytes)
    build.check(lib.tsl_dc_block_fast(
        table.buffer_info()[0], ptrs.buffer_info()[0], q.buffer_info()[0], g,
        k, out.data_ptr(), st_out.data_ptr(), scratch.data_ptr(), nbytes,
        stream), "tsl_dc_block_fast")
    launches = -(-g // _FAST_ROWS)
    dc_block_fast.launches += launches
    xs, ys = st_out.t().unbind()
    return [DcBlockerState(x_prev=x, y_prev=y, acc=st.acc)
            for x, y, st in zip(xs.unbind(), ys.unbind(), states)], out


dc_block_fast.launches = 0


def dc_block_fast_plain(states, rows, coeffs):
    """Plain torch version of :func:`dc_block_fast`, on any device: the
    chunked float64 scan of the module docstring, the rows side by side."""
    dev = rows[0].device
    x = q14.to_int16(torch.stack(list(rows))).to(torch.float64)   # [G, K]
    g, k = x.shape
    q = torch.tensor([1.0 - p / q14.Q14_ONE for p in coeffs],
                     dtype=torch.float64, device=dev)
    x_prev = torch.stack([s.x_prev for s in states]).to(
        torch.float64) / q14.Q14_ONE
    y0 = torch.stack([s.y_prev for s in states]).to(torch.float64)
    u = x - torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    nb = -(-k // _CHUNK)
    u = torch.nn.functional.pad(u, (0, nb * _CHUNK - k)).view(g, nb, _CHUNK)
    local = u @ _decay_matrix(q, _CHUNK, dev).transpose(1, 2)  # [G, nb, L]
    # y at the end of chunk b: c_b = q^L c_{b-1} + local[b, -1], c_{-1} = y0
    ql = q ** _CHUNK
    idx = torch.arange(nb, device=dev, dtype=torch.float64)
    ends = ((_decay_matrix(ql, nb, dev) @ local[:, :, -1:])[..., 0]
            + torch.pow(ql[:, None], idx + 1) * y0[:, None])
    c_prev = torch.cat([y0[:, None], ends[:, :-1]], dim=1)  # y entering b
    pw = torch.pow(q[:, None], torch.arange(1, _CHUNK + 1, device=dev,
                                            dtype=torch.float64))
    y = (local + c_prev[:, :, None] * pw[:, None, :]).reshape(g, -1)[:, :k]
    out = torch.clamp(torch.round(y), -32768, 32767).to(torch.int16)
    st = torch.stack([x[:, -1] * q14.Q14_ONE, torch.round(y[:, -1])],
                     dim=1).to(torch.int32)
    return [DcBlockerState(x_prev=st[i, 0], y_prev=st[i, 1],
                           acc=states[i].acc) for i in range(g)], out


def dc_block_exact(state: torch.Tensor, block: torch.Tensor,
                   p: int) -> torch.Tensor:
    """The exact recurrence over ``G`` streams: state [G, 3] int32 (x_prev,
    y_prev, acc), updated in place; block [G, n] int16 -> [G, n] int16.
    On a CUDA tensor it launches ``csrc/dc_blocker.cu``; on a CPU tensor it
    runs :func:`dc_block_exact_plain`."""
    if block.device.type == "cpu":
        return dc_block_exact_plain(state, block, p)
    if block.device.type != "cuda":
        raise ValueError(f"dc_block_exact runs on cuda or cpu, not "
                         f"{block.device}")
    g, n = block.shape
    for t, dtype, shape, name in ((block, torch.int16, (g, n), "block"),
                                  (state, torch.int32, (g, 3), "state")):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != block.device:
            raise ValueError(f"{name} on {t.device}, block on {block.device}")
    lib = build.load()
    out = torch.empty_like(block)
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = lib.tsl_dc_block_exact(block.data_ptr(), out.data_ptr(),
                                 state.data_ptr(), n, g, int(p), stream)
    build.check(err, "tsl_dc_block_exact")
    dc_block_exact.launches += 1
    return out


dc_block_exact.launches = 0


def dc_block_exact_plain(state: torch.Tensor, block: torch.Tensor,
                         p: int) -> torch.Tensor:
    """Plain version of :func:`dc_block_exact`: the recurrence as a loop
    over Python integers on the host, wrapped to int32 each sample."""
    st = state.cpu().tolist()
    out = []
    for g, row in enumerate(block.cpu().tolist()):
        x_prev, y_prev, acc = st[g]
        ys = []
        for s in row:
            x_new = s << q14.Q14_SHIFT
            acc = (acc - x_prev + x_new - p * y_prev + (1 << 31)) \
                % (1 << 32) - (1 << 31)
            x_prev = x_new
            y_prev = acc >> q14.Q14_SHIFT
            ys.append(y_prev)
        st[g] = [x_prev, y_prev, acc]
        out.append(ys)
    state.copy_(torch.tensor(st, dtype=torch.int32))
    res = np.array(out, dtype=np.int32).reshape(block.shape).astype(np.int16)
    return torch.from_numpy(res).to(block.device)


def dc_blocker_step_exact(state: DcBlockerState, block: torch.Tensor, p: int):
    """block [K] int16 PCM -> (new state, [K] int16), bit-exact with the
    JAX ``dc_blocker_step_exact``."""
    st = torch.stack([state.x_prev, state.y_prev, state.acc])[None]
    out = dc_block_exact(st, block[None].contiguous(), p)[0]
    return DcBlockerState(x_prev=st[0, 0], y_prev=st[0, 1], acc=st[0, 2]), out
