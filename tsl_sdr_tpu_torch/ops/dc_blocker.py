"""DC blocker, production tier: the float IIR as a chunked linear scan.

Port of ``tsl_sdr_tpu/ops/dc_blocker.py:31-93`` (state and
``dc_blocker_step_fast``). The reference recurrence
(``filter/dc_blocker.h:72-93``) in float form is the first-order IIR

    y[n] = q * y[n-1] + (x[n] - x[n-1]),     q = 1 - p / 2^14

which the JAX package evaluates with ``lax.associative_scan``. Here it is
a two-level chunked scan in float64 built from matrix products with
non-negative powers of ``q`` (no growing ``q^-n`` factor can overflow):
within chunks of ``L`` samples, ``local = u @ Tq^T`` with ``Tq[i, j] =
q^(i-j)``; across chunks, the chunk-end values go through the same form with
``q^L``. Output tracks the exact integer tier to a few LSB, like the JAX
fast tier (the tests hold the two within 2 LSB).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsl_sdr_tpu_torch.ops import q14

_CHUNK = 256


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


def _decay_matrix(q: float, n: int, device) -> torch.Tensor:
    """[n, n] lower-triangular ``q^(i-j)`` for i >= j, else 0."""
    k = torch.arange(n, device=device, dtype=torch.float64)
    e = k[:, None] - k[None, :]
    return torch.where(e >= 0, torch.pow(q, e.clamp(min=0)),
                       torch.zeros((), dtype=torch.float64, device=device))


def dc_blocker_step_fast(state: DcBlockerState, block: torch.Tensor, p: int):
    """block [K] int16 PCM -> (new state, [K] int16)."""
    dev = block.device
    x = block.to(torch.float64)
    q = 1.0 - p / q14.Q14_ONE
    x_prev = state.x_prev.to(torch.float64) / q14.Q14_ONE
    y0 = state.y_prev.to(torch.float64)
    u = x - torch.cat([x_prev[None], x[:-1]])
    k = u.shape[0]
    nb = -(-k // _CHUNK)
    u = torch.nn.functional.pad(u, (0, nb * _CHUNK - k)).view(nb, _CHUNK)
    local = u @ _decay_matrix(q, _CHUNK, dev).T          # [nb, L]
    # y at the end of chunk b: c_b = q^L c_{b-1} + local[b, -1], c_{-1} = y0
    ql = q ** _CHUNK
    idx = torch.arange(nb, device=dev, dtype=torch.float64)
    ends = (_decay_matrix(ql, nb, dev) @ local[:, -1]
            + torch.pow(ql, idx + 1) * y0)
    c_prev = torch.cat([y0[None], ends[:-1]])             # y entering chunk b
    pw = torch.pow(q, torch.arange(1, _CHUNK + 1, device=dev,
                                   dtype=torch.float64))
    y = (local + c_prev[:, None] * pw[None, :]).reshape(-1)[:k]
    out = torch.clamp(torch.round(y), -32768, 32767).to(torch.int16)
    new_state = DcBlockerState(
        x_prev=(x[-1] * q14.Q14_ONE).to(torch.int32),
        y_prev=torch.round(y[-1]).to(torch.int32),
        acc=state.acc,
    )
    return new_state, out
