"""The exact DC blocker's staged form (csrc/dc_blocker.cu) against the
port's plain loop and the JAX ``dc_blocker_step_exact``.

The kernel reorders the reference recurrence: it computes every
``d_n = (x_n << 14) - (x_{n-1} << 14)`` of a staged chunk first (the
state's ``x_prev`` standing for ``x_{-1} << 14``), then runs only ``acc =
(acc + d_n) - p * y; y = acc >> 14`` serially, ``y`` starting from the
state's ``y_prev``. Addition mod 2^32 is order-free, so the reordering is
EXACT: output and state BIT-EQUAL, here on random input at two poles, on
full-scale alternating input (the int16 cast of ``y`` wraps), from states
whose ``acc`` wraps and whose ``y_prev`` is not ``acc >> 14``, across
chunks and uneven blocks. (The kernel itself: tests/test_torch_cuda.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsl_sdr_tpu.ops import dc_blocker as jdcb
from tsl_sdr_tpu_torch.ops import dc_blocker as dcb

_M = 0xFFFFFFFF


def _s32(v: int) -> int:
    v &= _M
    return v - (1 << 32) if v >= 1 << 31 else v


def _staged(state, x: np.ndarray, p: int, chunk: int, ax: int):
    """The kernel's arithmetic over one stream, plainly: chunks of
    ``chunk`` samples on the row's grid (the row starting ``ax`` samples
    past it); each chunk's d_n computed at once, x_prev carried; then the
    two-instruction chain in uint32 with an arithmetic shift."""
    x_prev, y, acc = (int(v) for v in state)
    x_prev &= _M
    acc &= _M
    neg_p = (-p) & _M
    out = np.empty(x.shape[0], np.int16)
    if not x.shape[0]:   # no chunk at all: the state stays
        return list(state), out
    for base in range(-ax, x.shape[0], chunk):
        lo, hi = max(base, 0), min(base + chunk, x.shape[0])
        sh = (x[lo:hi].astype(np.int64) << 14) & _M
        d = (sh - np.concatenate([[x_prev], sh[:-1]])) & _M
        x_prev = int(sh[-1])
        for i, dn in zip(range(lo, hi), d.tolist()):
            acc = (acc + dn + neg_p * (y & _M)) & _M
            y = _s32(acc) >> 14
            out[i] = np.int16(_s32(y << 16) >> 16)
    return [_s32(x_prev), y, _s32(acc)], out


# (x_prev, y_prev, acc): the two near 2^31 wrap acc on their first sample
# whatever it is (for any p >= 1), and no y_prev here is acc >> 14
_STATES = {
    "zero": (0, 0, 0),
    "acc near +2^31": (-(32768 << 14), -4000, (1 << 31) - 2000),
    "acc near -2^31": (32767 << 14, 4000, -(1 << 31) + 2000),
    "y_prev not acc >> 14": (5 << 14, 12_345, 0),
}


def _inputs(kind: str, g: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-32768, 32768, size=(g, n)).astype(np.int16)
    alt = np.where(np.arange(n) % 2, 32767, -32768).astype(np.int16)
    return np.repeat(alt[None], g, axis=0)


@pytest.mark.parametrize("state", list(_STATES))
@pytest.mark.parametrize("kind", ["random", "alternating"])
@pytest.mark.parametrize("pole", [0.9999, 0.5])
def test_staged_dc_matches_plain_and_jax(pole, kind, state):
    p = dcb.make_pole_coeff(pole)
    x = _inputs(kind, 2, 5_000, seed=int(pole * 10) + len(kind))
    st0 = np.array([_STATES[state]] * 2, np.int32)
    st_p = torch.from_numpy(st0.copy())
    st_e = [list(row) for row in st0]
    for lo, hi in [(0, 1), (1, 1153), (1153, 1153), (1153, 5_000)]:
        ref = dcb.dc_block_exact_plain(st_p, torch.from_numpy(
            x[:, lo:hi].copy()), p).numpy()
        for ch in range(2):
            chunk, ax = (64, 3) if ch else (2048, 0)
            st_e[ch], got = _staged(st_e[ch], x[ch, lo:hi], p, chunk, ax)
            np.testing.assert_array_equal(got, ref[ch])
        np.testing.assert_array_equal(np.array(st_e, np.int32), st_p.numpy())
    # and through the plain loop to the JAX scan, over the whole stream
    js = jdcb.DcBlockerState(*(jnp.int32(v) for v in _STATES[state]))
    js, jo = jdcb.dc_blocker_step_exact(js, x[0], p)
    full_st = torch.from_numpy(st0[:1].copy())
    full = dcb.dc_block_exact_plain(full_st, torch.from_numpy(x[:1].copy()),
                                    p)
    np.testing.assert_array_equal(full[0].numpy(), np.asarray(jo))
    assert full_st[0].tolist() == [int(js.x_prev), int(js.y_prev),
                                   int(js.acc)]


def test_adversarial_cases_wrap():
    """The adversarial cases reach what they are for: from the states near
    +-2^31 acc leaves int32 on the first sample, and on alternating
    full-scale input at pole 0.5 y leaves the int16 range, so its cast
    wraps."""
    for pole in (0.9999, 0.5):
        p = dcb.make_pole_coeff(pole)
        assert p >= 1
        for s in (-32768, 32767):
            for name in ("acc near +2^31", "acc near -2^31"):
                x_prev, y, acc = _STATES[name]
                raw = acc - x_prev + (s << 14) - p * y
                assert not -(1 << 31) <= raw < 1 << 31, (name, s)
    p = dcb.make_pole_coeff(0.5)
    x_prev = y = acc = 0
    ys = []
    for s in _inputs("alternating", 1, 64, 0)[0].tolist():
        acc = _s32(acc - x_prev + (s << 14) - p * y)
        x_prev, y = s << 14, acc >> 14
        ys.append(y)
    assert max(map(abs, ys)) > 32767
