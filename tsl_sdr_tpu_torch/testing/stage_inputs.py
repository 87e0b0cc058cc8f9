"""Inputs for the block's last stages, for holding kernels K7, K8 and K9 to
their plain versions and the plain versions to the JAX package: PCM rows
whose sign slice carries sync words planted where a block must (and must
not) flag them, float rows as a resampler hands them to the DC blocker,
and adversarial sums for the exact tier's discriminator. numpy only, made
from a seed.
"""

from __future__ import annotations

import numpy as np

from tsl_sdr_tpu_torch.ops import sync_prefilter as sp

TAILS = {"pocsag": sp.POCSAG_TAIL, "ais": sp.AIS_TAIL, "flex": sp.FLEX_TAIL}
WORDS = {"pocsag": sp.POCSAG_SYNC, "ais": sp.AIS_PREAMBLE,
         "flex": sp.FLEX_BS1}

_TP, _TF, _TA = TAILS["pocsag"], TAILS["flex"], TAILS["ais"]
# (name, mode, rows, K, row types, layout, plants): the pager's POCSAG
# group as K1 gives it (columns of its [K, C] output) and its FLEX group (a
# resampler's float row and the DC blocker's int16 row), AIS at the mixed
# capture's shape, K % 8 != 0, K < TAIL and 130 rows (two launches); each
# plant (row, q) a sync word whose register ends at q of the [tail | new]
# plane: at the block start, across the tail boundary, (POCSAG) in a run
# ending at the last old sample, at the last new sample, and before the
# tested span
GATE_CASES = [
    ("the pager's POCSAG group", "pocsag", 6, 130_560, "int16", "columns",
     [(0, _TP + 40), (2, _TP + 5), (3, _TP - 17), (5, _TP + 100_000)]),
    ("POCSAG float32, K % 8 = 5", "pocsag", 3, 130_557, "float32", "rows",
     [(1, _TP - 17), (2, _TP + 130_000)]),
    ("POCSAG K < TAIL", "pocsag", 2, 1_003, "float32", "rows",
     [(0, _TP + 483), (1, _TP + 974)]),
    ("130 POCSAG rows (two launches)", "pocsag", 130, 4_100, "int16",
     "columns", [(0, _TP + 10), (129, _TP + 3_000)]),
    ("the pager's FLEX group", "flex", 2, 54_400, "mixed", "rows",
     [(0, _TF), (1, _TF + 54_399)]),
    ("FLEX int16, K % 8 = 5", "flex", 3, 54_397, "int16", "rows",
     [(0, _TF + 3), (2, _TF - 1)]),
    ("FLEX K < TAIL", "flex", 2, 200, "float32", "rows", [(1, _TF + 150)]),
    ("AIS at the mixed capture's shape", "ais", 1, 163_200, "float32",
     "rows", [(0, _TA + 2)]),
    ("AIS float32, K % 8 = 3", "ais", 3, 4_803, "float32", "rows",
     [(0, _TA - 3), (1, _TA + 4_801), (2, _TA - 2)]),
    ("AIS K < TAIL", "ais", 2, 101, "int16", "rows", [(1, _TA + 60)]),
]


def plant_word(plane, mode: str, q: int) -> None:
    """Plant ``mode``'s sync word in a ``[tail | new]`` bit plane so that
    the register ending at ``q`` matches it: POCSAG for a run of spb/2 + 1
    positions at spb 32 (a trigger's run), AIS (NRZI-coded) at ``q`` and
    ``q + 1``, FLEX at ``q``."""
    word = WORDS[mode]
    if mode == "pocsag":
        for p in range(q, q + 17):
            for b in range(32):
                plane[p - b * 32] = (word >> b) & 1
    elif mode == "flex":
        for b in range(32):
            plane[q - b * sp.FLEX_SPB] = (word >> b) & 1
    else:
        for p in (q, q + 1):
            for b in range(31, -1, -1):
                r = p - b * sp.AIS_DECIM
                plane[r] = plane[r - sp.AIS_DECIM] ^ (1 - ((word >> b) & 1))


def rows_from_bits(bits, mode: str, dtype, rng) -> np.ndarray:
    """PCM slicing to ``bits`` under ``mode``'s predicate; float rows hold
    values in (-1, 1) that truncate to 0 on the side of the predicate they
    must not pass."""
    n = bits.shape
    big = rng.uniform(1, 3000, size=n)
    small = np.where(rng.random(n) < 0.3,
                     rng.uniform(-0.999, 0.999, size=n), 0.0)
    keep = rng.random(n) < 0.7
    if mode == "pocsag":      # bit: trunc(x) < 0
        x = np.where(bits == 1, -big, big * keep + small)
    elif mode == "ais":       # bit: trunc(x) > 0
        x = np.where(bits == 1, big, -big * keep + small)
    else:                     # bit: to_int16(x) >= 0
        x = np.where(bits == 1, big * keep + small, -big)
    if dtype == np.int16:
        x = np.trunc(x)
        if mode != "flex":
            x[(x == 0) & (bits == 1)] = -1 if mode == "pocsag" else 1
    return x.astype(dtype)


def gate_inputs(mode: str, g: int, k: int, types: str, plants, seed: int):
    """(rows, tail): ``g`` PCM rows of ``k`` samples (numpy; ``types``
    "int16", "float32", or "mixed": a float row then int16 ones) and the
    carried tail [g, T] uint8, with ``plants`` planted."""
    rng = np.random.default_rng(seed)
    t = TAILS[mode]
    plane = rng.integers(0, 2, size=(g, t + k)).astype(np.uint8)
    for r, q in plants:
        plant_word(plane[r], mode, q)
    dts = [np.float32 if types == "float32" or (types == "mixed" and r == 0)
           else np.int16 for r in range(g)]
    rows = [rows_from_bits(plane[r, t:], mode, dts[r], rng) for r in range(g)]
    return rows, plane[:, :t].copy()


def tested_rows(mode: str, k: int, plants) -> set:
    """The rows whose planted words lie where a block tests, so must flag:
    POCSAG a run (pairs spb/4 apart) ending at t - 1 or later, FLEX a word
    at a new position, AIS a pair (q, q + 1) from t - 4 on. A word planted
    just before may alias into the tested span (BS1 repeats at a shift of
    2), so other planted rows may flag too; rows with nothing planted must
    not."""
    t = TAILS[mode]
    lo = {"pocsag": t - 17, "flex": t, "ais": t - 4}[mode]
    hi = t + k - {"pocsag": 16, "flex": 0, "ais": 1}[mode]
    return {r for r, q in plants if lo <= q < hi}


def dc_rows(rng, g: int, n: int) -> np.ndarray:
    """[g, n] float32 rows as a resampler gives them to the DC blocker:
    tones over DC offsets, and noise."""
    t = np.arange(n)
    x = (rng.uniform(2000, 7000, size=(g, 1))
         * np.sin(2 * np.pi * t / rng.uniform(40, 200, size=(g, 1)))
         + rng.uniform(-3000, 3000, size=(g, 1))
         + rng.normal(scale=400, size=(g, n)))
    return np.clip(x, -32768, 32767).astype(np.float32)


K9_CASES = ("random", "full scale", "zero vectors", "table abscissae")


def k9_inputs(name: str, k: int, c: int, seed: int = 0):
    """(a_re, a_im [k, c] int16, seq [k, c, 2] int16, last [c, 2] int32):
    K5's Q.14 sums, the rotator and the FM carry at random, at full scale,
    with zero vectors, or (identity rotator) with conjugate products that
    land on the LUT's abscissae, z = i / 255 exactly."""
    rng = np.random.default_rng(seed)
    a_re = rng.integers(-32768, 32768, size=(k, c)).astype(np.int16)
    a_im = rng.integers(-32768, 32768, size=(k, c)).astype(np.int16)
    seq = rng.integers(-16384, 16385, size=(k, c, 2)).astype(np.int16)
    last = rng.integers(-32768, 32768, size=(c, 2)).astype(np.int32)
    if name == "full scale":
        a_re[:] = -32768
        a_im[: k // 2] = -32768
        seq[:] = -32768
    elif name == "zero vectors":
        a_re[::3] = 0
        a_im[::3] = 0
        seq[k // 2:] = 0
    elif name == "table abscissae":
        # ch = a; prev (m, 0) and ch (255 m, i m) make s = ch * conj(prev)
        # (255 m m', i m m'), on z = i / 255
        seq[..., 0], seq[..., 1] = 16384, 0
        n = np.arange(k)[:, None]
        i = (n % 256 + np.arange(c)[None, :]) % 256
        m = 1 + n % 50
        sign = rng.choice([-1, 1], size=(k, c, 2))
        a_re[:] = np.where(n % 2, 255 * m, m) * sign[..., 0]
        a_im[:] = np.where(n % 2, i * m, 0) * sign[..., 1]
    elif name != "random":
        raise ValueError(f"unknown case {name!r}")
    return a_re, a_im, seq, last
