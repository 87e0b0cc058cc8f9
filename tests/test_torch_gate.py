"""The block's last stages against the JAX package, on the CPU: the egress
gate (kernel K7's plain version), the fast DC blocker over a block's rows
(K8's) and the bit-exact tier's derotation and discriminator (K9's), then
the pager pipeline through them.

Each kernel's arithmetic is also emulated here in numpy, CTA by CTA and
thread by thread as its CUDA source walks it (K7's tiles, ballot words,
residue-class register runs, match words and flag fold; K8's chunks and
look-back in a shuffled CTA order; K9's tiles, halo rows, channel blocks
and groups of 8 on and off the 16-byte grid), and held to the plain
version, so that what the card alone can run has its indexing checked
where the tests run.

Tolerances: the gate EXACT (flags, packed bytes, pcm and tails, byte for
byte); the DC blocker within 2 PCM LSB of JAX's float32 associative scan
and within 1 LSB of the port's single-row function and of the kernel's
chunked scan (float64 sums in other orders); K9 EXACT (integer products,
one float32 rounding a step in the same order).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu.ops import dc_blocker as jdcb
from tsl_sdr_tpu.ops import sync_prefilter as jsp
from tsl_sdr_tpu.ops.fm import fm_demod_np
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.ops import atan2, dc_blocker as dcb, fm, gate
from tsl_sdr_tpu_torch.ops import sync_prefilter as sp
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.testing import stage_inputs as si

# -- the gate --------------------------------------------------------------

def _jax_gate(mode, rows, tail):
    """tsl_sdr_tpu/models/pipeline.py:219-262 for one pack group."""
    rows = jnp.stack([jnp.asarray(r) for r in rows])
    t = tail.shape[1]
    k = rows.shape[1]
    if mode == "flex":
        rows = rows.astype(jnp.int16)
        predu = (rows >= 0).astype(jnp.uint8)
        full = jnp.concatenate([jnp.asarray(tail), predu], axis=1)
        flags = jsp.flex_any_candidate(full, k)
        out = jnp.concatenate([flags.astype(jnp.int16)[:, None],
                               rows[:, -t:], rows], axis=1)
        return np.asarray(out), np.asarray(full[:, -t:])
    if jnp.issubdtype(rows.dtype, jnp.floating):
        rows = jnp.trunc(rows)
    pred = (rows > 0) if mode == "ais" else (rows < 0)
    predu = pred.astype(jnp.uint8)
    full = jnp.concatenate([jnp.asarray(tail), predu], axis=1)
    if mode == "pocsag":
        flags = jsp.pocsag_any_candidate(full, k)
    else:
        flags = jsp.ais_any_candidate(full, k)
    k8 = -(-k // 8) * 8
    if k8 != k:
        predu = jnp.pad(predu, ((0, 0), (0, k8 - k)))
    new_tail = full[:, -t:]
    out = jnp.concatenate([flags.astype(jnp.uint8)[:, None],
                           jnp.packbits(new_tail, axis=1),
                           jnp.packbits(predu, axis=1)], axis=1)
    return np.asarray(out), np.asarray(new_tail)


@pytest.mark.parametrize("case", si.GATE_CASES, ids=lambda c: c[0])
def test_gate_plain_matches_jax(case):
    _, mode, g, k, types, layout, plants = case
    rows, tail = si.gate_inputs(mode, g, k, types, plants, 3)
    if layout == "columns":   # K1's [K, C] output, a channel a column
        mat = torch.from_numpy(np.stack(rows, axis=1))
        trows = [mat[:, r] for r in range(g)]
    else:
        trows = [torch.from_numpy(r) for r in rows]
    out, new_tail = gate.egress_gate(mode, trows, torch.from_numpy(tail))
    ref, ref_tail = _jax_gate(mode, rows, tail)
    assert out.dtype == (torch.int16 if mode == "flex" else torch.uint8)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(new_tail.numpy(), ref_tail)
    flagged = set(np.flatnonzero(ref[:, 0]).tolist())
    assert si.tested_rows(mode, k, plants) <= flagged
    assert flagged <= {r for r, _ in plants}


def test_gate_mixed_row_types_match_jax():
    """A group of an int16 row (after the DC blocker) and float rows (after
    a resampler), as a DC-blocked POCSAG channel beside others gives."""
    rows, tail = si.gate_inputs("pocsag", 3, 9_000, "float32",
                                [(1, sp.POCSAG_TAIL + 3_000)], 5)
    rows[1] = np.trunc(rows[1]).astype(np.int16)
    out, new_tail = gate.egress_gate(
        "pocsag", [torch.from_numpy(r) for r in rows], torch.from_numpy(tail))
    ref, ref_tail = _jax_gate("pocsag", rows, tail)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(new_tail.numpy(), ref_tail)


# gate.cu's constants, through the wrapper's one copy of them
EARLY, LOOK, SPECS = gate.EARLY, gate.LOOK, gate.SPECS
M32 = 0xFFFFFFFF
_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.int64)


def _to_i16(x):
    return np.trunc(np.clip(np.asarray(x, np.float64), -32768, 32767)
                    ).astype(np.int64)


def _ballot(bits):
    """__ballot_sync over 32 lanes: bit l of the word is lane l's."""
    return int((np.asarray(bits, np.int64) << np.arange(32)).sum())


def _funnel_l(lo, hi, s):
    """__funnelshift_l(lo, hi, s) for 0 < s < 32."""
    return ((hi << s) | (lo >> (32 - s))) & M32


def _packed_bytes(word):
    """__byte_perm(__brev(word), 0, 0x0123): __brev, then the bytes in
    reverse order; byte e holds positions 8e..8e+7, the first at bit 7."""
    rev = sum(int(_REV8[(word >> (8 * e)) & 0xFF]) << (24 - 8 * e)
              for e in range(4))
    return sum(((rev >> (24 - 8 * e)) & 0xFF) << (8 * e) for e in range(4))


def _popcount(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _walk(src, p0, np_, spec, m, run):
    """One spec's register runs over the window's bit words ``src``
    (positions relative to b0): items (class r, run u) of ``run``
    positions, each a 31-bit warm-up and then reg = (reg << 1) | bit a
    step, a match setting its bit in ``m``; all items side by side, step
    by step."""
    spb, word, ham = spec[:3]
    runs = -(-(-(-np_ // spb)) // run)
    it = np.arange(spb * runs)
    r, u = it % spb, it // spb
    jr = (np_ - r + spb - 1) // spb
    ja = u * run
    jb = np.minimum(jr, ja + run)
    reg = np.zeros(len(it), np.int64)
    for k in range(31 + run):
        j = ja - 31 + k
        bi = p0 + r + spb * j
        live = j < jb
        assert (bi[live] >= 0).all() and (bi[live] < 32 * len(src)).all()
        bi = np.where(live, bi, 0)
        bit = (src[bi >> 5] >> (bi & 31)) & 1
        reg = ((reg << 1) | bit) & M32
        if k >= 31:
            hit = live & (_popcount(reg ^ word) <= ham)
            for b in bi[hit]:
                m[b >> 5] |= 1 << (b & 31)


def _emulate_gate(mode, rows, tail, tile, run, vec):
    """gate.cu in numpy, CTA by CTA and warp by warp: each tile's window
    sign-sliced into ballot words (``vec``: four samples a lane, a word
    ORed from eight lanes' nibbles), AIS's NRZI words, the residue-class
    register runs setting the m words, the pairs as ANDs of shifted m
    words, the packed bytes from the window's words, the tail CTA, and
    the flag folded by the last CTA to count itself done (here, the tiles in
    a shuffled order)."""
    g, t = tail.shape
    k = len(rows[0])
    n_tiles = -(-k // tile)
    is_flex = mode == "flex"
    tp = min(k, t)
    width = 1 + tp + k if is_flex else 1 + t // 8 + -(-k // 8)
    out = np.full((g, width), 0x55, np.int16 if is_flex else np.uint8)
    new_tail = np.zeros_like(tail)
    rng = np.random.default_rng(0)
    for r in range(g):
        v = _to_i16(rows[r])
        bit = {"pocsag": v < 0, "ais": v > 0, "flex": v >= 0}[mode]

        def plane(q, r=r, bit=bit):
            q = np.asarray(q)
            return np.where(q < t, tail[r, np.minimum(q, t - 1)],
                            bit[np.clip(q - t, 0, k - 1)]).astype(np.int64)

        # the tail CTA
        for w in range(-(-t // 32)):
            i = 32 * w + np.arange(32)
            b = np.where(i < t, plane(k + np.minimum(i, t - 1)), 0)
            new_tail[r, i[i < t]] = b[i < t]
            if not is_flex:
                word = _packed_bytes(_ballot(b))
                for lane in range(4):
                    if 4 * w + lane < t // 8:
                        out[r, 1 + 4 * w + lane] = (word >> (8 * lane)) & 0xFF
        if is_flex:
            out[r, 1:1 + tp] = v[k - tp:]
        fold = 0
        for j in rng.permutation(n_tiles):
            n0, n1 = j * tile, min(k, (j + 1) * tile)
            qa = t + n0 - (EARLY if j == 0 else 0)
            qb = t + n1
            wq = (qa - LOOK[mode] - t) // 32          # floor division
            b0 = t + 32 * wq
            nw = -(-(qb - b0) // 32)
            wt = max(0, min(nw, -wq))
            win = np.zeros(nw + 4, np.int64)
            for w in range(wt):
                q = b0 + 32 * w + np.arange(32)
                win[w] = _ballot(np.where(q >= 0,
                                          tail[r, np.clip(q, 0, t - 1)], 0))
            if vec:
                for w in range(wt, nw, 4):
                    n = 32 * (wq + w) + 4 * np.arange(32)[:, None] + \
                        np.arange(4)[None, :]
                    nib = (np.where(n < k, bit[np.minimum(n, k - 1)], 0)
                           << np.arange(4)).sum(1)
                    part = nib << (4 * (np.arange(32) & 7))
                    for kk in range(4):
                        win[w + kk] = int(np.bitwise_or.reduce(
                            part[8 * kk:8 * kk + 8]))
            else:
                for w in range(wt, nw):
                    n = 32 * (wq + w) + np.arange(32)
                    win[w] = _ballot(np.where(n < k,
                                              bit[np.minimum(n, k - 1)], 0))
            src = win
            if mode == "ais":
                src = np.zeros_like(win)
                for w in range(nw):
                    prev = win[w - 1] if w else 0
                    x = ~(win[w] ^ _funnel_l(prev, win[w], 5)) & M32
                    lo = b0 + 32 * w
                    if lo < 5:
                        x = 0 if lo <= -27 else x & (M32 << (5 - lo)) & M32
                    src[w] = x
            hit = False
            wa, wb = (qa - b0) // 32, (qb - 1 - b0) // 32
            p0s = [max(t + sp[3], qa - sp[5]) for sp in SPECS[mode]]
            for spec, p0 in zip(SPECS[mode], p0s):
                spb, _, _, mlo_off, dmin, dmax = spec
                m = np.zeros(nw + 4, np.int64)
                _walk(src, p0 - b0, qb - p0, spec, m, run)
                # the runs set exactly the matches of the registers read
                # whole, 32 bits at stride spb, at every position
                p = np.arange(p0, qb) - b0
                reg = sum(((src[(p - b * spb) >> 5] >> ((p - b * spb) & 31))
                           & 1) << b for b in range(32))
                want = np.zeros(32 * len(m), np.int64)
                want[p] = _popcount(reg ^ spec[1]) <= spec[2]
                np.testing.assert_array_equal(
                    (m[:, None] >> np.arange(32)) & 1, want.reshape(-1, 32))
                for w in range(wa, wb + 1):
                    cur, prev = int(m[w]), int(m[w - 1])
                    if dmax == 0:
                        hit |= cur != 0
                    for d in range(max(dmin, 1), dmax + 1):
                        hit |= (cur & _funnel_l(prev, cur, d)) != 0
            if is_flex:
                out[r, 1 + tp + n0:1 + tp + n1] = v[n0:n1]
            else:
                wo = (t + n0 - b0) // 32
                for i in range(-(-(n1 - n0) // 32)):
                    word = _packed_bytes(int(win[wo + i]))
                    b = n0 // 8 + 4 * i
                    for e in range(4):
                        if b + e < -(-k // 8):
                            out[r, 1 + t // 8 + b + e] = (word >> (8 * e)) \
                                & 0xFF
            # one atomic add of (1 | hit << 32); the CTA that saw
            # n_tiles - 1 tiles done writes the flag and zeroes the word
            old, fold = fold, fold + (1 | int(hit) << 32)
            if old & M32 == n_tiles - 1:
                out[r, 0] = (old >> 32) != 0 or hit
                fold = 0
        assert fold == 0
    return out, new_tail


def _check_emulation(mode, g, k, types, layout, plants, tile, seed,
                     run=None):
    rows, tail = si.gate_inputs(mode, g, k, types, plants, seed)
    got, got_tail = _emulate_gate(mode, rows, tail, tile,
                                  run or gate.launch_run(mode, tile),
                                  vec=layout == "rows")
    out, new_tail = gate.egress_gate_plain(
        mode, [torch.from_numpy(r) for r in rows], torch.from_numpy(tail))
    np.testing.assert_array_equal(got, out.numpy())
    np.testing.assert_array_equal(got_tail, new_tail.numpy())
    return out


@pytest.mark.parametrize("case", si.GATE_CASES, ids=lambda c: c[0])
def test_gate_kernel_emulation_matches_plain(case):
    """Each case at the tile the wrapper picks for its full shape on an
    H100 (132 SMs), cut to 2 rows and 9,000 samples (several tiles); a
    word planted near the block's end stays as near the cut block's
    end."""
    _, mode, g, k, types, layout, plants = case
    tile = gate.launch_tile(mode, g, k, 132)
    g, cut = min(g, 2), min(k, 9_000)
    plants = [(r, q - (k - cut) if q >= si.TAILS[mode] + cut - 17 else q)
              for r, q in plants if r < g]
    _check_emulation(mode, g, cut, types, layout, plants, tile, 4)


# (mode, tile, layout, plant offset from a tile boundary in F, register
# run or the wrapper's): a POCSAG run, a FLEX register and an AIS pair that
# straddle two tiles; runs of 8 take the threads several passes
STRADDLE = [("pocsag", 2048, "columns", -8, 8),
            ("pocsag", 4096, "rows", -3, None),
            ("pocsag", 8192, "rows", 1, 128),
            ("ais", 1024, "rows", -1, None), ("ais", 4096, "columns", 0, 8),
            ("flex", 1024, "rows", 5, None),
            ("flex", 8192, "columns", 200, 64)]


@pytest.mark.parametrize("mode,tile,layout,off,run", STRADDLE)
def test_gate_emulation_across_tiles(mode, tile, layout, off, run):
    """Words planted so that a register, a POCSAG run's pairs or an AIS
    pair cross the boundary between tiles 1 and 2: the emulation equals
    the plain version and the planted row flags."""
    t = si.TAILS[mode]
    q = t + 2 * tile + off
    out = _check_emulation(mode, 2, 3 * tile - 100, "float32", layout,
                           [(0, q)], tile, 6, run)
    assert out[0, 0] == 1 and out[1, 0] == 0


def test_launch_shapes_on_an_h100():
    """The tiles, runs and CTA counts the docstrings give at the pager's
    shapes on 132 SMs."""
    for mode, g, k, tile, run in (("pocsag", 6, 130_560, 2048, 32),
                                  ("flex", 2, 54_400, 1024, 16),
                                  ("ais", 1, 163_200, 1024, 16),
                                  ("pocsag", 130, 4_100, 2048, 32),
                                  ("pocsag", 300, 130_560, 8192, 128),
                                  ("pocsag", 2, 1_003, 2048, 32)):
        assert gate.launch_tile(mode, g, k, 132) == tile
        assert gate.launch_run(mode, tile) == run
    assert 6 * -(-130_560 // 2048) == 384


def _cu_constants(name):
    """The ``constexpr int`` constants of ``csrc/<name>``, evaluated."""
    src = (Path(gate.__file__).parents[1] / "csrc" / name).read_text()
    env = {}
    for key, expr in re.findall(r"constexpr int (\w+) =\s*([^;]+);", src):
        env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return src, env


def test_wrapper_geometry_matches_kernel_sources():
    """The Python copies of the kernels' geometry (``ops/gate.py``'s
    tiles, threads, rows, look-back and register specs, which pick K7's
    tile and run and drive the emulation; ``ops/dc_blocker.py``'s rows
    and chunk) equal the constants of ``gate.cu`` and ``dc_fast.cu``."""
    src, c = _cu_constants("gate.cu")
    assert (c["kThreads"], c["kMinTile"], c["kMaxTile"], c["kRows"],
            c["kEarly"]) == (gate.THREADS, gate.TILES[0], gate.TILES[-1],
                             gate.MAX_ROWS, gate.EARLY)
    assert [c["kLookPocsag"], c["kLookAis"], c["kLookFlex"]] == \
        [gate.LOOK[m] for m in ("pocsag", "ais", "flex")]
    body = re.search(r"kSpecs\[\d+\] = \{(.*?)\n\};", src, re.S).group(1)
    specs = [tuple(int(v.rstrip("u"), 0) for v in row.split(","))
             for row in re.findall(r"\{([^{}]+)\}", body)]
    assert specs == [tuple(x) for m in ("pocsag", "ais", "flex")
                     for x in gate.SPECS[m]]
    _, c = _cu_constants("dc_fast.cu")
    assert (c["kRows"], c["kChunk"]) == (dcb._FAST_ROWS, dcb.FAST_CHUNK)


def test_gate_wrapper_checks():
    rows = [torch.zeros(100, dtype=torch.int16)]
    tail = torch.zeros((1, sp.POCSAG_TAIL), dtype=torch.uint8)
    with pytest.raises(ValueError, match="mode"):
        gate.egress_gate("pcm", rows, tail)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gate.egress_gate("pocsag", [r.to("meta") for r in rows],
                         tail.to("meta"))
    # the plain version keeps the JAX tail-span check
    with pytest.raises(ValueError, match="register span"):
        gate.egress_gate("pocsag", rows, tail[:, :2000])


# -- the fast DC blocker ----------------------------------------------------

def test_dc_fast_rows_match_jax_and_single_row():
    """Three rows with their own poles, over blocks of uneven lengths
    (one of a single sample), the states carried: each row within 2 LSB
    of JAX's dc_blocker_step_fast, and within 1 LSB of the port's
    single-row function."""
    rng = np.random.default_rng(12)
    poles = [0.9999, 0.999, 0.5]
    ps = [dcb.make_pole_coeff(p) for p in poles]
    x = si.dc_rows(rng, 3, 3 * 4_000 + 1)
    jst = [jdcb.init_dc_blocker_state() for _ in ps]
    one = [dcb.init_dc_blocker_state(device="cpu") for _ in ps]
    many = [dcb.init_dc_blocker_state(device="cpu") for _ in ps]
    for lo, hi in ((0, 4_000), (4_000, 4_001), (4_001, 12_001)):
        blk = x[:, lo:hi]
        many, out = dcb.dc_block_fast(
            many, [torch.from_numpy(r) for r in blk], ps)
        assert out.dtype == torch.int16 and out.shape == blk.shape
        for r, p in enumerate(ps):
            jst[r], jo = jdcb.dc_blocker_step_fast(
                jst[r], blk[r].astype(np.int16), p)
            one[r], oo = dcb.dc_blocker_step_fast(
                one[r], torch.from_numpy(blk[r]), p)
            got = out[r].numpy().astype(np.int32)
            assert np.abs(got - np.asarray(jo, np.int32)).max() <= 2
            assert np.abs(got - oo.numpy().astype(np.int32)).max() <= 1
            assert int(many[r].x_prev) == int(jst[r].x_prev)
            assert abs(int(many[r].y_prev) - int(jst[r].y_prev)) <= 2
            assert abs(int(many[r].y_prev) - int(one[r].y_prev)) <= 1


def _scan(a, e):
    """Inclusive Hillis-Steele scan of affine maps y -> a*y + e along the
    last axis (the lanes' __shfl_up scan), the first map applied first."""
    a, e = a.copy(), e.copy()
    off = 1
    while off < a.shape[-1]:
        pa = np.concatenate([np.ones_like(a[..., :off]), a[..., :-off]],
                            axis=-1)
        pe = np.concatenate([np.zeros_like(e[..., :off]), e[..., :-off]],
                            axis=-1)
        a, e = a * pa, a * pe + e
        off *= 2
    return a, e


def _emulate_dc_fast(xs, x_prev, y_prev, qs, threads=256, per=8, group=32,
                     seed=0):
    """dc_fast.cu in numpy over rows of one length: a CTA a chunk of
    ``threads * per`` samples (its id from a ticket: row id // chunks,
    chunk id % chunks), each thread ``per`` samples run from 0, the maps
    scanned as the lanes and warps do, the chunk's sum E published; the
    y entering chunk c = group*m + o composed from the E of chunks
    group*m .. c-1 (a lane each, a scan with identity lanes) applied to
    the y entering chunk group*m (published by it; y_prev for m = 0), or
    for o = 0 from the group before. The CTAs run in a shuffled order; a
    CTA whose window is not yet published waits (goes to the back), as
    the kernel's spin does. Then each thread reruns its samples."""
    g, k = xs.shape
    chunk = threads * per
    nch = -(-k // chunk)
    xi = _to_i16(xs).astype(np.float64)
    out = np.empty((g, k), np.int16)
    st = [None] * g
    agg, base = {}, {}
    a_full = [q ** chunk for q in qs]
    pending = list(np.random.default_rng(seed).permutation(g * nch))
    local = {}
    while pending:
        cta = pending.pop(0)
        r, c = divmod(int(cta), nch)
        q = qs[r]
        c0 = c * chunk
        if cta not in local:
            x = xi[r, c0:c0 + chunk]
            cn = len(x)
            x_before = x_prev[r] / 16384.0 if c == 0 else xi[r, c0 - 1]
            lo = np.minimum(cn, np.arange(threads) * per)
            hi = np.minimum(cn, lo + per)
            x_in = np.array([x_before if lo[j] == 0 else x[lo[j] - 1]
                             for j in range(threads)])
            a, e, xp = np.ones(threads), np.zeros(threads), x_in.copy()
            for i in range(per):
                live = lo + i < hi
                xv = x[np.minimum(lo + i, cn - 1)]
                e = np.where(live, q * e + (xv - xp), e)
                a = np.where(live, a * q, a)
                xp = np.where(live, xv, xp)
            wa, we = _scan(a.reshape(-1, 32), e.reshape(-1, 32))
            tot_a = np.ones(32)
            tot_e = np.zeros(32)
            tot_a[:threads // 32], tot_e[:threads // 32] = wa[:, -1], we[:, -1]
            ba, be = _scan(tot_a, tot_e)
            if c + 1 < nch:
                agg[r, c] = be[threads // 32 - 1]
            local[cta] = (x, cn, lo, hi, x_in, wa, we, ba, be)
        x, cn, lo, hi, x_in, wa, we, ba, be = local[cta]
        if c == 0:
            y_in = float(y_prev[r])
        else:
            o = c % group
            gb = c - o if o else c - group
            n = o if o else group
            need = [(r, gb + i) for i in range(n)]
            if any(key not in agg for key in need) or \
                    (gb and (r, gb // group) not in base):
                pending.append(cta)
                continue
            la, le = np.ones(32), np.zeros(32)
            la[:n] = a_full[r]
            le[:n] = [agg[key] for key in need]
            la, le = _scan(la, le)
            yb = float(y_prev[r]) if gb == 0 else base[r, gb // group]
            y_in = la[n - 1] * yb + le[n - 1]
            if o == 0:
                base[r, c // group] = y_in
        for j in range(threads):
            w, lane = divmod(j, 32)
            ea, ee = (ba[w - 1], be[w - 1]) if w else (1.0, 0.0)
            if lane:
                ea, ee = (wa[w, lane - 1] * ea,
                          wa[w, lane - 1] * ee + we[w, lane - 1])
            y = ea * y_in + ee
            xp = x_in[j]
            for n in range(lo[j], hi[j]):
                y = q * y + (x[n] - xp)
                xp = x[n]
                out[r, c0 + n] = np.clip(np.rint(y), -32768, 32767)
            if c == nch - 1 and lo[j] < hi[j] == cn:
                st[r] = (int(xp) * 16384, int(np.rint(y)))
    return out, st


def _dc_fast_case(g, k, threads, per, seed):
    rng = np.random.default_rng(seed)
    x = si.dc_rows(rng, g, k)
    ps = [dcb.make_pole_coeff(0.5 if r % 2 else 0.9999) for r in range(g)]
    x_prev = rng.integers(-3000, 3000, g) << 14
    y_prev = rng.integers(-2000, 2000, g)
    states = [dcb.DcBlockerState(x_prev=torch.tensor(xp, dtype=torch.int32),
                                 y_prev=torch.tensor(yp, dtype=torch.int32),
                                 acc=torch.tensor(0, dtype=torch.int32))
              for xp, yp in zip(x_prev, y_prev)]
    st2, out = dcb.dc_block_fast_plain(states, [torch.from_numpy(r)
                                                for r in x], ps)
    got, st = _emulate_dc_fast(x, x_prev, y_prev,
                               [1 - p / 16384 for p in ps], threads, per,
                               seed=seed)
    diff = np.abs(got.astype(np.int32) - out.numpy())
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 2
    for (xp, yp), s in zip(st, st2):
        assert xp == int(s.x_prev) and abs(yp - int(s.y_prev)) <= 1


@pytest.mark.parametrize("k,threads,per", [(54_400, 256, 8), (1, 256, 8),
                                           (3_001, 64, 4),
                                           (70_001, 64, 4)])
def test_dc_fast_kernel_emulation_matches_plain(k, threads, per):
    """One row: the pager's block (27 chunks), a single sample, a ragged
    row at a small tiling (12 chunks), and 274 chunks (nine windows of
    32, each entered from the y its first chunk published)."""
    _dc_fast_case(1, k, threads, per, k)


@pytest.mark.parametrize("g,k", [(1, 1_000), (65, 2_500)])
def test_dc_fast_emulation_rows(g, k):
    """A row shorter than one chunk, and 65 rows (the kernel's two
    launches; each row its own chunks), each row with its own pole and
    state."""
    _dc_fast_case(g, k, 256, 8, g)


def test_dc_fast_wrapper_checks():
    st = dcb.init_dc_blocker_state(device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dcb.dc_block_fast([st], [torch.zeros(8, device="meta")], [1])


# -- K9: the exact tier's derotation and discriminator -----------------------

def _jax_exact_fm(a_re, a_im, seq, last):
    """tsl_sdr_tpu/models/channelizer.py:288-301 (step_exact_packed_end)."""
    d_re = (a_re.astype(np.int32) * seq[..., 0]
            - a_im.astype(np.int32) * seq[..., 1])
    d_im = (a_re.astype(np.int32) * seq[..., 1]
            + a_im.astype(np.int32) * seq[..., 0])

    def round_np(v):
        return ((v >> 14) + ((v >> 13) & 1)).astype(np.int16)

    ch = np.stack([round_np(d_re), round_np(d_im)], axis=-1)
    pcm, last2 = fm_demod_np(np.moveaxis(ch, 1, 0), last=last)
    return pcm, ch, np.asarray(last2, np.int32)


@pytest.mark.parametrize("name", si.K9_CASES)
def test_exact_fm_plain_matches_jax(name):
    a_re, a_im, seq, last = si.k9_inputs(name, 4_096, 8)
    pcm, ch, last2 = fm.exact_fm(torch.from_numpy(a_re),
                                 torch.from_numpy(a_im),
                                 torch.from_numpy(seq),
                                 torch.from_numpy(last))
    ref_pcm, ref_ch, ref_last = _jax_exact_fm(a_re, a_im, seq, last)
    np.testing.assert_array_equal(ch.numpy(), ref_ch)
    np.testing.assert_array_equal(pcm.numpy(), ref_pcm)
    np.testing.assert_array_equal(last2.numpy(), ref_last)


def _wrap32(v):
    return ((v + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)


def _derot_np(ar, ai, sr, si):
    """exact_fm.cu's derotate: int32 wrapping products, Q.28 -> Q.14."""
    ar, ai = ar.astype(np.int64), ai.astype(np.int64)
    sr, si = sr.astype(np.int64), si.astype(np.int64)
    dr, di = _wrap32(ar * sr - ai * si), _wrap32(ar * si + ai * sr)
    return (((dr >> 14) + ((dr >> 13) & 1)).astype(np.int16).astype(np.int64),
            ((di >> 14) + ((di >> 13) & 1)).astype(np.int16).astype(np.int64))


def _discriminate_np(cr, ci, pr, pim):
    """exact_fm.cu's discriminate: the wrapped conjugate product, the LUT
    arctangent one float32 rounding a step, the float64 scale."""
    f32 = np.float32
    table = atan2.ATAN_TABLE
    pi, hp = f32(np.pi), f32(np.pi / 2)
    s_re = _wrap32(cr * pr + ci * pim)
    s_im = _wrap32(ci * pr - cr * pim)
    y, x = s_im.astype(f32), s_re.astype(f32)
    ya, xa = np.abs(y), np.abs(x)
    hi = np.maximum(ya, xa)
    z = np.minimum(ya, xa) / np.where(hi == 0, f32(1), hi)
    alpha = z * f32(255)
    index = alpha.astype(np.int32) & 0xFF
    frac = alpha - index.astype(f32)
    t0, t1 = table[index], table[index + 1]
    base = np.where(z.astype(np.float64) < 0.003921569, z,
                    t0 + (t1 - t0) * frac)
    ax = np.where(x >= 0, np.where(y >= 0, base, -base),
                  np.where(y >= 0, pi - base, base - pi))
    ay = np.where(y >= 0, np.where(x >= 0, hp - base, hp + base),
                  np.where(x >= 0, -hp + base, -hp - base))
    phi = np.where((ya == 0) & (xa == 0), f32(0), np.where(xa > ya, ax, ay))
    scaled = (phi.astype(np.float64) / np.pi * 16384.0).astype(f32)
    return np.trunc(scaled).astype(np.int16)


def _groups(start, length, n_groups):
    """exact_fm.cu's runs cut into groups of 8 flat indices on the 8-grid
    from the base: for run ``q`` of ``start``/``length`` (arrays) and group
    ``j < n_groups`` the clipped [lo, hi), the group's start and the run's
    number, one entry a (run, group) with lo < hi."""
    q = np.repeat(np.arange(start.size), n_groups)
    g = (start[q] & ~7) + 8 * np.tile(np.arange(n_groups), start.size)
    lo = np.maximum(g, start[q])
    hi = np.minimum(g + 8, start[q] + length)
    keep = lo < hi
    return lo[keep], hi[keep], g[keep], q[keep]


def _expand(lo, hi):
    """Every index of the ranges [lo, hi), and the range of each."""
    n = hi - lo
    which = np.repeat(np.arange(lo.size), n)
    return lo[which] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n), \
        which


def _emulate_exact_fm(a_re, a_im, seq, last, sms):
    """exact_fm.cu in numpy, CTA by CTA as its grid walks the tiles: a CTA
    (bx, by) takes outputs [bx*tk, +tk) of channels [by*cb, +cb)
    (``fm.exact_fm_tile`` on a card of ``sms`` SMs), derotates its halo row (or takes ``last``),
    then its samples in groups of 8 flat (k, c) indices on the 8-grid
    (one run for the whole tile where it holds every channel, else one a
    row) into ch and its shared tile, discriminates each sample after its
    predecessor there, and writes the PCM through its transposed tile in
    groups of 8 of [C, K]. Each output element must be written exactly
    once. Returns (pcm, ch, last_out) and the number of groups that a tile
    edge cut (written by scalars, not 16-byte vectors)."""
    k, c_n = a_re.shape
    tk, cb = fm.exact_fm_tile(k, c_n, sms)
    pitch = tk + 2
    are, aim = a_re.reshape(-1), a_im.reshape(-1)
    sre, sim = seq[..., 0].reshape(-1), seq[..., 1].reshape(-1)
    ch = np.zeros((k * c_n, 2), np.int16)
    pcm = np.zeros(c_n * k, np.int16)
    last_out = np.zeros((c_n, 2), np.int32)
    n_ch, n_pcm, n_last = (np.zeros(k * c_n, int), np.zeros(c_n * k, int),
                           np.zeros(c_n, int))
    cut = 0
    for bx in range(-(-k // tk)):
        for by in range(-(-c_n // cb)):
            k0, cb0 = bx * tk, by * cb
            tka, cba = min(tk, k - k0), min(cb, c_n - cb0)
            if k0 == 0:
                halo = last[cb0:cb0 + cba].astype(np.int64)
            else:
                e = (k0 - 1) * c_n + cb0 + np.arange(cba)
                halo = np.stack(_derot_np(are[e], aim[e], sre[e], sim[e]), -1)
            flat = cba == c_n
            nrun, run = (1, tka * c_n) if flat else (tka, cba)
            on_grid = flat or ((c_n | cb) & 7) == 0
            start = (k0 + np.arange(nrun)) * c_n + cb0
            lo, hi, g, r = _groups(start, run, (run + (7 if on_grid else 14))
                                   // 8)
            cut += int(np.sum((lo != g) | (hi != g + 8)))
            e, which = _expand(lo, hi)
            loc = r[which] * run + (e - start[r[which]])
            ch_s = np.zeros((tka * cba, 2), np.int64)
            cr, ci = _derot_np(are[e], aim[e], sre[e], sim[e])
            ch_s[loc] = np.stack([cr, ci], -1)
            assert np.array_equal(np.sort(loc), np.arange(tka * cba))
            ch[e] = np.stack([cr, ci], -1)
            n_ch[e] += 1
            lidx = np.arange(tka * cba)
            rr, cc = lidx // cba, lidx % cba
            prev = np.where((rr == 0)[:, None], halo[cc],
                            ch_s[np.maximum(lidx - cba, 0)])
            pcm_s = np.zeros(cb * pitch, np.int16)
            pcm_s[cc * pitch + rr] = _discriminate_np(
                ch_s[:, 0], ch_s[:, 1], prev[:, 0], prev[:, 1])
            if k0 + tka == k:
                last_out[cb0:cb0 + cba] = ch_s[(tka - 1) * cba:]
                n_last[cb0:cb0 + cba] += 1
            start = (cb0 + np.arange(cba)) * k + k0
            lo, hi, g, rows = _groups(start, tka,
                                      (tka + (7 if k % 8 == 0 else 14)) // 8)
            cut += int(np.sum((lo != g) | (hi != g + 8)))
            e, which = _expand(lo, hi)
            pcm[e] = pcm_s[rows[which] * pitch + (e - start[rows[which]])]
            n_pcm[e] += 1
    assert (n_ch == 1).all() and (n_pcm == 1).all() and (n_last == 1).all()
    return (pcm.reshape(c_n, k), ch.reshape(k, c_n, 2), last_out), cut


# (channels, outputs): the pager's 8 at a multiple of the largest tile,
# then a last tile cut short at 1 and 8 channels (every channel a CTA), 64
# (the widest such bank), 232 (blocks of 32, the last of 8) and 100
# (blocks off the 8-grid); each on a card of one SM (the largest tiles)
# and of an H100's 132 (tiles cut for four CTAs an SM)
K9_SHAPES = [(8, 4096), (1, 4109), (8, 4109), (64, 1037), (232, 296),
             (100, 203)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("c,k", K9_SHAPES)
@pytest.mark.parametrize("name", si.K9_CASES)
def test_exact_fm_kernel_emulation_matches_plain(name, c, k, sms):
    a_re, a_im, seq, last = si.k9_inputs(name, k, c, seed=1)
    got, cut = _emulate_exact_fm(a_re, a_im, seq, last, sms)
    want = fm.exact_fm_plain(torch.from_numpy(a_re), torch.from_numpy(a_im),
                             torch.from_numpy(seq), torch.from_numpy(last))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    tk, cb = fm.exact_fm_tile(k, c, sms)
    if c % 8 == 0 and k % 8 == 0:
        # every load and store a 16-byte vector but at a ragged last tile
        assert cut <= (2 * cb if k % tk else 0)


def test_exact_fm_tile_matches_kernel_source():
    """K9's tile from ``fm.exact_fm_tile`` fits ``exact_fm.cu``'s shared
    tile: its capacity constants are the Python module's, tk is a multiple
    of 8, a block gives about CTAS_PER_SM CTAs an SM, and the
    main paths' shapes get the tiles the design names."""
    _, c = _cu_constants("exact_fm.cu")
    assert (c["kTileSamples"], c["kMaxBlock"]) == (fm.TILE_SAMPLES,
                                                   fm.MAX_BLOCK)
    for c_n in (1, 8, 33, 64, 65, 100, 232, 256):
        for k in (1, 9, 1000, 6552, 130_560, 417_792):
            tk, cb = fm.exact_fm_tile(k, c_n, 132)
            assert tk % 8 == 0 and tk * cb <= fm.TILE_SAMPLES
            assert cb == (c_n if c_n <= fm.MAX_BLOCK else fm.WIDE_BLOCK)
            # about CTAS_PER_SM CTAs an SM, but for rounding tk to 8
            ctas = -(-k // tk) * -(-c_n // cb)
            assert 2 * ctas >= min(fm.CTAS_PER_SM * 132,
                                   -(-k // 8) * -(-c_n // cb))
    # the exact pager block, multifm_rtlsdr_8ch's, the exact wide banks'
    assert fm.exact_fm_tile(130_560, 8, 132) == (248, 8)
    assert fm.exact_fm_tile(130_560, 8, 1) == (512, 8)
    assert fm.exact_fm_tile(6_552, 8, 132) == (16, 8)
    assert fm.exact_fm_tile(6_552, 64, 132) == (16, 64)
    assert fm.exact_fm_tile(2_176, 232, 132) == (32, 32)


# -- the pager pipeline through the new wrappers ------------------------------

def test_pager_pipeline_through_new_stages_matches_jax(monkeypatch):
    """The pager deployment's rates, LPF and block, cut to four channels
    (two POCSAG, the two FLEX with the DC-blocked one) and two blocks: the
    port, whose finish runs dc_block_fast and egress_gate once each a
    block and group, decodes what the JAX pipeline decodes, with the same
    gating counts."""
    chans = (2, 3, 6, 7)
    calls = {"gate": 0, "dc": 0}
    for mod, name, key in ((gate, "egress_gate", "gate"),
                           (dcb, "dc_block_fast", "dc")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(mod, name, counted)
    n = 6_500_000
    rng = np.random.default_rng(4)
    iq = rng.normal(scale=80, size=(n, 2))
    starts = {2: 300_000, 3: 4_000_000, 6: 1_000_000, 7: 3_600_000}
    for ch, start in starts.items():
        sig, _ = pager.burst(ch, *pager._message(ch))
        iq[start:start + len(sig)] += sig
    iq = np.clip(np.round(iq), -32768, 32767).astype(np.int16)

    def specs(mod):
        return [s for i, s in enumerate(pager.channel_specs(mod.ChannelSpec))
                if i in chans]

    jp = jpipe.ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                               pager.DECIMATION, specs(jpipe), exact=False)
    ref = jp.process_capture(iq)
    tp = tpipe.ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                               pager.DECIMATION, specs(tpipe), device="cpu")
    assert tp.block_size == jp.block_size == 4_177_920
    got = tp.process_capture(iq)
    fields = [[dataclasses.asdict(m) for m in c] for c in got]
    assert fields == [[dataclasses.asdict(m) for m in c] for c in ref]
    assert [len(c) for c in got] == [1, 1, 1, 1]
    np.testing.assert_array_equal(tp.stream_stats["fetched"],
                                  jp.stream_stats["fetched"])
    blocks = tp.stream_stats["blocks"]
    assert calls == {"gate": 2 * blocks, "dc": blocks}
