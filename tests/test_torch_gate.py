"""The block's last stages against the JAX package, on the CPU: the egress
gate (kernel K7's plain version), the fast DC blocker over a block's rows
(K8's) and the bit-exact tier's derotation and discriminator (K9's), then
the pager pipeline through them.

Each kernel's arithmetic is also emulated here in numpy, CTA by CTA and
thread by thread as its CUDA source walks it (tiles, windows, the ticket
fold, the chunked scan), and held to the plain version, so that what the
card alone can run has its indexing checked where the tests run.

Tolerances: the gate EXACT (flags, packed bytes, pcm and tails, byte for
byte); the DC blocker within 2 PCM LSB of JAX's float32 associative scan
and within 1 LSB of the port's single-row function and of the kernel's
chunked scan (float64 sums in other orders); K9 EXACT (integer products,
one float32 rounding a step in the same order).
"""

import dataclasses

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


# gate.cu's constants
TILE, EARLY = 2048, 4
LOOK = {"pocsag": 18 + 31 * 75, "ais": 4 + 31 * 5 + 5, "flex": 31 * 10}
SPECS = {"pocsag": [(75, sp.POCSAG_SYNC, 4, -19, 18, 18),
                    (32, sp.POCSAG_SYNC, 4, -9, 8, 8),
                    (16, sp.POCSAG_SYNC, 4, -5, 4, 4)],
         "ais": [(5, sp.AIS_PREAMBLE, 2, -4, 1, 4)],
         "flex": [(10, sp.FLEX_BS1, 0, 0, 0, 0)]}


def _to_i16(x):
    return np.trunc(np.clip(np.asarray(x, np.float64), -32768, 32767)
                    ).astype(np.int64)


def _emulate_gate(mode, rows, tail):
    """gate.cu in numpy, CTA by CTA: each tile's window of the plane, its
    registers, pairs and packed bytes, the tail CTA, and the flag folded
    by the last CTA to take a ticket (here, the tiles in a shuffled
    order)."""
    g, t = tail.shape
    k = len(rows[0])
    n_tiles = -(-k // TILE)
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
        new_tail[r] = plane(k + np.arange(t))
        if is_flex:
            out[r, 1:1 + tp] = v[k - tp:]
        else:
            bits = plane(k + np.arange(t)).reshape(-1, 8)
            out[r, 1:1 + t // 8] = (bits << np.arange(7, -1, -1)).sum(1)
        acc, ticket = 0, 0
        for j in rng.permutation(n_tiles):
            n0, n1 = j * TILE, min(k, (j + 1) * TILE)
            qa = t + n0 - (EARLY if j == 0 else 0)
            qb = t + n1
            w0 = max(0, qa - LOOK[mode])
            win = plane(np.arange(w0, qb))
            src = win
            if mode == "ais":
                i = np.arange(len(win))
                src = np.where((w0 + i < 5) | (i < 5), 0,
                               1 - (win ^ np.roll(win, 5)))
            hit = False
            for spb, word, ham, mlo_off, dmin, dmax in SPECS[mode]:
                mlo = t + mlo_off
                p0 = max(mlo, qa - dmax)
                p = np.arange(p0, qb)
                assert p0 - 31 * spb - w0 >= 0 and p0 - dmax >= w0 or w0 == 0
                reg = np.zeros(len(p), np.int64)
                for b in range(32):
                    reg |= src[p - b * spb - w0] << b
                x = reg ^ word
                pop = np.array([bin(int(z)).count("1") for z in x])
                m = pop <= ham
                for q in range(max(qa, mlo + dmin), qb):
                    i = q - p0
                    if dmax == 0:
                        hit |= bool(m[i])
                    for d in range(max(dmin, 1), dmax + 1):
                        if q - d >= mlo:
                            assert i - d >= 0
                            hit |= bool(m[i] & m[i - d])
            if is_flex:
                out[r, 1 + tp + n0:1 + tp + n1] = v[n0:n1]
            else:
                for n in range(n0, n1, 8):
                    byte = 0
                    for i in range(8):
                        if n + i < k:
                            byte |= int(win[t + n + i - w0]) << (7 - i)
                    out[r, 1 + t // 8 + n // 8] = byte
            acc |= hit
            ticket += 1
            if ticket == n_tiles:
                out[r, 0] = acc
    return out, new_tail


@pytest.mark.parametrize("case", si.GATE_CASES, ids=lambda c: c[0])
def test_gate_kernel_emulation_matches_plain(case):
    _, mode, g, k, types, _, plants = case
    # cut to 2 rows and 9,000 samples (five tiles); a word planted near
    # the block's end stays as near the cut block's end
    g, cut = min(g, 2), min(k, 9_000)
    plants = [(r, q - (k - cut) if q >= si.TAILS[mode] + cut - 17 else q)
              for r, q in plants if r < g]
    rows, tail = si.gate_inputs(mode, g, cut, types, plants, 4)
    got, got_tail = _emulate_gate(mode, rows, tail)
    out, new_tail = gate.egress_gate_plain(
        mode, [torch.from_numpy(r) for r in rows], torch.from_numpy(tail))
    np.testing.assert_array_equal(got, out.numpy())
    np.testing.assert_array_equal(got_tail, new_tail.numpy())


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


def _emulate_dc_fast(x, x_prev, y_prev, q, threads=1024, per=16):
    """dc_fast.cu in numpy for one row: segments of ``threads * per``
    samples, each thread a chunk of ``per`` run from 0, the maps scanned as
    the lanes and warps do (a Hillis-Steele scan in the lanes, then over
    the warps), each chunk run again from its carry, x and y carried to
    the next segment."""
    k = len(x)
    xi = _to_i16(x).astype(np.float64)
    seg = threads * per

    def scan(a, e):
        a, e = a.copy(), e.copy()
        off = 1
        while off < a.shape[-1]:
            pa = np.concatenate([np.ones_like(a[..., :off]), a[..., :-off]],
                                axis=-1)
            pe = np.concatenate([np.zeros_like(e[..., :off]),
                                 e[..., :-off]], axis=-1)
            a, e = a * pa, a * pe + e
            off *= 2
        return a, e

    out = np.empty(k, np.int16)
    cx, cy = x_prev / 16384.0, float(y_prev)
    for s0 in range(0, k, seg):
        xs = xi[s0:s0 + seg]
        sn = len(xs)
        lo = np.minimum(sn, np.arange(threads) * per)
        hi = np.minimum(sn, lo + per)
        x_in = [cx if lo[j] == 0 else xs[lo[j] - 1] for j in range(threads)]
        a = np.ones(threads)
        e = np.zeros(threads)
        for j in range(threads):
            xp = x_in[j]
            for n in range(lo[j], hi[j]):
                e[j] = q * e[j] + (xs[n] - xp)
                a[j] *= q
                xp = xs[n]
        wa, we = scan(a.reshape(-1, 32), e.reshape(-1, 32))
        ba, be = scan(wa[:, -1], we[:, -1])
        for j in range(threads):
            w, lane = divmod(j, 32)
            ea, ee = (ba[w - 1], be[w - 1]) if w else (1.0, 0.0)
            if lane:
                ea, ee = (wa[w, lane - 1] * ea,
                          wa[w, lane - 1] * ee + we[w, lane - 1])
            y = ea * cy + ee
            xp = x_in[j]
            for n in range(lo[j], hi[j]):
                y = q * y + (xs[n] - xp)
                xp = xs[n]
                out[s0 + n] = np.clip(np.rint(y), -32768, 32767)
            if hi[j] == sn and lo[j] < hi[j]:
                last = (xp, y)
        cx, cy = last
    return out, (int(cx) * 16384, int(np.rint(cy)))


@pytest.mark.parametrize("k,threads,per", [(54_400, 1024, 16), (1, 1024, 16),
                                           (3_001, 64, 4)])
def test_dc_fast_kernel_emulation_matches_plain(k, threads, per):
    rng = np.random.default_rng(k)
    x = si.dc_rows(rng, 1, k)[0]
    p = dcb.make_pole_coeff(0.9999)
    st = dcb.DcBlockerState(x_prev=torch.tensor(-41 << 14, dtype=torch.int32),
                            y_prev=torch.tensor(123, dtype=torch.int32),
                            acc=torch.tensor(0, dtype=torch.int32))
    (st2,), out = dcb.dc_block_fast_plain([st], [torch.from_numpy(x)], [p])
    got, (xp, yp) = _emulate_dc_fast(x, -41 << 14, 123, 1 - p / 16384,
                                     threads, per)
    diff = np.abs(got.astype(np.int32) - out[0].numpy())
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 2
    assert xp == int(st2.x_prev) and abs(yp - int(st2.y_prev)) <= 1


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


def _emulate_exact_fm(a_re, a_im, seq, last):
    """exact_fm.cu in numpy: every thread's two derotations, its products
    wrapped to int32, the LUT arctangent one float32 rounding a step, the
    float64 scale."""
    f32 = np.float32
    table = atan2.ATAN_TABLE
    pi, hp = f32(np.pi), f32(np.pi / 2)

    def wrap32(v):
        return ((v + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)

    def derot(ar, ai, s):
        ar, ai = ar.astype(np.int64), ai.astype(np.int64)
        sr, si = s[..., 0].astype(np.int64), s[..., 1].astype(np.int64)
        dr, di = wrap32(ar * sr - ai * si), wrap32(ar * si + ai * sr)
        return (((dr >> 14) + ((dr >> 13) & 1)).astype(np.int16),
                ((di >> 14) + ((di >> 13) & 1)).astype(np.int16))

    cr, ci = derot(a_re, a_im, seq)
    pr = np.concatenate([last[None, :, 0], cr[:-1]]).astype(np.int64)
    pim = np.concatenate([last[None, :, 1], ci[:-1]]).astype(np.int64)
    s_re = wrap32(cr * pr + ci.astype(np.int64) * pim)
    s_im = wrap32(ci * pr - cr.astype(np.int64) * pim)
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
    pcm = np.trunc(scaled).astype(np.int16).T
    return pcm, np.stack([cr, ci], -1), np.stack([cr[-1], ci[-1]],
                                                 -1).astype(np.int32)


@pytest.mark.parametrize("name", si.K9_CASES)
def test_exact_fm_kernel_emulation_matches_plain(name):
    a_re, a_im, seq, last = si.k9_inputs(name, 4_096, 8, seed=1)
    got = _emulate_exact_fm(a_re, a_im, seq, last)
    want = fm.exact_fm_plain(torch.from_numpy(a_re), torch.from_numpy(a_im),
                             torch.from_numpy(seq), torch.from_numpy(last))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


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
