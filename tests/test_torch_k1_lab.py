"""The K1 lab (``bench/torch_k1_lab.py``) on the CPU: its patches, numpy
emulations of its variants' CTA loops against their plain versions, and the
plain versions against the JAX package.

The lab's variants are patched copies of K1's two bodies
(``tsl_sdr_tpu_torch/csrc/chain.cu``, ``bank.cu``, ``fm.cuh``); the card
runs them (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 23). Here:

- every cut's anchors occur exactly once in the current sources, ``full``
  is the shipped source byte for byte and every other variant changes it;
- numpy emulations of the CTA loops the cuts write (the copy and split
  bodies' staging and output loops, ``streams``' groups of warps, the FIR
  body's Q.14 epilogue, the persistent ``carry`` CTAs that keep the
  look-back rows, the ``ring`` CTAs' cp.async buffers and their
  ``wait_group`` bookkeeping with taps in the raw k order, the bank
  body's output loop and FIR walk) on 2-3 tiles with a ragged last one
  equal the lab's plain versions: tolerance 0 (integer sums, and K1's
  float32 FM in the plain version's order);
- the plain versions against the JAX package: ``copy`` and ``split`` equal
  the JAX lab's ``copy`` and ``conv`` kernels (``bench/pallas_parts_lab.py:
  85-122``, written here in ``jnp``, grid step by grid step), ``fir``
  equals ``packed_fir_step_exact``'s a_re and a_im (tolerance 0), and K1's
  plain version (what ``carryful`` and ``ring`` compute) agrees with
  ``PallasChain(interpret=True)`` within 1 PCM LSB on more than 99 % of
  the outputs (the tolerance of ``tests/test_torch_chain.py``: the Pallas
  kernel's float32 matmul sum rounds where int32 does not; the first
  output of each channel differs by design, as there).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsl_sdr_tpu.ops import packed_fir as jpf
from tsl_sdr_tpu.ops.pallas_chain import PallasChain
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.ops import fm, imma_split, packed_fir

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_k1_lab", ROOT / "bench" / "torch_k1_lab.py")
lab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lab)

# small blocks: rows of the block at each shape (2-3 tiles, the last ragged)
SMALL = {"pager": 2 * 255 + 37, "8 channels": 2 * 111 + 50,
         "16 channels": 2 * 63 + 20}


def _shape(name, seed=0, full_scale=True):
    """A small block at one of the lab's shapes (16 channels: the bank
    body at the JAX labs' settings)."""
    if name == "16 channels":
        chain = lab.lab_chain(16, "cpu")
        plan = chain.taps.plan
        rng = np.random.default_rng(seed)
        vals = rng.integers(-32768, 32768, size=plan.carry_vals + SMALL[name]
                            * plan.row).astype(np.int16)
        vals[-3 * plan.row:] = -32768
        vals = torch.from_numpy(vals)
        prev = torch.from_numpy(rng.normal(scale=1e5, size=(2, 16)).astype(
            np.float32))
        return lab.Shape(name, chain.taps, vals[:plan.carry_vals],
                         vals[plan.carry_vals:], prev)
    row = 128 if name == "pager" else 640
    return lab.make_shape(name, "cpu", seed=seed,
                          samples=SMALL[name] * row // 2,
                          full_scale=full_scale)


def _rows(vals, s0, n, row):
    """Stream rows [s0, s0 + n) (zeros outside the stream) as [n, row]."""
    out = np.zeros((n, row), np.int64)
    total = vals.size // row
    for i in range(n):
        if 0 <= s0 + i < total:
            out[i] = vals[(s0 + i) * row:(s0 + i + 1) * row]
    return out


def _vals(shape):
    return np.concatenate([shape.carry.numpy(), shape.block.numpy()]).astype(
        np.int64)


def _wrap32(a):
    return ((a + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)


def _q14(a):
    """K5's kQ14 rounding, narrowed mod 2^16."""
    r = (a >> 14) + ((a >> 13) & 1)
    return ((r + 2 ** 15) % 2 ** 16 - 2 ** 15).astype(np.int16)


def _global_col(rem, c0, cpb, nr_ch):
    """chain.cu's global_col, vectorized (-1 for a padding channel)."""
    if cpb == nr_ch:
        return rem
    j, cl = np.divmod(rem, cpb)
    c = c0 + cl
    return np.where(c < nr_ch, j * nr_ch + c, -1)


def _stage_tile(vals, plan, r0, tr, groups=1):
    """The tile body's staging of rows [r0 - 1, r0 + tr + cr): the 16-byte
    chunks each of ``groups`` groups of 256 / groups threads stores (the
    ``streams`` loop; 1 is the shipped loop), each chunk stored once.
    Returns the rows as [x_rows, row] int64."""
    row, cr = plan.row, plan.cr_rows
    x_rows = tr + 1 + cr
    per_row = row // 8
    n_x = x_rows * per_row
    total = vals.size
    base = (r0 - 1) * row
    gt = 256 // groups
    stored = np.zeros(n_x, np.int64)
    x = np.zeros((x_rows, row), np.int64)
    for thread in range(256):
        grp = thread // gt
        g_lo = n_x * grp // groups
        g_hi = n_x * (grp + 1) // groups
        for i0 in range(g_lo + thread % gt, g_hi, gt * 4):
            for u in range(4):
                i = i0 + u * gt
                if i >= g_hi:
                    continue
                s = base + 8 * i
                v = vals[s:s + 8] if 0 <= s < total else np.zeros(8)
                x[i // per_row, 8 * (i % per_row):8 * (i % per_row) + 8] = v
                stored[i] += 1
    assert (stored == 1).all()
    return x


def _split_back(x):
    """The split planes of staged rows and the values the split cut puts
    back together: (int16)(((unsigned)hi << 8) | lo)."""
    v = x.astype(np.int16)
    hi = (v >> 8).astype(np.int8).view(np.uint8).astype(np.uint32)
    lo = (v & 0xFF).astype(np.uint32)
    return ((hi << 8) | lo).astype(np.uint16).view(np.int16)


def _tile_rows_out(shape, kind, groups=1):
    """The tile body's copy or split cut: for each tile, staging, then
    output row r0 + lr - 1, column global_col(rem) takes the block row
    (local row lr + cr, raw) or the stream row (local lr, from the planes)."""
    taps = shape.taps
    plan = taps.plan
    vals = _vals(shape)
    rows = shape.block.numel() // plan.row
    tr, cpb, nr_ch = taps.tile_rows, taps.chans_per_block, plan.nr_channels
    hc, hcb = plan.halfcols, plan.opr * cpb
    out = np.full((rows, hc), 12345, np.int64)
    for b in range(-(-nr_ch // cpb)):
        for t in range(-(-rows // tr)):
            r0 = t * tr
            n_out = min(tr, rows - r0)
            x = _stage_tile(vals, plan, r0, tr, groups)
            item = np.arange(n_out * hcb)
            lr = 1 + item // hcb
            rem = item - (lr - 1) * hcb
            col = _global_col(rem, b * cpb, cpb, nr_ch)
            ok = col >= 0
            if kind == "copy":
                v = x[lr + plan.cr_rows, col]
            else:
                v = _split_back(x)[lr, col]
            out[(r0 + lr - 1)[ok], col[ok]] = v[ok]
    return out


@pytest.mark.parametrize("key", sorted(lab.VARIANTS), ids=" ".join)
def test_every_anchor_occurs_once(key):
    """Each cut's anchors occur exactly once in the shipped source it cuts,
    so the lab cannot rot silently when K1 changes."""
    for file, anchor in lab.anchors(lab.VARIANTS[key]):
        assert (lab.CSRC / file).read_text().count(anchor) == 1, (file,
                                                                  anchor)


@pytest.mark.parametrize("key", sorted(lab.VARIANTS), ids=" ".join)
def test_full_is_shipped_and_each_cut_changes_it(key):
    v = lab.VARIANTS[key]
    files = lab.source(v)
    shipped = {f: (lab.CSRC / f).read_text() for f in files}
    if key[1] == "full":
        assert files == shipped
    else:
        assert files != shipped
        assert v.cuts


def test_a_missing_anchor_stops_the_lab_and_names_it():
    cut = lab.Cut(lab.T, "no such line in chain.cu\n", "")
    with pytest.raises(SystemExit, match="no such line in chain.cu"):
        lab.apply((lab.CSRC / "chain.cu").read_text(), lab.T, [cut])


@pytest.mark.parametrize("name", ["pager", "8 channels"])
@pytest.mark.parametrize("kind", ["copy", "split"])
def test_tile_copy_and_split_emulation_equals_plain(name, kind):
    shape = _shape(name)
    want = (lab.copy_plain if kind == "copy" else lab.split_plain)(
        shape.taps, shape.carry, shape.block)
    np.testing.assert_array_equal(_tile_rows_out(shape, kind), want.numpy())


@pytest.mark.parametrize("groups", [2, 4])
def test_streams_groups_stage_every_chunk_once(groups):
    """``streams2``/``streams4``: the tile's chunks split into contiguous
    parts a group of warps each, every chunk stored once (asserted inside
    the emulation); the copy out equals the plain version."""
    shape = _shape("pager", seed=groups)
    np.testing.assert_array_equal(
        _tile_rows_out(shape, "copy", groups),
        lab.copy_plain(shape.taps, shape.carry, shape.block).numpy())


def _tile_ops(taps, raw):
    """The tile body's tap operands as numpy (w_hi, w_lo, ktab): the
    shipped ones, or the ring variants' raw k order."""
    if raw:
        return tuple(t.numpy() for t in lab.raw_operands(taps, "cpu"))
    return taps.w_hi.numpy(), taps.w_lo.numpy(), taps.ktab.numpy()


def _tile_sums(x, taps, ops, raw, b=0):
    """The tile's int32 sums [tr + 1, 2 * hcb] of channel block ``b`` from
    staged rows x, as the products form them from the operands: each n8
    tile over its ktab k-steps, fragment base + 4 * ks + j of the compact
    planes; in the raw k order A's values are permuted the same way."""
    plan = taps.plan
    w_hi, w_lo, ktab = ops
    row, cr = plan.row, plan.cr_rows
    hcb = plan.opr * taps.chans_per_block
    ntb = taps.tiles_per_block
    ksteps = -(-plan.win // 32)
    n_rows = x.shape[0] - cr
    win = np.stack([x[lr:lr + cr + 1].reshape(-1)[:32 * ksteps]
                    for lr in range(n_rows)])
    order = imma_split.raw_k_order(32 * ksteps) if raw else \
        np.arange(32 * ksteps)
    acc = np.zeros((n_rows, ntb * 8), np.int64)
    tab = ktab[b * ntb:(b + 1) * ntb]
    tap0 = ktab[b * ntb - 1, 3] if b else 0
    for j, (lo, hi, base, _) in enumerate(tab):
        hi = min(hi, ksteps)
        if hi <= lo:
            continue
        f = base + 4 * np.arange(lo, hi) + j % 4
        wt = imma_split.unfragment(w_hi[f, None], w_lo[f, None],
                                   32 * (hi - lo), 8).astype(np.int64)
        assert f.max() < ktab[(b + 1) * ntb - 1, 3] and f.min() >= tap0
        acc[:, 8 * j:8 * j + 8] = win[:, order[32 * lo:32 * hi]] @ wt
    return _wrap32(acc[:, :2 * hcb])


def _pcm(ar, ai, pr, pi, om):
    """fm.cuh's fm_pcm elementwise, in the plain version's float32 ops."""
    ar, ai, pr, pi, om = (torch.as_tensor(np.asarray(a, np.float32))
                          for a in (ar, ai, pr, pi, om))
    sre = ar * pr + ai * pi
    sim = ai * pr - ar * pi
    phi = fm.atan2_poly(sim, sre) + om
    p = fm.PI_F32
    phi = torch.where(phi > p, phi - 2 * p, phi)
    phi = torch.where(phi <= -p, phi + 2 * p, phi)
    phi = torch.where((sre == 0) & (sim == 0), torch.zeros_like(phi), phi)
    return torch.trunc(phi / torch.full_like(phi, p) * 16384.0).to(
        torch.int16).numpy()


def _tile_epilogue(taps, acc, r0, n_out, prev, out, fir, prev_out, b=0):
    """The tile body's epilogue of one tile from its sums ``acc`` (local
    row 0 the look-back row): ``fir``, Q.14 planes out[ri, r, col]; else
    the FM loop (history (lr, rem - cpb), (lr - 1, rem + hcb - cpb) or
    prev[]) into out[r, col], and prev_out from the block's last row."""
    plan = taps.plan
    cpb, nr_ch = taps.chans_per_block, plan.nr_channels
    hcb = plan.opr * cpb
    c0 = b * cpb
    rows = out.shape[-2]
    lr, rem = np.meshgrid(np.arange(1, n_out + 1), np.arange(hcb),
                          indexing="ij")
    col = _global_col(rem, c0, cpb, nr_ch)
    ok = col >= 0
    if fir:
        for ri in range(2):
            out[ri, (r0 + lr - 1)[ok], col[ok]] = _q14(
                acc[lr, ri * hcb + rem][ok])
        return
    a_re = acc[:, :hcb].astype(np.float32)
    a_im = acc[:, hcb:].astype(np.float32)
    same = rem >= cpb
    h_lr = np.where(same, lr, lr - 1)
    h_rem = np.where(same, rem - cpb, rem + hcb - cpb)
    pr, pi = a_re[h_lr, h_rem], a_im[h_lr, h_rem]
    first = ~same & (r0 + lr - 1 == 0)
    pr = np.where(first, prev[0][c0 + rem % cpb * (rem < cpb)], pr)
    pi = np.where(first, prev[1][c0 + rem % cpb * (rem < cpb)], pi)
    om = taps.omega_row.numpy()[np.maximum(col, 0)]
    v = _pcm(a_re[lr, rem], a_im[lr, rem], pr, pi, om)
    out[(r0 + lr - 1)[ok], col[ok]] = v[ok]
    if r0 + n_out == rows:
        cl = np.arange(cpb)
        keep = c0 + cl < nr_ch
        prev_out[0, (c0 + cl)[keep]] = a_re[n_out, hcb - cpb + cl][keep]
        prev_out[1, (c0 + cl)[keep]] = a_im[n_out, hcb - cpb + cl][keep]


def _persistent(shape, kind, n_ctas, nbuf=2):
    """The persistent tile body's CTAs: CTA y walks tiles [tiles * y / Y,
    tiles * (y + 1) / Y). ``carry``: after its first tile a CTA moves
    local rows [tr, tr + 1 + cr) to [0, 1 + cr) and stages chunks from
    (1 + cr) * per_row on. ``ring``: tile t's rows go by cp.async into
    buffer (t - t0) % nbuf, issued nbuf - 1 tiles ahead, one commit group
    a step (empty past the run), and arrive when a wait_group(nbuf - 1)
    completes their group; a buffer is read only with no group pending on
    it. Yields (tile, the staged rows it computes from)."""
    plan = shape.taps.plan
    row, cr, tr = plan.row, plan.cr_rows, shape.taps.tile_rows
    vals = _vals(shape)
    rows = shape.block.numel() // row
    tiles = -(-rows // tr)
    x_rows = tr + 1 + cr
    per_row = row // 8
    for y in range(n_ctas):
        t0, t1 = tiles * y // n_ctas, tiles * (y + 1) // n_ctas
        if kind == "carry":
            x = np.zeros((x_rows, row), np.int64)
            for t in range(t0, t1):
                skip = 0
                if t > t0:
                    x[:1 + cr] = x[tr:tr + 1 + cr].copy()
                    skip = (1 + cr) * per_row
                base = (t * tr - 1) * row
                for i in range(skip, x_rows * per_row):
                    s = base + 8 * i
                    x[i // per_row, 8 * (i % per_row):8 * (i % per_row) + 8] \
                        = vals[s:s + 8] if 0 <= s < vals.size else 0
                yield t, x.copy()
            continue
        bufs = [np.full((x_rows, row), -999, np.int64) for _ in range(nbuf)]
        groups = []   # (buffer, first stream row) or None, in commit order
        done = 0

        def wait(pending):
            nonlocal done
            while done < len(groups) - pending:
                g = groups[done]
                if g is not None:
                    bufs[g[0]] = _rows(vals, g[1], x_rows, row)
                done += 1

        for k in range(nbuf - 1):
            groups.append(((k % nbuf), (t0 + k) * tr - 1)
                          if t0 + k < t1 else None)
        for t in range(t0, t1):
            tn = t + nbuf - 1
            groups.append(((tn - t0) % nbuf, tn * tr - 1) if tn < t1 else None)
            wait(nbuf - 1)
            slot = (t - t0) % nbuf
            assert all(g is None or g[0] != slot for g in groups[done:])
            yield t, bufs[slot].copy()


@pytest.mark.parametrize("name", ["pager", "8 channels"])
@pytest.mark.parametrize("kind,n_ctas,nbuf", [
    ("carry", 1, 0), ("carry", 2, 0), ("ring", 1, 2), ("ring", 2, 2),
    ("ring", 1, 4), ("ring", 3, 4)])
def test_persistent_emulation_equals_plain(name, kind, n_ctas, nbuf):
    """``carryful`` and ``ring2``/``ring4``: every tile computes from the
    stream rows [r0 - 1, r0 + tr + cr) (asserted), and the tiles' PCM and
    FM carry, formed as the kernel forms them (ring: raw rows, taps in the
    raw k order), equal K1's plain version exactly; ``carryfir``'s Q.14
    planes equal the FIR's plain version."""
    shape = _shape(name, seed=nbuf + n_ctas)
    taps = shape.taps
    plan = taps.plan
    vals = _vals(shape)
    rows = shape.block.numel() // plan.row
    tr = taps.tile_rows
    ops = _tile_ops(taps, kind == "ring")
    pcm = np.zeros((rows, plan.halfcols), np.int16)
    planes = np.zeros((2, rows, plan.halfcols), np.int16)
    prev_out = np.full((2, plan.nr_channels), np.nan, np.float32)
    prev = shape.prev.numpy()
    seen = []
    for t, x in _persistent(shape, kind, n_ctas, nbuf):
        np.testing.assert_array_equal(
            x, _rows(vals, t * tr - 1, tr + 1 + plan.cr_rows, plan.row))
        acc = _tile_sums(x, taps, ops, kind == "ring")
        n_out = min(tr, rows - t * tr)
        _tile_epilogue(taps, acc, t * tr, n_out, prev, pcm, False, prev_out)
        if kind == "carry":
            _tile_epilogue(taps, acc, t * tr, n_out, prev, planes, True, None)
        seen.append(t)
    assert sorted(seen) == list(range(-(-rows // tr)))
    want, want_prev = k1.chain_fm_plain(taps, shape.carry, shape.prev,
                                        shape.block)
    np.testing.assert_array_equal(pcm, want.numpy())
    np.testing.assert_array_equal(prev_out, want_prev.numpy())
    if kind == "carry":
        np.testing.assert_array_equal(
            planes, lab.fir_plain(taps, shape.carry, shape.block).numpy())


@pytest.mark.parametrize("name", ["pager", "8 channels"])
def test_tile_fir_emulation_equals_plain(name):
    """``fir``: the shipped staging and products, each sum of local rows 1
    .. n_out written as K5's Q.14 rounding to plane ri, output row r0 +
    lr - 1, column global_col(rem); no FM."""
    shape = _shape(name, seed=5)
    taps = shape.taps
    plan = taps.plan
    vals = _vals(shape)
    rows = shape.block.numel() // plan.row
    tr = taps.tile_rows
    ops = _tile_ops(taps, False)
    planes = np.zeros((2, rows, plan.halfcols), np.int16)
    for t in range(-(-rows // tr)):
        x = _stage_tile(vals, plan, t * tr, tr)
        acc = _tile_sums(x, taps, ops, False)
        _tile_epilogue(taps, acc, t * tr, min(tr, rows - t * tr), None,
                       planes, True, None)
    np.testing.assert_array_equal(
        planes, lab.fir_plain(taps, shape.carry, shape.block).numpy())


def _bank_value(x, kind, lr, col, cr):
    if kind == "copy":
        return x[lr + cr, col]
    w = x.astype(np.int16).view(np.uint16).astype(np.uint32)
    word = w[lr, col & ~1] | (w[lr, col | 1] << 16)
    # __byte_perm(w, 0, 0x3131), (w, 0, 0x2020), then (lo, hi, 0x5140)
    hi = ((word >> 8) & 0xFF) | (((word >> 24) & 0xFF) << 8)
    lo = (word & 0xFF) | (((word >> 16) & 0xFF) << 8)
    v = (lo & 0xFF) | ((hi & 0xFF) << 8) | (((lo >> 8) & 0xFF) << 16) \
        | (((hi >> 8) & 0xFF) << 24)
    half = np.where(col & 1, v >> 16, v & 0xFFFF)
    return half.astype(np.uint16).view(np.int16)


@pytest.mark.parametrize("kind", ["copy", "split", "fir"])
def test_bank_emulation_equals_plain(kind):
    """The bank body's cuts at 16 channels (one sub-block of two octets,
    63-row tiles, 8 phases): each unit's raw rows [r0 - 1, r0 + tr + cr);
    ``copy`` and ``split`` write column j * C + c of the sub-block's
    channels from the block row or the stream row (split: the word's
    bytes split and put back together by __byte_perm); ``fir``: the
    bank walk (8 items of two warps, each half of the phases, lanes (g,
    t), C-fragment rows g and g + 8 and channels 2t, 2t + 1 of the item's
    octet) writes each output once, Q.14-rounded."""
    shape = _shape("16 channels", seed=7)
    taps = shape.taps
    assert taps.body == "bank"
    plan = taps.plan
    vals = _vals(shape)
    rows = shape.block.numel() // plan.row
    tr, cr, opr, nr_ch = taps.tile_rows, plan.cr_rows, plan.opr, \
        plan.nr_channels
    hc = plan.halfcols
    n_oct = taps.tiles_per_block // (2 * opr)
    cpb = 8 * n_oct
    n_sub = -(-nr_ch // cpb)
    w = packed_fir.tap_matrix_i16(plan).astype(np.int64)
    out = np.zeros((2, rows, hc) if kind == "fir" else (rows, hc), np.int64)
    count = np.zeros(out.shape, np.int64)
    for s in range(n_sub):
        c0 = s * cpb
        for t in range(-(-rows // tr)):
            r0 = t * tr
            n_out = min(tr, rows - r0)
            x = _rows(vals, r0 - 1, tr + 1 + cr, plan.row)
            if kind != "fir":
                item = np.arange(n_out * opr * cpb)
                lr = 1 + item // (opr * cpb)
                rem = item - (lr - 1) * opr * cpb
                j, c = rem // cpb, c0 + rem % cpb
                ok = c < nr_ch
                col = j * nr_ch + c
                out[(r0 + lr - 1)[ok], col[ok]] = _bank_value(
                    x, kind, lr, col, cr)[ok]
                count[(r0 + lr - 1)[ok], col[ok]] += 1
                continue
            win = np.stack([x[lr:lr + cr + 1].reshape(-1)[:plan.win]
                            for lr in range(tr + 1)])
            acc = _wrap32(win @ w)
            for warp in range(16):
                item, h = warp >> 1, warp & 1
                mt, o = divmod(item, n_oct)
                js = opr // 2
                for j in range(js if h else 0, opr if h else js):
                    for lane in range(32):
                        g, tt = lane >> 2, lane & 3
                        for i in range(4):
                            lr = 16 * mt + g + 8 * (i >> 1)
                            c = c0 + 8 * o + 2 * tt + (i & 1)
                            if lr < 1 or lr > n_out or c >= nr_ch:
                                continue
                            at = (r0 + lr - 1, j * nr_ch + c)
                            for ri in range(2):
                                out[(ri,) + at] = _q14(
                                    acc[lr, (ri * opr + j) * nr_ch + c])
                                count[(ri,) + at] += 1
    assert (count == 1).all()
    fn = {"copy": lab.copy_plain, "split": lab.split_plain,
          "fir": lab.fir_plain}[kind]
    np.testing.assert_array_equal(out, fn(taps, shape.carry,
                                          shape.block).numpy())


def test_launch_tiles_fit_and_say_what_they_cut():
    """par<k> fits k CTAs an SM; ring<n> fits n raw row buffers; at the
    pager block neither ring keeps the shipped 255-row tile beside its
    staged taps (the lab prints the tile it runs, and times ``full``
    there too)."""
    taps = lab.pager_chain("cpu").taps
    plan = taps.plan
    row, cr, hc = plan.row, plan.cr_rows, plan.halfcols
    for name in ("par2", "par4", "ring2", "ring4"):
        v = lab.VARIANTS["tile", name]
        tr, staged = lab.launch_tile(v, taps)
        assert (tr + 1) % 16 == 0
        if v.nbuf:   # raw row buffers beside the accumulator planes
            smem = v.nbuf * (tr + 1 + cr) * (2 * row + 16) \
                + 2 * (tr + 1) * hc * 4
            cap = lab.SMEM_BLOCK
        else:
            smem = k1.smem_bytes(tr, row, cr, hc)
            cap = lab.SMEM_SM // v.ctas - lab.SMEM_RESERVED
        assert smem + (taps.tap_block_bytes if staged else 0) <= cap, name
        if v.nbuf:
            assert tr < taps.tile_rows
    assert lab.launch_tile(lab.VARIANTS["tile", "full"], taps) == (255, True)
    assert lab.depth_chunk(640) == 22 and 8 * 22 * 1280 <= lab.SMEM_BLOCK


def _jax_copy(block_rows, hc):
    """bench/pallas_parts_lab.py copy_kernel over its grid: each tile's
    rows, their first halfcols values (``+ s * 0``)."""
    return block_rows[:, :hc] + jnp.sum(block_rows[:, :hc], axis=1,
                                        keepdims=True) * 0


def _jax_conv(block_rows, carry_rows, tr, cr, hc):
    """bench/pallas_parts_lab.py conv_kernel, grid step by grid step: the
    head (the carry for step 0, else the previous tile's last 1 + cr rows)
    and the tile as float32, out = the window from its second row, its
    first tr rows' first halfcols values."""
    out = []
    for i in range(block_rows.shape[0] // tr):
        xa = block_rows[i * tr:(i + 1) * tr]
        head = carry_rows if i == 0 else block_rows[i * tr - 1 - cr:i * tr]
        x = jnp.concatenate([head.astype(jnp.float32),
                             xa.astype(jnp.float32)])
        out.append(x[1:1 + tr, :hc].astype(jnp.int16))
    return jnp.concatenate(out)


@pytest.mark.parametrize("name", ["pager", "8 channels"])
def test_copy_and_split_plain_match_the_jax_lab(name):
    shape = _shape(name, full_scale=False)
    plan = shape.taps.plan
    tr = 16
    rows = shape.block.numel() // plan.row // tr * tr
    block = shape.block[:rows * plan.row]
    block_rows = jnp.asarray(block.numpy().reshape(rows, plan.row))
    # PallasChain's carry: a zero look-back row, then the cr rows
    carry_rows = jnp.asarray(np.concatenate([
        np.zeros((1, plan.row), np.int16),
        shape.carry.numpy().reshape(plan.cr_rows, plan.row)]))
    hc = plan.halfcols
    np.testing.assert_array_equal(
        lab.copy_plain(shape.taps, shape.carry, block).numpy(),
        np.asarray(_jax_copy(block_rows, hc)))
    np.testing.assert_array_equal(
        lab.split_plain(shape.taps, shape.carry, block).numpy(),
        np.asarray(_jax_conv(block_rows, carry_rows, tr, plan.cr_rows, hc)))


def _jax_plan(name):
    """The JAX package's chain at one of the lab's shapes."""
    import tsl_sdr_tpu.models.channelizer as jch
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass
    from tsl_sdr_tpu_torch.testing import pager

    if name == "pager":
        return jch.MultifmChain(pager.lpf_taps(), list(pager.OFFSETS_HZ),
                                pager.FS, pager.DECIMATION, exact=False)
    fs = 1_000_000
    offs = np.random.default_rng(0).integers(-fs // 3, fs // 3,
                                             size=int(name.split()[0]))
    return jch.MultifmChain(firdes_low_pass(1.0, fs, 12_500, 9_000)[:128],
                            offs, fs, 40, exact=False)


@pytest.mark.parametrize("name", ["pager", "8 channels", "16 channels"])
def test_fir_plain_matches_packed_fir_step_exact(name):
    shape = _shape(name, seed=9)
    jchain = _jax_plan(name)
    _, a_re, a_im = jpf.packed_fir_step_exact(
        jchain.packed_plan, jnp.asarray(shape.carry.numpy()),
        shape.block.numpy())
    got = lab.fir_plain(shape.taps, shape.carry, shape.block).numpy()
    np.testing.assert_array_equal(got[0], np.asarray(a_re))
    np.testing.assert_array_equal(got[1], np.asarray(a_im))


@pytest.mark.parametrize("name", ["pager", "8 channels"])
def test_k1_plain_matches_pallas_interpret(name):
    """What ``carryful``, ``ring2``/``ring4``, ``streams*full`` and
    ``par*`` compute (K1's plain version) against the Pallas kernel in
    interpret mode at 16-row tiles over three grid steps."""
    shape = _shape(name, seed=4, full_scale=False)
    taps = shape.taps
    plan = taps.plan
    rows = 48
    block = shape.block[:rows * plan.row]
    pal = PallasChain(_jax_plan(name).packed_plan,
                      taps.omega_c.numpy(), interpret=True,
                      precision="highest")
    pal.tr = 16
    carry = np.concatenate([np.zeros((1, plan.row), np.int16),
                            shape.carry.numpy().reshape(-1, plan.row)])
    _, want = pal.step(jnp.asarray(carry), block.numpy())
    prev = torch.zeros((2, plan.nr_channels), dtype=torch.float32)
    got, _ = k1.chain_fm_plain(taps, shape.carry, prev, block)
    c = plan.nr_channels
    d = np.abs(np.asarray(want, np.int32).reshape(-1)[c:]
               - got.numpy().astype(np.int32).reshape(-1)[c:])
    d = np.minimum(d, 32768 - d)
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() > 0.99
