"""Wide channel banks: the port's phase-grouped FIR and K1/K5's channel
blocks against the JAX package, on the CPU.

The shapes are the JAX package's own: BENCH_SUITE's channelizer rows (1
Msps, decimation 40, 128 taps; 8, 16, 64 and 256 channels,
``bench_suite.py`` ``prep_multifm``), ``etc/multifm_rtlsdr_8ch.json`` as it
is and widened to 64 channels, ``etc/multifm_airspy.json`` widened to the
232 12.5 kHz channels of its +-1.45 MHz, the 8-channel pager deployment and
its decimation-50 band.

Bars:
- plans, the form's choice and ``grouped_fir_sums``: EQUAL to the JAX
  package's (numpy fields; int32 sums bit for bit: integer sums do not
  depend on their order);
- ``MultifmChain``: the exact tier's PCM bit-equal to JAX's, the production
  tier's within 1 PCM LSB of the XLA tier's (the port's polynomial atan2
  against XLA's arctan2, tests/test_torch_chain.py);
- the kernels' operands (launch shape, k-ranges, compact planes, channel
  blocks): what the CUDA kernel reads is the tap matrix, whole, and every
  launch fits in 227 KB of shared memory; an emulation of the kernel's
  indexing from those operands gives the plain version's sums EXACTLY.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models.channelizer import MultifmChain as JaxChain
from tsl_sdr_tpu.ops import packed_fir as jpf
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.ops import fm, imma_split, packed_fir
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.utils.convert import plan_from_jax

ETC = Path(__file__).resolve().parents[1] / "etc"


def _bench(c):
    fs = 1_000_000
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:128]
    offs = np.random.default_rng(0).integers(-fs // 3, fs // 3, size=c)
    return lpf, offs, fs, 40


def _config(name, nr_ch=None, spacing=12_500.0, span=None):
    cfg = json.loads((ETC / name).read_text())
    offs = [ch["chanCenterFreq"] - cfg["centerFreqHz"]
            for ch in cfg.get("channels", [])]
    if nr_ch is not None:
        lo = -span if span else -spacing * (nr_ch // 2)
        offs = lo + spacing * np.arange(nr_ch)
    return (np.asarray(cfg["lpfTaps"]), np.asarray(offs, np.float64),
            cfg["sampleRateHz"], cfg["decimationFactor"])


SHAPES = {
    "bench_8ch": lambda: _bench(8),
    "bench_16ch": lambda: _bench(16),
    "bench_64ch": lambda: _bench(64),
    "bench_256ch": lambda: _bench(256),
    "rtlsdr_8ch": lambda: _config("multifm_rtlsdr_8ch.json"),
    "rtlsdr_64ch": lambda: _config("multifm_rtlsdr_8ch.json", 64),
    "airspy_232ch": lambda: _config("multifm_airspy.json", 232,
                                    span=1_450_000),
    "pager": lambda: (pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS,
                      pager.DECIMATION),
    "pager_dec50": lambda: (pager.dec50_lpf_taps(), pager.OFFSETS_HZ[:6],
                            pager.FS, pager.DEC50_DECIMATION),
}
# (grouped, K1's launch shape) of each; the pager's two shapes are the
# launches K1 had before channel blocks (one block of all channels); at
# BENCH_SUITE's 16-256 channels K1 takes the bank body (sub-blocks of 16
# channels, 63-row tiles, taps resident), where the tile body read its
# taps from L2
EXPECTED = {
    "bench_8ch": (False, (111, 8)),
    "bench_16ch": (True, (63, 16)),
    "bench_64ch": (True, (63, 16)),
    "bench_256ch": (True, (63, 16)),
    "rtlsdr_8ch": (False, (111, 8)),
    "rtlsdr_64ch": (True, (31, 64)),
    "airspy_232ch": (True, (31, 48)),
    "pager": (False, (255, 8)),
    "pager_dec50": (True, (15, 6)),
}


def _plans(shape):
    args = SHAPES[shape]()
    return packed_fir.make_packed_fir_plan(*args), jpf.make_packed_fir_plan(
        *args)


def _iq(n, seed, scale=9000):
    rng = np.random.default_rng(seed)
    return rng.integers(-scale, scale, size=(n, 2), dtype=np.int64).astype(
        np.int16)


def _lsb_diff(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return np.minimum(d, 32768 - d)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_grouped_plan_and_choice_match_jax(shape):
    plan, jplan = _plans(shape)
    assert packed_fir.grouped_fir_worthwhile(plan) == \
        jpf.grouped_fir_worthwhile(jplan) == EXPECTED[shape][0]
    got = packed_fir.make_grouped_from_plan(plan)
    want = plan_from_jax(jpf.make_grouped_from_plan(jplan))
    assert type(want) is packed_fir.GroupedFirPlan
    for field in packed_fir.GroupedFirPlan._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("shape", ["bench_16ch", "bench_64ch"])
def test_grouped_sums_match_jax_and_chunked(shape):
    """Three uneven streaming steps, full-scale input: the port's grouped
    sums equal the JAX package's ``_grouped_matmul`` and the chunked sums
    bit for bit (carries threaded as the streaming step threads them)."""
    plan, jplan = _plans(shape)
    gplan = packed_fir.make_grouped_from_plan(plan)
    jg = jpf.make_grouped_from_plan(jplan)
    wg = torch.from_numpy(gplan.wg_i16.astype(np.float64))
    w = torch.from_numpy(np.stack(plan.w_chunks_i16).astype(np.float64))
    q = plan.block_quantum
    x = _iq(plan.carry_len + 29 * q, 3, scale=32768)
    x[:40] = -32768
    carry = torch.from_numpy(x[:plan.carry_len].reshape(-1).copy())
    pos = plan.carry_len
    for nq in (5, 17, 7):
        blk = torch.from_numpy(x[pos:pos + nq * q].reshape(-1).copy())
        got = packed_fir.grouped_fir_sums(plan, gplan, carry, blk, wg)
        rows = torch.cat([carry, blk]).view(-1, plan.row).numpy()
        want = jpf._grouped_matmul(
            rows, jg.wg_i16, r_valid=rows.shape[0] - plan.cr_rows,
            row=plan.row, spill=jg.spill, g=jg.g, n_groups=jg.n_groups,
            win_g=jg.win_g, d=plan.decimation, nr_ch=plan.nr_channels)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, packed_fir.packed_fir_sums(plan, carry, blk,
                                                           w))
        assert got.shape == (nq * q * 2 // plan.row, 2 * plan.halfcols)
        carry = packed_fir.next_carry(carry, blk, plan.carry_vals)
        pos += nq * q


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_chain_picks_the_form_as_jax(shape):
    args = SHAPES[shape]()
    got = MultifmChain(*args, device="cpu")
    want = JaxChain(*args, exact=False, backend="xla")
    assert (got.grouped_plan is None) == (want.grouped_plan is None)
    assert got.taps.grouped == (want.grouped_plan is not None)
    if want.grouped_plan is not None:
        for field in packed_fir.GroupedFirPlan._fields:
            np.testing.assert_array_equal(
                getattr(got.grouped_plan, field),
                np.asarray(getattr(want.grouped_plan, field)))


@pytest.mark.parametrize("shape", ["bench_64ch", "bench_256ch"])
def test_wide_chain_matches_jax_both_tiers(shape):
    """The exact tier's PCM bit-equal to JAX's, the production tier's (three
    uneven steps, state threaded) within 1 LSB of the XLA tier's."""
    args = SHAPES[shape]()
    ch = MultifmChain(*args, exact=True, device="cpu")
    q, c_len = ch.block_quantum, ch.carry_len
    x = _iq(c_len + 45 * q, 4)
    want = JaxChain(*args, exact=True).process_array(x, block_size=16 * q)
    got = ch.process_array(x, block_size=16 * q)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_array_equal(got, want)

    ref = JaxChain(*args, exact=False, backend="xla")
    fast = MultifmChain(*args, device="cpu")
    js = ref.init_state(prefix=x[:c_len])
    ts = fast.init_state(prefix=x[:c_len])
    pos, outs_j, outs_t = c_len, [], []
    for nq in (10, 25, 10):
        blk = x[pos:pos + nq * q].reshape(-1)
        js, pj = ref._step_raw(js, blk)
        ts, pt = fast._step_raw(ts, torch.from_numpy(blk.copy()))
        outs_j.append(np.asarray(pj))
        outs_t.append(pt.numpy())
        pos += nq * q
    diff = _lsb_diff(np.concatenate(outs_j), np.concatenate(outs_t))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    np.testing.assert_array_equal(np.asarray(js.prev_r), ts.prev_r.numpy())
    np.testing.assert_array_equal(np.asarray(js.prev_i), ts.prev_i.numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_launch_shape_fits_and_keeps_narrow_launches(shape):
    """Every shape gets a K1 launch that fits 227 KB (256 and 232 channels
    in channel blocks of a multiple of 8); the shapes that fit one block
    keep it; the pager's two launches are those of one block of all
    channels; the bank body is taken only where the tile body would read
    its taps from L2, and then with its taps resident and 8 items a
    tile."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu")
    tr, cpb = taps.tile_rows, taps.chans_per_block
    assert (taps.grouped, (tr, cpb)) == EXPECTED[shape]
    assert (tr + 1) % 16 == 0
    if taps.body == "bank":
        assert cpb % 8 == 0 and (tr + 1) // 16 * cpb // 8 == 8
        need = (taps.tap_block_bytes + taps.stages * k1.bank_x_bytes(
            tr + 1, plan.row, plan.cr_rows) + taps.tiles_per_block * 16
            + (8 * 2 * 16 * 8 * 2 + plan.opr * cpb) * 4)
        assert need <= 227 * 1024
        # the tile body's launch would not have staged its taps
        w = packed_fir.tap_matrix_i16(plan)

        def tile_taps(c):
            return k1.block_tap_bytes(k1.tile_ranges(
                w, k1.channel_block_columns(plan.opr, plan.nr_channels, c),
                taps.grouped), plan.nr_channels, c)

        ttr, tcpb = k1.launch_shape(plan.row, plan.cr_rows, plan.nr_channels,
                                    plan.opr, tile_taps)
        assert k1.smem_bytes(ttr, plan.row, plan.cr_rows, plan.opr * tcpb) \
            + tile_taps(tcpb) > 227 * 1024
        return
    need = k1.smem_bytes(tr, plan.row, plan.cr_rows, plan.opr * cpb)
    assert need <= 227 * 1024
    if cpb < plan.nr_channels:
        assert cpb % 8 == 0
        # the widest block that fits beside a 16-row tile would not fit
        # one block of all channels
        assert k1.smem_bytes(15, plan.row, plan.cr_rows,
                             plan.halfcols) > 227 * 1024


def test_launch_shape_raises_naming_the_shape():
    with pytest.raises(ValueError, match="row=3200.*64 channels"):
        k1.launch_shape(3200, 20, 64, 32, lambda cpb: 0)


# K5's own launch: (tile rows, n8 tiles a sub-block, row buffers, taps
# resident)
EXPECTED_K5 = {
    "bench_8ch": (160, 16, 1, False),
    "bench_16ch": (32, 32, 1, True),
    "bench_64ch": (32, 32, 2, True),
    "bench_256ch": (32, 32, 2, True),
    "rtlsdr_8ch": (160, 16, 1, False),
    "rtlsdr_64ch": (160, 32, 1, False),
    "airspy_232ch": (32, 32, 1, False),
    "pager": (256, 4, 2, True),
    "pager_dec50": (32, 24, 1, False),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_exact_launch_shape_is_its_own(shape):
    """K5's launch is its own: no look-back row and no f32 accumulator
    plane (shared memory: resident taps, row buffers and ktab rows only),
    tiles of whole m-tiles, 8 items a tile where the taps are resident,
    else sub-blocks of at most 8 groups reading their taps from L2. At 64
    channels its taps are resident, where K1's tile body read them from L2
    beside 31-row tiles, and its tile is taller; the pager keeps K1's
    launch (255 x 8, the tile body) and gives K5 256-row tiles beside
    resident taps."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu")
    xt = taps.exact
    assert (xt.tile_rows, xt.tiles_per_block, xt.stages, xt.staged) \
        == EXPECTED_K5[shape]
    assert xt.tile_rows % 16 == 0 and xt.tiles_per_block % 4 == 0
    need = (xt.tap_block_bytes if xt.staged else 0) + xt.stages \
        * k1.bank_x_bytes(xt.tile_rows, plan.row, plan.cr_rows) \
        + xt.tiles_per_block * 16
    assert need <= 227 * 1024
    if xt.staged:
        assert xt.tile_rows // 32 * xt.tiles_per_block // 4 % 8 == 0
    else:
        assert xt.tiles_per_block <= 32
    if shape == "bench_64ch":
        assert xt.staged and xt.tile_rows > 31
    if shape == "pager":
        assert (taps.body, taps.tile_rows, taps.chans_per_block) == (
            "tile", 255, 8)
        assert xt.tile_rows == 256 and xt.staged


def test_exact_launch_shape_raises_naming_the_shape():
    with pytest.raises(ValueError, match="row=8192, cr=20"):
        k1.exact_shape(8192, 20, np.full(4, 10))


def _kernel_taps(taps):
    """The kernel's operands as full int16 matrices: the compact planes
    expanded, unfragmented, and their columns put back in tap order."""
    plan = taps.plan
    ktab = taps.ktab.numpy()
    k_tiles = -(-plan.win // 32)
    hi, lo = imma_split.expand_groups(taps.w_hi.numpy(), taps.w_lo.numpy(),
                                      ktab[:, :2], ktab[:, 2], k_tiles,
                                      taps.tiles_per_block, 4)
    cols = k1.channel_block_columns(plan.opr, plan.nr_channels,
                                    taps.chans_per_block)
    return hi, lo, cols, k_tiles


@pytest.mark.parametrize("shape", ["bench_16ch", "bench_64ch", "bench_256ch",
                                   "airspy_232ch", "pager", "pager_dec50"])
@pytest.mark.parametrize("grouped", [True, False])
def test_kernel_operands_hold_the_whole_tap_matrix(shape, grouped):
    """K1's operands (tile body or bank body) and K5's, expanded and put
    back in tap order (and natural k order), are the tap matrix, every
    column once; every non-zero of a tile lies in its k-range, a chunked
    tile with a column runs every step; the planes hold each group's union
    of steps, each sub-block's fragments end where the next begin, and the
    widest fits the bytes the launch reserves."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu",
                        grouped=grouped)
    w = packed_fir.tap_matrix_i16(plan)
    k_tiles = -(-plan.win // 32)
    for name, ops, cols, group, tpb, raw in _bank_sets(taps):
        assert sorted(cols[cols >= 0]) == list(range(w.shape[1])), name
        ktab = ops.ktab.numpy()
        assert cols.size == 8 * len(ktab)
        wp = k1.permuted_taps(w, cols)
        np.testing.assert_array_equal(
            _full_taps(ops, cols, group, tpb, raw, plan.win), wp,
            err_msg=name)
        u = np.arange(plan.win)
        for t in range(cols.size // 8):
            nz = u[(wp[:, 8 * t:8 * t + 8] != 0).any(axis=1)]
            if nz.size:
                assert 32 * ktab[t, 0] <= nz[0] and nz[-1] < 32 * ktab[t, 1]
            if not grouped and (cols[8 * t:8 * t + 8] >= 0).any():
                assert tuple(ktab[t, :2]) == (0, k_tiles)
        spans = imma_split.group_spans(ktab[:, :2], tpb, group)
        sizes = (group * (spans[:, 1] - spans[:, 0])).reshape(
            -1, -(-tpb // group)).sum(axis=1)
        assert len(ops.w_hi) == sizes.sum(), name
        np.testing.assert_array_equal(ktab[:, 3],
                                      np.repeat(np.cumsum(sizes), tpb))
        assert ops.tap_block_bytes == sizes.max() * 512, name
        if grouped and shape.startswith("bench"):
            # 128 taps: a column's 256 values span 9 of 26 32-value steps
            assert (ktab[:, 1] - ktab[:, 0]).max() <= 9 and k_tiles == 26


def _emulate_kernel(taps, carry, block):
    """K5's raw sums as the CUDA kernel forms them from its operands: for
    each channel block and 8-column tile, the products of the k-steps in
    the tile's range only, read from the compact planes at its group's
    base (fragment ``base + 4*ks + j``), each column written by the
    kernel's index arithmetic."""
    plan = taps.plan
    hc, nr_ch, cpb = plan.halfcols, plan.nr_channels, taps.chans_per_block
    hcb = plan.opr * cpb
    ntb = -(-2 * hcb // 8)
    vals = np.concatenate([carry, block]).astype(np.int64)
    rows = block.size // plan.row
    k_tiles = -(-plan.win // 32)
    vals = np.concatenate([vals, np.zeros(32 * k_tiles, np.int64)])
    x = np.lib.stride_tricks.sliding_window_view(vals, 32 * k_tiles)[
        ::plan.row][:rows]
    ktab = taps.ktab.numpy()
    out = np.zeros((rows, 2 * hc), np.int64)
    for t, (lo_, hi_, base, _) in enumerate(ktab):
        if hi_ <= lo_:
            continue
        n = hi_ - lo_
        f = base + 4 * np.arange(lo_, hi_) + t % ntb % 4
        wt = imma_split.unfragment(taps.w_hi.numpy()[f, None],
                                   taps.w_lo.numpy()[f, None], 32 * n, 8)
        s = x[:, 32 * lo_:32 * hi_] @ wt.astype(np.int64)
        b, lt = divmod(t, ntb)
        for e in range(8):
            lc = lt * 8 + e
            if lc >= 2 * hcb:
                continue
            ri, rem = divmod(lc, hcb)
            jj, cl = divmod(rem, cpb)
            c = b * cpb + cl
            if c < nr_ch:
                out[:, ri * hc + jj * nr_ch + c] = s[:, e]
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.mark.parametrize("shape", ["bench_16ch", "bench_64ch", "bench_256ch",
                                   "airspy_232ch", "pager", "pager_dec50"])
@pytest.mark.parametrize("grouped", [True, False])
def test_kernel_emulation_equals_plain(shape, grouped):
    """K1's product (tile body or bank body) and K5's (the bank body: its
    sub-blocks, resident or L2 taps, raw k order, a persistent grid of 5
    blocks over the units), emulated from their operands on full-scale
    input with a ragged last tile, equal the plain version's wrapped int32
    sums exactly (the grouped form's and the chunked form's are the same);
    K5 at its tallest tile and at the tile launch_rows cuts it to for so
    short a block on 132 SMs."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu",
                        grouped=grouped)
    xt = taps.exact
    carry, block = _bank_block(plan, max(taps.tile_rows, xt.tile_rows), 5)
    want = taps.fir_sums(torch.from_numpy(carry.copy()),
                         torch.from_numpy(block.copy())).numpy()
    if taps.body == "tile":
        got = _emulate_kernel(taps, carry, block)
    else:
        got = _emulate_k1_bank_sums(taps, carry, block)
    np.testing.assert_array_equal(got, want)
    rows = block.size // plan.row
    cut = xt.launch_rows(rows, 132)
    assert cut % 16 == 0 and (cut == 16 or xt.n_sub * -(-rows // cut) >= 132)
    for tr in sorted({xt.tile_rows, cut}):
        np.testing.assert_array_equal(
            _emulate_bank_k5(taps, carry, block, tr), want)


@pytest.mark.parametrize("shape", ["bench_256ch", "airspy_232ch",
                                   "pager_dec50", "pager"])
def test_channel_block_fm_history_is_flat_index_minus_c(shape):
    """K1's FM epilogue reads each output's history inside its channel
    block's accumulators (the same channel one phase back, or the last
    phase of the look-back row); that is the plain version's flat index
    minus C for every output of every block."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu")
    nr_ch, cpb, opr = plan.nr_channels, taps.chans_per_block, plan.opr
    hcb = opr * cpb
    for b in range(-(-nr_ch // cpb)):
        lr, rem = np.meshgrid(np.arange(1, 4), np.arange(hcb),
                              indexing="ij")
        jj, cl = np.divmod(rem, cpb)
        c = b * cpb + cl
        keep = c < nr_ch
        # the kernel: local (row, column) of the history
        h_lr = np.where(jj > 0, lr, lr - 1)
        h_rem = np.where(jj > 0, rem - cpb, rem + hcb - cpb)
        h_j, h_cl = np.divmod(h_rem, cpb)
        kernel_flat = (h_lr * opr + h_j) * nr_ch + b * cpb + h_cl
        plain_flat = (lr * opr + jj) * nr_ch + c - nr_ch
        np.testing.assert_array_equal(kernel_flat[keep], plain_flat[keep])


def test_compact_groups_round_trip():
    """Two blocks of 5 tiles in groups of 4 (the second group of each is
    short): each group keeps the union of its tiles' steps, its tiles side
    by side; expanded, every tile's own steps come back."""
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 256, size=(7, 10, 32, 8), dtype=np.uint8)
    lo = rng.integers(0, 256, size=(7, 10, 32, 8), dtype=np.uint8)
    ranges = np.array([[0, 7], [2, 5], [0, 0], [6, 7], [3, 3],
                       [1, 2], [1, 3], [2, 4], [1, 2], [0, 0]])
    spans = imma_split.group_spans(ranges, 5, 4)
    np.testing.assert_array_equal(spans, [[0, 7], [0, 0], [1, 4], [0, 0]])
    ch, cl, base, end = imma_split.compact_groups(hi, lo, ranges, 5, 4)
    assert ch.shape == (4 * (7 + 3), 32, 8)
    assert list(base) == [0] * 4 + [28] + [24] * 4 + [40]
    assert list(end) == [28] * 5 + [40] * 5
    np.testing.assert_array_equal(ch[base[6] + 4 * 2 + 1], hi[2, 6])
    eh, el = imma_split.expand_groups(ch, cl, ranges, base, 7, 5, 4)
    for got, src in ((eh, hi), (el, lo)):
        for t, (a, b) in enumerate(ranges):
            np.testing.assert_array_equal(got[a:b, t], src[a:b, t])
            assert not got[:a, t].any() and not got[b:, t].any()


def test_tap_support_covers_the_taps():
    """The plan's layout puts taps only where ``tap_support`` says, and
    ``with_taps_i16`` round-trips the tap matrix."""
    for shape in ("bench_64ch", "pager", "airspy_232ch"):
        plan, _ = _plans(shape)
        w = packed_fir.tap_matrix_i16(plan)
        assert not w[~packed_fir.tap_support(plan)].any()
        w2 = np.where(packed_fir.tap_support(plan), 1, 0).astype(np.int16)
        np.testing.assert_array_equal(packed_fir.tap_matrix_i16(
            packed_fir.with_taps_i16(plan, w2)), w2)


def test_grouped_counter_only_counts_card_launches():
    """A CPU tensor runs the plain version: no counter moves."""
    args = SHAPES["bench_64ch"]()
    ch = MultifmChain(*args, device="cpu")
    assert ch.taps.grouped
    before = (k1.chain_fm.launches, k1.chain_fm.grouped_launches,
              k1.chain_fm.bank_launches)
    st = ch.init_state()
    k1.chain_fm(ch.taps, st.carry_vals, torch.stack([st.prev_r, st.prev_i]),
                torch.from_numpy(_iq(2 * ch.block_quantum, 6).reshape(-1)))
    assert ch.taps.body == "bank"
    assert (k1.chain_fm.launches, k1.chain_fm.grouped_launches,
            k1.chain_fm.bank_launches) == before


# -- the bank body (csrc/bank.cu): K5 everywhere, K1 where its taps stay
# resident --------------------------------------------------------------

def _bank_sets(taps):
    """Each operand set the kernels read, with what the kernel assumes of
    it: (name, operands, column order, group, tiles a sub-block, raw k
    order). K1's is the tile body's (channel blocks, groups of 4) or the
    bank body's (octets, groups of 2, k-permuted); K5's the tap matrix's
    own order in groups of 4, k-permuted."""
    plan = taps.plan
    xt = taps.exact
    if taps.body == "tile":
        k1_cols = k1.channel_block_columns(plan.opr, plan.nr_channels,
                                           taps.chans_per_block)
        k1_set = ("K1 tile", taps, k1_cols, 4, taps.tiles_per_block, False)
    else:
        k1_set = ("K1 bank", taps, _padded(k1.octet_columns(
            plan.opr, plan.nr_channels), taps.tiles_per_block), 2,
            taps.tiles_per_block, True)
    k5_cols = _padded(k1.channel_block_columns(
        plan.opr, plan.nr_channels, plan.nr_channels), xt.tiles_per_block)
    return [k1_set, ("K5", xt, k5_cols, 4, xt.tiles_per_block, True)]


def _padded(cols, tiles_per_block):
    """Columns padded with -1 to whole sub-blocks."""
    return np.concatenate([cols, np.full(-cols.size % (8 * tiles_per_block),
                                         -1)])


def _full_taps(ops, cols, group, tpb, raw, win):
    """The operand set's compact planes expanded to the full int16 matrix
    in its column order and natural k order."""
    ktab = ops.ktab.numpy()
    k_tiles = -(-win // 32)
    hi, lo = imma_split.expand_groups(ops.w_hi.numpy(), ops.w_lo.numpy(),
                                      ktab[:, :2], ktab[:, 2], k_tiles, tpb,
                                      group)
    w = imma_split.unfragment(hi, lo, 32 * k_tiles, cols.size)
    if raw:
        back = np.empty_like(w)
        back[imma_split.raw_k_order(len(w))] = w
        w = back
    return w[:win]


def _stage(vals, plan, s0, n):
    """Stream rows [s0, s0 + n) of carry ++ block, zeros outside."""
    total = vals.size // plan.row
    out = np.zeros((n, plan.row), np.int64)
    lo, hi = max(s0, 0), min(s0 + n, total)
    if hi > lo:
        out[lo - s0:hi - s0] = vals.reshape(-1, plan.row)[lo:hi]
    return out


def _item_sums(x, frags, rows0, n_rows, lo, hi, group, kpr):
    """One item's products as the bank body forms them: at k-step ks the
    A operand is staged row rows0 + q (ks = kpr * q + kk), values 32 kk ..
    in the raw k order, against the group's fragments of that step."""
    hi_p, lo_p, base = frags
    rko = imma_split.raw_k_order(32)
    acc = np.zeros((n_rows, 8 * group), np.int64)
    for ks in range(lo, hi):
        q, kk = divmod(ks, kpr)
        a = x[rows0 + q:rows0 + q + n_rows, 32 * kk:32 * kk + 32][:, rko]
        f = base + group * ks + np.arange(group)
        b = imma_split.unfragment(hi_p[f][None], lo_p[f][None], 32,
                                  8 * group)
        acc += a @ b.astype(np.int64)
    return acc


def _emulate_bank_k5(taps, carry, block, tr, n_blocks=5):
    """K5's raw sums as the bank body forms them: ``n_blocks`` persistent
    blocks, each an even run of (sub-block, row tile) units; at each
    sub-block it reads that sub-block's fragments only (from the end of
    the previous one's), stages its tile's rows [r0, r0 + tr + cr) and
    runs each group of 4 tiles over the union of their k-steps (in raw k
    order); columns written by the kernel's index arithmetic."""
    plan, xt = taps.plan, taps.exact
    ktab = xt.ktab.numpy()
    tpb = xt.tiles_per_block
    rows = block.size // plan.row
    hc, win = plan.halfcols, plan.win
    kpr, ksteps = plan.row // 32, -(-win // 32)
    vals = np.concatenate([carry, block]).astype(np.int64)
    n_sub, tiles = len(ktab) // tpb, -(-rows // tr)
    units = n_sub * tiles
    out = np.zeros((rows, 2 * hc), np.int64)
    written = np.zeros((rows, 2 * hc), bool)
    for bi in range(n_blocks):
        for u in range(units * bi // n_blocks, units * (bi + 1) // n_blocks):
            s, t = divmod(u, tiles)
            tab = ktab[s * tpb:(s + 1) * tpb]
            tap0 = ktab[s * tpb - 1, 3] if s else 0
            if xt.staged:
                assert (tab[0, 3] - tap0) * 512 <= xt.tap_block_bytes
            frags = (xt.w_hi.numpy()[tap0:tab[0, 3]],
                     xt.w_lo.numpy()[tap0:tab[0, 3]])
            r0 = t * tr
            n_out = min(tr, rows - r0)
            x = _stage(vals, plan, r0, tr + plan.cr_rows)
            for g in range(tpb // 4):
                grp = tab[4 * g:4 * g + 4]
                live = grp[:, 0] < np.minimum(grp[:, 1], ksteps)
                if not live.any():
                    continue
                lo = grp[live, 0].min()
                hi = np.minimum(grp[live, 1], ksteps).max()
                acc = _item_sums(x, frags + (grp[0, 2] - tap0,), 0, tr, lo,
                                 hi, 4, kpr)
                lc = (s * tpb + 4 * g) * 8 + np.arange(32)
                keep = lc < 2 * hc
                out[r0:r0 + n_out, lc[keep]] = acc[:n_out, keep]
                written[r0:r0 + n_out, lc[keep]] = True
    # an all-zero group is skipped: its columns stay 0, as the kernel's do
    zero = np.ones(2 * hc, bool)
    zero[:] = ~written.any(axis=0)
    assert written[:, ~zero].all()
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _bank_fm_operands(taps, octets):
    """K1's bank-body operands at any shape, ``octets`` octets a sub-block
    (the launch ChainTaps takes at BENCH_SUITE's widths; forced here at
    the others): (w_hi, w_lo, ktab, tiles a sub-block, tile rows)."""
    plan = taps.plan
    w = packed_fir.tap_matrix_i16(plan)
    cols = k1.octet_columns(plan.opr, plan.nr_channels)
    ranges = k1.tile_ranges(w, cols, taps.grouped)
    tpb = 2 * plan.opr * octets
    pad = -len(ranges) % tpb
    hi, lo, ktab, _ = k1.operands(
        w, np.concatenate([cols, np.full(8 * pad, -1)]),
        np.concatenate([ranges, np.zeros((pad, 2), np.int64)]), tpb, 2,
        True)
    return hi, lo, ktab, tpb, 8 // octets * 16 - 1


def _emulate_bank_fm(taps, carry, block, prev, ops, n_blocks=3):
    """K1's PCM and carry as the bank body forms them: units as K5's; a
    tile's rows [r0 - 1, r0 + tr + cr) (local row 0 the look-back row);
    8 items (m-tile, octet), each two warps: half 0 walks phases [0, opr /
    2), half 1 the rest, each output's history its previous phase in the
    same thread; each half's last phase goes to the edge plane, from which
    half 1's first phase takes phase opr / 2 - 1 (same row) and phase 0
    takes phase opr - 1 one row up (the m-tile above's row 15 for row 0;
    prev[] for output row 0). Returns (pcm, prev_out)."""
    plan = taps.plan
    w_hi, w_lo, ktab, tpb, tr = ops
    nr_ch, opr, hc = plan.nr_channels, plan.opr, plan.halfcols
    n_oct = tpb // (2 * opr)
    cpb = 8 * n_oct
    rows = block.size // plan.row
    kpr, ksteps = plan.row // 32, -(-plan.win // 32)
    om = taps.omega_c.numpy()
    vals = np.concatenate([carry, block]).astype(np.int64)
    n_sub, tiles = len(ktab) // tpb, -(-rows // tr)
    units = n_sub * tiles
    js = opr // 2
    jobs = []   # (out row, column, channel, cur re, im, hist re, im)
    prev_out = np.full((2, nr_ch), np.nan, np.float32)

    def wrap(a):
        return ((a + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32).astype(
            np.float32)

    for bi in range(n_blocks):
        for u in range(units * bi // n_blocks, units * (bi + 1) // n_blocks):
            s, t = divmod(u, tiles)
            tab = ktab[s * tpb:(s + 1) * tpb]
            tap0 = ktab[s * tpb - 1, 3] if s else 0
            frags = (w_hi[tap0:tab[0, 3]], w_lo[tap0:tab[0, 3]])
            r0 = t * tr
            n_out = min(tr, rows - r0)
            x = _stage(vals, plan, r0 - 1, tr + 1 + plan.cr_rows)
            edge = np.zeros((8, 2, 16, 8, 2), np.float32)
            first = {}
            for item in range(8):
                mt, o = divmod(item, n_oct)
                for h, (jb, je) in enumerate(((0, js), (js, opr))):
                    hist = None
                    for j in range(jb, je):
                        grp = tab[(o * opr + j) * 2:(o * opr + j) * 2 + 2]
                        live = grp[:, 0] < np.minimum(grp[:, 1], ksteps)
                        acc = np.zeros((16, 16), np.int64)
                        if live.any():
                            acc = _item_sums(
                                x, frags + (grp[0, 2] - tap0,), 16 * mt, 16,
                                grp[live, 0].min(),
                                np.minimum(grp[live, 1], ksteps).max(), 2,
                                kpr)
                        cur = (wrap(acc[:, :8]), wrap(acc[:, 8:]))
                        if j == jb:
                            first[item, h] = cur
                        else:
                            jobs.append((r0, mt, o, j, cur, hist, n_out,
                                         s))
                        hist = cur
                    if je > jb:
                        edge[item, h] = np.stack(hist, axis=-1)
                        lr = 16 * mt + np.arange(16)
                        hit = (r0 + n_out == rows) & (lr == n_out)
                        c = s * cpb + 8 * o + np.arange(8)
                        if h == 1 and hit.any():
                            ok = c < nr_ch
                            prev_out[0, c[ok]] = hist[0][hit][0][ok]
                            prev_out[1, c[ok]] = hist[1][hit][0][ok]
            for (item, h), cur in first.items():
                mt, o = divmod(item, n_oct)
                j = js if h else 0
                if j > 0:
                    hr, hi_ = edge[item, 0, ..., 0], edge[item, 0, ..., 1]
                else:
                    above = edge[max(item - n_oct, 0), 1, 15]
                    hr = np.concatenate([above[None, :, 0],
                                         edge[item, 1, :15, :, 0]])
                    hi_ = np.concatenate([above[None, :, 1],
                                          edge[item, 1, :15, :, 1]])
                jobs.append((r0, mt, o, j, cur, (hr, hi_), n_out, s))
    pcm = np.full((rows, hc), -99999, np.int64)
    for r0, mt, o, j, cur, hist, n_out, s in jobs:
        lr = 16 * mt + np.arange(16)[:, None]
        c = s * cpb + 8 * o + np.arange(8)[None, :]
        pr = np.broadcast_to(hist[0], (16, 8)).copy()
        pi = np.broadcast_to(hist[1], (16, 8)).copy()
        first_row = (r0 + lr - 1 == 0) & (j == 0)
        cc = np.minimum(c, nr_ch - 1)
        pr = np.where(first_row, prev[0][cc], pr)
        pi = np.where(first_row, prev[1][cc], pi)
        got, _, _ = fm.fm_from_baseband(
            torch.from_numpy(cur[0].reshape(-1)),
            torch.from_numpy(cur[1].reshape(-1)),
            torch.from_numpy(pr.reshape(-1).astype(np.float32)),
            torch.from_numpy(pi.reshape(-1).astype(np.float32)),
            torch.from_numpy(np.broadcast_to(om[cc], (16, 8)).reshape(-1)))
        got = got.numpy().reshape(16, 8)
        keep = (lr >= 1) & (lr <= n_out) & (c < nr_ch)
        rr = np.broadcast_to(r0 + lr - 1, (16, 8))[keep]
        pcm[rr, (j * nr_ch + np.broadcast_to(c, (16, 8)))[keep]] = got[keep]
    assert (pcm != -99999).all()
    return pcm.astype(np.int16), prev_out


def _bank_block(plan, tr, seed):
    """Full-scale carry and a block of ``2 * tr + 5`` rows (a ragged last
    tile), the last 300 samples at -32768."""
    rows = 2 * tr + 5
    x = _iq(plan.carry_len + rows * plan.row // 2, seed, scale=32768)
    x[-300:] = -32768
    return x[:plan.carry_len].reshape(-1), x[plan.carry_len:].reshape(-1)


# octets a sub-block of K1's bank body at each shape: ChainTaps' own at
# BENCH_SUITE's widths (None), forced at the others
BANK_FM = {"bench_16ch": None, "bench_64ch": None, "bench_256ch": None,
           "airspy_232ch": 2, "pager": 1, "pager_dec50": 1}


@pytest.mark.parametrize("shape", sorted(BANK_FM))
def test_bank_fm_emulation_equals_plain(shape):
    """K1's bank body, emulated from its operands (octet order, groups of
    2 tiles, raw k order, 8 items of two half-walks, the FM history in
    registers, the edge phases, the look-back row, a ragged last tile),
    gives the plain version's PCM and carry EXACTLY: at BENCH_SUITE's
    widths with ChainTaps' own launch, and with the layout forced at the
    pager (2 phases), decimation 50 (32 phases, 6 channels) and 232
    channels (a padding octet)."""
    plan, _ = _plans(shape)
    omega = np.random.default_rng(3).uniform(-3, 3, plan.nr_channels)
    taps = k1.ChainTaps(plan, omega, device="cpu")
    if BANK_FM[shape] is None:
        assert taps.body == "bank"
        ops = (taps.w_hi.numpy(), taps.w_lo.numpy(), taps.ktab.numpy(),
               taps.tiles_per_block, taps.tile_rows)
    else:
        assert taps.body == "tile"
        ops = _bank_fm_operands(taps, BANK_FM[shape])
    carry, block = _bank_block(plan, ops[4], 6)
    prev = np.random.default_rng(7).normal(
        scale=1e5, size=(2, plan.nr_channels)).astype(np.float32)
    pcm, prev_out = _emulate_bank_fm(taps, carry, block, prev, ops)
    want, want_prev = k1.chain_fm_plain(
        taps, torch.from_numpy(carry.copy()), torch.from_numpy(prev),
        torch.from_numpy(block.copy()))
    np.testing.assert_array_equal(pcm, want.numpy())
    np.testing.assert_array_equal(prev_out, want_prev.numpy())


def _emulate_k1_bank_sums(taps, carry, block):
    """K1's sums as its bank body forms them, before the FM stage: each
    sub-block's resident fragments; a tile's rows [r0 - 1, r0 + tr + cr),
    the look-back row dropped; each m-tile by an octet's phase, its re and
    im tiles over the union of their k-steps in the raw k order; column
    (octet, phase, re/im, e) -> ri * halfcols + j * C + channel."""
    plan = taps.plan
    ktab = taps.ktab.numpy()
    tpb, tr = taps.tiles_per_block, taps.tile_rows
    nr_ch, opr, hc = plan.nr_channels, plan.opr, plan.halfcols
    n_oct = tpb // (2 * opr)
    rows = block.size // plan.row
    kpr, ksteps = plan.row // 32, -(-plan.win // 32)
    vals = np.concatenate([carry, block]).astype(np.int64)
    out = np.zeros((rows, 2 * hc), np.int64)
    for s in range(len(ktab) // tpb):
        tab = ktab[s * tpb:(s + 1) * tpb]
        tap0 = ktab[s * tpb - 1, 3] if s else 0
        assert (tab[0, 3] - tap0) * 512 <= taps.tap_block_bytes
        frags = (taps.w_hi.numpy()[tap0:tab[0, 3]],
                 taps.w_lo.numpy()[tap0:tab[0, 3]])
        for t in range(-(-rows // tr)):
            r0 = t * tr
            n_out = min(tr, rows - r0)
            x = _stage(vals, plan, r0 - 1, tr + 1 + plan.cr_rows)
            for o in range(n_oct):
                c = s * 8 * n_oct + 8 * o + np.arange(8)
                ok = c < nr_ch
                for j in range(opr):
                    grp = tab[(o * opr + j) * 2:(o * opr + j) * 2 + 2]
                    live = grp[:, 0] < np.minimum(grp[:, 1], ksteps)
                    if not live.any():
                        continue
                    acc = _item_sums(x, frags + (grp[0, 2] - tap0,), 0,
                                     tr + 1, grp[live, 0].min(),
                                     np.minimum(grp[live, 1], ksteps).max(),
                                     2, kpr)[1:n_out + 1]
                    for ri in range(2):
                        out[r0:r0 + n_out, ri * hc + j * nr_ch + c[ok]] = \
                            acc[:, 8 * ri:8 * ri + 8][:, ok]
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
