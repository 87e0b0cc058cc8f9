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
from tsl_sdr_tpu_torch.ops import imma_split, packed_fir
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
# (grouped, launch shape) of each; the pager's two shapes are the launches
# K1 and K5 had before channel blocks (one block of all channels)
EXPECTED = {
    "bench_8ch": (False, (111, 8)),
    "bench_16ch": (True, (95, 16)),
    "bench_64ch": (True, (31, 64)),
    "bench_256ch": (True, (31, 88)),
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
    """Every shape gets a launch that fits 227 KB (256 and 232 channels in
    channel blocks of a multiple of 8); the shapes that fit one block keep
    it; the pager's two launches are those of one block of all channels."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu")
    tr, cpb = taps.tile_rows, taps.chans_per_block
    assert (taps.grouped, (tr, cpb)) == EXPECTED[shape]
    assert (tr + 1) % 16 == 0
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


@pytest.mark.parametrize("shape", ["bench_16ch", "bench_256ch",
                                   "airspy_232ch", "pager", "pager_dec50"])
@pytest.mark.parametrize("grouped", [True, False])
def test_kernel_operands_hold_the_whole_tap_matrix(shape, grouped):
    """Every non-zero tap of every 8-column tile lies inside its k-range;
    the compact planes, expanded, equal the full planes of the permuted
    matrix; the permutation puts every tap column in exactly once."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu",
                        grouped=grouped)
    w = packed_fir.tap_matrix_i16(plan)
    hi, lo, cols, k_tiles = _kernel_taps(taps)
    assert sorted(cols[cols >= 0]) == list(range(w.shape[1]))
    wp = k1.permuted_taps(w, cols)
    full = imma_split.fragment_planes(wp)
    np.testing.assert_array_equal(hi, full[0])
    np.testing.assert_array_equal(lo, full[1])
    ktab = taps.ktab.numpy()
    u = np.arange(plan.win)
    for t in range(cols.size // 8):
        nz = u[(wp[:, 8 * t:8 * t + 8] != 0).any(axis=1)]
        if nz.size:
            assert 32 * ktab[t, 0] <= nz[0] and nz[-1] < 32 * ktab[t, 1]
        if not grouped and (cols[8 * t:8 * t + 8] >= 0).any():
            assert tuple(ktab[t, :2]) == (0, k_tiles)
    steps = ktab[:, 1] - ktab[:, 0]
    # the planes hold each warp group's union of steps, 4 tiles a step, and
    # each tile knows where its block's fragments end
    spans = imma_split.group_spans(ktab[:, :2], taps.tiles_per_block, 4)
    sizes = (4 * (spans[:, 1] - spans[:, 0])).reshape(
        -1, -(-taps.tiles_per_block // 4)).sum(axis=1)
    assert taps.w_hi.shape[0] == sizes.sum()
    np.testing.assert_array_equal(
        ktab[:, 3], np.repeat(np.cumsum(sizes), taps.tiles_per_block))
    assert taps.tap_block_bytes == sizes.max() * 512
    if grouped and shape.startswith("bench"):
        # 128 taps: a column's 256 values span 9 of 26 32-value steps
        assert steps.max() <= 9 and k_tiles == 26


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


@pytest.mark.parametrize("shape", ["bench_16ch", "bench_256ch",
                                   "airspy_232ch", "pager_dec50"])
@pytest.mark.parametrize("grouped", [True, False])
def test_kernel_emulation_equals_plain(shape, grouped):
    """The kernel's product, emulated from its operands on full-scale
    input, equals the plain version's wrapped int32 sums exactly (the
    grouped form's and the chunked form's are the same)."""
    plan, _ = _plans(shape)
    taps = k1.ChainTaps(plan, np.zeros(plan.nr_channels), device="cpu",
                        grouped=grouped)
    x = _iq(plan.carry_len + 37 * plan.block_quantum, 5, scale=32768)
    x[-300:] = -32768
    carry = x[:plan.carry_len].reshape(-1)
    block = x[plan.carry_len:].reshape(-1)
    want = taps.fir_sums(torch.from_numpy(carry.copy()),
                         torch.from_numpy(block.copy()))
    np.testing.assert_array_equal(_emulate_kernel(taps, carry, block),
                                  want.numpy())


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
    """A CPU tensor runs the plain version: neither counter moves."""
    args = SHAPES["bench_64ch"]()
    ch = MultifmChain(*args, device="cpu")
    assert ch.taps.grouped
    before = (k1.chain_fm.launches, k1.chain_fm.grouped_launches)
    st = ch.init_state()
    k1.chain_fm(ch.taps, st.carry_vals, torch.stack([st.prev_r, st.prev_i]),
                torch.from_numpy(_iq(2 * ch.block_quantum, 6).reshape(-1)))
    assert (k1.chain_fm.launches, k1.chain_fm.grouped_launches) == before
