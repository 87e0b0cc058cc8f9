"""The int8 split of kernels K1 and K3 (``ops/imma_split.py``), on the CPU.

Bars (all exact):
- the four cross sums of byte products, recombined mod 2**32, equal the
  direct wrapped int32 sum of int16 products, at the extremes (-32768,
  32767, 0, -1) of both operands and at depths 1 to 32,768;
- no cross sum leaves s32 at depth 32,768 (the kernels' limit);
- the high/low tap planes that ``row_taps`` and ``ChainTaps`` build
  recombine to the original taps: the kernels multiply what the plain
  versions multiply.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import imma_split, polyphase, q14
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter)

EXTREMES = (-32768, 32767, 0, -1)


def _wrapped(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The direct product: int64 sums of int16 products, wrapped to int32."""
    acc = (x.to(torch.int64) @ w.to(torch.int64)) & 0xFFFFFFFF
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


_values = st.one_of(st.sampled_from(EXTREMES),
                    st.integers(-32768, 32767))


@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 64), n=st.integers(1, 9),
       data=st.data())
def test_split_product_equals_wrapped_product(k, n, data):
    x = torch.tensor(data.draw(st.lists(_values, min_size=2 * k,
                                        max_size=2 * k)),
                     dtype=torch.int16).reshape(2, k)
    w = torch.tensor(data.draw(st.lists(_values, min_size=k * n,
                                        max_size=k * n)),
                     dtype=torch.int16).reshape(k, n)
    assert torch.equal(imma_split.split_matmul_plain(x, w), _wrapped(x, w))


@settings(max_examples=12, deadline=None)
@given(k=st.integers(1, imma_split.MAX_DEPTH),
       xv=st.sampled_from(EXTREMES), wv=st.sampled_from(EXTREMES),
       seed=st.integers(0, 2 ** 16))
def test_split_product_at_depth(k, xv, wv, seed):
    """Long rows of one extreme value with random values mixed in."""
    rng = np.random.default_rng(seed)
    x = np.full((1, k), xv, np.int16)
    w = np.full((k, 2), wv, np.int16)
    mix = rng.random(k) < 0.5
    x[0, mix] = rng.integers(-32768, 32768, mix.sum())
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(imma_split.split_matmul_plain(x, w), _wrapped(x, w))


@pytest.mark.parametrize("xv,wv", [(-32768, -32768), (-32768, 32767),
                                   (32767, -32768), (-1, -1)])
def test_partial_sums_stay_in_s32_at_max_depth(xv, wv):
    """HH, HL + LH and LL at depth 32,768 of the worst bytes fit in s32,
    so mma.sync's s32 accumulators never wrap before recombination."""
    k = imma_split.MAX_DEPTH
    xh, xl = imma_split.split_i16(np.array(xv, np.int16))
    wh, wl = imma_split.split_i16(np.array(wv, np.int16))
    worst_ll = k * 255 * 255
    worst_mid = k * (128 * 255 + 255 * 128)
    for total in (k * int(xh) * int(wh),
                  k * (int(xh) * int(wl) + int(xl) * int(wh)),
                  k * int(xl) * int(wl), worst_ll, worst_mid):
        assert -2 ** 31 <= total < 2 ** 31


@pytest.mark.parametrize("k,n", [(1, 1), (31, 7), (32, 8), (77, 21),
                                 (1632, 640)])
def test_fragment_planes_round_trip(k, n):
    rng = np.random.default_rng(k * n)
    w = rng.integers(-32768, 32768, (k, n)).astype(np.int16)
    w[0, 0], w[-1, -1] = -32768, 32767
    hi, lo = imma_split.fragment_planes(w)
    assert hi.shape == lo.shape == (-(-k // 32), -(-n // 8), 32, 8)
    assert hi.dtype == lo.dtype == np.uint8
    np.testing.assert_array_equal(imma_split.unfragment(hi, lo, k, n), w)


def _b_fragment(hi, lo, kt, nt, lane):
    """(k, n) of each byte a lane holds in the B fragment of m16n8k32 (PTX:
    b_i at row 4*(lane%4) + i%4 (+16 for i >= 4), column lane/4)."""
    g, t = lane // 4, lane % 4
    rows = [32 * kt + 4 * t + i % 4 + (16 if i >= 4 else 0)
            for i in range(8)]
    return rows, 8 * nt + g, hi[kt, nt, lane], lo[kt, nt, lane]


def test_fragment_lanes_hold_the_ptx_b_layout():
    rng = np.random.default_rng(1)
    w = rng.integers(-32768, 32768, (64, 16)).astype(np.int16)
    hi, lo = imma_split.fragment_planes(w)
    wh, wl = imma_split.split_i16(w)
    for kt in range(2):
        for nt in range(2):
            for lane in range(32):
                rows, col, bh, bl = _b_fragment(hi, lo, kt, nt, lane)
                np.testing.assert_array_equal(bh, wh[rows, col].view(np.uint8))
                np.testing.assert_array_equal(bl, wl[rows, col])


@pytest.mark.parametrize("ratio,target", [((5, 12), 85 * 640),
                                          ((192, 125), 1024),
                                          ((16, 25), 1024)])
def test_row_taps_planes_recombine_to_the_taps(ratio, target):
    """K3's planes hold [w0; w1[:spill]], padded to a multiple of 32 rows
    with zeros: the real spill, not the 128-padded one."""
    i_, d_ = ratio
    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(design_rational_resampler_filter(i_, d_, 0.4)),
        i_, d_, block_out_target=target, align_k_row=target == 1024)
    taps = polyphase.row_taps(plan, device="cpu")
    k = plan.row_in + plan.spill
    k_pad = 32 * taps.w_hi.shape[0]
    assert k_pad == -(-k // 32) * 32 <= plan.row_in + 128
    got = imma_split.unfragment(taps.w_hi.numpy(), taps.w_lo.numpy(), k_pad,
                                plan.k_row)
    np.testing.assert_array_equal(got[:plan.row_in], plan.w_row_i16)
    np.testing.assert_array_equal(got[plan.row_in:k],
                                  plan.w_spill_i16[:plan.spill])
    assert not got[k:].any() and not plan.w_spill_i16[plan.spill:].any()


def test_chain_taps_planes_recombine_to_the_taps():
    ch = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS,
                      pager.DECIMATION, exact=False, device="cpu")
    plan = ch.packed_plan
    k_tiles, n_tiles = -(-plan.win // 32), -(-2 * plan.halfcols // 8)
    # the pager bank is chunked and one channel block: every tile keeps
    # all its k-steps, in the tap matrix's own column order
    assert not ch.taps.grouped and ch.taps.chans_per_block == 8
    ktab = ch.taps.ktab.numpy()
    assert (ktab[:, :2] == [0, k_tiles]).all()
    hi, lo = imma_split.expand_groups(ch.taps.w_hi.numpy(),
                                      ch.taps.w_lo.numpy(), ktab[:, :2],
                                      ktab[:, 2], k_tiles, n_tiles, 4)
    got = imma_split.unfragment(hi, lo, plan.win, 2 * plan.halfcols)
    np.testing.assert_array_equal(
        got, np.concatenate(plan.w_chunks_i16)[:plan.win])
    assert ch.taps.w_hi.shape[0] == k_tiles * n_tiles
