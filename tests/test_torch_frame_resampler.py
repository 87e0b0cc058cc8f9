"""The port's frame-form resampler (ops/frame_resampler.py, kernel K4) and
the exact tier of both resampler forms, against the JAX package.

Tolerances:
- frame-form ``polyphase.resample_step`` vs the JAX ``resample_step`` (XLA
  transposed-residue tier), exact and fast: BIT-EQUAL. Both sum int16 x
  int16 products in wrapping int32 (order-free), then apply the same
  epilogue: Q.28 -> Q.14 rounding, or float32 conversion and a
  power-of-two scale.
- packed-row ``resample_step(exact=True)`` (K3's q14 mode) vs the JAX
  ``resample_step(exact=True)``: BIT-EQUAL, for the same reason.
- ``resample_capture`` vs ``resample_capture_pallas(interpret=True)``:
  atol 0.01 (its float32 HIGHEST dot rounds the sum;
  tests/test_polyphase.py:101).
- ``q14.round_q28_q14`` vs the JAX one: EQUAL on every int32 edge.
- K4's tap planes recombine to ``plan.w_frames_i16`` EXACTLY (zero
  padding), and a plain emulation of the kernel's arithmetic (staged
  windows, Hankel rows, the int8 split) equals ``frame_resample_plain``
  BIT FOR BIT: the split is exact mod 2^32 (tests/test_torch_imma_split.py).
(The CUDA kernels against the plain versions: tests/test_torch_cuda.py.)
"""

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.ops import polyphase as jpp
from tsl_sdr_tpu.ops import q14 as jq14
from tsl_sdr_tpu.ops.pallas_resampler import resample_capture_pallas
from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter
from tsl_sdr_tpu_torch.ops import frame_resampler as k4
from tsl_sdr_tpu_torch.ops import imma_split, polyphase, q14
from tsl_sdr_tpu_torch.utils import convert


def _plans(i_, d_, target=1024, align=True, coeffs=None):
    if coeffs is None:
        coeffs = jq14.quantize_q14(design_rational_resampler_filter(i_, d_,
                                                                    0.4))
    jplan = jpp.make_resampler_plan(coeffs, i_, d_, block_out_target=target,
                                    align_k_row=align)
    return jplan, convert.plan_from_jax(jplan)


def _streams(jplan, plan, x, nb, exact):
    """Both packages' outputs for ``nb`` blocks of each row of ``x``."""
    ref = []
    for row in x:
        st = jpp.init_resampler_state(jplan, prefix=row[:plan.carry_len])
        outs = []
        for b in range(nb):
            lo = plan.carry_len + b * plan.block_in
            st, o = jpp.resample_step(jplan, st, row[lo:lo + plan.block_in],
                                      exact=exact)
            outs.append(np.asarray(o))
        ref.append(np.concatenate(outs))
    taps = polyphase.plan_taps(plan, device="cpu")
    carry = polyphase.init_resampler_carry(plan, len(x), device="cpu",
                                           prefix=x[:, :plan.carry_len])
    got = []
    for b in range(nb):
        lo = plan.carry_len + b * plan.block_in
        carry, o = polyphase.resample_step(
            plan, carry, torch.from_numpy(x[:, lo:lo + plan.block_in].copy()),
            taps, exact=exact)
        got.append(o.numpy())
    np.testing.assert_array_equal(carry.numpy(), x[:, -plan.carry_len:])
    return np.concatenate(got, axis=1), np.stack(ref)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("i_,d_", [(147, 160), (25, 16), (25, 48), (64, 1),
                                   (64, 3), (32, 5)])
def test_frame_step_matches_jax(i_, d_, exact):
    """The plans of tests/test_polyphase.py:184-205 that have no packed-row
    form: lcm(I_rep, 128) > 1024, or a spill longer than a row."""
    jplan, plan = _plans(i_, d_)
    assert plan.k_row == 0
    rng = np.random.default_rng(i_ * 1000 + d_)
    nb = 3
    x = rng.integers(-32768, 32768, size=(2, plan.carry_len + nb
                                          * plan.block_in)).astype(np.int16)
    got, ref = _streams(jplan, plan, x, nb, exact)
    assert got.dtype == (np.int16 if exact else np.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_frame_step_int32_wrap_matches_jax(exact):
    """Random taps at full scale overflow int32: both packages wrap."""
    rng = np.random.default_rng(7)
    coeffs = jq14.quantize_q14(rng.normal(size=161) * 0.9)
    jplan, plan = _plans(25, 16, coeffs=coeffs)
    x = rng.choice(np.array([-32768, 32767], np.int16),
                   size=(1, plan.carry_len + 2 * plan.block_in))
    got, ref = _streams(jplan, plan, x, 2, exact)
    np.testing.assert_array_equal(got, ref)
    # some accumulators did wrap
    p = plan.taps_sel_i16.shape[1]
    acc = [int(x[0, off:off + p].astype(np.int64)
               @ plan.taps_sel_i16[k].astype(np.int64))
           for k, off in enumerate(plan.offsets)]
    assert max(map(abs, acc)) >= 2 ** 31


@pytest.mark.parametrize("i_,d_,target,align", [
    (16, 25, 1024, True),      # ResamplerChain's FLEX plan
    (192, 125, 1024, True),    # etc/pocsag_38400_from_25k.json
    (5, 12, 3 * 640, False),   # the pipeline's FLEX group
])
def test_row_step_exact_matches_jax(i_, d_, target, align):
    """K3's q14 mode: the packed-row exact tier."""
    jplan, plan = _plans(i_, d_, target, align)
    assert plan.k_row
    rng = np.random.default_rng(i_)
    nb = 3
    x = rng.integers(-32768, 32768, size=(3, plan.carry_len + nb
                                          * plan.block_in)).astype(np.int16)
    got, ref = _streams(jplan, plan, x, nb, exact=True)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("i_,d_", [(16, 25), (147, 160)])
def test_resample_capture_matches_pallas_interpret(i_, d_):
    jplan, plan = _plans(i_, d_)
    rng = np.random.default_rng(3)
    pcm = rng.integers(-12000, 12000, size=(37 * plan.d_rep,),
                       dtype=np.int64).astype(np.int16)
    ref = np.asarray(resample_capture_pallas(jplan, pcm, tile_frames=8,
                                             interpret=True))
    taps = k4.frame_taps(plan, device="cpu")
    got = k4.resample_capture(plan, torch.from_numpy(pcm), taps)
    assert got.shape == ref.shape == (37 * plan.i_rep,)
    np.testing.assert_allclose(got.numpy(), ref, atol=0.01)


def test_resample_capture_contract():
    """Output k is the window at k * D // I; the last frames read zeros."""
    _, plan = _plans(25, 16)
    taps = k4.frame_taps(plan, device="cpu")
    rng = np.random.default_rng(4)
    pcm = rng.integers(-9000, 9000, size=(20 * plan.d_rep,)).astype(np.int16)
    got = k4.resample_capture(plan, torch.from_numpy(pcm), taps,
                              out="q14").numpy()
    padded = np.concatenate([pcm, np.zeros(plan.frame_shifts * plan.d_rep,
                                           np.int16)]).astype(np.int64)
    p = plan.taps_sel_i16.shape[1]
    for k in range(got.shape[0]):
        off = k * plan.decimation // plan.interpolation
        w = plan.taps_sel_i16[k % plan.i_rep].astype(np.int64)
        acc = int((padded[off:off + p] * w).sum())
        acc = (acc + 2 ** 31) % 2 ** 32 - 2 ** 31
        want = ((acc >> 14) + ((acc >> 13) & 1) + 2 ** 15) % 2 ** 16 - 2 ** 15
        assert got[k] == want, k
    with pytest.raises(ValueError, match="multiple"):
        k4.resample_capture(plan, torch.from_numpy(pcm[:-1]), taps)


def test_round_q28_q14_matches_jax():
    edges = np.array([0, 1, -1, 8191, 8192, -8192, -8193, 16383, 16384,
                      2 ** 31 - 1, -2 ** 31, 2 ** 29 + 8192, -(2 ** 29) - 1,
                      536862720, -536862721], dtype=np.int32)
    rng = np.random.default_rng(5)
    a = np.concatenate([edges, rng.integers(-2 ** 31, 2 ** 31, size=10_000,
                                            dtype=np.int64).astype(np.int32)])
    got = q14.round_q28_q14(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq14.round_q28_q14(a)))
    with pytest.raises(ValueError, match="f32"):
        q14.from_acc(torch.from_numpy(a), "f16")


# every frame-form plan the repo runs: 25/16 with the designed filter (the
# decoder's step and the decimation-50 pipeline's 6-channel step) and with
# full-scale random taps whose sums wrap int32, and the other plans of
# test_frame_step_matches_jax
_WRAP_COEFFS = jq14.quantize_q14(np.random.default_rng(7).normal(size=161)
                                 * 0.9)
_K4_PLANS = {
    "25/16": (25, 16, 1024, True, None, 1),
    "25/16 pipeline step": (25, 16, 131_050, False, None, 6),
    "25/16 wrapping taps": (25, 16, 1024, True, _WRAP_COEFFS, 1),
    "147/160": (147, 160, 1024, True, None, 2),
    "25/48": (25, 48, 1024, True, None, 2),
    "64/1": (64, 1, 1024, True, None, 2),
    "64/3": (64, 3, 1024, True, None, 2),
    "32/5": (32, 5, 1024, True, None, 2),
}


def _k4_plan(name):
    i_, d_, target, align, coeffs, g = _K4_PLANS[name]
    _, plan = _plans(i_, d_, target, align, coeffs)
    assert plan.k_row == 0
    return plan, g


def _dense_planes(taps):
    """The kernel's kept tap tiles back in place: high and low planes
    ``[KT, NT, 32, 8]`` with zeros where ``w_index`` marks no tile; checks
    the index's counts of tiles kept before each word on the way."""
    index = taps.w_index.numpy().view(np.uint32)
    kt = index.shape[0]
    nt = -(-taps.w_frames.shape[1] // 8)
    bits = index[:, :, :1] >> np.arange(32, dtype=np.uint32) & 1
    live = bits.reshape(kt, -1)[:, :nt].astype(bool)
    assert not bits.reshape(kt, -1)[:, nt:].any()
    kept = bits.sum(axis=2).reshape(-1)
    np.testing.assert_array_equal(index[:, :, 1].reshape(-1),
                                  np.cumsum(kept) - kept)
    planes = []
    for tiles in (taps.w_hi.numpy(), taps.w_lo.numpy()):
        full = np.zeros((kt, nt, 32, 8), np.uint8)
        full[live] = tiles
        planes.append(full)
    return planes


@pytest.mark.parametrize("name", list(_K4_PLANS))
def test_frame_taps_planes_recombine_to_the_frame_matrix(name):
    """The kept tiles, put back, are the split planes of W, whose
    recombination is ``plan.w_frames_i16`` with zero padding: no tile with
    a non-zero tap was dropped."""
    plan, _ = _k4_plan(name)
    taps = k4.frame_taps(plan, device="cpu")
    k, n = plan.w_frames_i16.shape
    hi, lo = _dense_planes(taps)
    assert hi.shape == (-(-k // 32), -(-n // 8), 32, 8) == lo.shape
    for got, want in zip((hi, lo), imma_split.fragment_planes(
            plan.w_frames_i16)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imma_split.unfragment(hi, lo, k, n),
                                  plan.w_frames_i16)
    full = imma_split.unfragment(hi, lo, 32 * hi.shape[0], 8 * hi.shape[1])
    assert not full[k:].any() and not full[:, n:].any()
    np.testing.assert_array_equal(taps.w_frames.numpy(), plan.w_frames_i16)
    if name == "147/160":   # W is banded: most tiles are dropped
        assert taps.w_hi.shape[0] < hi.shape[0] * hi.shape[1] / 3


def _k4_emulation(carry, block, taps, frames, out, a):
    """csrc/frame_resampler.cu's arithmetic, plainly: blocks of TM frames
    (the kernel's own, from ``k4.launch_shape``); each stages its window
    from the row's aligned 8-sample chunks (the row starting ``a``
    samples past a 16-byte boundary), split into byte
    planes and shifted down by the window's lead; A[r, k] is byte r * D_rep
    + k of the planes (K padded to 32); the products go through the int8
    split against the kept tap tiles, put back in place (the dropped ones
    are zero, so skipping them changes no sum)."""
    hi, lo = _dense_planes(taps)
    k_pad, n_pad = 32 * hi.shape[0], 8 * hi.shape[1]
    w = torch.from_numpy(imma_split.unfragment(hi, lo, k_pad, n_pad))
    d, i_rep = taps.d_rep, taps.w_frames.shape[1]
    g, n = block.shape
    n_carry = carry.shape[1]
    tm = k4.launch_shape(taps, frames, out).tm
    wb = ((tm - 1) * d + k_pad + 4 + 15) // 16 * 16
    res = torch.empty((g, frames, i_rep), dtype=torch.int32)
    for ch in range(g):
        cg, bg = carry[ch].numpy(), block[ch].numpy()
        for m0 in range(0, frames, tm):
            s = m0 * d - n_carry + a
            c0, lead = s // 8, s % 8
            b = 8 * c0 - a + np.arange(wb + 8)     # block index of each
            t = np.zeros(b.shape, np.int16)         # sample of the chunks
            inb = (b >= 0) & (b < n)
            t[inb] = bg[b[inb]]
            inc = (b < 0) & (b >= -n_carry)
            t[inc] = cg[n_carry + b[inc]]
            h, l_ = imma_split.split_i16(t)
            h = h.view(np.uint8)[lead:lead + wb]
            l_ = l_[lead:lead + wb]
            plane = (h.view(np.int8).astype(np.int32) * 256 + l_).astype(
                np.int16)
            rows = min(tm, frames - m0)
            idx = np.arange(tm)[:, None] * d + np.arange(k_pad)[None, :]
            acc = imma_split.split_matmul_plain(
                torch.from_numpy(plane[idx]), w)
            res[ch, m0:m0 + rows] = acc[:rows, :i_rep]
    return q14.from_acc(res.reshape(g, -1), out)


@pytest.mark.parametrize("out", ["f32", "q14"])
@pytest.mark.parametrize("name", list(_K4_PLANS))
def test_frame_kernel_emulation_matches_plain(name, out):
    plan, g = _k4_plan(name)
    taps = k4.frame_taps(plan, device="cpu")
    rng = np.random.default_rng(len(name) * 10 + plan.d_rep)
    if "wrapping" in name:
        vals = np.array([-32768, 32767], np.int16)
        x = rng.choice(vals, size=(g, plan.carry_len + plan.block_in))
    else:
        x = rng.integers(-32768, 32768, size=(
            g, plan.carry_len + plan.block_in)).astype(np.int16)
    carry = torch.from_numpy(x[:, :plan.carry_len].copy())
    block = torch.from_numpy(x[:, plan.carry_len:].copy())
    frames = plan.block_out // plan.i_rep
    ref = k4.frame_resample_plain(carry, block, taps, frames=frames, out=out)
    for a in (0, 5):
        got = _k4_emulation(carry, block, taps, frames, out, a)
        assert got.dtype == ref.dtype and torch.equal(got, ref), a
    if "wrapping" in name:   # some sums did wrap
        t = np.concatenate([x[0], np.zeros(64, np.int16)]).astype(np.int64)
        win = np.lib.stride_tricks.sliding_window_view(
            t, plan.w_frames_i16.shape[0])[::plan.d_rep][:frames]
        assert np.abs(win @ plan.w_frames_i16.astype(np.int64)).max() \
            >= 2 ** 31


@pytest.mark.parametrize("out", ["f32", "q14"])
@pytest.mark.parametrize("name", list(_K4_PLANS))
def test_frame_launch_shape_follows_its_rule(name, out):
    """``k4.launch_shape``, the kernel's one launch rule, at the plan's step
    and at a long capture: TM on the 16-frame grid, at most 64 and no more
    than the frames rounded up to 16; a block's units (m16 tiles x groups
    of four n8 tiles) take its warps at most two rounds; shared memory
    under the cap. At 147/160 (19 n8 tiles) a long call tiles by 48 frames
    on 8 warps; 25/16 by 64 on 4, and by 48 at decoder-torch's 41 frames."""
    plan, _ = _k4_plan(name)
    taps = k4.frame_taps(plan, device="cpu")
    n_groups = -(-plan.i_rep // 32)
    for frames in (plan.block_out // plan.i_rep, 20_000):
        s = k4.launch_shape(taps, frames, out)
        assert s.tm % 16 == 0 and 16 <= s.tm <= k4.TM_MAX
        assert s.tm <= -(-frames // 16) * 16
        assert k4.WARPS_MIN <= s.warps <= k4.WARPS_MAX
        assert s.tm // 16 * n_groups <= 2 * s.warps or s.tm == 16
        assert s.smem <= k4.SMEM_MAX
        assert (s.k_pad, s.n_tiles, s.n_live) == (
            -(-plan.w_frames_i16.shape[0] // 32) * 32, -(-plan.i_rep // 8),
            taps.w_hi.shape[0])
    want = {"147/160": (48, 8), "25/16": (64, 4),
            "25/16 pipeline step": (64, 4)}
    if name in want:
        assert k4.launch_shape(taps, 20_000, out)[:2] == want[name]
    if name == "25/16":
        assert k4.launch_shape(taps, 41, out)[:2] == (48, 4)
