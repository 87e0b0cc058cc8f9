"""The hand-written CUDA kernels against their plain torch versions.

These run only on a machine with an NVIDIA GPU and nvcc (the kernels have
no CPU mode); elsewhere each test skips. The file imports nothing of jax
or the JAX package, so the card's machine can run it without the JAX
package's test setup:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: K1 <= 1 PCM LSB and >= 99.9 % exact (its float ops are written
to match the plain version one to one, so it is exact in practice); K3 and
K4 EXACTLY equal in both output modes (wrapping int32 sums, then one float32
conversion and a power-of-two scale, or the integer Q.28 -> Q.14 rounding);
the exact DC blocker EXACTLY equal (the same integer recurrence).
"""

import numpy as np
import pytest
import torch

from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.ops import dc_blocker
from tsl_sdr_tpu_torch.ops import frame_resampler as k4
from tsl_sdr_tpu_torch.ops import polyphase, q14
from tsl_sdr_tpu_torch.ops import row_resampler as k3
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.utils.filter_design import (
    design_rational_resampler_filter)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU (no CPU mode)")
    return torch.device("cuda")


def _iq(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(
        np.int16)


@pytest.mark.parametrize("tiles,extra,decim", [(4, 0, 32), (4, 2, 32),
                                               (0, 3, 32), (3, 5, 50)])
def test_chain_kernel_matches_plain(cuda, tiles, extra, decim):
    """Whole tiles, a ragged last tile, and a block shorter than a tile, at
    four of the pager deployment's channels (577 taps, decimate by 32), and
    at decimation 50 (3,200-value rows: 16-row tiles, taps read from L2)."""
    if decim == 32:
        ch = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ[::2], pager.FS,
                          pager.DECIMATION, device=cuda)
    else:
        ch = MultifmChain(pager.dec50_lpf_taps(), pager.OFFSETS_HZ[:6],
                          pager.FS, pager.DEC50_DECIMATION, device=cuda)
    plan = ch.packed_plan
    rows = tiles * ch.taps.tile_rows + extra
    vals = torch.from_numpy(
        _iq(plan.carry_len + rows * ch.block_quantum, 6).reshape(-1)).to(cuda)
    carry, block = vals[:plan.carry_vals], vals[plan.carry_vals:]
    prev = torch.from_numpy(np.random.default_rng(7).normal(
        scale=1e5, size=(2, plan.nr_channels)).astype(np.float32)).to(cuda)
    before = k1.chain_fm.launches
    got, gprev = k1.chain_fm(ch.taps, carry, prev, block)
    ref, rprev = k1.chain_fm_plain(ch.taps, carry, prev, block)
    torch.cuda.synchronize()
    assert k1.chain_fm.launches == before + 1
    d = np.abs(got.cpu().numpy().astype(np.int32) - ref.cpu().numpy())
    d = np.minimum(d, 32768 - d)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    assert torch.equal(gprev, rprev)


@pytest.mark.parametrize("g,m", [(2, 85), (3, 9), (1, 1)])
def test_row_resample_kernel_matches_plain(cuda, g, m):
    """The pipeline's [2 channels, 85 rows] FLEX block, and row counts off
    the kernel's 16-row tile; K_ROW = 640 is twenty 32-column blocks."""
    coeffs = q14.quantize_q14(design_rational_resampler_filter(5, 12, 0.4))
    plan = polyphase.make_resampler_plan(coeffs, 5, 12,
                                         block_out_target=m * 640,
                                         align_k_row=False)
    taps = polyphase.row_taps(plan, device=cuda)
    rng = np.random.default_rng(3)
    carry = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.carry_len)).astype(np.int16)).to(cuda)
    block = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.block_in)).astype(np.int16)).to(cuda)
    before = k3.row_resample.launches
    got = k3.row_resample(carry, block, taps, row_in=plan.row_in)
    ref = k3.row_resample_plain(carry, block, taps, row_in=plan.row_in)
    torch.cuda.synchronize()
    assert k3.row_resample.launches == before + 1
    assert got.shape == (g, m, plan.k_row)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("i_,d_,g,frames,short", [
    (147, 160, 3, 133, 0),    # 3 channels, a ragged last frame tile
    (25, 16, 2, 5184, 0),     # the decimation-50 pipeline's POCSAG group
    (64, 1, 2, 70, 5),        # D_rep = 1, 36 spill frames, a short block
    (32, 5, 1, 3, 2),         # fewer frames than one m16 tile
    (25, 48, 2, 41, 0),       # D_rep = 48: ldmatrix rows at pitch 48
    (64, 3, 3, 333, 7),       # D_rep = 3: funnel-shifted A fragments
])
@pytest.mark.parametrize("out", ["f32", "q14"])
def test_frame_resample_kernel_matches_plain(cuda, i_, d_, g, frames, short,
                                             out):
    coeffs = q14.quantize_q14(design_rational_resampler_filter(i_, d_, 0.4))
    plan = polyphase.make_resampler_plan(coeffs, i_, d_)
    assert plan.k_row == 0
    taps = k4.frame_taps(plan, device=cuda)
    rng = np.random.default_rng(frames)
    carry = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.carry_len)).astype(np.int16)).to(cuda)
    block = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, frames * plan.d_rep - short)).astype(
            np.int16)).to(cuda)
    before = k4.frame_resample.launches
    got = k4.frame_resample(carry, block, taps, frames=frames, out=out)
    ref = k4.frame_resample_plain(carry, block, taps, frames=frames, out=out)
    torch.cuda.synchronize()
    assert k4.frame_resample.launches == before + 1
    assert got.shape == (g, frames * plan.i_rep) and got.dtype == ref.dtype
    assert torch.equal(got, ref)


def test_resample_capture_kernel_matches_plain(cuda):
    """The whole-capture entry (no carry) at 147/160, 10 s of 48 kHz."""
    coeffs = q14.quantize_q14(design_rational_resampler_filter(147, 160,
                                                               0.4))
    plan = polyphase.make_resampler_plan(coeffs, 147, 160)
    taps = k4.frame_taps(plan, device=cuda)
    pcm = torch.from_numpy(np.random.default_rng(1).integers(
        -20000, 20000, size=480_000).astype(np.int16)).to(cuda)
    for out in ("f32", "q14"):
        got = k4.resample_capture(plan, pcm, taps, out=out)
        ref = k4.frame_resample_plain(pcm.new_zeros((1, 0)), pcm[None], taps,
                                      frames=3000, out=out)[0]
        assert torch.equal(got, ref)


def test_frame_resample_kernel_checks_its_launch(cuda):
    """The kernel takes TM, warps and shared memory from
    ``k4.launch_shape`` and rejects shared memory that is not its layout's
    size at that TM, or a TM off its 16-frame grid."""
    from tsl_sdr_tpu_torch.kernels import build

    coeffs = q14.quantize_q14(design_rational_resampler_filter(25, 16, 0.4))
    plan = polyphase.make_resampler_plan(coeffs, 25, 16)
    taps = k4.frame_taps(plan, device=cuda)
    frames = plan.block_out // plan.i_rep
    rng = np.random.default_rng(41)
    carry, block = (torch.from_numpy(rng.integers(
        -32768, 32767, size=(1, n)).astype(np.int16)).to(cuda)
        for n in (plan.carry_len, plan.block_in))
    res = torch.empty((1, frames * plan.i_rep), dtype=torch.float32,
                      device=cuda)
    lib = build.load()
    shape = k4.launch_shape(taps, frames)

    def launch(tm, warps, smem):
        return lib.tsl_frame_resample(
            carry.data_ptr(), block.data_ptr(), taps.w_hi.data_ptr(),
            taps.w_lo.data_ptr(), taps.w_index.data_ptr(), res.data_ptr(),
            frames, plan.i_rep, plan.d_rep, shape.k_pad, shape.n_tiles,
            shape.n_live, plan.carry_len, plan.block_in, 1, 0, tm, warps,
            smem, torch.cuda.current_stream().cuda_stream)

    assert launch(shape.tm, shape.warps, shape.smem) == 0
    torch.cuda.synchronize()
    assert torch.equal(res, k4.frame_resample_plain(carry, block, taps,
                                                    frames=frames))
    assert launch(shape.tm, shape.warps, shape.smem + 16) != 0
    assert launch(shape.tm - 8, shape.warps, shape.smem) != 0


def _offset_rows(x: np.ndarray, offset: int, device) -> torch.Tensor:
    """``x`` [G, n] as a contiguous device tensor starting ``offset``
    samples into its buffer, so its rows sit off the 16-byte grid."""
    buf = torch.zeros(x.size + offset, dtype=torch.int16, device=device)
    buf[offset:] = torch.from_numpy(x.reshape(-1)).to(device)
    return buf[offset:].view(x.shape)


@pytest.mark.parametrize("i_,d_", [(147, 160), (64, 1)])
@pytest.mark.parametrize("out", ["f32", "q14"])
def test_frame_resample_kernel_adversarial(cuda, i_, d_, out):
    """All -32768 samples against a frame matrix of +-32767 taps: every
    byte product at its extreme and the int32 sums through many wraps;
    the block's rows off the 16-byte grid."""
    coeffs = q14.quantize_q14(design_rational_resampler_filter(i_, d_, 0.4))
    plan = polyphase.make_resampler_plan(coeffs, i_, d_)
    rng = np.random.default_rng(i_ + d_)
    w = np.where(rng.random(plan.w_frames_i16.shape) < 0.5, -32767,
                 32767).astype(np.int16)
    taps = k4.frame_taps_of(w, plan.d_rep, device=cuda)
    g, frames = 2, plan.block_out // plan.i_rep
    carry = torch.full((g, plan.carry_len), -32768, dtype=torch.int16,
                       device=cuda)
    block = _offset_rows(np.full((g, plan.block_in), -32768, np.int16), 3,
                         cuda)
    got = k4.frame_resample(carry, block, taps, frames=frames, out=out)
    ref = k4.frame_resample_plain(carry, block, taps, frames=frames, out=out)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("g,m", [(1, 3), (2, 85)])
def test_row_resample_q14_matches_plain(cuda, g, m):
    """K3's exact epilogue at the 192/125 plan of
    etc/pocsag_38400_from_25k.json (6,303 taps)."""
    coeffs = q14.quantize_q14(design_rational_resampler_filter(192, 125, 0.4))
    plan = polyphase.make_resampler_plan(coeffs, 192, 125,
                                         block_out_target=m * 384,
                                         align_k_row=False)
    taps = polyphase.row_taps(plan, device=cuda)
    rng = np.random.default_rng(m)
    carry = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.carry_len)).astype(np.int16)).to(cuda)
    block = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.block_in)).astype(np.int16)).to(cuda)
    before = k3.row_resample.launches_q14
    got = k3.row_resample(carry, block, taps, row_in=plan.row_in, out="q14")
    ref = k3.row_resample_plain(carry, block, taps, row_in=plan.row_in,
                                out="q14")
    torch.cuda.synchronize()
    assert k3.row_resample.launches_q14 == before + 1
    assert got.dtype == torch.int16 and torch.equal(got, ref)


@pytest.mark.parametrize("i_,d_,align,g", [(1, 17, False, 2),
                                           (5, 36, True, 1),
                                           (3, 64, True, 2)])
@pytest.mark.parametrize("out", ["f32", "q14"])
def test_row_resample_kernel_multipass_matches_plain(cuda, i_, d_, align, g,
                                                     out):
    """Packed-row plans whose K (row_in + spill: 2,720, 4,864 and 8,896)
    passes the 2,048 the kernel stages at a time: it restages in passes,
    the last one shorter, and some warps get no k-step of a pass."""
    coeffs = q14.quantize_q14(design_rational_resampler_filter(i_, d_, 0.4))
    plan = polyphase.make_resampler_plan(coeffs, i_, d_, align_k_row=align)
    assert plan.k_row and plan.row_in + plan.spill > 2048
    taps = polyphase.row_taps(plan, device=cuda)
    rng = np.random.default_rng(i_ * d_)
    carry = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.carry_len)).astype(np.int16)).to(cuda)
    block = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, plan.block_in)).astype(np.int16)).to(cuda)
    got = k3.row_resample(carry, block, taps, row_in=plan.row_in, out=out)
    ref = k3.row_resample_plain(carry, block, taps, row_in=plan.row_in,
                                out=out)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_dc_block_exact_kernel_matches_plain(cuda):
    """Three streams, state carried across uneven blocks."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-32768, 32767, size=(3, 20_000)).astype(
        np.int16))
    p = dc_blocker.make_pole_coeff(0.9999)
    st_k = torch.zeros((3, 3), dtype=torch.int32, device=cuda)
    st_p = torch.zeros((3, 3), dtype=torch.int32)
    before = dc_blocker.dc_block_exact.launches
    for lo, hi in [(0, 1), (1, 4097), (4097, 20_000)]:
        got = dc_blocker.dc_block_exact(st_k, x[:, lo:hi].contiguous().to(cuda),
                                        p)
        ref = dc_blocker.dc_block_exact_plain(st_p, x[:, lo:hi].contiguous(),
                                              p)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref)
        assert torch.equal(st_k.cpu(), st_p)
    assert dc_blocker.dc_block_exact.launches == before + 3


# (x_prev, y_prev, acc) of tests/test_torch_dc_exact.py: acc wraps on the
# first sample, and y_prev is not acc >> 14
_DC_STATES = [(0, 0, 0), (-(32768 << 14), -4000, (1 << 31) - 2000),
              (32767 << 14, 4000, -(1 << 31) + 2000), (5 << 14, 12_345, 0)]


@pytest.mark.parametrize("g", [1, 6, 33])
@pytest.mark.parametrize("pole", [0.9999, 0.5])
def test_dc_block_exact_kernel_adversarial(cuda, g, pole):
    """G streams (33 cross a warp's worth), random and full-scale
    alternating input, the adversarial states, and a stream longer than a
    staged chunk (2,048 samples) in uneven blocks, some off the 16-byte
    grid: output and state exactly equal."""
    rng = np.random.default_rng(g)
    n = 5_000
    x = rng.integers(-32768, 32768, size=(g, n)).astype(np.int16)
    x[1::2] = np.where(np.arange(n) % 2, 32767, -32768)
    st0 = np.array([_DC_STATES[i % 4] for i in range(g)], np.int32)
    p = dc_blocker.make_pole_coeff(pole)
    st_k = torch.from_numpy(st0.copy()).to(cuda)
    st_p = torch.from_numpy(st0.copy())
    for k, (lo, hi) in enumerate([(0, 3), (3, 1155), (1155, 1155),
                                  (1155, 3500), (3500, n)]):
        part = np.ascontiguousarray(x[:, lo:hi])
        got = dc_blocker.dc_block_exact(st_k, _offset_rows(part, k, cuda),
                                        p)
        ref = dc_blocker.dc_block_exact_plain(st_p, torch.from_numpy(part),
                                              p)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref), (lo, hi)
        assert torch.equal(st_k.cpu(), st_p), (lo, hi)


def test_wrappers_raise_on_bad_input(cuda):
    """A CUDA tensor never falls back to the plain version: bad shapes,
    dtypes or devices raise before any launch."""
    ch = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ[:2], pager.FS,
                      pager.DECIMATION, device=cuda)
    st = ch.init_state()
    prev = torch.stack([st.prev_r, st.prev_i])
    block = torch.zeros(ch.packed_plan.row * 3 + 2, dtype=torch.int16,
                        device=cuda)
    with pytest.raises(ValueError, match="rows"):
        k1.chain_fm(ch.taps, st.carry_vals, prev, block)
    with pytest.raises(ValueError, match="int16"):
        k1.chain_fm(ch.taps, st.carry_vals.to(torch.int32), prev,
                    block[:ch.packed_plan.row])
    w0 = torch.zeros((16, 32), dtype=torch.int16, device=cuda)
    plane = torch.zeros((1, 4, 32, 8), dtype=torch.uint8, device=cuda)
    bad = k3.RowTaps(w0, None, plane.to(torch.int8), plane)
    with pytest.raises(ValueError, match="w_hi"):
        k3.row_resample(torch.zeros((1, 4), dtype=torch.int16, device=cuda),
                        torch.zeros((1, 64), dtype=torch.int16, device=cuda),
                        bad, row_in=16)
