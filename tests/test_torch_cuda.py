"""The hand-written CUDA kernels against their plain torch versions.

These run only on a machine with an NVIDIA GPU and nvcc (the kernels have
no CPU mode); elsewhere each test skips. The file imports nothing of jax
or the JAX package, so the card's machine can run it without the JAX
package's test setup:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The pipeline's drain worker and its checkpoints are checked on the card
too: the worker equals the inline drain, and a checkpoint moves between
the card and the CPU.

Tolerances: K1 <= 1 PCM LSB and >= 99.9 % exact (its float ops are written
to match the plain version one to one, so it is exact in practice); K3 and
K4 EXACTLY equal in both output modes (wrapping int32 sums, then one float32
conversion and a power-of-two scale, or the integer Q.28 -> Q.14 rounding);
the exact DC blocker EXACTLY equal (the same integer recurrence); K5
EXACTLY equal in both epilogues (wrapping int32 sums, then the integer
rounding or nothing), and the exact channelizer's PCM on the card equal to
the CPU's byte for byte; K1 and K5 on wide banks (grouped operands, channel
blocks at 256 and 232 channels) EXACTLY equal, the FM stage's PCM and
carry included; K6 (the chunked Costas loop) EXACTLY equal, outputs and
state (its float ops are written with _rn intrinsics in the plain
version's order and its sums in the plain version's tree), and the Costas
chain's int16 output equal to the run with every kernel swapped for its
plain version; K7 (the egress gate) EXACTLY equal, output buffer and new
tail; K8 (the fast DC blocker) within 1 LSB (float64 sums in another
order); K9 (the exact tier's derotation and discriminator) EXACTLY
equal, at every tile shape and off the 16-byte grid; K10 (the integer NCO
and its scalings) EXACTLY equal in both modes (its cosf and sinf are the
ones torch's cos and sin call on the card).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from tsl_sdr_tpu_torch.kernels import build
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.models import costas_channel
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.ops import costas as k6
from tsl_sdr_tpu_torch.ops import exact_fir as k5
from tsl_sdr_tpu_torch.ops import dc_blocker, fm, gate
from tsl_sdr_tpu_torch.ops import frame_resampler as k4
from tsl_sdr_tpu_torch.ops import packed_fir, polyphase, q14
from tsl_sdr_tpu_torch.ops import row_resampler as k3
from tsl_sdr_tpu_torch.testing import pager, stage_inputs
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
                          pager.DECIMATION, exact=False, device=cuda)
    else:
        ch = MultifmChain(pager.dec50_lpf_taps(), pager.OFFSETS_HZ[:6],
                          pager.FS, pager.DEC50_DECIMATION, exact=False,
                          device=cuda)
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
                      pager.DECIMATION, exact=False, device=cuda)
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



def _pager_run(pipe, iq, bounds, got=None):
    got = got or [[] for _ in pipe.channels]
    for lo, hi in zip(bounds, bounds[1:]):
        for c, part in enumerate(pipe.push(iq[lo:hi])):
            got[c].extend(part)
    for c, part in enumerate(pipe.flush()):
        got[c].extend(part)
    return [[dataclasses.asdict(m) for m in msgs] for msgs in got]


@pytest.fixture(scope="module")
def pager_capture():
    """All eight pager channels with a burst each, over ten 491,520-sample
    blocks."""
    starts = [150_000 + k * 550_000 for k in range(8)]
    starts[6], starts[7] = 250_000, 2_300_000     # the FLEX bursts
    return pager.capture(5_000_000, starts, seed=9)


def _pager_pipe(device, **kw):
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    return ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                           pager.DECIMATION, pager.channel_specs(ChannelSpec),
                           block_size=491_520, device=device, **kw)


def test_drain_async_on_the_card_equals_sync(cuda, pager_capture):
    """The drain worker on the card (its own thread's device, the copies on
    the dispatch stream) decodes what the inline drain does: every burst."""
    iq, expected = pager_capture
    bounds = [0, 1_000, 700_001, 2_345_678, 3_000_000, len(iq)]
    got = {asy: _pager_run(_pager_pipe(cuda, drain_async=asy), iq, bounds)
           for asy in (False, True)}
    assert got[True] == got[False]
    assert [[m["capcode"] for m in ch] for ch in got[True]] == [
        [1_100_000 + 1_000 * k + 8 * (k >= 6)] for k in range(8)]


def test_the_pinned_ring_has_its_spans_on_the_card(cuda, pager_capture):
    """On the card each upload goes through the pinned ring: its spans
    (``engine.upload.pin_copy`` every block, ``engine.upload.ring_wait``
    from the third, when a slot comes round again) nest in
    ``engine.upload`` in the profiler's record, and their keys lie inside
    ``upload_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iq, _ = pager_capture
    pipe = _pager_pipe(cuda)
    pipe.timing = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pager_run(pipe, iq, [0, len(iq)])
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    uploads = [r for r in ranges if r[0] == "engine.upload"]
    blocks = pipe.stream_stats["blocks"]
    assert len(uploads) == blocks
    for name, n in (("engine.upload.pin_copy", blocks),
                    ("engine.upload.ring_wait", blocks - 2)):
        mine = [r for r in ranges if r[0] == name]
        assert len(mine) == n, name
        assert all(any(u[1] <= a and b <= u[2] for u in uploads)
                   for _, a, b in mine), name
    tm = pipe.timing
    assert tm["pin_copy_s"] > 0
    assert tm["upload_s"] >= tm["pin_copy_s"] + tm["ring_wait_s"]


def _legs(first, second, iq, path, split=2_100_000):
    a = _pager_pipe(first, drain_async=True)
    got = [list(ch) for ch in a.push(iq[:split])]
    for c, part in enumerate(a.checkpoint_stream(path)):
        got[c].extend(part)
    b = _pager_pipe(second)
    b.restore_stream(path)
    return _pager_run(b, iq[split:], [0, len(iq) - split], got)


@pytest.mark.parametrize("first,second", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_moves_between_card_and_cpu(cuda, pager_capture, tmp_path,
                                               first, second):
    """A checkpoint written on one device restores on the other, with the
    same messages as the same two legs run on the card alone (bursts on
    air across the restart are lost alike)."""
    iq, _ = pager_capture
    want = _legs("cuda", "cuda", iq, tmp_path / "ref.npz")
    assert sum(map(len, want)) >= 4
    assert _legs(first, second, iq, tmp_path / "s.npz") == want


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 1), (1, 8)])
def test_sharded_channelizer_on_the_card(cuda, shape):
    """The sharded channelizer at the pager's plan on a mesh of the one
    card repeated: K1 once for each (time span, channel shard), and the
    result equal to the same mesh of CPU stand-ins (the plain version)
    and to one K1 call over the whole capture."""
    from tsl_sdr_tpu_torch.ops import packed_fir
    from tsl_sdr_tpu_torch.parallel.channelizer import make_sharded_multifm
    from tsl_sdr_tpu_torch.parallel.mesh import make_mesh

    plan = packed_fir.make_packed_fir_plan(
        pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS, pager.DECIMATION)
    t, c = shape
    iq = _iq(8 * 4_096 * plan.row // 2, 11)

    def run(devices, mesh_shape):
        mesh = make_mesh(*mesh_shape, devices=devices * (
            mesh_shape[0] * mesh_shape[1]))
        return make_sharded_multifm(plan, mesh)(iq).cpu()

    before = k1.chain_fm.launches
    got = run([cuda], shape)
    assert k1.chain_fm.launches - before == t * c
    assert torch.equal(got, run(["cpu"], shape))
    assert torch.equal(got, run([cuda], (1, 1)))


def test_mesh_pipeline_on_the_card(cuda, pager_capture):
    """ReceivePipeline on a (2, 2) mesh of the one card decodes every
    burst as the pipeline without a mesh does, with equal fetched
    counters; K1 launches = blocks x spans x channel shards."""
    from tsl_sdr_tpu_torch.parallel.mesh import make_mesh

    iq, _ = pager_capture
    bounds = [0, 1_000, 700_001, 2_345_678, len(iq)]
    base = _pager_pipe(cuda)
    want = _pager_run(base, iq, bounds)
    pipe = _pager_pipe(cuda, mesh=make_mesh(2, 2, devices=[cuda] * 4))
    before = k1.chain_fm.launches
    assert _pager_run(pipe, iq, bounds) == want
    assert k1.chain_fm.launches - before == 4 * pipe.stream_stats["blocks"]
    np.testing.assert_array_equal(pipe.stream_stats["fetched"],
                                  base.stream_stats["fetched"])


def test_host_path_on_the_card_matches_push(cuda, pager_capture):
    """process_capture(device_decode=False), the stage-by-stage path, on
    the card decodes what push/flush decodes: at the pager deployment K1,
    K3 and the exact DC kernel launch on it, at decimation 50 K4 does."""
    iq, _ = pager_capture
    pipe = _pager_pipe(cuda)
    want = [[dataclasses.asdict(m) for m in ch]
            for ch in pipe.process_capture(iq)]
    before = (k1.chain_fm.launches, k3.row_resample.launches,
              dc_blocker.dc_block_exact.launches)
    got = [[dataclasses.asdict(m) for m in ch]
           for ch in pipe.process_capture(iq, device_decode=False)]
    after = (k1.chain_fm.launches, k3.row_resample.launches,
             dc_blocker.dc_block_exact.launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert got == want and sum(map(len, got)) == 8

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    specs = pager.dec50_channel_specs(ChannelSpec)
    starts = [150_000 + k * 500_000 for k in range(len(specs))]
    iq50, _ = pager.capture(4_200_000, starts, seed=10)
    pipe = ReceivePipeline(pager.dec50_lpf_taps(), pager.CENTER_HZ, pager.FS,
                           pager.DEC50_DECIMATION, specs, device=cuda)
    want = [[dataclasses.asdict(m) for m in ch]
            for ch in pipe.process_capture(iq50)]
    before = k4.frame_resample.launches
    got = [[dataclasses.asdict(m) for m in ch]
           for ch in pipe.process_capture(iq50, device_decode=False)]
    assert k4.frame_resample.launches > before
    assert got == want and sum(map(len, got)) == len(specs)


@pytest.mark.parametrize("exact", [False, True], ids=["fused", "exact"])
def test_pipeline_soak_seed_on_the_card(cuda, exact):
    """``bench/torch_soak_pipeline.py``'s seed 1 (FLEX, AIS and POCSAG at
    decimation 24: K3 at 5/16 and 3/4, K4 at 15/16) on the card: the
    engine decodes what the host path decodes, all three bursts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_soak_pipeline",
        Path(__file__).resolve().parents[1] / "bench"
        / "torch_soak_pipeline.py")
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    before = (k3.row_resample.launches + k3.row_resample.launches_q14,
              k4.frame_resample.launches)
    got, want = soak.run_seed(1, exact=exact, device=cuda)
    after = (k3.row_resample.launches + k3.row_resample.launches_q14,
             k4.frame_resample.launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert got == want and sum(map(len, got)) == 3


def test_cli_device_count_guard(cuda, tmp_path, capsys):
    """pipeline-torch refuses a mesh larger than the CUDA devices it sees,
    with pipeline-tpu's message."""
    import json

    from tsl_sdr_tpu_torch.cli import pipeline as cli

    iq_path = tmp_path / "cap.cs16"
    np.zeros(100_000 * 2, np.int16).tofile(iq_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(pager.config(str(iq_path))))
    n = torch.cuda.device_count()
    assert cli.main([str(cfg), "--time-shards", str(n + 1)]) == 2
    assert capsys.readouterr().err == (
        f"pipeline-torch: --time-shards {n + 1} x --channel-shards 1 needs "
        f"{n + 1} devices, have {n}\n")


# rows = 3 of K5's tiles + extra: whole tiles, a ragged last one, 70,768
# rows at the pager (277 units for the card's 132 blocks, a run of units
# ending mid-block, more than 65,535 rows) and 37 rows at 8 channels (the
# tile cut by launch_rows)
@pytest.mark.parametrize("bank,extra", [("pager", 0), ("pager", 5),
                                        ("8ch", 3), ("pager", 70_000),
                                        ("8ch", -443)])
@pytest.mark.parametrize("out", ["q14", "raw"])
def test_exact_fir_kernel_matches_plain(cuda, bank, extra, out):
    """K5, both epilogues, EXACTLY equal to its plain version: the pager
    bank (ROW 128, taps resident, 256-row tiles) and
    etc/multifm_rtlsdr_8ch.json's (ROW 640, 64 columns a half, taps from
    L2), whole tiles, a ragged last one, many units and a short block,
    full-scale input."""
    from tsl_sdr_tpu_torch.ops import exact_fir as k5
    from tsl_sdr_tpu_torch.utils.config import MultifmConfig

    if bank == "pager":
        ch = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS,
                          pager.DECIMATION, exact=True, device=cuda)
    else:
        cfg = MultifmConfig.load(Path(__file__).resolve().parents[1]
                                 / "etc" / "multifm_rtlsdr_8ch.json")
        ch = MultifmChain.from_config(cfg, exact=True, device=cuda)
    plan = ch.packed_plan
    rows = 3 * ch.taps.exact.tile_rows + extra
    rng = np.random.default_rng(8)
    vals = torch.from_numpy(rng.integers(
        -32768, 32768, size=plan.carry_vals + rows * plan.row).astype(
            np.int16)).to(cuda)
    carry, block = vals[:plan.carry_vals], vals[plan.carry_vals:]
    before = k5.exact_fir.launches
    got = k5.exact_fir(ch.taps, carry, block, out)
    ref = k5.exact_fir_plain(ch.taps, carry, block, out)
    torch.cuda.synchronize()
    assert k5.exact_fir.launches == before + 1
    if out == "q14":
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    else:
        assert got.dtype == torch.int32 and torch.equal(got, ref)


def _wide_bank(shape):
    """BENCH_SUITE's channelizer shape (1 Msps, decimation 40, 128 taps) at
    ``shape`` channels, or etc/multifm_airspy.json's settings at its 232
    12.5 kHz channels."""
    if shape == "airspy_232ch":
        import json

        cfg = json.loads((Path(__file__).resolve().parents[1] / "etc"
                          / "multifm_airspy.json").read_text())
        return (cfg["lpfTaps"], -1_450_000 + 12_500 * np.arange(232),
                cfg["sampleRateHz"], cfg["decimationFactor"])
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = 1_000_000
    offs = np.random.default_rng(0).integers(-fs // 3, fs // 3, size=shape)
    return firdes_low_pass(1.0, fs, 12_500, 9_000)[:128], offs, fs, 40


def _adversarial(taps):
    """The same ChainTaps with every tap its layout may hold set to
    +-32767 (random signs); grouped taps keep the layout's zeros, which
    the grouped form leaves out."""
    from tsl_sdr_tpu_torch.ops import packed_fir

    plan = taps.plan
    support = packed_fir.tap_support(plan)
    rng = np.random.default_rng(17)
    w = np.where(rng.random(support.shape) < 0.5, -32767, 32767)
    if taps.grouped:
        w = np.where(support, w, 0)
    return k1.ChainTaps(packed_fir.with_taps_i16(plan, w.astype(np.int16)),
                        taps.omega_c.cpu().numpy(), device=taps.w_hi.device,
                        grouped=taps.grouped)


@pytest.mark.parametrize("shape", [16, 40, 64, 256, "airspy_232ch"])
@pytest.mark.parametrize("case", ["ragged", "adversarial", "many units"])
def test_wide_bank_kernels_match_plain(cuda, shape, case):
    """K1 and K5 (both epilogues) with grouped operands, EXACTLY equal to
    their plain versions on a block with a ragged last tile, on all -32768
    against taps of +-32767, and on 5,007 rows (more units than the
    persistent grid has blocks, runs that end mid-block); two halves of a
    block equal the whole. K1 runs its bank body at 16-256 channels (at 40
    in three sub-blocks of 16, the last half padding) and its tile body in
    channel blocks at 232; K5 runs sub-blocks of 32 tap tiles, resident,
    or at 232 channels 15 of at most 32 read from L2."""
    from tsl_sdr_tpu_torch.ops import exact_fir as k5

    ch = MultifmChain(*_wide_bank(shape), exact=False, device=cuda)
    taps, plan = ch.taps, ch.packed_plan
    assert taps.grouped
    assert taps.body == ("tile" if shape == "airspy_232ch" else "bank")
    assert (taps.chans_per_block < plan.nr_channels) == (shape != 16)
    rows = 3 * max(taps.tile_rows, taps.exact.tile_rows) + 5
    if case == "many units":
        rows = 5007
    n = plan.carry_vals + rows * plan.row
    if case == "adversarial":
        taps = _adversarial(taps)
        vals = np.full(n, -32768, np.int16)
    else:
        vals = np.random.default_rng(4).integers(-32768, 32768, size=n)
    vals = torch.from_numpy(vals.astype(np.int16)).to(cuda)
    carry, block = vals[:plan.carry_vals], vals[plan.carry_vals:]
    prev = torch.from_numpy(np.random.default_rng(7).normal(
        scale=1e5, size=(2, plan.nr_channels)).astype(np.float32)).to(cuda)
    before = (k1.chain_fm.grouped_launches, k5.exact_fir.grouped_launches,
              k1.chain_fm.bank_launches)
    got, gprev = k1.chain_fm(taps, carry, prev, block)
    ref, rprev = k1.chain_fm_plain(taps, carry, prev, block)
    assert torch.equal(got, ref) and torch.equal(gprev, rprev)
    for out in ("q14", "raw"):
        g5 = k5.exact_fir(taps, carry, block, out)
        r5 = k5.exact_fir_plain(taps, carry, block, out)
        if out == "q14":
            g5, r5 = torch.stack(g5), torch.stack(r5)
        assert torch.equal(g5, r5), out
    torch.cuda.synchronize()
    assert (k1.chain_fm.grouped_launches, k5.exact_fir.grouped_launches,
            k1.chain_fm.bank_launches) \
        == (before[0] + 1, before[1] + 2, before[2] + (taps.body == "bank"))
    half = (rows // 2) * plan.row
    carry2 = block[half - plan.carry_vals:half].contiguous()
    a, p_a = k1.chain_fm(taps, carry, prev, block[:half])
    b, p_b = k1.chain_fm(taps, carry2, p_a, block[half:])
    assert torch.equal(torch.cat([a, b]), got) and torch.equal(p_b, gprev)
    whole = k5.exact_fir(taps, carry, block, "raw")
    parts = [k5.exact_fir(taps, carry, block[:half], "raw"),
             k5.exact_fir(taps, carry2, block[half:], "raw")]
    assert torch.equal(torch.cat(parts), whole)


def test_exact_chain_on_the_card_equals_cpu(cuda):
    """MultifmChain(exact=True): K5, the uploaded rotator and the integer
    discriminator on the card give the CPU run's PCM byte for byte."""
    x = _iq(600_000, 9)
    outs = [MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ, pager.FS,
                         pager.DECIMATION, exact=True,
                         device=dev).process_array(x, block_size=131_072)
            for dev in (cuda, "cpu")]
    assert outs[0].shape == outs[1].shape and outs[0].size > 0
    np.testing.assert_array_equal(outs[0], outs[1])


def _costas_planes(k, c, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    xr = rng.normal(scale=scale, size=(k, c)).astype(np.float32)
    xi = rng.normal(scale=scale, size=(k, c)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, size=c).astype(np.float32)
    fd = rng.uniform(-0.05, 0.05, size=c).astype(np.float32)
    return [torch.from_numpy(a) for a in (xr, xi, ph, fd)]


def _costas_both(params, planes, chunk, device):
    """K6 and its plain version on the card from the same inputs."""
    xr, xi, ph, fd = (t.to(device) for t in planes)
    outs = []
    for fn in (k6.costas_block_planes, k6.costas_block_planes_plain):
        st = k6.CostasState(ph.clone(), fd.clone())
        st2, o_re, o_im = fn(params, st, xr, xi, chunk)
        outs.append((o_re, o_im, st2.last_phase, st2.f_dev))
    return outs


def _assert_costas_equal(outs):
    for got, want in zip(*outs):
        assert got.shape == want.shape
        assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("k,c,chunk", [(250_000, 8, None), (3 * 32 + 17, 1, 32),
                                       (40 * 32 + 5, 33, 32),
                                       (3 * 512 + 100, 1, 512),
                                       (2 * 512 + 7, 33, 512),
                                       (5 * 100 + 1, 4, 100), (9, 2, 22)])
def test_costas_kernel_matches_plain(cuda, k, c, chunk):
    """K6 against its plain version on the card: the slice's shape (8
    channels, K = 250,000, auto chunk 22 with its remainder of 14), chunks
    of 32, 100 and 512 (up to 16 samples a lane) at 1, 4 and 33 channels,
    a call shorter than one chunk: outputs and state exactly equal."""
    params = k6.make_costas_params(0.0, 0.05, 0.002, 8192)
    before = k6.costas_block_planes.launches
    _assert_costas_equal(_costas_both(params, _costas_planes(k, c, k + c),
                                      chunk, cuda))
    assert k6.costas_block_planes.launches == before + 1


@pytest.mark.parametrize("chunk", [32, 512])
def test_costas_kernel_adversarial(cuda, chunk):
    """Full-scale input past the error clip, gains far past stable so
    f_dev sits on both clamps, phases through zero and 2*pi: exactly
    equal."""
    params = k6.make_costas_params(1e-3, 0.5, 0.05, 8192)
    k, c = 6 * chunk + 3, 6
    t = np.arange(k, dtype=np.float64)[:, None]
    rot = np.array([0.9, -0.9, 2.5, -2.5, 0.0, 3.1])[None, :]
    planes = [torch.from_numpy((1.99 * f(rot * t)).astype(np.float32))
              for f in (np.cos, np.sin)]
    planes += [torch.tensor([0.0, 6.2831, 1e-7, 3.0, 6.28318, 0.5]),
               torch.tensor([-0.3, 0.3, 0.0, -0.29, 0.31, -0.31])]
    outs = _costas_both(params, planes, chunk, cuda)
    _assert_costas_equal(outs)
    assert (outs[0][0] * outs[0][1]).abs().max() > params.e_max


def test_costas_kernel_halves_equal_whole(cuda):
    """Two calls split at a multiple of the chunk equal one call."""
    params = k6.make_costas_params(0.0, 0.05, 0.002, 8192)
    xr, xi, ph, fd = (t.to(cuda) for t in _costas_planes(22 * 1000 + 9, 8,
                                                         3))
    st = k6.CostasState(ph, fd)
    s1, r1, i1 = k6.costas_block_planes(params, st, xr[:22 * 400],
                                        xi[:22 * 400])
    s2, r2, i2 = k6.costas_block_planes(params, s1, xr[22 * 400:],
                                        xi[22 * 400:])
    sw, rw, iw = k6.costas_block_planes(params, st, xr, xi)
    assert torch.equal(torch.cat([r1, r2]), rw)
    assert torch.equal(torch.cat([i1, i2]), iw)
    assert torch.equal(s2.last_phase, sw.last_phase)
    assert torch.equal(s2.f_dev, sw.f_dev)


def test_costas_chain_on_the_card_equals_plain(cuda, monkeypatch):
    """CostasChannelizer at BENCH_SUITE's costas_chain_device settings (8
    channels, 1 Msps, decimation 8, 64 taps) over three blocks, state
    carried: K5 and K6 launch, and the int16 output equals the run with
    both swapped for their plain versions."""
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = 1_000_000
    lpf = firdes_low_pass(1.0, fs, 40_000, 20_000)[:64]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=8)
    chain = costas_channel.CostasChannelizer(lpf, offsets, fs, 8,
                                             device=cuda)
    n = 200_000 // chain.block_quantum * chain.block_quantum
    iq = _iq(chain.carry_len + 3 * n, 21)

    def run():
        st = chain.init_state(prefix=iq[:chain.carry_len])
        outs = []
        for b in range(3):
            lo = chain.carry_len + b * n
            st, out = chain.step(st, iq[lo:lo + n])
            outs.append(out)
        return torch.cat(outs, 1), st

    fir, loop = k5.exact_fir, k6.costas_block_planes
    n5, n6 = fir.launches, loop.launches
    got, st_k = run()
    assert fir.launches == n5 + 3
    assert loop.launches == n6 + 3
    monkeypatch.setattr(costas_channel, "exact_fir", k5.exact_fir_plain)
    monkeypatch.setattr(k6, "costas_block_planes",
                        k6.costas_block_planes_plain)
    want, st_p = run()
    assert (fir.launches, loop.launches) == (n5 + 3, n6 + 3)
    assert got.shape == (8, 3 * n // 8, 2) and got.dtype == torch.int16
    assert torch.equal(got, want)
    assert torch.equal(st_k.costas.last_phase, st_p.costas.last_phase)


def test_costas_wrapper_raises_on_bad_input(cuda):
    """No fallback: a bad plane or state raises before any launch."""
    params = k6.make_costas_params(0.0, 0.05, 0.002, 8192)
    st = k6.init_costas_state(params, 4, cuda)
    x = torch.zeros((64, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        k6.costas_block_planes(params, st, x.double(), x)
    with pytest.raises(ValueError, match="last_phase"):
        k6.costas_block_planes(params, k6.init_costas_state(params, 3, cuda),
                               x, x)
    with pytest.raises(ValueError, match="chunk"):
        k6.costas_block_planes(params, st, x, x, chunk=513)
    with pytest.raises(ValueError, match="on cpu"):
        k6.costas_block_planes(params, k6.init_costas_state(params, 4, "cpu"),
                               x, x)


# -- K7, K8, K9: the block's last stages --------------------------------------

@pytest.mark.parametrize("case", stage_inputs.GATE_CASES, ids=lambda c: c[0])
def test_gate_kernel_matches_plain(cuda, case):
    """K7 at the pager's groups, the mixed capture's AIS shape, K % 8 !=
    0, K < TAIL and 130 rows: output buffer and new tail byte-equal to the
    plain version, at two launches (the flag scratch is reset)."""
    _, mode, g, k, types, layout, plants = case
    rows, tail = stage_inputs.gate_inputs(mode, g, k, types, plants, 9)
    if layout == "columns":
        mat = torch.from_numpy(np.stack(rows, axis=1)).to(cuda)
        trows = [mat[:, r] for r in range(g)]
    else:
        trows = [torch.from_numpy(r).to(cuda) for r in rows]
    tail = torch.from_numpy(tail).to(cuda)
    want = gate.egress_gate_plain(mode, trows, tail)
    before = gate.egress_gate.launches
    for _ in range(2):
        got = gate.egress_gate(mode, trows, tail)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert gate.egress_gate.launches == before + 2 * -(-g // gate.MAX_ROWS)
    assert stage_inputs.tested_rows(mode, k, plants) <= set(
        want[0][:, 0].nonzero().flatten().tolist())


@pytest.mark.parametrize("g,pole", [(1, 0.9999), (6, 0.5), (65, 0.9999)])
def test_dc_fast_kernel_matches_plain(cuda, g, pole):
    """K8 over blocks of the pager's 54,400 samples (the last ragged), the
    states carried: within 1 LSB of the plain version (float64 sums in
    another order; expect no sample to differ)."""
    x = torch.from_numpy(stage_inputs.dc_rows(np.random.default_rng(g), g,
                                              300_000)).to(cuda)
    p = dc_blocker.make_pole_coeff(pole)
    sk = [dc_blocker.init_dc_blocker_state(device=cuda) for _ in range(g)]
    sp = [dc_blocker.init_dc_blocker_state(device=cuda) for _ in range(g)]
    for lo in range(0, x.shape[1], 54_400):
        rows = [x[r, lo:lo + 54_400] for r in range(g)]
        sk, ok = dc_blocker.dc_block_fast(sk, rows, [p] * g)
        sp, op = dc_blocker.dc_block_fast_plain(sp, rows, [p] * g)
        assert (ok.int() - op.int()).abs().max() <= 1
    for a, b in zip(sk, sp):
        assert int(a.x_prev) == int(b.x_prev)
        assert abs(int(a.y_prev) - int(b.y_prev)) <= 1


def _scratches(name):
    return {key[2]: buf for key, buf in build._scratch.items()
            if key[0] == name}


def test_gate_scratch_needs_no_reset(cuda):
    """K7 at the pager's POCSAG group three times in a row on one stream,
    then three times on a second stream: each call one launch, equal to
    the plain version byte for byte, its flag scratch all zero again
    after it (no reset launch), and each stream with its own scratch."""
    case = stage_inputs.GATE_CASES[0]
    _, mode, g, k, types, _, plants = case
    rows, tail = stage_inputs.gate_inputs(mode, g, k, types, plants, 2)
    mat = torch.from_numpy(np.stack(rows, axis=1)).to(cuda)
    trows = [mat[:, r] for r in range(g)]
    tail = torch.from_numpy(tail).to(cuda)
    want = gate.egress_gate_plain(mode, trows, tail)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    seen = []
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for _ in range(3):
                before = gate.egress_gate.launches
                got = gate.egress_gate(mode, trows, tail)
                assert gate.egress_gate.launches == before + 1
                stream.synchronize()
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
                buf = _scratches("egress_gate")[stream.cuda_stream]
                assert not buf.any()
        seen.append(stream.cuda_stream)
    assert set(seen) <= set(_scratches("egress_gate")) and seen[0] != seen[1]
    assert want[0][:, 0].any()


def test_dc_fast_scratch_needs_no_reset(cuda):
    """K8 over 300,000 samples (147 chunks, five look-back windows) on two
    rows, three times in a row on one stream, then three times on a
    second stream while the first runs it again: each call one launch and
    within 1 LSB of the plain version (the same output every time: a
    chunk's carry does not depend on the order CTAs ran in), the ticket
    back at 0 after each (no reset launch), each stream with its own
    scratch."""
    x = torch.from_numpy(stage_inputs.dc_rows(np.random.default_rng(8), 2,
                                              300_000)).to(cuda)
    rows = [x[0], x[1]]
    ps = [dc_blocker.make_pole_coeff(0.9999), dc_blocker.make_pole_coeff(0.5)]
    sts = [dc_blocker.init_dc_blocker_state(device=cuda) for _ in ps]
    _, want = dc_blocker.dc_block_fast_plain(sts, rows, ps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for _ in range(3):
                before = dc_blocker.dc_block_fast.launches
                outs.append(dc_blocker.dc_block_fast(sts, rows, ps)[1])
                assert dc_blocker.dc_block_fast.launches == before + 1
        if stream is side:
            # the first stream again, at the same time as the second
            outs.append(dc_blocker.dc_block_fast(sts, rows, ps)[1])
    torch.cuda.synchronize()
    for out in outs:
        assert (out.int() - want.int()).abs().max() <= 1
        assert torch.equal(out, outs[0])
    bufs = _scratches("dc_block_fast")
    assert {torch.cuda.current_stream().cuda_stream, side.cuda_stream} <= \
        set(bufs)
    for buf in bufs.values():   # the ticket, below the launch epoch
        assert int(buf[:8].view(torch.int64)) & 0xFFFFFF == 0


def _gate_graph_case(cuda, seed):
    case = stage_inputs.GATE_CASES[0]
    _, mode, g, k, types, _, plants = case
    plants = plants[:seed % len(plants) + 1]
    rows, tail = stage_inputs.gate_inputs(mode, g, k, types, plants, seed)
    return (torch.from_numpy(np.stack(rows, axis=1)).to(cuda),
            torch.from_numpy(tail).to(cuda))


@pytest.mark.parametrize("kernel", ["dc_fast", "gate"])
def test_scratch_survives_graph_replay(cuda, kernel):
    """K8 (300,000 samples on two rows, 147 chunks) and K7 (the pager's
    POCSAG group) captured once in a CUDA graph and replayed three times,
    new input copied into the captured rows before each replay: every
    replay equals the plain version on its own input. A replay passes the
    launch's arguments as captured, so K8's look-back tags must come from
    an epoch on the device and K7's flag word must be left zero."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    if kernel == "dc_fast":
        def data(seed):
            return torch.from_numpy(stage_inputs.dc_rows(
                np.random.default_rng(seed), 2, 300_000)).to(cuda)
        x = data(20)
        ps = [dc_blocker.make_pole_coeff(0.9999),
              dc_blocker.make_pole_coeff(0.5)]
        sts = [dc_blocker.init_dc_blocker_state(device=cuda) for _ in ps]

        def run():
            return dc_blocker.dc_block_fast(sts, [x[0], x[1]], ps)[1]

        def plain():
            return dc_blocker.dc_block_fast_plain(sts, [x[0], x[1]], ps)[1]
    else:
        mat, tail = _gate_graph_case(cuda, 20)
        mode = stage_inputs.GATE_CASES[0][1]

        def data(seed):
            return _gate_graph_case(cuda, seed)

        def run():
            return gate.egress_gate(mode, list(mat.unbind(1)), tail)

        def plain():
            return gate.egress_gate_plain(mode, list(mat.unbind(1)), tail)
    with torch.cuda.stream(side):
        run()   # the scratch is made outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = run()
    for seed in (21, 22, 23):
        if kernel == "dc_fast":
            x.copy_(data(seed))
        else:
            m2, t2 = data(seed)
            mat.copy_(m2)
            tail.copy_(t2)
        graph.replay()
        torch.cuda.synchronize()
        want = plain()
        if kernel == "dc_fast":
            assert (got.int() - want.int()).abs().max() <= 1
        else:
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_dc_fast_refuses_short_scratch(cuda):
    """The C entry point checks the scratch against the size it exports
    (tsl_dc_block_fast_scratch): a byte short is cudaErrorInvalidValue,
    before any launch."""
    import array

    x = torch.zeros(54_400, dtype=torch.int16, device=cuda)
    st = dc_blocker.init_dc_blocker_state(device=cuda)
    k, table = build.row_table([x], x.get_device(), "test")
    ptrs = array.array("q", (st.x_prev.data_ptr(), st.y_prev.data_ptr()))
    q = array.array("d", (0.9999,))
    out = torch.empty((1, k), dtype=torch.int16, device=cuda)
    st_out = torch.empty((1, 2), dtype=torch.int32, device=cuda)
    lib = build.load()
    nbytes = lib.tsl_dc_block_fast_scratch(k)
    scratch = torch.zeros(nbytes, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (table.buffer_info()[0], ptrs.buffer_info()[0],
            q.buffer_info()[0], 1, k, out.data_ptr(), st_out.data_ptr(),
            scratch.data_ptr())
    assert lib.tsl_dc_block_fast(*args, nbytes - 1, stream) == 1
    assert lib.tsl_dc_block_fast(*args, nbytes, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", stage_inputs.K9_CASES)
def test_exact_fm_kernel_matches_plain(cuda, name):
    """K9 at the exact pager block's shape (130,560 x 8) on random and
    adversarial sums: PCM, channelized IQ and FM carry bit-equal."""
    args = [torch.from_numpy(a).to(cuda)
            for a in stage_inputs.k9_inputs(name, 130_560, 8)]
    got = fm.exact_fm(*args)
    want = fm.exact_fm_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_exact_chain_runs_k9(cuda):
    """The exact chain's step launches K9 once a block, and its PCM and
    channelized IQ equal the CPU's."""
    rng = np.random.default_rng(3)
    iq = rng.integers(-3000, 3000, size=(3 * 8192 + 577, 2)).astype(np.int16)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        ch = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ[:3], pager.FS,
                          pager.DECIMATION, exact=True, device=dev)
        st = ch.init_state(iq[:ch.carry_len])
        n = (len(iq) - ch.carry_len) // ch.block_quantum * ch.block_quantum
        before = fm.exact_fm.launches
        st, pcm, chan = ch.step_debug(st, iq[ch.carry_len:ch.carry_len + n])
        outs[dev.type] = (pcm, chan)
        if dev.type == "cuda":
            assert fm.exact_fm.launches == before + 1
    np.testing.assert_array_equal(outs["cuda"][0], outs["cpu"][0])
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])


def test_new_wrappers_raise_on_bad_input(cuda):
    """K7, K8 and K9 refuse what their kernels do not take."""
    tail = torch.zeros((1, 2560), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="int16 or float32"):
        gate.egress_gate("pocsag", [torch.zeros(64, device=cuda,
                                                dtype=torch.float64)], tail)
    with pytest.raises(ValueError, match="shorter than its"):
        gate.egress_gate("pocsag", [torch.zeros(64, device=cuda)],
                         tail[:, :1024])
    st = dc_blocker.init_dc_blocker_state(device="cpu")
    with pytest.raises(ValueError, match="int32 scalars"):
        dc_blocker.dc_block_fast([st], [torch.zeros(64, device=cuda)], [1])
    z = torch.zeros((8, 2), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="seq"):
        fm.exact_fm(z, z, z, torch.zeros((2, 2), dtype=torch.int32,
                                         device=cuda))


# -- K9's tiles and K10 (the integer NCO and its scalings) -------------------

@pytest.mark.parametrize("c,k", [(1, 4109), (8, 130_557), (64, 6_553),
                                 (232, 2_181), (256, 1_031)])
@pytest.mark.parametrize("name", ["random", "full scale"])
def test_exact_fm_kernel_tiles_match_plain(cuda, c, k, name):
    """K9 at one channel (a tile of 4,096 outputs), the pager's 8, 64 (every
    channel a CTA), 232 and 256 (blocks of 32), each with a ragged last
    tile: PCM, channelized IQ and FM carry bit-equal; then the same inputs
    off the 16-byte grid (the kernel's scalar loads)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in stage_inputs.k9_inputs(name, k, c, seed=c)]
    off = []
    for a, by in zip(args[:3], (1, 1, 2)):   # seq by one (re, im) pair
        buf = torch.empty(a.numel() + 2, dtype=a.dtype, device=cuda)
        view = buf[by:by + a.numel()].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16
        off.append(view)
    for inputs in (args, off + args[3:]):
        got = fm.exact_fm(*inputs)
        want = fm.exact_fm_plain(*inputs)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _costas_row_sums(cuda, blocks=1):
    """K5's raw sums of random IQ at BENCH_SUITE's costas_chain_device
    chain (8 channels, decimation 8, 2,000,000-sample blocks): the chain
    and one [rows, 2 * halfcols] int32 tensor a block."""
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = 1_000_000
    lpf = firdes_low_pass(1.0, fs, 40_000, 20_000)[:64]
    offsets = np.random.default_rng(0).integers(-fs // 3, fs // 3, size=8)
    chain = costas_channel.CostasChannelizer(lpf, offsets, fs, 8,
                                             device=cuda)
    n = 2_000_000 // chain.block_quantum * chain.block_quantum
    iq = torch.from_numpy(_iq(chain.carry_len + blocks * n, 22)).to(cuda)
    vals = iq.reshape(-1)
    c_v = 2 * chain.carry_len
    sums = [k5.exact_fir(chain.taps, vals[c_v + 2 * b * n - c_v:
                                          c_v + 2 * b * n],
                         vals[c_v + 2 * b * n:c_v + 2 * (b + 1) * n], "raw")
            for b in range(blocks)]
    return chain, sums


@pytest.mark.parametrize("k0", [0, 2**31 - 50_000, 5 * 2**32 + 3])
def test_nco_kernel_matches_plain(cuda, k0):
    """K10 at the Costas row (250,000 x 8) in both modes, at output
    indices where the int32 phase wraps inside the block: bit-equal to
    its plain version (torch's cos and sin on the card are the CUDA math
    library's, as the kernel's)."""
    chain, (p,) = _costas_row_sums(cuda)
    om = chain._omega_i32
    before = packed_fir.nco_derotate.launches
    for out in ("planes", "int16"):
        got = packed_fir.nco_derotate(p, om, k0, out)
        want = packed_fir.nco_derotate_plain(p, om, k0, out)
        torch.cuda.synchronize()
        got, want = (got, want) if out == "planes" else ((got,), (want,))
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b), int((a != b).sum())
    assert packed_fir.nco_derotate.launches == before + 2


@pytest.mark.parametrize("rows,c,opr", [(97, 3, 5), (5, 1, 1), (64, 8, 3)])
def test_nco_kernel_scalar_shapes(cuda, rows, c, opr):
    """Rows of a length off the 4-vector grid (the kernel's scalar loads
    and stores) and a p one element off the 16-byte grid, full-scale sums
    that saturate the int16 baseband: both modes bit-equal."""
    rng = np.random.default_rng(rows)
    p = torch.from_numpy(rng.integers(-2**31, 2**31, size=(
        rows, 2 * opr * c)).astype(np.int32)).to(cuda)
    om = torch.from_numpy(packed_fir.omega_turns_i32(
        rng.uniform(-np.pi, np.pi, size=c))).to(cuda)
    buf = torch.empty(p.numel() + 1, dtype=torch.int32, device=cuda)
    moved = buf[1:].view(p.shape)
    moved.copy_(p)
    for src in (p, moved):
        for out in ("planes", "int16"):
            got = packed_fir.nco_derotate(src, om, 2**32 - 7, out)
            want = packed_fir.nco_derotate_plain(src, om, 2**32 - 7, out)
            torch.cuda.synchronize()
            got, want = (got, want) if out == "planes" else ((got,), (want,))
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_costas_paths_launch_k10_once_a_block(cuda):
    """``CostasChannelizer.step`` and ``process_array_native`` and the
    production tier's ``step_debug`` each launch K10 once a block."""
    chain, _ = _costas_row_sums(cuda, blocks=0)
    q = chain.block_quantum
    n = 100_000 // q * q
    iq = _iq(chain.carry_len + 3 * n, 23)
    counter = packed_fir.nco_derotate
    before = counter.launches
    st = chain.init_state(prefix=iq[:chain.carry_len])
    for b in range(3):
        lo = chain.carry_len + b * n
        st, _ = chain.step(st, iq[lo:lo + n])
    assert counter.launches == before + 3
    chain.process_array_native(iq, block_size=n)
    assert counter.launches == before + 6
    mf = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ[:3], pager.FS,
                      pager.DECIMATION, exact=False, device=cuda)
    x = _iq(mf.carry_len + 2 * 8 * mf.block_quantum, 24)
    st = mf.init_state(x[:mf.carry_len])
    for b in range(2):
        lo = mf.carry_len + b * 8 * mf.block_quantum
        st, _, _ = mf.step_debug(st, x[lo:lo + 8 * mf.block_quantum])
    assert counter.launches == before + 8


def test_nco_and_exact_fm_wrappers_raise_on_bad_input(cuda):
    """K9 and K10 refuse wrong dtypes, shapes and devices before any
    launch."""
    om = torch.zeros(4, dtype=torch.int32, device=cuda)
    p = torch.zeros((6, 16), dtype=torch.int32, device=cuda)
    before = packed_fir.nco_derotate.launches
    with pytest.raises(ValueError, match="int32"):
        packed_fir.nco_derotate(p.float(), om, 0, "planes")
    with pytest.raises(ValueError, match="a multiple of 4"):
        packed_fir.nco_derotate(p[:, :12], om, 0, "int16")
    with pytest.raises(ValueError, match="omega_i32"):
        packed_fir.nco_derotate(p, om.long(), 0, "planes")
    with pytest.raises(ValueError, match="on cpu"):
        packed_fir.nco_derotate(p, om.cpu(), 0, "planes")
    with pytest.raises(ValueError, match="contiguous"):
        packed_fir.nco_derotate(p.T.contiguous().T, om, 0, "planes")
    assert packed_fir.nco_derotate.launches == before
    z = torch.zeros((8, 2), dtype=torch.int16, device=cuda)
    last = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="a_im"):
        fm.exact_fm(z, z.int(), torch.zeros((8, 2, 2), dtype=torch.int16,
                                            device=cuda), last)
    with pytest.raises(ValueError, match="last"):
        fm.exact_fm(z, z, torch.zeros((8, 2, 2), dtype=torch.int16,
                                      device=cuda), last.cpu())
    seq = torch.zeros(8 * 2 * 2 + 1, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="4-byte"):
        fm.exact_fm(z, z, seq[1:].view(8, 2, 2), last)


# -- the K1 lab (bench/torch_k1_lab.py): patched copies of K1's bodies -------

def _k1_lab():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_k1_lab", Path(__file__).resolve().parents[1] / "bench"
        / "torch_k1_lab.py")
    lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lab)
    return lab


k1_lab = _k1_lab()
# the lab's variants with a defined output (the rest are timing-only)
K1_LAB_EXACT = sorted(k for k, v in k1_lab.VARIANTS.items()
                      if v.out != "timing" and k[1] != "two")


@pytest.fixture(scope="module")
def k1_lab_libs():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU (no CPU mode)")
    return k1_lab.build_all(K1_LAB_EXACT)[0]


def _k1_lab_shape(body, full_scale):
    """A small block on the card: the pager's tile body (2 tiles and a
    ragged one), or the bank body at 16 channels of the JAX labs'
    settings (3 tiles, the last ragged)."""
    if body == "tile":
        return k1_lab.make_shape("pager", "cuda", seed=3,
                                 samples=(2 * 255 + 37) * 64,
                                 full_scale=full_scale)
    chain = k1_lab.lab_chain(16, "cuda")
    plan = chain.taps.plan
    x = _iq(plan.carry_len + (2 * 63 + 20) * plan.row // 2, 4)
    if full_scale:
        x[-500:] = -32768
    vals = torch.from_numpy(x.reshape(-1).copy()).cuda()
    prev = torch.from_numpy(np.random.default_rng(5).normal(
        scale=1e5, size=(2, 16)).astype(np.float32)).cuda()
    return k1_lab.Shape("16 channels", chain.taps, vals[:plan.carry_vals],
                        vals[plan.carry_vals:], prev)


@pytest.mark.parametrize("key", K1_LAB_EXACT, ids=" ".join)
@pytest.mark.parametrize("full_scale", [False, True])
def test_k1_lab_variant_matches_plain(cuda, k1_lab_libs, key, full_scale):
    """Each lab variant with a defined output (K1's PCM and carry: carryful,
    ring2, ring4, streams*full, par*; the copy, split and FIR cuts and
    carryfir) EXACTLY equal to its plain version at one small shape."""
    shape = _k1_lab_shape(key[0], full_scale)
    v = k1_lab.VARIANTS[key]
    tr = k1_lab.launch_tile(v, shape.taps)[0] if key[0] == "tile" else None
    assert k1_lab.check(k1_lab_libs[key], v, shape, tr) == 0


def test_k1_lab_check_sees_a_skipped_tile(cuda, k1_lab_libs):
    """The lab's check fails a ring2 build that never computes tile 1, run
    right after the true ring2 filled a same-sized output correctly: each
    output is filled with a sentinel first, so output a variant never
    writes cannot pass on what the allocator hands back."""
    key = ("tile", "ring2")
    v = k1_lab.VARIANTS[key]
    anchor = ("    chain_tile(t, t > t0, smem + (size_t)((t - t0) % LAB_NBUF)"
              " * slot,\n")
    skip = v._replace(cuts=v.cuts + (k1_lab.Cut(
        k1_lab.T, anchor, "    if (t != 1)   // tile 1 is never computed\n"
        + anchor),))
    lib = k1_lab.build_all([key], {key: skip})[0][key]
    shape = _k1_lab_shape("tile", False)
    tr = k1_lab.launch_tile(v, shape.taps)[0]
    rows = shape.block.numel() // shape.taps.plan.row
    assert rows > 2 * tr   # tile 1 is a whole tile, not the last
    assert k1_lab.check(k1_lab_libs[key], v, shape, tr) == 0
    assert k1_lab.check(lib, skip, shape, tr) > 0
