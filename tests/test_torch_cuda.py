"""The hand-written CUDA kernels against their plain torch versions.

These run only on a machine with an NVIDIA GPU and nvcc (the kernels have
no CPU mode); elsewhere each test skips. The file imports no jax, so the
card's machine can run it without the JAX package's test setup:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: K1 <= 1 PCM LSB and >= 99.9 % exact (its float ops are written
to match the plain version one to one, so it is exact in practice); K3
EXACTLY equal (exact int32 sums, one float32 conversion, a power-of-two
scale).
"""

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import chain as k1
from tsl_sdr_tpu_torch.ops import polyphase, q14
from tsl_sdr_tpu_torch.ops import row_resampler as k3
from tsl_sdr_tpu_torch.testing import pager

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


@pytest.mark.parametrize("tiles,extra", [(4, 0), (4, 2), (0, 3)])
def test_chain_kernel_matches_plain(cuda, tiles, extra):
    """Whole tiles, a ragged last tile, and a block shorter than a tile, at
    four of the pager deployment's channels (577 taps, decimate by 32)."""
    ch = MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ[::2], pager.FS,
                      pager.DECIMATION, device=cuda)
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
    the kernel's 8-row tile; K_ROW = 640 is five 128-column tiles."""
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
    got = k3.row_resample(carry, block, taps.w0, taps.w1, row_in=plan.row_in)
    ref = k3.row_resample_plain(carry, block, taps.w0, taps.w1,
                                row_in=plan.row_in)
    torch.cuda.synchronize()
    assert k3.row_resample.launches == before + 1
    assert got.shape == (g, m, plan.k_row)
    assert torch.equal(got, ref)


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
    w0 = torch.zeros((16, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="w0"):
        k3.row_resample(torch.zeros((1, 4), dtype=torch.int16, device=cuda),
                        torch.zeros((1, 64), dtype=torch.int16, device=cuda),
                        w0.to(torch.float32), None, row_in=16)
