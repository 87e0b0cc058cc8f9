"""The port's fused channelizer + FM (ops/chain.py, kernel K1) against the
JAX package's production tier.

Tolerances:
- vs the XLA tier (``MultifmChain(backend="xla")._step_raw``): <= 1 PCM LSB
  with the +-pi phase wrap folded. Both take the same int32 accumulators
  (the port's are exact in float64, the XLA tier's exact in int32); the
  port's polynomial atan2 differs from XLA's arctan2 by ~2e-6 rad
  (0.01 LSB), which flips a truncation at most one LSB
  (tests/test_pallas_chain.py:36).
- vs the Pallas kernel in interpret mode at HIGHEST precision: <= 1 LSB (its
  f32 matmul sum of int-valued products may round where int32 does not).
- block boundaries and tiles: EXACTLY equal (integer sums, same float ops).
(The CUDA kernel against this plain version: tests/test_torch_cuda.py.)
"""

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models.channelizer import MultifmChain as JaxChain
from tsl_sdr_tpu.ops.pallas_chain import PallasChain
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import chain as k1


def _lsb_diff(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return np.minimum(d, 32768 - d)


CASES = {
    # 2 channels, 96 taps, decimate by 16 (tests/test_pallas_chain.py)
    "2ch_d16": (512_000, 16, firdes_low_pass(1.0, 512_000, 18_000, 9_000)[:96],
                [40_000, -100_000]),
    # 4 of the pager deployment's channels at its full 577-tap width
    "4ch_pager": (1_228_800, 32, firdes_low_pass(1.0, 1_228_800, 9_600, 7_000),
                  [-450_000, -60_000, 190_000, 450_000]),
}


def _iq(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(
        np.int16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chain_matches_xla_tier(case):
    fs, d, lpf, offs = CASES[case]
    ref = JaxChain(lpf, offs, fs, d, exact=False, backend="xla")
    got = MultifmChain(lpf, offs, fs, d, device="cpu")
    q, c_len = got.block_quantum, got.carry_len
    x = _iq(c_len + 50 * q, 1)
    js = ref.init_state(prefix=x[:c_len])
    ts = got.init_state(prefix=x[:c_len])
    pos = c_len
    outs_j, outs_t = [], []
    for nq in (10, 30, 10):          # uneven blocks: state threads across
        blk = x[pos:pos + nq * q].reshape(-1)
        js, pj = ref._step_raw(js, blk)
        ts, pt = got._step_raw(ts, torch.from_numpy(blk.copy()))
        outs_j.append(np.asarray(pj))
        outs_t.append(pt.numpy())
        pos += nq * q
    diff = _lsb_diff(np.concatenate(outs_j), np.concatenate(outs_t))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99
    np.testing.assert_array_equal(np.asarray(js.carry_vals),
                                  ts.carry_vals.numpy())
    # the FM carry is the last baseband sample: same int32 sums -> equal
    np.testing.assert_array_equal(np.asarray(js.prev_r), ts.prev_r.numpy())
    np.testing.assert_array_equal(np.asarray(js.prev_i), ts.prev_i.numpy())
    assert int(js.out_index) == ts.out_index


@pytest.mark.parametrize("rows", [16 * 6, 16 * 5 + 7])
def test_plain_chain_matches_pallas_interpret(rows):
    """rows = 96: tile-aligned (the zero-copy kernel, _chain_call_v2);
    rows = 87: ragged (the padded kernel, _chain_call)."""
    fs, d, lpf, offs = CASES["2ch_d16"]
    got = MultifmChain(lpf, offs, fs, d, device="cpu")
    plan = got.packed_plan
    pal = PallasChain(plan, got._omega_reduced, interpret=True,
                      precision="highest")
    pal.tr = 16  # several grid programs in interpret mode
    q = plan.block_quantum
    n = rows * q
    x = _iq(plan.carry_len + n, 2)
    outs_p, outs_t = [], []
    ps = pal.init_carry(x[:plan.carry_len])
    ts = got.init_state(prefix=x[:plan.carry_len])
    split = n // 2 // q * q
    for lo, hi in ((0, split), (split, n)):
        blk = x[plan.carry_len + lo:plan.carry_len + hi].reshape(-1)
        ps, pp = pal.step(ps, blk)
        ts, pt = got._step_raw(ts, torch.from_numpy(blk.copy()))
        outs_p.append(np.asarray(pp))
        outs_t.append(pt.numpy())
    # the Pallas carry seeds the first sample's FM history from a zero
    # look-back row, the port (like the XLA tier) from a zero baseband
    # sample: the first output of each channel differs by design
    c = plan.nr_channels
    diff = _lsb_diff(np.concatenate(outs_p).reshape(-1)[c:],
                     np.concatenate(outs_t).reshape(-1)[c:])
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


def test_plain_chain_block_boundary_invariance():
    fs, d, lpf, offs = CASES["4ch_pager"]
    ch = MultifmChain(lpf, offs, fs, d, device="cpu")
    q, c_len = ch.block_quantum, ch.carry_len
    x = torch.from_numpy(_iq(c_len + 24 * q, 3))
    _, whole = ch._step_raw(ch.init_state(prefix=x[:c_len].numpy()),
                            x[c_len:].reshape(-1))
    st = ch.init_state(prefix=x[:c_len].numpy())
    parts = []
    pos = c_len
    for nq in (1, 7, 16):
        st, p = ch._step_raw(st, x[pos:pos + nq * q].reshape(-1))
        parts.append(p)
        pos += nq * q
    assert torch.equal(torch.cat(parts), whole)


def test_ragged_last_tile_matches_xla():
    """A pipeline-sized block at the pager width whose row count is not a
    multiple of the kernel tile (65,280 rows at 127: last tile 2 rows);
    here at 2 channels and a block of 1,018 rows (8 tiles + 2)."""
    fs, d, lpf, offs = CASES["4ch_pager"]
    ch = MultifmChain(lpf, offs[:2], fs, d, device="cpu")
    tr = ch.taps.tile_rows
    rows = 8 * tr + 2
    assert rows % tr == 2
    ref = JaxChain(lpf, offs[:2], fs, d, exact=False, backend="xla")
    x = _iq(ch.carry_len + rows * ch.block_quantum, 4)
    _, pj = ref._step_raw(ref.init_state(prefix=x[:ch.carry_len]),
                          x[ch.carry_len:].reshape(-1))
    _, pt = ch._step_raw(ch.init_state(prefix=x[:ch.carry_len]),
                         torch.from_numpy(x[ch.carry_len:].reshape(-1).copy()))
    assert pt.shape == (rows, ch.packed_plan.halfcols)
    assert _lsb_diff(np.asarray(pj), pt.numpy()).max() <= 1


@pytest.mark.parametrize("row,cr,hc", [(128, 9, 16), (640, 1, 64),
                                       (128, 2, 512), (1280, 6, 8),
                                       (3200, 1, 192)])
def test_tile_rows_fit_the_kernel(row, cr, hc):
    """Tiles of whole 16-row m-tiles whose staged rows (high and low byte
    planes, pitch ROW + 16) and f32 accumulators fit in 227 KB (3,200-value
    rows: the decimation-50 pipeline), in one block of all ``hc`` output
    columns (here one output a row of ``hc`` channels)."""
    tap_bytes = 2 * (cr + 1) * row // 32 * -(-2 * hc // 8) * 256
    tr, cpb = k1.launch_shape(row, cr, hc, 1, lambda c: tap_bytes)
    assert cpb == hc
    assert (tr + 1) % 16 == 0 and 15 <= tr <= 255
    x_bytes = 2 * (tr + 1 + cr) * (row + 16)
    assert x_bytes + 2 * (tr + 1) * hc * 4 <= 227 * 1024


def test_cpu_tensor_runs_plain_version():
    fs, d, lpf, offs = CASES["2ch_d16"]
    ch = MultifmChain(lpf, offs, fs, d, device="cpu")
    before = k1.chain_fm.launches
    st = ch.init_state()
    block = torch.from_numpy(_iq(4 * ch.block_quantum, 5).reshape(-1))
    prev = torch.stack([st.prev_r, st.prev_i])
    got = k1.chain_fm(ch.taps, st.carry_vals, prev, block)
    ref = k1.chain_fm_plain(ch.taps, st.carry_vals, prev, block)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert k1.chain_fm.launches == before  # no kernel launched on the CPU
