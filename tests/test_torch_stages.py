"""The pipeline's plain-torch device stages against the JAX package:
wire widening, the DC blocker's fast tier, the sync prefilters, packbits and
the float -> int16 cast.

Tolerances: everything EXACT except the DC blocker, held within 2 PCM LSB:
the JAX fast tier runs a float32 associative scan, the port a float64
chunked scan, and both round the same IIR's output to int16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsl_sdr_tpu.ops import dc_blocker as jdcb
from tsl_sdr_tpu.ops import sync_prefilter as jsp
from tsl_sdr_tpu.utils.iq import IQ_FORMATS, WIRE_DTYPES, widen_iq_bytes
from tsl_sdr_tpu_torch.models.pipeline import to_int16, widen_wire
from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
from tsl_sdr_tpu_torch.ops import sync_prefilter as sp


@pytest.mark.parametrize("fmt", IQ_FORMATS)
def test_wire_widening_matches_host_rules(fmt):
    raw = np.arange(512, dtype=np.int64).astype(np.uint8)  # every byte x2
    raw = np.concatenate([raw, np.random.default_rng(0).integers(
        0, 256, size=4096).astype(np.uint8)])
    ref = widen_iq_bytes(raw, fmt)
    wire = torch.from_numpy(raw.view(WIRE_DTYPES[fmt]).copy())
    got = widen_wire(wire, fmt)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("pole", [0.9999, 0.999, 0.99])
def test_dc_blocker_fast_tier_matches_jax(pole):
    p = dcb.make_pole_coeff(pole)
    assert p == jdcb.make_pole_coeff(pole)
    rng = np.random.default_rng(1)
    t = np.arange(2 * 3000 + 1)
    x = (6000 * np.sin(2 * np.pi * t / 97) + 2500
         + rng.normal(scale=400, size=t.shape))
    x = np.clip(x, -32768, 32767).astype(np.int16)
    jst = jdcb.init_dc_blocker_state()
    tst = dcb.init_dc_blocker_state(device="cpu")
    for blk in (x[:3000], x[3000:3001], x[3001:]):   # incl. a 1-sample block
        jst, jo = jdcb.dc_blocker_step_fast(jst, blk, p)
        tst, to = dcb.dc_blocker_step_fast(tst, torch.from_numpy(blk), p)
        diff = np.abs(np.asarray(jo, np.int32) - to.numpy().astype(np.int32))
        assert diff.max() <= 2, diff.max()
        assert int(jst.x_prev) == int(tst.x_prev)
        assert abs(int(jst.y_prev) - int(tst.y_prev)) <= 2


def _planted_bits(rng, c, n, words, spb, every):
    """Random bit planes with a 32-bit word planted at stride spb."""
    bits = rng.integers(0, 2, size=(c, n)).astype(np.uint8)
    for ch in range(0, c, every):
        pos = rng.integers(40 * spb, n - 40 * spb)
        for k in range(32):
            bits[ch, pos - k * spb] = (words >> k) & 1
    return bits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefilters_match_jax(seed):
    rng = np.random.default_rng(seed)
    k_new = 6000
    # POCSAG: sync word at 1200 baud (spb 32) held for spb/2 + 1 samples
    bits = rng.integers(0, 2, size=(4, sp.POCSAG_TAIL + k_new)).astype(
        np.uint8)
    for ch in (0, 2):
        pos = rng.integers(sp.POCSAG_TAIL + 40 * 32, bits.shape[1] - 64)
        for run in range(17):
            for k in range(32):
                bits[ch, pos + run - k * 32] = (sp.POCSAG_SYNC >> k) & 1
    ref = np.asarray(jsp.pocsag_any_candidate(jnp.asarray(bits), k_new))
    got = sp.pocsag_any_candidate(torch.from_numpy(bits), k_new).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] and got[2]

    bits = _planted_bits(rng, 3, sp.FLEX_TAIL + k_new, sp.FLEX_BS1, 10, 2)
    ref = np.asarray(jsp.flex_any_candidate(jnp.asarray(bits), k_new))
    got = sp.flex_any_candidate(torch.from_numpy(bits), k_new).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] and got[2]

    bits = rng.integers(0, 2, size=(3, sp.AIS_TAIL + k_new)).astype(np.uint8)
    ref = np.asarray(jsp.ais_any_candidate(jnp.asarray(bits), k_new))
    got = sp.ais_any_candidate(torch.from_numpy(bits), k_new).numpy()
    np.testing.assert_array_equal(got, ref)


def test_popcount_covers_all_32_bits():
    v = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7CD215D8, 0xAAAAAAAA],
                 np.int64)
    want = [bin(int(x)).count("1") for x in v]
    assert sp._popcount32(torch.from_numpy(v)).tolist() == want


@pytest.mark.parametrize("k", [1, 7, 8, 9, 64, 1001])
def test_packbits_matches_numpy(k):
    bits = np.random.default_rng(k).integers(0, 2, size=(3, k)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        sp.packbits(torch.from_numpy(bits)).numpy(),
        np.packbits(bits, axis=1))


def test_float_to_int16_cast_matches_jax():
    """Pin JAX's f32 -> int16 astype at and beyond the int16 range
    (it saturates; inf saturates too) and match it."""
    x = np.array([0.0, 0.7, -0.7, 1.5, -1.5, 32766.9, 32767.0, 32767.9,
                  32768.0, 40000.0, 1e10, np.inf, -32767.9, -32768.0,
                  -32768.9, -32769.0, -40000.0, -1e10, -np.inf], np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int16))
    assert ref[8] == 32767 and ref[-1] == -32768      # the pinned behaviour
    np.testing.assert_array_equal(to_int16(torch.from_numpy(x)).numpy(), ref)
    ints = torch.tensor([-5, 0, 7], dtype=torch.int16)
    assert torch.equal(to_int16(ints), ints)
