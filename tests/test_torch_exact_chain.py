"""The port's bit-exact channelizer tier against the JAX package's, on the
CPU, bit for bit: the LUT arctangent, the integer discriminator, the native
rotator, the exact packed FIR (K5's plain version, both epilogues), and
``MultifmChain(exact=True)`` whole and streamed from a state carried across
from JAX. ``step_debug``'s tap on both tiers: the exact tier's IQ and PCM
equal; the production tier's PCM within 1 LSB of the XLA tier's (the
chain's bound, tests/test_torch_chain.py) and its IQ within 1 LSB (the
NCO's float32 cos/sin may differ from XLA's by an ulp, which can flip a
truncation).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models.channelizer import MultifmChain as JaxChain
from tsl_sdr_tpu.ops import atan2 as jatan2
from tsl_sdr_tpu.ops import fm as jfm
from tsl_sdr_tpu.ops import packed_fir as jpf
from tsl_sdr_tpu.runtime import native as jnative
from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
from tsl_sdr_tpu_torch.ops import atan2, exact_fir, fm, packed_fir
from tsl_sdr_tpu_torch.runtime import native
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.utils import convert
from tsl_sdr_tpu_torch.utils.config import MultifmConfig
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

# (lpf, offsets, fs, decimation): the pager deployment's bank (ROW 128,
# cr 9, 16 output columns a half) and etc/multifm_rtlsdr_8ch.json's (ROW
# 640, cr 2, 64 a half)
_8CH = MultifmConfig.load(Path(__file__).resolve().parents[1] / "etc"
                          / "multifm_rtlsdr_8ch.json")
BANKS = {
    "pager": (pager.lpf_taps(), list(pager.OFFSETS_HZ), pager.FS,
              pager.DECIMATION),
    "rtlsdr_8ch": (np.asarray(_8CH.lpf_taps), _8CH.channel_offsets_hz,
                   _8CH.sample_rate_hz, _8CH.decimation_factor),
    "2ch": (firdes_low_pass(1.0, 1_000_000, 12_500, 9_000), [138_000,
                                                            -212_500],
            1_000_000, 40),
}


def _iq(n, seed, scale=9000):
    rng = np.random.default_rng(seed)
    return rng.integers(-scale, scale, size=(n, 2)).astype(np.int16)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_fast_atan2_matches_numpy_oracle():
    rng = np.random.default_rng(3)
    y = rng.normal(scale=1e4, size=200_000).astype(np.float32)
    x = rng.normal(scale=1e4, size=200_000).astype(np.float32)
    # z = min/max below TAN_MAP_RES, on both sides of it
    x[:1000] = 1e6
    y[:1000] = rng.uniform(-4e3, 4e3, 1000).astype(np.float32)
    # both zero, the axes, signed zeros, equal magnitudes
    special = np.array([(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0),
                        (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0),
                        (-0.0, 5.0), (-0.0, -5.0), (3.0, 3.0), (-3.0, 3.0),
                        (3.0, -3.0), (-3.0, -3.0), (2.0 ** 31, -1.0)],
                       np.float32)
    y = np.concatenate([y, special[:, 0]])
    x = np.concatenate([x, special[:, 1]])
    want = jatan2.fast_atan2_np(y, x)
    got = atan2.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(atan2.ATAN_TABLE, jatan2.ATAN_TABLE)


def test_fm_demod_exact_matches_numpy_oracle():
    rng = np.random.default_rng(4)
    ch = rng.integers(-32768, 32768, size=(5, 3000, 2)).astype(np.int16)
    ch[0, :40] = -32768          # -32768^2 * 2 wraps the int32 to -2^31
    ch[1, :20] = [-32768, 32767]
    ch[2, 100:120] = 0           # zero power
    last = rng.integers(-32768, 32768, size=(5, 2)).astype(np.int32)
    last[0] = -32768
    want, want_last = jfm.fm_demod_np(ch, last=last)
    got, got_last = fm.fm_demod_exact(torch.from_numpy(ch),
                                      torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_last.numpy(), want_last)
    # a block split in two, the carry threaded, equals the whole
    a, la = fm.fm_demod_exact(torch.from_numpy(ch[:, :1234]),
                              torch.from_numpy(last))
    b, _ = fm.fm_demod_exact(torch.from_numpy(ch[:, 1234:]), la)
    np.testing.assert_array_equal(torch.cat([a, b], 1).numpy(), want)


def test_rotator_seq_matches_jax():
    plan = packed_fir.make_packed_fir_plan(*BANKS["pager"])
    rot_j = np.zeros((8, 2), np.int16)
    rot_j[:, 0] = 16384
    rot_j[3] = [-12000, 9000]    # a mid-stream, un-normalised rotator
    rot_t = rot_j.copy()
    incr = plan.rot_incr_i32.copy()
    incr[5] = 0                  # zero increment: derotation off
    want = jnative.rotator_seq(rot_j, incr, 50_000)
    got = native.rotator_seq(rot_t, incr, 50_000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rot_t, rot_j)   # both advanced in place


@pytest.mark.parametrize("bank", ["pager", "rtlsdr_8ch"])
def test_packed_fir_step_exact_matches_jax(bank):
    args = BANKS[bank]
    plan = packed_fir.make_packed_fir_plan(*args)
    jplan = jpf.make_packed_fir_plan(*args)
    assert (plan.row, plan.cr_rows, plan.win) == \
        {"pager": (128, 9, 1218), "rtlsdr_8ch": (640, 2, 1290)}[bank]
    ch = MultifmChain(*args, exact=True, device="cpu")
    rows = 3 * ch.taps.tile_rows + 7
    x = _iq(plan.carry_len + rows * plan.row // 2, 5, scale=32768)
    x[:50] = -32768
    carry = x[:plan.carry_len].reshape(-1)
    block = x[plan.carry_len:].reshape(-1)
    jc, jre, jim = jpf.packed_fir_step_exact(jplan, carry, block)
    tc, tre, tim = packed_fir.packed_fir_step_exact(
        plan, torch.from_numpy(carry.copy()), torch.from_numpy(block.copy()),
        ch.taps.w_f64)
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # K5's plain version, both epilogues, on the same operands
    are, aim = exact_fir.exact_fir(ch.taps, torch.from_numpy(carry.copy()),
                                   torch.from_numpy(block.copy()))
    np.testing.assert_array_equal(are.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(aim.numpy(), np.asarray(jim))
    raw = exact_fir.exact_fir(ch.taps, torch.from_numpy(carry.copy()),
                              torch.from_numpy(block.copy()), "raw")
    _, far, fai = jpf.packed_fir_step(jplan, carry, block)
    np.testing.assert_array_equal(
        raw.numpy().astype(np.float32),
        np.concatenate([np.asarray(far), np.asarray(fai)], 1))


@pytest.mark.parametrize("bank", ["2ch", "pager"])
def test_process_array_exact_matches_jax(bank):
    args = BANKS[bank]
    x = _iq(300_000, 6)
    want = JaxChain(*args, exact=True).process_array(x, block_size=65_536)
    got = MultifmChain(*args, exact=True, device="cpu").process_array(
        x, block_size=65_536)
    assert got.dtype == np.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_step_exact_streamed_from_a_jax_state():
    """JAX runs two blocks; its state converts to the port's; both then
    stream the rest in uneven blocks: the same PCM, and the same state
    after (converted back)."""
    args = BANKS["2ch"]
    jc = JaxChain(*args, exact=True)
    tc = MultifmChain(*args, exact=True, device="cpu")
    q, c_len = tc.block_quantum, tc.carry_len
    x = _iq(c_len + 40 * q, 7)
    js = jc.init_state(prefix=x[:c_len])
    pos = c_len
    for nq in (5, 3):
        js, _ = jc.step_exact_packed(js, x[pos:pos + nq * q])
        pos += nq * q
    ts = convert.exact_state_from_jax(js)
    back = convert.exact_state_to_jax(ts, like=js)
    for a, b in zip(back, js):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for nq in (1, 11, 4, 7):
        blk = x[pos:pos + nq * q]
        js, pj = jc.step_exact_packed(js, blk)
        ts, pt = tc.step_exact_packed(ts, blk)
        np.testing.assert_array_equal(pt, np.asarray(pj))
        pos += nq * q
    for a, b in zip(convert.exact_state_to_jax(ts, like=js), js):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_step_debug_both_tiers():
    args = BANKS["2ch"]
    x = _iq(200_000, 8)
    for exact in (True, False):
        jc = JaxChain(*args, exact=exact, backend="xla")
        tc = MultifmChain(*args, exact=exact, device="cpu")
        q, c_len = tc.block_quantum, tc.carry_len
        js = jc.init_state(prefix=x[:c_len])
        ts = tc.init_state(prefix=x[:c_len])
        # the production step's PCM (K1's) of the first block
        _, step_pcm = tc.step(tc.init_state(prefix=x[:c_len]),
                              x[c_len:c_len + 9 * q])
        pos = c_len
        for nq in (9, 14):
            blk = x[pos:pos + nq * q]
            js, jp, jiq = jc.step_debug(js, blk)
            ts, tp, tiq = tc.step_debug(ts, blk)
            jp, jiq = np.asarray(jp), np.asarray(jiq)
            assert tp.shape == jp.shape and tiq.shape == jiq.shape
            assert tp.dtype == tiq.dtype == np.int16
            if exact:
                np.testing.assert_array_equal(tp, jp)
                np.testing.assert_array_equal(tiq, jiq)
            else:
                d = np.abs(tp.astype(np.int32) - jp)
                assert np.minimum(d, 32768 - d).max() <= 1
                assert np.abs(tiq.astype(np.int32) - jiq).max() <= 1
                if pos == c_len:    # the tap's PCM is the step's
                    np.testing.assert_array_equal(tp, step_pcm.numpy())
            pos += nq * q
