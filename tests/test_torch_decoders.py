"""The port's copies of the decoders, BCH, generators, JSON output and
config against the JAX package's, on the CPU.

Bars (all exact):
- POCSAG (512/1200/2400 baud, alpha and numeric), FLEX (1600/2, 3200/2,
  3200/4, 6400/4) and AIS: the same messages, field for field, from the
  same noisy PCM (numpy seed), in both the native and the ``native=False``
  tier, through ``scan`` and through ``on_pcm`` in uneven pieces;
- BCH(31,21): 10,000 random words and every 0-, 1- and 2-bit error of a
  set of codewords decode to the same words and verdicts in the port's
  native and numpy tiers as in the JAX ``pocsag_bch``;
- the port's generators give arrays equal to the JAX generators';
- ``jsonout`` gives the same lines, ``config`` the same objects.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from tsl_sdr_tpu.models import ais as jais
from tsl_sdr_tpu.models import bch as jbch
from tsl_sdr_tpu.models import flex as jflex
from tsl_sdr_tpu.models import pocsag as jpocsag
from tsl_sdr_tpu.testing import ais_gen
from tsl_sdr_tpu.testing import flex_gen as jflex_gen
from tsl_sdr_tpu.testing import pocsag_gen as jpocsag_gen
from tsl_sdr_tpu.utils import config as jconfig
from tsl_sdr_tpu.utils import jsonout as jjsonout
from tsl_sdr_tpu_torch.models import ais as tais
from tsl_sdr_tpu_torch.models import bch as tbch
from tsl_sdr_tpu_torch.models import flex as tflex
from tsl_sdr_tpu_torch.models import pocsag as tpocsag
from tsl_sdr_tpu_torch.testing import ais_gen as tais_gen
from tsl_sdr_tpu_torch.testing import flex_gen as tflex_gen
from tsl_sdr_tpu_torch.testing import pocsag_gen as tpocsag_gen
from tsl_sdr_tpu_torch.utils import config as tconfig
from tsl_sdr_tpu_torch.utils import jsonout as tjsonout

ROOT = Path(__file__).resolve().parents[1]
NOW = 1_700_000_000.0   # a fixed timestamp for the JSON lines


def _fields(msgs):
    return [(type(m).__name__, dataclasses.asdict(m)) for m in msgs]


def _noisy(pcm, seed, lead=3_000):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.zeros(lead), pcm, np.zeros(lead)])
    return np.clip(x + rng.normal(scale=400, size=x.size), -32768,
                   32767).astype(np.int16)


def _decode(dec, pcm, api, seed):
    if api == "scan":
        return dec.scan(pcm)
    cuts = np.sort(np.random.default_rng(seed).integers(0, pcm.size, 7))
    out = []
    for part in np.split(pcm, cuts):
        out.extend(dec.on_pcm(part))
    return out


def _pocsag_pcm(gen, baud, kind):
    content = "PORT 0123 alpha" if kind == "alpha" else "0123 456-789"
    return gen.generate(
        [gen.PocsagBurst(capcode=1_234_567, function=3 if kind == "alpha"
                         else 0, kind=kind, content=content),
         gen.PocsagBurst(capcode=2_001, function=1, kind=kind,
                         content=content[::-1])],
        baud=baud, amplitude=6000, tail_bits=128)


_FLEX_MSGS = [("alnum", "FLEX PORT"), ("numeric", "5551234"),
              ("alnum", "SECOND PHASE MSG"), ("numeric", "42")]


def _flex_pcm(gen, baud, levels):
    msgs = [gen.FlexBurstMessage(capcode=1_000_000 + 17 * k, kind=kind,
                                 content=text)
            for k, (kind, text) in enumerate(_FLEX_MSGS)]
    return gen.generate(msgs, baud=baud, fsk_levels=levels, amplitude=7000,
                        tail_bits=200)


@pytest.mark.parametrize("api", ["scan", "on_pcm"])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["alpha", "numeric"])
@pytest.mark.parametrize("baud", [512, 1200, 2400])
def test_pocsag_matches_jax(baud, kind, native, api):
    pcm = _noisy(_pocsag_pcm(jpocsag_gen, baud, kind), seed=baud)
    got = _decode(tpocsag.PocsagDecoder(native=native), pcm, api, baud)
    ref = _decode(jpocsag.PocsagDecoder(native=native), pcm, api, baud)
    assert _fields(got) == _fields(ref) and len(ref) == 2


@pytest.mark.parametrize("api", ["scan", "on_pcm"])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("baud,levels", [(1600, 2), (3200, 2), (3200, 4),
                                         (6400, 4)])
def test_flex_matches_jax(baud, levels, native, api):
    pcm, _ = _flex_pcm(jflex_gen, baud, levels)
    pcm = _noisy(pcm, seed=baud + levels)
    got = _decode(tflex.FlexDecoder(freq_hz=929_000_000, native=native), pcm,
                  api, baud)
    ref = _decode(jflex.FlexDecoder(freq_hz=929_000_000, native=native), pcm,
                  api, baud)
    assert _fields(got) == _fields(ref) and len(ref) == len(_FLEX_MSGS)


@pytest.mark.parametrize("api", ["scan", "on_pcm"])
@pytest.mark.parametrize("native", [True, False])
def test_ais_matches_jax(native, api):
    packets = [ais_gen.make_position_report(367_001_234, longitude=-70.9,
                                            latitude=42.36),
               ais_gen.make_static_voyage(367_001_234, ship_name="PORT TEST",
                                          destination="BOSTON"),
               ais_gen.make_safety_broadcast(2_470_001, "SECURITE")]
    pcm = _noisy(ais_gen.generate(packets, amplitude=9000), seed=5)
    got = _decode(tais.AisDecoder(native=native), pcm, api, 5)
    ref = _decode(jais.AisDecoder(native=native), pcm, api, 5)
    assert _fields(got) == _fields(ref) and len(ref) == len(packets)


def _bch_words():
    rng = np.random.default_rng(31)
    rand = rng.integers(0, 2 ** 31, 10_000, dtype=np.uint32)
    code = jbch.pocsag_bch(native=False)
    payload = rng.integers(0, 2 ** 21, 16, dtype=np.uint32)
    words = [np.asarray(code.encode(payload), np.uint32)]
    for i in range(31):                      # every 1- and 2-bit error
        words.append(words[0] ^ np.uint32(1 << i))
        for j in range(i + 1, 31):
            words.append(words[0] ^ np.uint32((1 << i) | (1 << j)))
    return np.concatenate([rand, *words]).astype(np.uint32)


@pytest.mark.parametrize("native", [True, False])
def test_bch_matches_jax(native):
    words = _bch_words()
    got_c, got_f = tbch.pocsag_bch(native=native).decode(words)
    ref_c, ref_f = jbch.pocsag_bch(native=False).decode(words)
    np.testing.assert_array_equal(got_c, ref_c)
    np.testing.assert_array_equal(got_f, ref_f)
    # the 0-2-bit error words all correct to their codeword
    assert not ref_f[10_000:].any()
    assert tbch.pocsag_bch(native=native).decode_one(int(words[0])) == \
        jbch.pocsag_bch(native=False).decode_one(int(words[0]))


def _ais_pcm(gen):
    packets = [gen.make_position_report(367_001_234, longitude=-70.9,
                                        latitude=42.36),
               gen.make_static_voyage(367_001_234, ship_name="PORT TEST",
                                      destination="BOSTON"),
               gen.make_safety_broadcast(2_470_001, "SECURITE")]
    return packets, gen.generate(packets, amplitude=9000, gap_bits=40)


@pytest.mark.parametrize("case", ["pocsag_alpha", "pocsag_numeric",
                                  "flex_1600_2", "flex_6400_4", "ais"])
def test_generators_match_jax(case):
    if case == "ais":
        got_pk, got = _ais_pcm(tais_gen)
        ref_pk, ref = _ais_pcm(ais_gen)
        assert got_pk == ref_pk
        np.testing.assert_array_equal(got, ref)
        return
    if case.startswith("pocsag"):
        kind = case.split("_")[1]
        np.testing.assert_array_equal(_pocsag_pcm(tpocsag_gen, 1200, kind),
                                      _pocsag_pcm(jpocsag_gen, 1200, kind))
        return
    baud, levels = map(int, case.split("_")[1:])
    got, got_exp = _flex_pcm(tflex_gen, baud, levels)
    ref, ref_exp = _flex_pcm(jflex_gen, baud, levels)
    np.testing.assert_array_equal(got, ref)
    assert got_exp == ref_exp


def test_jsonout_matches_jax():
    pcm = _noisy(_pocsag_pcm(jpocsag_gen, 1200, "alpha"), seed=1)
    fpcm = _noisy(_flex_pcm(jflex_gen, 1600, 2)[0], seed=2)
    apcm = _noisy(ais_gen.generate(
        [ais_gen.make_position_report(367_000_222, longitude=-71.0,
                                      latitude=42.3)]), seed=3)
    lines = {}
    for name, jo, mods in (("port", tjsonout, (tpocsag, tflex, tais)),
                           ("jax", jjsonout, (jpocsag, jflex, jais))):
        msgs = (mods[0].PocsagDecoder().scan(pcm)
                + mods[1].FlexDecoder(freq_hz=931_000_000).scan(fpcm)
                + mods[2].AisDecoder().scan(apcm))
        lines[name] = [jo.message_to_json(m, freq_hz=931_000_000, now=NOW)
                       for m in msgs]
    assert lines["port"] == lines["jax"]
    assert len(lines["jax"]) == 2 + len(_FLEX_MSGS) + 1
    assert all(line for line in lines["jax"])


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        (ROOT / "etc").glob("*.json")))
def test_config_matches_jax(name):
    path = ROOT / "etc" / name
    raw = tconfig.load_config(path)
    assert raw == jconfig.load_config(path)
    if "rationalResampler" in raw or "lpfCoeffs" in raw:
        assert tconfig.load_lpf_coeffs(path) == jconfig.load_lpf_coeffs(path)
        return
    got = tconfig.MultifmConfig.from_dict(raw)
    ref = jconfig.MultifmConfig.from_dict(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
