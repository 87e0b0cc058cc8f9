"""``ReceivePipeline(mesh=)``, the port's, against the JAX package's mesh
runs and against the port's run without a mesh, on the CPU.

JAX partitions its fused block program with GSPMD on the conftest's 8
virtual devices; the port cuts channels and time spans by hand on meshes
of ``["cpu"] * n``. The captures and configurations are the JAX tests'
(``tests/test_parallel.py:233-400``).

Bars: decoded messages EQUAL to JAX's mesh run and to the port's run
without a mesh, with equal ``fetched`` (egress gating) counters; every
``pcm`` channel's PCM EQUAL to the run without a mesh, DC-blocked ones
included (the port runs the DC stage over the whole block's rows); a
checkpoint written on a (2, 2) mesh resumes on the mesh and on a pipeline
without one, decoding what one uninterrupted run decodes.
"""

import dataclasses

import jax
import numpy as np
import pytest

from tests.test_pipeline import _fm_mod
from tests.test_pipeline_stream import _capture, _keys, _specs
from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu.parallel.mesh import make_mesh as jax_mesh
from tsl_sdr_tpu.testing import pocsag_gen
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.parallel.mesh import make_mesh
from tsl_sdr_tpu_torch.parallel.pipeline import span_bounds
from tsl_sdr_tpu_torch.testing import ais_gen, flex_gen
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CENTER = 929_500_000


def _cpu_mesh(time, channels):
    return make_mesh(time=time, channels=channels,
                     devices=["cpu"] * (time * channels))


def _port_specs(specs):
    return [tpipe.ChannelSpec(**dataclasses.asdict(s)) for s in specs]


def _runs(lpf, fs, decim, specs, iq, block, jax_shape, port_shapes):
    """(JAX mesh run, JAX run, port run, {shape: port mesh run}): each as
    (message keys, fetched counters)."""
    def run(pipe):
        return _keys(pipe.process_capture(iq)), pipe.stream_stats["fetched"]

    jm = run(jpipe.ReceivePipeline(lpf, CENTER, fs, decim, specs,
                                   exact=False, block_size=block,
                                   mesh=jax_mesh(*jax_shape)))
    j1 = run(jpipe.ReceivePipeline(lpf, CENTER, fs, decim, specs,
                                   exact=False, block_size=block))
    tspecs = _port_specs(specs)
    t1 = run(tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs,
                                   block_size=block, device="cpu"))
    tm = {shape: run(tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs,
                                           block_size=block,
                                           mesh=_cpu_mesh(*shape)))
          for shape in port_shapes}
    return jm, j1, t1, tm


def _check(jm, j1, t1, tm):
    assert t1[0] == j1[0] == jm[0]
    np.testing.assert_array_equal(t1[1], j1[1])
    np.testing.assert_array_equal(t1[1], jm[1])
    for shape, (keys, fetched) in tm.items():
        assert keys == jm[0], shape
        np.testing.assert_array_equal(fetched, t1[1], err_msg=str(shape))


@pytest.fixture(scope="module")
def pager8():
    """The JAX channel-sharding test's 8 POCSAG channels, 3 bursts."""
    decim, fs = 32, 38400 * 32
    offsets = [-450_000 + 120_000 * k for k in range(8)]
    rng = np.random.default_rng(8)
    parts = None
    for k in (0, 3, 5):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=300000 + k, function=1,
                                    kind="alpha", content=f"SH{k}")],
            baud=1200, amplitude=4096, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (offsets[k] + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 3500
        if parts is None:
            parts = np.zeros((len(sig) + 800_000, 2))
        parts[400_000:400_000 + len(sig)] += sig
    iq = (parts + rng.normal(scale=90, size=parts.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)
    specs = [jpipe.ChannelSpec(CENTER + o, "pocsag") for o in offsets]
    return lpf, fs, decim, specs, iq


@pytest.mark.parametrize("ch_shards", [2, 8])
def test_channel_sharded_pipeline_matches_jax(pager8, ch_shards):
    lpf, fs, decim, specs, iq = pager8
    shape = (8 // ch_shards, ch_shards)
    jm, j1, t1, tm = _runs(lpf, fs, decim, specs, iq, 393_216, shape,
                           [shape, (1, ch_shards)])
    assert sum(len(c) for c in jm[0]) == 3
    _check(jm, j1, t1, tm)


def _time_capture():
    """The JAX time-sharding test's capture: POCSAG 3/4 (DC-blocked),
    FLEX 5/16, AIS 15/16 and a silent POCSAG channel at decimation 24."""
    decim = 24
    fs = 51200 * decim
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=555001, function=2, kind="alpha",
                                content="TS POCSAG")],
        baud=1200, amplitude=4096, tail_bits=128)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=555002, kind="alnum",
                                   content="TS FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=200)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999111, longitude=-70.9,
                                      latitude=42.36)], amplitude=9000)
    sigs = [_fm_mod(p_bb, 38400, 250_000, fs),
            _fm_mod(f_bb, 16000, -180_000, fs, amp=7000),
            _fm_mod(a_bb, 48000, 400_000, fs, amp=7000, dev_hz=4800)]
    rng = np.random.default_rng(17)
    n = max(map(len, sigs)) + 700_000
    iq = rng.normal(scale=100, size=(n, 2))
    for s in sigs:
        iq[250_000:250_000 + len(s)] += s
    specs = [jpipe.ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
             jpipe.ChannelSpec(CENTER - 180_000, "flex"),
             jpipe.ChannelSpec(CENTER + 400_000, "ais"),
             jpipe.ChannelSpec(CENTER - 350_000, "pocsag")]
    return firdes_low_pass(1.0, fs, 12_000, 8_000), fs, decim, specs, \
        iq.astype(np.int16)


def test_time_sharded_pipeline_matches_jax():
    lpf, fs, decim, specs, iq = _time_capture()
    jm, j1, t1, tm = _runs(lpf, fs, decim, specs, iq, 393_216, (8, 1),
                           [(8, 1), (3, 1), (2, 2)])
    assert all(jm[0][:3]) and not jm[0][3], jm[0]
    _check(jm, j1, t1, tm)


@pytest.mark.parametrize("extra", [0, 1], ids=["5ch-indivisible", "6ch"])
def test_channel_sharded_pipeline_mixed_protocols(extra):
    """5 channels over 2 channel shards leave the channel axis unused (as
    in JAX), 6 partition; both decode what one device decodes."""
    specs = _specs() + [jpipe.ChannelSpec(CENTER - 480_000, "ais")][:extra]
    fs = 38400 * 32
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)
    jm, j1, t1, tm = _runs(lpf, fs, 32, specs, _capture(), 262_144, (4, 2),
                           [(4, 2), (2, 3)])
    assert sum(len(c) for c in jm[0]) == 3
    _check(jm, j1, t1, tm)
    pipe = tpipe.ReceivePipeline(lpf, CENTER, fs, 32, _port_specs(specs),
                                 block_size=262_144, mesh=_cpu_mesh(4, 2))
    assert pipe._engine.cols == (1 if len(specs) % 2 else 2)


def test_pcm_channels_equal_without_mesh():
    """Every channel's PCM, the DC-blocked and the inverted ones included,
    equals the run without a mesh at every mesh shape, at an uneven push
    split and with the drain worker; the counters add up."""
    lpf, fs, decim, specs, iq = _time_capture()
    tspecs = _port_specs(specs) + [
        tpipe.ChannelSpec(CENTER + 10_000, "pcm", dc_block=True),
        tpipe.ChannelSpec(CENTER - 10_000, "pcm", invert=True),
        tpipe.ChannelSpec(CENTER - 180_000, "pcm", dc_block=True,
                          dc_block_pole=0.999)]
    base = tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs,
                                 block_size=393_216, device="cpu")
    want = base.process_capture(iq)
    for shape, split in (((1, 1), None), ((8, 1), None), ((3, 2), None),
                         ((1, 7), None), ((2, 7), 1_000_003),
                         ((4, 1), "async")):
        pipe = tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs,
                                     block_size=393_216,
                                     mesh=_cpu_mesh(*shape),
                                     drain_async=split == "async")
        if isinstance(split, int):
            got = [a + b for a, b in zip(pipe.push(iq[:split]),
                                         pipe.push(iq[split:]))]
            got = [a + b for a, b in zip(got, pipe.flush())]
            for i in range(4, 7):
                got[i] = np.concatenate(got[i])
        else:
            got = pipe.process_capture(iq)
        assert _keys(got[:4]) == _keys(want[:4]), shape
        for i in range(4, 7):
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"{shape} ch{i}")
        st, st0 = pipe.stream_stats, base.stream_stats
        np.testing.assert_array_equal(st["fetched"], st0["fetched"])
        assert st["blocks"] == st0["blocks"]
        assert st["upload_elems"] == st0["upload_elems"]
        eng = pipe._engine
        assert st["halo_bytes"] == st["blocks"] * (shape[0] - 1) \
            * eng.halo_vals * 2


def _burst_capture():
    """The JAX mesh checkpoint test's capture: two POCSAG bursts."""
    decim, fs = 32, 38400 * 32
    rng = np.random.default_rng(9)

    def burst(cap, txt):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=txt)],
            baud=1200, amplitude=4096, tail_bits=256)
        return _fm_mod(bb, 38400, 250_000, fs).astype(np.int16)

    pad = rng.integers(-300, 300, size=(700_000, 2)).astype(np.int16)
    iq = np.concatenate([pad, burst(111, "MESH ONE"), pad,
                         burst(222, "MESH TWO"), pad])
    iq = (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)
    specs = [jpipe.ChannelSpec(CENTER + 250_000, "pocsag"),
             jpipe.ChannelSpec(CENTER - 250_000, "pocsag")]
    return firdes_low_pass(1.0, fs, 9_600, 7_000), fs, decim, specs, iq


@pytest.mark.parametrize("resume_on", ["mesh", "no mesh"])
def test_mesh_checkpoint_resume(tmp_path, resume_on):
    """A (2, 2) mesh pipeline checkpointed mid-stream resumes, on the mesh
    or on a pipeline without one (the file is the single-device format,
    the fingerprint does not name the mesh), and decodes what JAX's
    uninterrupted mesh run decodes."""
    lpf, fs, decim, specs, iq = _burst_capture()
    want = _keys(jpipe.ReceivePipeline(
        lpf, CENTER, fs, decim, specs, exact=False, block_size=393_216,
        mesh=jax_mesh(time=2, channels=2)).process_capture(iq))
    assert [k[1] for k in want[0]] == [111, 222]
    tspecs = _port_specs(specs)

    def mk(mesh):
        return tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs,
                                     block_size=393_216, device="cpu",
                                     mesh=mesh)

    assert _keys(mk(_cpu_mesh(2, 2)).process_capture(iq)) == want
    half = len(iq) // 2
    state = tmp_path / "s.npz"
    p1 = mk(_cpu_mesh(2, 2))
    got = _keys(p1.push(iq[:half]))
    for i, part in enumerate(_keys(p1.checkpoint_stream(state))):
        got[i].extend(part)
    p2 = mk(_cpu_mesh(2, 2) if resume_on == "mesh" else None)
    p2.restore_stream(state)
    for res in (p2.push(iq[half:]), p2.flush()):
        for i, keys in enumerate(_keys(res)):
            got[i].extend(keys)
    assert got == want


def test_mesh_exact_tier_runs_on_first_device():
    """``exact=True`` ignores the mesh, as JAX's exact engine does: one
    device (the mesh's first), the same PCM as without a mesh."""
    lpf, fs, decim, specs, iq = _burst_capture()
    tspecs = _port_specs(specs) + [tpipe.ChannelSpec(CENTER, "pcm")]
    iq = iq[:600_000]
    mesh = _cpu_mesh(2, 2)
    pipe = tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs, exact=True,
                                 block_size=393_216, mesh=mesh)
    assert pipe._engine is None and pipe.device == mesh.devices[0, 0]
    want = tpipe.ReceivePipeline(lpf, CENTER, fs, decim, tspecs, exact=True,
                                 block_size=393_216, device="cpu")
    np.testing.assert_array_equal(pipe.process_capture(iq)[2],
                                  want.process_capture(iq)[2])


def test_span_bounds():
    """Spans of whole quanta, the first ones longer; too few quanta or a
    span shorter than the next one's halo refuse."""
    assert [b - a for a, b in span_bounds(85 * 49_152, 49_152, 2)] == \
        [43 * 49_152, 42 * 49_152]
    assert [(b - a) // 49_152 for a, b in span_bounds(85 * 49_152, 49_152,
                                                      4)] == [22, 21, 21, 21]
    with pytest.raises(ValueError, match="cannot be cut into 9"):
        span_bounds(8 * 256, 256, 9)
    lpf, fs, decim, _, _ = _burst_capture()
    with pytest.raises(ValueError, match="shorter than the"):
        tpipe.ReceivePipeline(lpf, CENTER, fs, decim,
                              [tpipe.ChannelSpec(CENTER, "pcm")],
                              block_size=256 * 8, mesh=_cpu_mesh(8, 1))
