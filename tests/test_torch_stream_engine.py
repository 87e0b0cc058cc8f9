"""The port's streaming engine against the JAX package's: the drain worker
(``drain_async``), its teardown, the timing lock, checkpoint/restore and
warm-up, on the CPU.

Bars: decoded messages IDENTICAL (every field, per channel, in order) to
the JAX ``ReceivePipeline`` on the same seeded capture, at random push
splits; checkpoint leaves bit for bit; the egress-gating counts equal.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tsl_sdr_tpu.models import pipeline as jpipe
from tsl_sdr_tpu.testing import ais_gen
from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.testing import flex_gen, pocsag_gen
from tsl_sdr_tpu_torch.testing.pager import fm_mod
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

DECIM = 32
FS = 38_400 * DECIM
CENTER = 929_500_000
BLOCK = 262_144


def _specs(mod):
    return [
        mod.ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
        mod.ChannelSpec(CENTER - 180_000, "flex"),
        mod.ChannelSpec(CENTER + 400_000, "ais"),
        mod.ChannelSpec(CENTER - 350_000, "pocsag"),  # silent: gated
        mod.ChannelSpec(CENTER + 480_000, "ais"),     # silent: gated
    ]


def _make_capture(seed=21):
    """POCSAG, FLEX and AIS bursts from 300,000 on (after
    tests/test_pipeline_stream.py:24), 600,000 samples of noise after."""
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=1122334, function=2, kind="alpha",
                                content="STREAM POCSAG")],
        baud=1200, amplitude=4096, tail_bits=256)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=1234567, kind="alnum",
                                   content="STREAM FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999111, longitude=-70.9,
                                      latitude=42.36)], amplitude=9000)
    parts = [fm_mod(p_bb, 38_400, 250_000, FS, amp=9000),
             fm_mod(f_bb, 16_000, -180_000, FS, amp=7000),
             fm_mod(a_bb, 48_000, 400_000, FS, amp=7000, dev_hz=4800)]
    n = max(map(len, parts)) + 600_000
    iq = np.zeros((n, 2))
    for p in parts:
        iq[300_000:300_000 + len(p)] += p
    rng = np.random.default_rng(seed)
    return (iq + rng.normal(scale=120, size=iq.shape)).astype(np.int16)


LPF = firdes_low_pass(1.0, FS, 12_000, 8_000)


@pytest.fixture(scope="module")
def capture():
    iq = _make_capture()
    jp = jpipe.ReceivePipeline(LPF, CENTER, FS, DECIM, _specs(jpipe),
                               exact=False, block_size=BLOCK)
    ref = jp.process_capture(iq)
    assert [len(r) for r in ref] == [1, 1, 1, 0, 0]
    return {"iq": iq, "ref": ref, "ref_stats": jp.stream_stats}


def _fields(results):
    return [[(type(m).__name__, dataclasses.asdict(m)) for m in msgs]
            for msgs in results]


def _port(**kw):
    return tpipe.ReceivePipeline(LPF, CENTER, FS, DECIM, _specs(tpipe),
                                 device="cpu", block_size=BLOCK, **kw)


def _jax(**kw):
    return jpipe.ReceivePipeline(LPF, CENTER, FS, DECIM, _specs(jpipe),
                                 exact=False, block_size=BLOCK, **kw)


def _run(pipe, iq, bounds):
    got = [[] for _ in pipe.channels]
    for lo, hi in zip(bounds, bounds[1:]):
        for c, part in enumerate(pipe.push(iq[lo:hi])):
            got[c].extend(part)
    for c, part in enumerate(pipe.flush()):
        got[c].extend(part)
    return got


def _splits(n, seed):
    rng = np.random.default_rng(seed)
    cuts = np.cumsum(rng.integers(50_000, 500_000, size=n // 50_000))
    return [0, *[int(c) for c in cuts if c < n], n]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_drain_async_equals_sync_and_jax(capture, depth):
    """The worker moves where the drain runs, never what it computes: the
    same messages and gating counts as the inline drain and as JAX."""
    iq, ref = capture["iq"], capture["ref"]
    bounds = _splits(len(iq), seed=depth)
    pipes = {asy: _port(inflight_depth=depth, drain_async=asy)
             for asy in (False, True)}
    got = {asy: _run(p, iq, bounds) for asy, p in pipes.items()}
    assert _fields(got[True]) == _fields(got[False]) == _fields(ref)
    for p in pipes.values():
        st = p.stream_stats
        assert st["blocks"] == capture["ref_stats"]["blocks"]
        np.testing.assert_array_equal(st["fetched"],
                                      capture["ref_stats"]["fetched"])


def test_stream_reset_joins_worker_with_entries_queued(capture):
    """The teardown fault of the JAX drain worker cannot happen here:
    stream_reset() with blocks still queued joins the worker, whose blocks
    go to its own (old) stream, so a capture pushed next decodes exactly as
    on a fresh pipeline, gating counts included."""
    pipe = _port(inflight_depth=1, drain_async=True)
    slow = pipe._drain
    release = threading.Event()

    def drain_held(s, entry, new):
        # the worker holds its first block until the test has looked at
        # the queue behind it
        release.wait(timeout=60)
        slow(s, entry, new)

    pipe._drain = drain_held
    # 4 blocks dispatched at inflight depth 1: 3 handed to the worker, one
    # held by it and 2 queued (the queue's bound; a 4th hand-off would
    # wait for the held block)
    noise = np.random.default_rng(4).normal(
        scale=120, size=(5 * BLOCK, 2)).astype(np.int16)
    pipe.push(noise)
    old = pipe._stream
    worker = old["dthread"]
    assert old["dq"].qsize() == 2 and worker.is_alive()
    handed = old["blocks"] + old["dq"].qsize() + 1
    release.set()
    pipe.stream_reset()
    assert not worker.is_alive()
    assert old["blocks"] >= handed       # drained into its own stream
    pipe._drain = slow

    got = pipe.process_capture(capture["iq"])
    fresh = _port(drain_async=True)
    want = fresh.process_capture(capture["iq"])
    assert _fields(got) == _fields(want) == _fields(capture["ref"])
    assert pipe.stream_stats["blocks"] == fresh.stream_stats["blocks"]
    np.testing.assert_array_equal(pipe.stream_stats["fetched"],
                                  fresh.stream_stats["fetched"])


def test_tick_from_many_threads_loses_no_update():
    """A span's exit is a read-modify-write of ``timing``; under the lock
    no update is lost with more threads than cores and a tiny switch
    interval. Each span adds its own ``seconds``."""
    pipe = _port()
    pipe.timing = {}
    n_threads, n_ticks = 16, 2_000
    sums = [0.0] * n_threads

    def hammer(k):
        for _ in range(n_ticks):
            with pipe._trace("x", "x") as span:
                pass
            sums[k] += span.seconds

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    # one lost update would miss a span's seconds, about one in 32,000 of
    # the sum
    assert pipe.timing["x"] == pytest.approx(sum(sums), rel=1e-9)


@pytest.mark.parametrize("split,drain_async", [
    (400_000, False),      # decoders restart before every burst
    (400_000, True),
    (1_500_000, True),     # inside the bursts: lost alike
    (2_900_000, False),    # after them: nothing lost
])
def test_checkpoint_restore_matches_jax(capture, tmp_path, split,
                                        drain_async):
    """Checkpoint after ``split`` samples, restore into a new pipeline,
    stream the rest: the same messages as JAX's checkpoint_stream /
    restore_stream on the same split (the decoders restart at the last
    whole block before it; the partial block rides in the checkpoint)."""
    iq = capture["iq"]
    res = {}
    for name, make in (("jax", _jax),
                       ("torch", lambda: _port(drain_async=drain_async))):
        first = make()
        got = [list(c) for c in first.push(iq[:split])]
        path = tmp_path / f"{name}.npz"
        for c, part in enumerate(first.checkpoint_stream(path)):
            got[c].extend(part)
        second = make()
        assert second.restore_stream(path) == {}
        for c, part in enumerate(second.push(iq[split:])):
            got[c].extend(part)
        for c, part in enumerate(second.flush()):
            got[c].extend(part)
        res[name] = got
    assert _fields(res["torch"]) == _fields(res["jax"])
    if split > 2_000_000:
        assert _fields(res["torch"]) == _fields(capture["ref"])


def _leaves(pipe):
    out = {}
    tpipe._map_state(pipe._stream["st"], lambda n, v: out.setdefault(n, v))
    return out


def test_checkpoint_round_trip_bit_for_bit(capture, tmp_path):
    iq = capture["iq"]
    a = _port(drain_async=True)
    a.push(iq[:1_234_567])
    path = tmp_path / "s.npz"
    a.checkpoint_stream(path, user_meta={"consumed_samples": 1_234_567})
    assert not (tmp_path / "s.npz.tmp").exists()
    b = _port()
    assert b.restore_stream(path) == {"consumed_samples": 1_234_567}
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    assert {n.split(".")[0] for n in la} == {"chain", "rs", "dc", "tails"}
    assert "rs.5_12" in la and "dc.0.acc" in la and "tails.flex" in la
    for name, v in la.items():
        w = lb[name]
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and torch.equal(v, w), name
        else:
            assert v == w, name
    sa, sb = a._stream, b._stream
    for key in ("buf_len", "lead_drop", "hot", "blocks"):
        assert sa[key] == sb[key], key
    np.testing.assert_array_equal(np.concatenate(sa["buf"]),
                                  np.concatenate(sb["buf"]))
    np.testing.assert_array_equal(sa["fetched"], sb["fetched"])
    assert all(sb["gap"].values())
    for i, tp in sa["tail_pcm"].items():
        np.testing.assert_array_equal(tp, sb["tail_pcm"][i])


def test_fingerprint_refuses_config_edits(tmp_path):
    """Edits that change no state shape (the DC pole, a gain, the taps)
    fail the fingerprint, and so does a JAX package checkpoint."""
    noise = np.random.default_rng(2).integers(
        -200, 200, size=(600_000, 2)).astype(np.int16)
    path = tmp_path / "s.npz"
    pipe = _port()
    pipe.push(noise)
    pipe.checkpoint_stream(path)

    def edited(i, **kw):
        specs = _specs(tpipe)
        specs[i] = dataclasses.replace(specs[i], **kw)
        return tpipe.ReceivePipeline(LPF, CENTER, FS, DECIM, specs,
                                     device="cpu", block_size=BLOCK)

    for pipe2 in (edited(0, dc_block_pole=0.95), edited(3, db_gain=3.0),
                  tpipe.ReceivePipeline(
                      firdes_low_pass(1.0, FS, 11_000, 8_000), CENTER, FS,
                      DECIM, _specs(tpipe), device="cpu", block_size=BLOCK)):
        with pytest.raises(ValueError, match="differently-configured"):
            pipe2.restore_stream(path)
    jp = _jax()
    jp.push(noise)
    jp.checkpoint_stream(tmp_path / "jax.npz")
    with pytest.raises(ValueError, match="differently-configured"):
        _port().restore_stream(tmp_path / "jax.npz")


def test_restore_resets_decoders_in_process(tmp_path):
    pipe = _port()
    pipe.push(np.random.default_rng(6).integers(
        -200, 200, size=(600_000, 2)).astype(np.int16))
    before = list(pipe._decoders)
    pipe.checkpoint_stream(tmp_path / "s.npz")
    pipe.restore_stream(tmp_path / "s.npz")
    for old, new in zip(before, pipe._decoders):
        assert new is not old and new.in_search


@pytest.mark.parametrize("drain_async", [False, True])
def test_warm_device_leaves_output_unchanged(capture, drain_async):
    iq = capture["iq"]
    warm = _port(drain_async=drain_async)
    assert warm.warm_device() > 0.0
    assert warm._stream is None
    got = _run(warm, iq, [0, len(iq)])
    assert _fields(got) == _fields(capture["ref"])
    assert warm.stream_stats["blocks"] == capture["ref_stats"]["blocks"]
    primed = _port()
    primed.push(iq[:300_000])
    assert primed.warm_device() == 0.0


@pytest.mark.parametrize("depth", [1, 2])
def test_live_latency_bounded_by_inflight_depth(depth):
    """A message completes within inflight_depth + 1 pushed blocks of the
    block holding its last sample (tests/test_pipeline_stream.py:720)."""
    pipe = tpipe.ReceivePipeline(
        LPF, CENTER, FS, DECIM, [tpipe.ChannelSpec(CENTER + 250_000,
                                                   "pocsag")],
        device="cpu", block_size=BLOCK, inflight_depth=depth)
    bs = pipe.block_size
    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=909090, function=1, kind="alpha",
                                content="LATENCY")],
        baud=1200, amplitude=4096, tail_bits=64)
    sig = fm_mod(bb, 38_400, 250_000, FS, amp=9000)
    start = bs // 2
    n = start + len(sig) + (depth + 4) * bs
    iq = np.random.default_rng(13).normal(scale=120, size=(n, 2))
    iq[start:start + len(sig)] += sig
    iq = iq.astype(np.int16)
    end_block = (start + len(sig) - pipe.chain.carry_len) // bs
    got_at = next((k for k in range(n // bs)
                   if pipe.push(iq[k * bs:(k + 1) * bs])[0]), None)
    assert got_at is not None, "message never decoded"
    assert got_at <= end_block + depth + 1, (got_at, end_block, depth)


def _corrupt_checkpoint(src, dst, kind):
    """A copy of checkpoint ``src`` with one array reshaped against its
    metadata (``reshaped``) or without the input buffer (``no_buf``)."""
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    if kind == "reshaped":
        name = "state.chain.carry_vals"
        arrays[name] = arrays[name].reshape(2, -1)
    else:
        del arrays["buf"]
    with open(dst, "wb") as f:
        np.savez(f, **arrays)


@pytest.mark.parametrize("kind", ["reshaped", "no_buf"])
def test_restore_checks_arrays_before_touching_the_stream(capture, tmp_path,
                                                          kind):
    """A checkpoint whose metadata matches but whose arrays do not raises
    at restore and leaves no half-made stream: none on a fresh pipeline,
    the old one, untouched, on a streaming one."""
    iq = capture["iq"]
    a = _port()
    a.push(iq[:700_000])
    good = tmp_path / "good.npz"
    a.checkpoint_stream(good)
    bad = tmp_path / "bad.npz"
    _corrupt_checkpoint(good, bad, kind)
    fresh = _port()
    with pytest.raises(ValueError, match="checkpoint"):
        fresh.restore_stream(bad)
    assert fresh._stream is None
    busy = _port(drain_async=True)
    busy.push(iq[:700_000])
    old = busy._stream
    with pytest.raises(ValueError, match="checkpoint"):
        busy.restore_stream(bad)
    assert busy._stream is old and old["dthread"].is_alive()
    # the stream that stayed decodes the rest as if nothing had happened
    got = [list(c) for c in busy.push(iq[700_000:])]
    for c, part in enumerate(busy.flush()):
        got[c].extend(part)
    assert _fields(got) == _fields(capture["ref"])
