"""The copy of an upload into its pinned slot in parts
(``tsl_sdr_tpu_torch.models.pipeline.pin_copy`` over
``runtime.native.pin_copy``'s pool of threads) on plain numpy buffers:
byte-equal at every size, dtype and part count; one part, with no native
call, under the threshold and on one CPU; errors raised to the caller; the
pool under concurrent callers and in a forked child; the
stream's counts of it, and the benchmark's reader of them."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tsl_sdr_tpu_torch.models import pipeline as tpipe
from tsl_sdr_tpu_torch.runtime import native
from tsl_sdr_tpu_torch.testing import pager

from sdrbench import bench

PART = 64          # bytes a part, in the cases that shrink it
CAP = 4


def _sizes(itemsize: int) -> list:
    """Elements: 0, 1, an odd count, one part, and one element either side
    of every part count's first size."""
    per = PART // itemsize
    out = {0, 1, 7, per}
    for k in range(2, CAP + 2):
        out |= {k * per - 1, k * per, k * per + 1}
    return sorted(out)


def _arrays(dtype, n, seed=0):
    info = np.iinfo(dtype)
    src = np.random.default_rng(seed + n).integers(
        info.min, info.max, size=n, endpoint=True, dtype=dtype)
    return src, np.zeros(n, dtype)


@pytest.fixture
def calls(monkeypatch):
    """The part counts of every call that reaches the native pool."""
    seen = []
    real = native.pin_copy

    def spy(dst, src, parts):
        seen.append(parts)
        real(dst, src, parts)

    monkeypatch.setattr(native, "pin_copy", spy)
    return seen


@pytest.mark.parametrize("case", [
    *[(dt, n, 8) for dt in (np.int16, np.int8, np.uint8)
      for n in _sizes(np.dtype(dt).itemsize)],
    (np.int16, 10 * PART // 2, 1),         # one CPU: one part
    (np.uint8, 10 * PART, 1),
], ids=lambda c: f"{np.dtype(c[0]).name}-{c[1]}-cpus{c[2]}")
def test_the_copy_in_parts_is_byte_equal(monkeypatch, calls, case):
    dtype, n, cpus = case
    monkeypatch.setattr(tpipe, "PIN_COPY_PART_BYTES", PART)
    monkeypatch.setattr(tpipe, "PIN_COPY_MAX_PARTS", CAP)
    monkeypatch.setattr(tpipe.os, "sched_getaffinity",
                        lambda pid: set(range(cpus)))
    src, dst = _arrays(dtype, n)
    parts = tpipe.pin_copy(dst, src)
    assert dst.tobytes() == src.tobytes()
    assert parts == max(1, min(CAP, cpus, src.nbytes // PART))
    # one part: the calling thread's own np.copyto, the pool untouched
    assert calls == ([] if parts == 1 else [parts])
    if parts > 1:
        assert native.pin_copy_threads() >= parts - 1


def test_the_real_threshold_splits_from_two_parts(monkeypatch, calls):
    """At the module's constants an upload of one part's bytes is one copy
    and one of two parts' bytes two (on a machine of several CPUs)."""
    monkeypatch.setattr(tpipe.os, "sched_getaffinity",
                        lambda pid: set(range(8)))
    part = tpipe.PIN_COPY_PART_BYTES
    assert tpipe.PIN_COPY_MAX_PARTS >= 2 and part >= 1 << 20
    for nbytes, want in ((part, 1), (2 * part - 2, 1), (2 * part, 2)):
        src, dst = _arrays(np.int16, nbytes // 2)
        assert tpipe.pin_copy(dst, src) == want, nbytes
        assert np.array_equal(dst, src), nbytes
    assert calls == [2]


def test_a_failed_copy_reaches_the_caller(monkeypatch):
    """The pool's error (a part count it refuses; a thread it cannot
    start) is raised to the caller, and so to ``push``'s."""
    src, dst = _arrays(np.int16, 1000)
    with pytest.raises(OSError) as e:
        native.pin_copy(dst, src, 65)
    assert e.value.errno == 22                       # EINVAL

    class NoThreads:
        def tsl_pin_copy(self, *args):
            return 11                                # EAGAIN

    monkeypatch.setattr(native, "_PIN_COPY", NoThreads())
    monkeypatch.setattr(tpipe, "PIN_COPY_PART_BYTES", PART)
    monkeypatch.setattr(tpipe.os, "sched_getaffinity",
                        lambda pid: set(range(8)))
    with pytest.raises(OSError, match="copy in 8 parts") as e:
        tpipe.pin_copy(dst, src)
    assert e.value.errno == 11


@pytest.mark.parametrize("dst,src", [
    (np.zeros(8, np.int16), np.zeros(9, np.int16)),
    (np.zeros((4, 2), np.int16), np.zeros((4, 2), np.int16)),
    (np.zeros(8, np.int16), np.zeros(8, np.uint16)),
    (np.zeros(16, np.int16)[::2], np.zeros(8, np.int16)),
    (np.zeros(8, np.int16), np.zeros(16, np.int16)[::2]),
])
def test_the_pool_refuses_what_it_cannot_copy(dst, src):
    with pytest.raises(ValueError, match="contiguous 1-D"):
        native.pin_copy(dst, src, 2)


def test_the_pool_refuses_overlapping_and_read_only_arrays():
    buf = np.zeros(100, np.int16)
    with pytest.raises(ValueError, match="overlapping"):
        native.pin_copy(buf[10:60], buf[:50], 2)
    ro = np.zeros(8, np.int16)
    ro.flags.writeable = False
    with pytest.raises(ValueError, match="contiguous 1-D"):
        native.pin_copy(ro, np.ones(8, np.int16), 2)


def test_concurrent_callers_each_get_their_copy():
    """More threads than cores copy through the one pool at once, in 1 to
    8 parts; every copy equals its source."""
    n_threads, rounds = 3 * min(os.cpu_count() or 4, 16), 20
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def run(k):
        rng = np.random.default_rng(k)
        try:
            for r in range(rounds):
                n = int(rng.integers(0, 50_000))
                src = rng.integers(-2**15, 2**15, size=n, dtype=np.int16)
                dst = np.zeros_like(src)
                native.pin_copy(dst, src, int(rng.integers(1, 9)))
                if not np.array_equal(dst, src):
                    errors.append((k, r))
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append((k, repr(e)))

    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []


@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
@pytest.mark.filterwarnings(r"ignore:os\.fork\(\) was called")
def test_a_forked_child_copies_with_a_pool_of_its_own():
    """A child forked after the parent's pool started copies in parts (the
    parent's pool threads do not exist there) and exits."""
    src, dst = _arrays(np.int16, 100_000)
    native.pin_copy(dst, src, 4)
    pid = os.fork()
    if pid == 0:
        ok = False
        try:
            out = np.zeros_like(src)
            native.pin_copy(out, src, 6)
            ok = np.array_equal(out, src) and native.pin_copy_threads() == 5
        finally:
            os._exit(0 if ok else 1)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        pytest.fail("the forked child's copy did not end")
    assert os.waitstatus_to_exitcode(status) == 0


def test_a_cpu_pipeline_counts_no_upload_through_the_ring():
    """``stream_stats()`` has ``uploads`` and ``upload_split``; on the CPU
    the values go to the device as they are, through no ring, and count
    in neither."""
    pipe = tpipe.ReceivePipeline(
        pager.lpf_taps(), pager.CENTER_HZ, pager.FS, pager.DECIMATION,
        pager.channel_specs(tpipe.ChannelSpec), block_size=65_536,
        device="cpu")
    assert pipe.stream_stats["uploads"] == 0
    rng = np.random.default_rng(3)
    iq = rng.integers(-200, 200, size=(3 * pipe.block_size, 2),
                      dtype=np.int16)
    pipe.push(iq)
    st = pipe.stream_stats
    assert st["upload_bytes"] == 2 * iq[:pipe.block_size].nbytes
    assert st["uploads"] == 0 and st["upload_split"] == 0
    flat = iq[:pipe.block_size].reshape(-1)
    stats = {"uploads": 0, "upload_split": 0}
    vals = pipe._upload(flat, "cpu", stats)
    assert torch.equal(vals, torch.from_numpy(flat))
    assert stats == {"uploads": 0, "upload_split": 0}
    pipe.flush()
    st = pipe.stream_stats
    assert st["blocks"] >= 3 and st["uploads"] == st["upload_split"] == 0


@pytest.mark.parametrize("stats,want", [
    ({"fetched": np.zeros(8)}, None),                  # a program without
    ({"uploads": 0, "upload_split": 0}, None),         # the CPU
    ({"uploads": 12, "upload_split": 12}, 100.0),
    ({"uploads": 8, "upload_split": 2}, 25.0),
])
def test_the_split_share_reader(stats, want):
    got = bench.metric_reader("engine.pin_copy_split_pct").read(
        {"stats": stats})
    assert got == want
