"""The program's own spans in ``torch.profiler``'s record, and the device's
idle time credited to them.

A program span is a range the program opened on the host with
``record_function`` (a CPU user annotation) other than the harness's
``push`` and ``flush``: ``engine.dispatch``, ``decoders.pocsag`` and the
like (``tsl_sdr_tpu_torch.models.pipeline``, "Tracing"). The window and
the device's busy time are found as :func:`sdrbench.trace.reduce` finds
them; each stretch of the window that no kernel or copy covers is cut at
the spans' edges, and each piece is credited to the innermost
program span open over it (the latest-starting one, on any thread), or,
under none, to the harness span open over it (``harness`` between them).
"""

from __future__ import annotations

import heapq
import sys
from collections import defaultdict

from sdrbench import trace

# a key the program's spans write for every block it dispatches
ENGINE_KEY = "launch_s"


def events(prof) -> list:
    """:func:`sdrbench.trace.raw_events` with a fifth field: whether the
    event is a range opened on the host (a CPU user annotation)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        cuda = e.device_type() == DeviceType.CUDA
        ann = e.is_user_annotation()
        out.append((e.name(), cuda and not ann, a, a + e.duration_ns() / 1e3,
                    ann and not cuda))
    return out


def attribute(evs) -> dict:
    """``evs``: :func:`events` of a window of ``push`` and ``flush`` spans.
    ``idle_by_span``: the idle seconds credited to each span name;
    ``idle_gaps``: the ten longest idle stretches, each named by the
    innermost span open at its start; ``spans``: the program spans."""
    dev, harness, prog = [], [], []
    for name, on_dev, a, b, host_range in evs:
        if on_dev:
            dev.append((a, b))
        elif name in trace.SPANS:
            harness.append((a, b, name))
        elif host_range:
            prog.append((a, b, name))
    if not harness:
        raise ValueError("the trace holds no push or flush span")
    harness.sort()
    w0, w1 = harness[0][0], max(b for _, b, _ in harness)
    busy = trace._merge([(max(a, w0), min(b, w1)) for a, b in dev
                         if min(b, w1) > max(a, w0)])
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)

    marks = sorted({t for a, b, _ in prog + harness for t in (a, b)
                    if w0 < t < w1} | {t for g in gaps for t in g})
    prog.sort()
    open_, pi, gi, hi = [], 0, 0, 0
    by_span = defaultdict(float)
    named = {}
    for t0, t1 in zip(marks, marks[1:]):
        while gi < len(gaps) and gaps[gi][1] <= t0:
            gi += 1
        if gi == len(gaps):
            break
        while pi < len(prog) and prog[pi][0] <= t0:
            a, b, name = prog[pi]
            heapq.heappush(open_, (-a, pi, b, name))
            pi += 1
        while open_ and open_[0][2] <= t0:
            heapq.heappop(open_)
        if gaps[gi][0] > t0:
            continue
        if open_:
            name = open_[0][3]
        else:
            while hi < len(harness) and harness[hi][1] <= t0:
                hi += 1
            name = (harness[hi][2] if hi < len(harness)
                    and harness[hi][0] <= t0 else "harness")
        by_span[name] += (t1 - t0) / 1e6
        named.setdefault(gaps[gi], name)
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"idle_by_span": dict(by_span),
            "idle_gaps": [[named[g], (g[1] - g[0]) / 1e6] for g in gaps[:10]],
            "spans": len(prog)}


def _profile_of_caller():
    """The ``torch.profiler.profile`` held by a caller's local variable:
    the harness hands its readers the reduced trace, not the record."""
    from torch.profiler import profile

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, profile):
                return v
        f = f.f_back
    return None


def of_run(ctx: dict) -> dict | None:
    """:func:`attribute` of the traced run whose metrics ``ctx`` holds
    (kept in ``ctx`` for the next reader); None without a profiler."""
    if "program_spans" not in ctx:
        prof = _profile_of_caller()
        ctx["program_spans"] = attribute(events(prof)) if prof else None
    return ctx["program_spans"]


def idle_pct(ctx: dict, prefix: str) -> float | None:
    """The share of the window the device idles under a program span whose
    name starts with ``prefix``; None where no such span was open."""
    got = of_run(ctx)
    window = ctx["trace"]["window_s"]
    if not got or not window:
        return None
    hit = [s for n, s in got["idle_by_span"].items() if n.startswith(prefix)]
    return 100.0 * sum(hit) / window if hit else None


def per_block_ms(ctx: dict, *keys: str) -> float | None:
    """The ``pipe.timing`` keys' milliseconds a block; None where the
    program has no such spans. A key a device never writes reads 0 (the
    pinned ring's, on the CPU)."""
    tm = ctx["timing"]
    if ENGINE_KEY not in tm or not ctx["blocks"]:
        return None
    return 1e3 * sum(tm.get(k, 0.0) for k in keys) / ctx["blocks"]
