"""``torch.profiler``'s record of a window reduced to what the metrics and
the ``breakdown`` read: device time by kernel, the device's busy time (the
union of its kernels and copies), and the idle gaps, each named by the
harness's span (``push``, ``flush``) that was open when it began."""

from __future__ import annotations

SPANS = ("push", "flush")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def raw_events(prof) -> list:
    """(name, on the device, start, end) of every event the profiler
    kept, times in microseconds, read from its raw records (building
    ``prof.events()``'s tree takes minutes for a window of many blocks)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        dev = e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
        out.append((e.name(), dev, a, a + e.duration_ns() / 1e3))
    return out


def reduce(events) -> dict:
    """``events``: :func:`raw_events` of a window made of ``push`` and
    ``flush`` spans. Times in seconds."""
    dev, spans = [], []
    for name, on_dev, a, b in events:
        if on_dev:
            dev.append((name, a, b))
        elif name in SPANS:
            spans.append((a, b, name))
    if not spans:
        raise ValueError("the trace holds no push or flush span")
    spans.sort()
    w0, w1 = spans[0][0], max(b for _, b, _ in spans)
    kernels: dict = {}
    inside = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e6
        k[1] += 1
        inside.append((a, b))
    busy = _merge(inside)
    gaps = []
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)

    def who(t):
        for a, b, name in spans:
            if a <= t < b:
                return name
        return "harness"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_s": sum(v[0] for v in kernels.values()),
        "kernels": {n: {"s": v[0], "count": v[1]} for n, v in kernels.items()},
        "idle_gaps": [[who(a), (b - a) / 1e6] for a, b in gaps[:10]],
    }


def device_s(red: dict, names) -> float | None:
    """Device seconds of the kernels whose name contains one of ``names``;
    None where none ran."""
    hit = [v["s"] for n, v in red["kernels"].items()
           if any(k in n for k in names)]
    return sum(hit) if hit else None


def top_ops(red: dict, n: int = 10) -> list:
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1]["s"])
    return [[name[:96], v["s"]] for name, v in ops[:n]]
