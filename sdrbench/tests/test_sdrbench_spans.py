"""The readers of the program's spans (``sdrbench/spans.py``): a traced run
of the tiny cell reports them; a program without the spans reads null."""

from __future__ import annotations

import json

from conftest import REPO, TINY

from sdrbench import bench

NEW = ("engine.pin_copy_ms", "engine.launch_ms", "engine.device_wait_ms",
       "device.idle_decode_pct", "device.idle_engine_pct")


def test_a_traced_tiny_run_reports_the_span_metrics(tiny):
    root, spec = tiny
    res = bench.run(TINY, 2**31 + 777, 3.0, True, device="cpu", bench=spec,
                    root=root)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(NEW) <= set(got), set(NEW) - set(got)
    # no pinned ring on the CPU
    assert got["engine.pin_copy_ms"]["value"] == 0.0
    assert got["engine.launch_ms"]["value"] > 0
    assert got["engine.device_wait_ms"]["value"] >= 0
    # no device events on the CPU: the whole window is idle, most of it
    # under the engine's spans and the decoders'
    share = (got["device.idle_decode_pct"]["value"]
             + got["device.idle_engine_pct"]["value"])
    assert 50 < share <= 100 + 1e-9


def test_without_the_programs_spans_the_readers_read_null():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(NEW) <= {m["name"] for m in spec["per_layer"]}
    # a program that keeps only the keys of its phases and opens no span
    ctx = {"timing": {"dispatch_s": 0.5, "upload_s": 0.3,
                      "egress_start_s": 0.01, "drain_wait_s": 0.02,
                      "unpack_s": 0.1, "decode_s": 0.2},
           "blocks": 10, "trace": {"window_s": 2.0, "busy_s": 0.1},
           "program_spans": {"idle_by_span": {"push": 1.8, "flush": 0.1},
                             "idle_gaps": [["push", 0.2]]}}
    for name in NEW:
        assert bench.metric_reader(name).read(ctx) is None, name
