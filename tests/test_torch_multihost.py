"""The port across real processes: ``torch.distributed`` over gloo on the
CPU, each process a rank with its own time rows of the mesh.

Bars:
- the sharded channelizer across 2 processes x 2 local devices and 4 x 1
  equals the single-process run on the same mesh shape bit for bit, every
  rank gathers the same result, and the halo bytes the ranks sent are
  ``multihost.dcn_halo_bytes``;
- the receive pipeline across 2 x 2 (time-only and time x channels) and
  4 x 1 decodes, on every rank, the messages of a single-process run
  without a mesh (and of the JAX package's), with equal ``fetched``
  counters, and the ranks' uploads add up to the single-process count;
- ``pipeline-torch --distributed`` over 2 ranks writes ``pipeline-tpu``'s
  messages from rank 0, and rank 1 writes nothing.

Every subprocess is waited for with a timeout (``launch_workers``'
``communicate(timeout=...)``); each test takes well under a minute here.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tsl_sdr_tpu_torch.parallel import multihost
from tsl_sdr_tpu_torch.parallel.channelizer import make_sharded_multifm
from tsl_sdr_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_processes,n_local,channels", [(2, 2, 2),
                                                          (4, 1, 1)],
                         ids=["2proc_x2dev", "4proc_x1dev"])
def test_multiprocess_channelizer_matches_single_process(n_processes,
                                                         n_local, channels):
    res = multihost.run_multiprocess_selftest(n_processes, n_local,
                                              channels, timeout=60.0)
    n_time = n_processes * (n_local // channels)
    assert res["mesh_shape"] == (n_time, channels)
    chain = multihost.selftest_chain(nr_channels=2 * channels)
    plan = chain.packed_plan
    vals = multihost.selftest_capture(plan, n_time)
    want = make_sharded_multifm(plan, make_mesh(
        n_time, channels, ["cpu"] * (n_time * channels)))(vals).numpy()
    np.testing.assert_array_equal(res["pcm"], want)
    assert sum(res["sent_bytes"]) == res["dcn_halo_bytes"] == \
        (n_processes - 1) * (2 * plan.cr_rows + 1) * plan.row * 2
    assert res["dcn_halo_bytes"] < vals.nbytes / 20


@pytest.fixture(scope="module")
def single_pipeline_run():
    from tsl_sdr_tpu.parallel._mh_pipeline_worker import \
        run_pipeline as jax_run
    from tsl_sdr_tpu_torch.parallel._mh_pipeline_worker import run_pipeline

    msgs, stats = run_pipeline(None)
    jax_msgs, _ = jax_run(None)
    assert msgs == jax_msgs
    assert [m[0] for m in msgs[0]] == [7001, 7002] and not msgs[1]
    return [[list(m) for m in ch] for ch in msgs], stats


@pytest.mark.parametrize("n_processes,n_local,channels", [
    (2, 2, 1), (2, 2, 2), (4, 1, 1)])
def test_multiprocess_pipeline_decodes_identically(single_pipeline_run,
                                                   n_processes, n_local,
                                                   channels):
    want, stats = single_pipeline_run
    td, _logs = multihost.launch_workers(
        "tsl_sdr_tpu_torch.parallel._mh_pipeline_worker", n_processes,
        n_local, timeout=60.0, extra_args=("--channels", str(channels)))
    with td:
        outs = [json.load(open(Path(td.name) / f"mhp_out_{pid}.json"))
                for pid in range(n_processes)]
    for o in outs:
        assert o["msgs"] == want, o
        assert o["fetched"] == [int(v) for v in stats["fetched"]], o
        assert o["blocks"] == stats["blocks"]
    # each rank uploads only its own time spans
    assert sum(o["upload_elems"] for o in outs) == stats["upload_elems"]
    assert len({o["upload_elems"] for o in outs}) == 1
    # rank 0 takes look-back rows only between its own time rows
    assert (outs[0]["halo_bytes"] > 0) == (n_local // channels > 1)
    assert all(o["halo_bytes"] > 0 for o in outs[1:])


def test_pipeline_cli_distributed_two_processes(tmp_path):
    """pipeline-torch --distributed over 2 ranks (the CPU one device a
    rank, so the default mesh is 2 x 1): rank 0 writes the messages
    pipeline-tpu writes for the capture, rank 1 writes nothing."""
    from tsl_sdr_tpu.cli import pipeline as jax_cli
    from tsl_sdr_tpu_torch.parallel._mh_pipeline_worker import _capture
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    decim, fs, center = 32, 38400 * 32, 929_500_000
    iq = _capture(fs, decim)
    iq_path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(iq_path)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, firdes_low_pass(1.0, fs, 9_600, 7_000))),
        "channels": [
            {"protocol": "pocsag", "chanCenterFreq": center + 250_000},
            {"protocol": "pocsag", "chanCenterFreq": center - 250_000},
        ],
    }
    cfg_path = tmp_path / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))
    assert jax_cli.main([str(cfg_path), "-o", str(tmp_path / "tpu.jsonl"),
                         "--block-size", "393216"]) == 0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the two ranks share the host's cores: one thread each
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    outs = {p: tmp_path / f"out{p}.jsonl" for p in (0, 1)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tsl_sdr_tpu_torch.cli.pipeline",
         str(cfg_path), "--device", "cpu",
         "--distributed", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(p), "-o", str(outs[p]),
         "--block-size", "393216"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in (0, 1)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=60)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs

    def msgs(path):
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        for m in lines:
            m.pop("timestamp")
        return lines

    want = msgs(tmp_path / "tpu.jsonl")
    assert [m["capCode"] for m in want] == [7001, 7002]
    assert msgs(outs[0]) == want
    assert not outs[1].exists(), "rank 1 must not write"
    for rank, log in enumerate(logs):
        assert f"process {rank} of 2" in log and "halo_bytes=" in log, log
