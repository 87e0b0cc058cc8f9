"""The port runs where jax and the JAX package are absent.

A subprocess makes ``jax``, ``jaxlib`` and ``tsl_sdr_tpu`` unimportable
before anything loads, then imports the port, its pipeline, its CLI, its
hardware sources and mock radios, builds a 4-channel CPU pipeline and
decodes one POCSAG burst, every decoder on its native state machine, then
again on a (2, 2) mesh, and runs the sharded channelizer. A
second one runs ``decoder-torch`` (a 25/16 frame-form POCSAG input, exact
tier, ``-b``) and ``resampler-torch``, a third ``pipeline-torch --follow``
on a FIFO, a fourth ``multifm-torch --exact`` (both I/O runtimes) and
``pipeline-torch --exact`` on a POCSAG + AIS capture made with the port's
own generators, a fifth the Costas coherent chain (both tiers lock on a
BPSK channel) and Mueller-Muller clock recovery, a sixth the weak-scaling
witness, ``design-filter-torch``, the coefficient dumps and the nine
top-level names, a seventh the pipeline soak (one seed a tier), the
deployment soak's writer and leg arguments, and the version. No file of the port, and not ``chip_smoke.py``, imports
either package.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BLOCK = r"""
import sys
for name in ("jax", "jaxlib", "tsl_sdr_tpu"):
    sys.modules[name] = None
"""

_CHECK = r"""
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "tsl_sdr_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
"""

_SCRIPT = _BLOCK + r"""
import numpy as np
import tsl_sdr_tpu_torch
import tsl_sdr_tpu_torch.cli.pipeline
import tsl_sdr_tpu_torch.utils.convert
import tsl_sdr_tpu_torch.models.resampler
import tsl_sdr_tpu_torch.runtime.stream
import tsl_sdr_tpu_torch.sources
import tsl_sdr_tpu_torch.sources.hw
import tsl_sdr_tpu_torch.testing.mock_radios
import tsl_sdr_tpu_torch.testing.stage_inputs
import tsl_sdr_tpu_torch.ops.gate
from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu_torch.testing import pocsag_gen

bb = pocsag_gen.generate(
    [pocsag_gen.PocsagBurst(capcode=424242, function=1, kind="alpha",
                            content="NO JAX HERE")],
    baud=1200, amplitude=4096, tail_bits=256)
iq = pager.fm_mod(bb, 38_400, pager.OFFSETS_HZ[1], pager.FS, amp=8000)
iq = (iq + np.random.default_rng(0).normal(scale=100, size=iq.shape))
specs = pager.channel_specs(ChannelSpec)[:4]
pipe = ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                       pager.DECIMATION, specs, device="cpu",
                       block_size=1_000_000)
res = pipe.process_capture(iq.astype(np.int16))
assert [(m.capcode, m.data) for m in res[1]] == [(424242, b"NO JAX HERE")], res
assert not any(res[i] for i in (0, 2, 3)), res
assert all(d._nat is not None for d in pipe._decoders), "expected native"
# the same on a (2, 2) mesh of CPU stand-ins, and the sharded channelizer
import tsl_sdr_tpu_torch.parallel.multihost
from tsl_sdr_tpu_torch.parallel.channelizer import make_sharded_multifm
from tsl_sdr_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(time=2, channels=2, devices=["cpu"] * 4)
pipe = ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                       pager.DECIMATION, specs, block_size=1_000_000,
                       mesh=mesh)
assert [(m.capcode, m.data) for m in pipe.process_capture(
    iq.astype(np.int16))[1]] == [(424242, b"NO JAX HERE")]
pcm = make_sharded_multifm(pipe.chain.packed_plan, mesh)(
    iq.astype(np.int16)[:64 * pipe.chain.packed_plan.row])  # 128 rows
assert pcm.shape == (4, 128 * pipe.chain.packed_plan.opr), pcm.shape
assert sys.modules["jax"] is None and sys.modules["tsl_sdr_tpu"] is None
""" + _CHECK + r"""
print("NO-JAX OK")
"""


_CLI_SCRIPT = _BLOCK + r"""
import json, tempfile
from pathlib import Path
import numpy as np
from tsl_sdr_tpu_torch.testing import pocsag_gen
from tsl_sdr_tpu_torch.utils.filter_design import resampler_filter_json
from tsl_sdr_tpu_torch.cli import decoder, resampler

bb = pocsag_gen.generate(
    [pocsag_gen.PocsagBurst(capcode=2025, function=1, kind="alpha",
                            content="FRAME FORM")],
    baud=1200, amplitude=4096, tail_bits=256)
idx = np.arange(len(bb) * 16 // 25) * 25 // 16
pcm = np.concatenate([np.zeros(500, np.int16), bb[idx] + np.int16(300)])
tmp = Path(tempfile.mkdtemp())
pcm.tofile(tmp / "in.pcm")
(tmp / "f.json").write_text(resampler_filter_json(25, 16, 0.4))
assert decoder.main(["-m", "pocsag", "-I", "25", "-D", "16", "-b",
                     "-F", str(tmp / "f.json"), "-o", str(tmp / "o.json"),
                     "-c", "--device", "cpu", str(tmp / "in.pcm")]) == 0
msgs = [json.loads(x) for x in (tmp / "o.json").read_text().splitlines()]
assert [(m["capCode"], m["message"].rstrip("\0")) for m in msgs] == [
    (2025, "FRAME FORM")]
assert resampler.main(["-I", "25", "-D", "16", "-F", str(tmp / "f.json"),
                       "--device", "cpu", str(tmp / "in.pcm"),
                       str(tmp / "out.pcm")]) == 0
out = np.fromfile(tmp / "out.pcm", np.int16)
assert abs(out.size - pcm.size * 25 / 16) < 4096, out.size
""" + _CHECK + r"""
print("NO-JAX CLI OK")
"""


_FOLLOW_SCRIPT = _BLOCK + r"""
import json, os, tempfile, threading
from pathlib import Path
import numpy as np
from tsl_sdr_tpu_torch.cli import pipeline
from tsl_sdr_tpu_torch.testing import pager, pocsag_gen

bb = pocsag_gen.generate(
    [pocsag_gen.PocsagBurst(capcode=515151, function=1, kind="alpha",
                            content="FOLLOW NO JAX")],
    baud=1200, amplitude=4096, tail_bits=256)
iq = pager.fm_mod(bb, 38_400, pager.OFFSETS_HZ[2], pager.FS, amp=8000)
iq = (iq + np.random.default_rng(1).normal(scale=100, size=iq.shape))
raw = iq.astype(np.int16).tobytes()
tmp = Path(tempfile.mkdtemp())
fifo = tmp / "iq.fifo"
os.mkfifo(fifo)
cfg = pager.config(str(fifo))
cfg["channels"] = cfg["channels"][:4]
(tmp / "cfg.json").write_text(json.dumps(cfg))

def feed():
    with open(fifo, "wb") as f:
        for o in range(0, len(raw), 1 << 20):
            f.write(raw[o:o + (1 << 20)])

t = threading.Thread(target=feed)
t.start()
assert pipeline.main([str(tmp / "cfg.json"), "--follow", "--block-size",
                      "491520", "--device", "cpu",
                      "-o", str(tmp / "m.jsonl")]) == 0
t.join(timeout=60)
msgs = [json.loads(x) for x in (tmp / "m.jsonl").read_text().splitlines()]
want = pocsag_gen.expected_alpha_decode(b"FOLLOW NO JAX").decode()
assert [(m["capCode"], m["message"]) for m in msgs] == [(515151, want)], msgs
""" + _CHECK + r"""
print("NO-JAX FOLLOW OK")
"""


_EXACT_SCRIPT = _BLOCK + r"""
import json, tempfile
from pathlib import Path
import numpy as np
import tsl_sdr_tpu_torch.ops.atan2
import tsl_sdr_tpu_torch.ops.exact_fir
import tsl_sdr_tpu_torch.runtime.feeder
from tsl_sdr_tpu_torch.cli import multifm, pipeline
from tsl_sdr_tpu_torch.models.pocsag import PocsagDecoder
from tsl_sdr_tpu_torch.testing import ais_gen, pager, pocsag_gen

fs, decim, center = pager.FS, pager.DECIMATION, pager.CENTER_HZ
bb = pocsag_gen.generate(
    [pocsag_gen.PocsagBurst(capcode=616161, function=1, kind="alpha",
                            content="EXACT NO JAX")],
    baud=1200, amplitude=4096, tail_bits=256)
iq = pager.fm_mod(bb, 38_400, 190_000, fs, amp=8000)
a_bb = ais_gen.generate([ais_gen.make_position_report(
    367000444, longitude=-70.0, latitude=41.0)], amplitude=9000)
a_iq = pager.fm_mod(a_bb, 48_000, -320_000, fs, amp=7000, dev_hz=4800)
iq[100_000:100_000 + len(a_iq)] += a_iq
iq = (iq + np.random.default_rng(2).normal(scale=100, size=iq.shape))
tmp = Path(tempfile.mkdtemp())
iq.astype(np.int16).tofile(tmp / "cap.cs16")
cfg = {"device": {"type": "file", "filename": str(tmp / "cap.cs16"),
                  "fileFormat": "cs16"},
       "sampleRateHz": fs, "centerFreqHz": center, "decimationFactor": decim,
       "lpfTaps": [float(t) for t in pager.lpf_taps()],
       "channels": [{"chanCenterFreq": center + 190_000,
                     "outFifo": str(tmp / "ch0.pcm"), "protocol": "pocsag"},
                    {"chanCenterFreq": center - 320_000,
                     "outFifo": str(tmp / "ch1.pcm"), "protocol": "ais"}]}
(tmp / "cfg.json").write_text(json.dumps(cfg))
pcms = []
for runtime in ("native", "python"):
    assert multifm.main([str(tmp / "cfg.json"), "--exact", "--runtime",
                         runtime, "--device", "cpu"]) == 0
    pcm = np.fromfile(tmp / "ch0.pcm", np.int16)
    assert [(m.capcode, m.data.rstrip(b"\0")) for m in
            PocsagDecoder().scan(pcm)] == [(616161, b"EXACT NO JAX")]
    pcms.append(pcm)
n = min(map(len, pcms))
assert n > 0 and (pcms[0][:n] == pcms[1][:n]).all()
assert pipeline.main([str(tmp / "cfg.json"), "--exact", "--device", "cpu",
                      "-o", str(tmp / "m.jsonl")]) == 0
msgs = [json.loads(x) for x in (tmp / "m.jsonl").read_text().splitlines()]
assert sorted(m["proto"] for m in msgs) == ["ais", "pocsag"], msgs
""" + _CHECK + r"""
print("NO-JAX EXACT OK")
"""


_COSTAS_SCRIPT = _BLOCK + r"""
import numpy as np
import torch
import tsl_sdr_tpu_torch
from tsl_sdr_tpu_torch.ops import costas
from tsl_sdr_tpu_torch.ops.mueller_muller import MuellerMuller
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

fs, d, n = 256_000, 8, 64_000
rng = np.random.default_rng(33)
sym = rng.choice([-1.0, 1.0], size=n // 128 + 2)
bb = np.repeat(sym, 128)[:n]
ph = 2 * np.pi * (40_000 + 35.0) * np.arange(n) / fs
iq = (np.stack([np.cos(ph) * bb, np.sin(ph) * bb], -1) * 9000
      + rng.normal(scale=60, size=(n, 2))).astype(np.int16)
chain = tsl_sdr_tpu_torch.CostasChannelizer(
    firdes_low_pass(1.0, fs, 6_000, 4_000), [40_000], fs, d, alpha=0.1,
    beta=0.005, device="cpu")
q = chain.block_quantum
k = (n - chain.carry_len) // q * q
st, out = chain.step(chain.init_state(prefix=iq[:chain.carry_len]),
                     iq[chain.carry_len:chain.carry_len + k])
native = chain.process_array_native(iq, block_size=8_192)
for res in (out.numpy()[0], native[0]):
    tail = res[res.shape[0] // 2:].astype(np.float64)
    assert np.mean(tail[:, 0] ** 2) > 20 * np.mean(tail[:, 1] ** 2)
rail = out.numpy()[0, :, 0]
dec = MuellerMuller(kw=1e-4, km=4e-6, samples_per_bit=16.0,
                    error_min=15.0, error_max=17.0).process(rail)
assert abs(len(dec) - len(rail) / 16) < 16, len(dec)
assert costas.costas_block_planes.launches == 0
""" + _CHECK + r"""
print("NO-JAX COSTAS OK")
"""


_SURFACE_SCRIPT = _BLOCK + r"""
import contextlib, io, json, os, tempfile
from pathlib import Path
import tsl_sdr_tpu_torch
from tsl_sdr_tpu_torch.cli import design_filter
from tsl_sdr_tpu_torch.parallel import _mh_scaling_worker
from tsl_sdr_tpu_torch.utils.filter_design import resampler_filter_json

tmp = Path(tempfile.mkdtemp())
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert _mh_scaling_worker.main([
        "--pid", "0", "--nproc", "1", "--n-local", "2", "--port", "1",
        "--outdir", str(tmp), "--reps", "2", "--rows-per-shard", "64",
        "--device", "cpu"]) == 0
rec = json.loads((tmp / "mhs_out_0.json").read_text())
assert rec["n_time"] == 2 and rec["dcn_halo_bytes_per_block"] == 0, rec
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert design_filter.main(["16", "25", "0.4"]) == 0
assert out.getvalue() == resampler_filter_json(16, 25, 0.4) + "\n"
os.environ["TSL_DUMP_LPF"] = str(tmp / "lpf.txt")
os.environ["TSL_DUMP_FILTER_COEFFICIENTS"] = str(tmp / "ph.txt")
chain = tsl_sdr_tpu_torch.MultifmChain([0.25] * 8, [1000], 64_000, 4,
                                       device="cpu")
tsl_sdr_tpu_torch.ResamplerChain([0.5] * 6, 3, 2, device="cpu")
assert (tmp / "lpf.txt").read_text().startswith("lpf_shifted_1000 = [")
assert (tmp / "ph.txt").read_text().count("Phase ") == 3
for name in ("MultifmChain", "ResamplerChain", "ReceivePipeline",
             "ChannelSpec", "PocsagDecoder", "FlexDecoder", "AisDecoder",
             "CostasChannelizer", "MultifmConfig"):
    assert getattr(tsl_sdr_tpu_torch, name).__name__ == name
""" + _CHECK + r"""
print("NO-JAX SURFACE OK")
"""


_SOAK_SCRIPT = _BLOCK + r"""
import importlib.util

def bench(name):
    spec = importlib.util.spec_from_file_location(name, f"bench/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

soak = bench("torch_soak_pipeline")
assert soak.main(1, device="cpu") == 0
assert soak.main(1, exact=True, device="cpu") == 0
dep = bench("torch_soak_deployment")
sec = dep.PacedWriter("unused.fifo", 0)._second(0)
assert sec.shape == (dep.FS, 2) and sec.dtype.name == "int16"
argv = dep.leg_argv("c.json", "iq.fifo", "o.jsonl", "s.npz", standby=True)
assert argv[0] == "tsl_sdr_tpu_torch.cli.pipeline" and "--standby" in argv
import tsl_sdr_tpu_torch
assert tsl_sdr_tpu_torch.__version__
""" + _CHECK + r"""
print("NO-JAX SOAK OK")
"""


def _run_no_jax(script: str, token: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert token in res.stdout


def test_port_runs_without_jax():
    _run_no_jax(_SCRIPT, "NO-JAX OK")


def test_decoder_and_resampler_clis_run_without_jax():
    _run_no_jax(_CLI_SCRIPT, "NO-JAX CLI OK")


def test_follow_on_a_fifo_runs_without_jax():
    _run_no_jax(_FOLLOW_SCRIPT, "NO-JAX FOLLOW OK")


def test_exact_tier_clis_run_without_jax():
    _run_no_jax(_EXACT_SCRIPT, "NO-JAX EXACT OK")


def test_costas_chain_runs_without_jax():
    _run_no_jax(_COSTAS_SCRIPT, "NO-JAX COSTAS OK")


def test_surface_runs_without_jax():
    _run_no_jax(_SURFACE_SCRIPT, "NO-JAX SURFACE OK")


def test_soaks_and_version_run_without_jax():
    _run_no_jax(_SOAK_SCRIPT, "NO-JAX SOAK OK")


def test_no_port_file_imports_jax():
    """No ``import``/``from`` of jax, jaxlib, ml_dtypes or ``tsl_sdr_tpu``
    (``tsl_sdr_tpu_torch`` is the port itself) in the port, ``chip_smoke.py``
    or the port's labs (``bench/torch_*.py``)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|tsl_sdr_tpu)(\.|\s|$)",
        re.MULTILINE)
    files = sorted((ROOT / "tsl_sdr_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "bench").glob("torch_*.py"))
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"tsl_sdr_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "channelizer", "resampler", "multihost",
        "pipeline", "_mh_worker", "_mh_pipeline_worker")} <= names
    assert {"tsl_sdr_tpu_torch/ops/costas.py",
            "tsl_sdr_tpu_torch/ops/mueller_muller.py",
            "tsl_sdr_tpu_torch/models/costas_channel.py",
            "tsl_sdr_tpu_torch/runtime/native.py",
            "tsl_sdr_tpu_torch/utils/diag.py",
            "tsl_sdr_tpu_torch/parallel/_mh_scaling_worker.py",
            "tsl_sdr_tpu_torch/cli/design_filter.py",
            "bench/torch_k1_lab.py", "bench/torch_k9_lab.py",
            "bench/torch_soak_pipeline.py", "bench/torch_soak_deployment.py",
            "tsl_sdr_tpu_torch/_version.py"} <= names
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
