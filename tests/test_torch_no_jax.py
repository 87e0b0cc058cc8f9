"""The port runs where jax is absent.

A subprocess makes ``jax`` unimportable before anything loads, then imports
the port, its pipeline and its CLI, builds a 4-channel CPU pipeline and
decodes one POCSAG burst. The JAX package's jax-free modules (decoders,
generators, utils) load; anything that would import jax fails, and the
decoders fall back to their numpy tiers.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import numpy as np
import tsl_sdr_tpu_torch
import tsl_sdr_tpu_torch.cli.pipeline
import tsl_sdr_tpu_torch.utils.convert
from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
from tsl_sdr_tpu_torch.testing import pager
from tsl_sdr_tpu.testing import pocsag_gen

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
assert all(d._nat is None for d in pipe._decoders), "expected numpy tiers"
assert sys.modules["jax"] is None
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("NO-JAX OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO-JAX OK" in res.stdout


def test_no_port_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes)\b",
                         re.MULTILINE)
    files = sorted((ROOT / "tsl_sdr_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
