#!/usr/bin/env python3
"""K6 (``tsl_sdr_tpu_torch/csrc/costas.cu``) against its first form on the
card: where a warp-a-channel Costas loop loses time beside its dependent
chain.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 bench/torch_k6_lab.py

At the slice's planes (BENCH_SUITE's costas_chain_device block: 250,000
outputs x 8 channels, chunk 22; ``chip_smoke.py`` phase 18) it times, in
turns with ``torch.profiler``, K6 as it is (inputs staged by cp.async a
tile ahead, outputs written a tile at a time) and its first form,
``bench/costas_ring_v1.cu`` (each chunk loaded into a ring of registers a
few turns ahead, outputs stored every turn), with two cut copies of the
first form: no loads (inputs made from the index) and no stores. K6 and
the first form are held equal to the plain version first; the cut copies
compute something else. Beside them, the probe's chain a turn
(``bench/costas_chain_probe.cu``), the bound. The copies build with nvcc
into ``build/tsl_sdr_tpu_torch/k6_lab/``. Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
V1 = ROOT / "bench" / "costas_ring_v1.cu"
LOADS = ("      br[j] = __ldg(xr + at);\n      bi[j] = __ldg(xi + at);",
         "      br[j] = 0.3f + 1e-9f * (float)at;\n      bi[j] = 0.1f;")
STORES = ("            ore[at] = o_r[j];\n            oim[at] = o_i[j];",
          "            if (o_r[j] == 1234.5f) ore[at] = o_i[j];")
VARIANTS = {"first form": [], "first form, no loads": [LOADS],
            "first form, no stores": [STORES]}


def build_variant(name: str, patches) -> ctypes.CDLL:
    from tsl_sdr_tpu_torch.kernels import build

    text = V1.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{V1.name} no longer holds:\n{old}")
        text = text.replace(old, new)
    out = build.BUILD_DIR / "k6_lab"
    out.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_").replace(",", "")
    src = out / f"{stem}.cu"
    src.write_text(text)
    build.compile_shared([src], out / f"lib{stem}.so")
    lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
    lib.tsl_costas_ring_v1.argtypes = build.SIGNATURES["tsl_costas_chunks"]
    lib.tsl_costas_ring_v1.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT))
    for name in ("jax", "jaxlib", "tsl_sdr_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch

    import chip_smoke as cs
    from tsl_sdr_tpu_torch.kernels import build
    from tsl_sdr_tpu_torch.ops import costas as k6

    if not torch.cuda.is_available():
        print("torch_k6_lab: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    build.load()
    libs = {name: build_variant(name, patches)
            for name, patches in VARIANTS.items()}
    chain = cs.costas_bench_chain("cuda")
    iq, block = cs.costas_capture(chain, 1)
    vals = torch.from_numpy(iq[:chain.carry_len + block].reshape(-1)
                            .copy()).cuda()
    yr, yi = chain._baseband(vals[:2 * chain.carry_len],
                             vals[2 * chain.carry_len:], 0)
    scale = float(np.float32(1.0 / 16384.0))
    xr, xi = yr * scale * scale, yi * scale * scale
    p = chain.params
    st = k6.init_costas_state(p, chain.nr_channels, "cuda")
    chunk = k6.stable_chunk(p)
    stream = torch.cuda.current_stream().cuda_stream

    def first_form(lib):
        def run():
            o_re, o_im = torch.empty_like(xr), torch.empty_like(xi)
            ph, fd = torch.empty_like(st.last_phase), torch.empty_like(
                st.f_dev)
            build.check(lib.tsl_costas_ring_v1(
                xr.data_ptr(), xi.data_ptr(), o_re.data_ptr(),
                o_im.data_ptr(), st.last_phase.data_ptr(),
                st.f_dev.data_ptr(), ph.data_ptr(), fd.data_ptr(),
                xr.shape[0], xr.shape[1], chunk, p.alpha, p.beta, p.e_max,
                p.f_dev_min, p.f_dev_max, stream), "tsl_costas_ring_v1")
            return k6.CostasState(ph, fd), o_re, o_im
        return run

    runs = {"K6": lambda: k6.costas_block_planes(p, st, xr, xi)}
    runs.update({name: first_form(lib) for name, lib in libs.items()})
    s_p, r_p, i_p = k6.costas_block_planes_plain(p, st, xr, xi)
    for name in ("K6", "first form"):
        s, r, i = runs[name]()
        same = all(torch.equal(a, b) for a, b in (
            (r, r_p), (i, i_p), (s.last_phase, s_p.last_phase),
            (s.f_dev, s_p.f_dev)))
        print(f"{name}: {'equal to' if same else 'DIFFERS from'} the plain "
              f"version")
        if not same:
            return 1
    order = list(runs) + list(runs)[::-1]
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cs.device_ms(runs[name], 10))
    lat = cs.costas_chain_latency("cuda", chunk)
    chunks = -(-xr.shape[0] // chunk)
    bound = chunks * lat["ns_per_turn"] * 1e-6
    for name, t in times.items():
        ms = sum(t) / len(t)
        print(f"{card} | {name}: {ms:.4f} ms ({' '.join(f'{x:.4f}' for x in t)}"
              f"), {bound / ms:.1%} of the latency bound {bound:.4f} ms "
              f"({chunks} turns of {lat['cycles_per_turn']:.1f} cycles)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
