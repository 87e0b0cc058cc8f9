#!/usr/bin/env python3
"""Where K4 (``tsl_sdr_tpu_torch/csrc/frame_resampler.cu``) spends its time
on the card, without a profiler that reads inside a kernel.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 bench/torch_k4_lab.py ablate    # device time with phases cut
    python3 bench/torch_k4_lab.py ablate --pairs 4 "funnel A"
    python3 bench/torch_k4_lab.py phases    # clock64 stamps inside a block

Both compile patched copies of the kernel's source (textual cuts, or
``clock64()`` stamps) with nvcc into ``build/k4_lab/`` and run them at the
three shapes of ``chip_smoke.py``'s K4 rows: the decimation-50 pipeline's
25/16 step [6, 83,872], ``decoder-torch``'s 25/16 step [1, 656] and the
147/160 capture (2.88 M samples).

``ablate`` times, in turns, the kernel as it is, a copy that reads its A
fragments with aligned word loads and funnel shifts (the path of D_rep %
16 != 0) in place of ``ldmatrix`` (all three shapes have D_rep % 16 ==
0), and copies with the window's staging, the products (the warps' unit
loop), only their tensor-core instructions (and the A loads), the output
copy, or staging, products and copy cut out (their outputs are then
wrong; only the kernel and the funnel copy are checked against the plain
version), beside one float64 ``torch.bmm`` of the same product; named
variants run alone, and ``--pairs`` repeats the forward and backward
passes. ``phases`` records ``clock64()`` per warp of block (0, 0) after
the tap copy is issued, after staging, after the barrier, after the last
unit's k-steps, after the products, and at the end. The SM's clock counters are per scheduler, so
only differences within one warp mean anything; a warp without a unit
shows 0 for its k-steps. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k4_lab"

STAGING = ("j0 < chunks;", "j0 < 0;")
PRODUCTS = ("for (int u = warp; u < units; u += nwarps) {",
            "for (int u = warp; u < 0; u += nwarps) {")
COPY = ("q < (total + 15) / 16;", "q < 0;")
IMMA = ("if (live >> j & 1) imma::mma_split(",
        "if (live >> j & 1 && m < 0) imma::mma_split(")
FUNNEL = ("if constexpr (kLdm) {", "if constexpr (false) {")
NO_A = ("        imma::load_a(ah, a_hi, d_rep, 16 * mt, 32 * ks);\n"
        "        imma::load_a(al, a_lo, d_rep, 16 * mt, 32 * ks);",
        "        ah[0] = ah[1] = ah[2] = ah[3] = lane * ks;\n"
        "        al[0] = al[1] = al[2] = al[3] = lane + ks;")
ABLATIONS = {"kernel": [], "funnel A": [FUNNEL],
             "no staging": [STAGING], "no products": [PRODUCTS],
             "no IMMA": [IMMA], "no IMMA nor A loads": [IMMA, NO_A],
             "no copy": [COPY], "none of the three": [STAGING, PRODUCTS, COPY]}
EXACT = ("kernel", "funnel A")   # variants that still compute K4

STAMP = ("if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) == 0)"
         " g_lab[(threadIdx.x >> 5) * 8 + {k}] = clock64();\n")
PHASES = ["start", "tap copy issued", "window staged", "past the barrier",
          "last unit's k-steps done", "products done", "end"]


def stamps() -> list:
    """Patches that put PHASES' clock64 stamps into the kernel."""
    def at(k):
        return "  " + STAMP.format(k=k)

    first = "  const int g = blockIdx.y;\n"
    commit = '  asm volatile("cp.async.commit_group;\\n" ::);\n'
    wait = '  asm volatile("cp.async.wait_all;\\n" ::);\n  __syncthreads();\n'
    sums = "    // the unit's sums, converted into the tile\n"
    done = "  __syncthreads();\n\n  // the block's output span"
    end = ("            *reinterpret_cast<const uint16_t*>(out_s + b);\n"
           "      }\n    }\n  }\n}\n")
    return [
        ("namespace {\n",
         "__device__ unsigned long long g_lab[64];\nnamespace {\n"),
        (first, at(0) + first),
        (commit, commit + at(1)),
        (wait, at(2) + wait + '  asm volatile("bar.sync 0;" ::: "memory");\n'
         + at(3)),
        (sums, "  " + at(4) + sums),
        (done, at(5) + done),
        (end, end[:-2] + at(6) + "}\n"),
    ]


def build_variant(name: str, patches) -> ctypes.CDLL:
    from tsl_sdr_tpu_torch.kernels import build

    src = (build.CSRC / "frame_resampler.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int lab_read(void* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_lab, sizeof(g_lab));\n'
            '}\n'
            'extern "C" int lab_clear() {\n'
            '  static unsigned long long zero[64];\n'
            '  return (int)cudaMemcpyToSymbol(g_lab, zero, sizeof(zero));\n'
            '}\n' if "g_lab" in src else "")
    d = OUT / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "frame_resampler.cu").write_text(src)
    build.compile_shared([d / "frame_resampler.cu"], d / "lib.so")
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.tsl_frame_resample.argtypes = build.SIGNATURES["tsl_frame_resample"]
    lib.tsl_frame_resample.restype = ctypes.c_int
    return lib


def shapes():
    """The three shapes: name -> (carry, block, taps, frames)."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.testing import channel_audio

    rng = np.random.default_rng(1)

    def ints(shape):
        return torch.from_numpy(rng.integers(-32768, 32767, size=shape)
                                .astype(np.int16)).cuda()

    res = {}
    for name, (i_, d_, target, align, g) in {
            "pipeline step 25/16": (25, 16, 131_050, False, 6),
            "decoder-torch step 25/16": (25, 16, 1024, True, 1),
            "147/160 capture": (147, 160, 1024, True, 1)}.items():
        plan = polyphase.make_resampler_plan(
            q14.quantize_q14(channel_audio.resampler_taps(i_, d_)), i_, d_,
            block_out_target=target, align_k_row=align)
        taps = k4.frame_taps(plan, device="cuda")
        if name == "147/160 capture":
            frames = 2_880_000 // plan.d_rep
            res[name] = (ints((1, 0)), ints((1, frames * plan.d_rep)), taps,
                         frames)
        else:
            res[name] = (ints((g, plan.carry_len)), ints((g, plan.block_in)),
                         taps, plan.block_out // plan.i_rep)
    return res


def call(lib, carry, block, taps, frames):
    """``lib``'s K4 on the f32 epilogue, launched as the wrapper does."""
    import torch

    from tsl_sdr_tpu_torch.ops import frame_resampler as k4

    g, n = block.shape
    i_rep = taps.w_frames.shape[1]
    s = k4.launch_shape(taps, frames)
    out = torch.empty((g, frames * i_rep), dtype=torch.float32,
                      device=block.device)
    err = lib.tsl_frame_resample(
        carry.data_ptr(), block.data_ptr(), taps.w_hi.data_ptr(),
        taps.w_lo.data_ptr(), taps.w_index.data_ptr(), out.data_ptr(),
        frames, i_rep, taps.d_rep, s.k_pad, s.n_tiles, s.n_live,
        carry.shape[1], n, g, 0, s.tm, s.warps, s.smem,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tsl_frame_resample: CUDA error {err}")
    return out


def device_ms(fn, reps: int = 50) -> float:
    """Mean summed kernel time of fn (torch.profiler), after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError("the profiler recorded no device time")


def ablate(names, pairs: int) -> None:
    import torch

    from tsl_sdr_tpu_torch.ops import frame_resampler as k4

    names = list(dict.fromkeys(["kernel", *(names or ABLATIONS)]))
    with ThreadPoolExecutor() as ex:   # one nvcc a variant, side by side
        libs = dict(zip(names, ex.map(build_variant, names,
                                      [ABLATIONS[n] for n in names])))
    for sname, (carry, block, taps, frames) in shapes().items():
        ref = k4.frame_resample_plain(carry, block, taps, frames=frames)
        for name in (n for n in EXACT if n in libs):
            if not torch.equal(call(libs[name], carry, block, taps, frames),
                               ref):
                raise SystemExit(f"{sname}: {name} differs from plain")
        sd, d = taps.w_frames.shape[0], taps.d_rep
        total = torch.nn.functional.pad(
            torch.cat([carry, block], 1).to(torch.float64),
            (0, (frames - 1) * d + sd))
        a = total.as_strided((block.shape[0], frames, sd),
                             (total.stride(0), d, 1)).contiguous()
        wb = taps.w_frames.to(torch.float64).expand(
            block.shape[0], -1, -1).contiguous()
        fns = {name: (lambda lib=lib: call(lib, carry, block, taps, frames))
               for name, lib in libs.items()}
        fns["f64 torch.bmm"] = lambda: torch.bmm(a, wb)
        times = {name: [] for name in fns}
        for order in [list(fns), list(fns)[::-1]] * pairs:   # in turns
            for name in order:
                times[name].append(device_ms(fns[name]))
        print(f"{sname}: device us " + ", ".join(
            f"{name} {sum(t) / len(t) * 1e3:.2f}" for name, t in
            times.items()), flush=True)


def phases() -> None:
    import numpy as np
    import torch

    lib = build_variant("phases", stamps())
    lib.lab_read.argtypes = [ctypes.c_void_p]
    for sname, (carry, block, taps, frames) in shapes().items():
        buf = np.zeros(64, np.uint64)
        for _ in range(5):   # the last of five launches
            lib.lab_clear()
            call(lib, carry, block, taps, frames)
            torch.cuda.synchronize()
        lib.lab_read(buf.ctypes.data)
        t = buf.reshape(8, 8).astype(np.int64)
        rows = t[t[:, 6] > 0]
        print(f"{sname}: cycles of each phase, per warp of block (0, 0), "
              f"from {PHASES[0]!r} to {PHASES[-1]!r}: " + " | ".join(
                  PHASES[k] for k in range(1, 7)), flush=True)
        for w, r in enumerate(rows):
            if not r[4]:   # a warp without a unit: no k-step stamp
                r[4] = r[3]
            print(f"  warp {w}: {np.diff(r[:7]).tolist()}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="ablate",
                    choices=["ablate", "phases"])
    ap.add_argument("variants", nargs="*", choices=list(ABLATIONS),
                    help="ablate only these (and the kernel)")
    ap.add_argument("--pairs", type=int, default=1,
                    help="forward and backward passes of the timing")
    args = ap.parse_intermixed_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k4_lab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(res.stdout.strip(), flush=True)
    if args.mode == "ablate":
        ablate(args.variants, args.pairs)
    else:
        phases()
    return 0


if __name__ == "__main__":
    sys.exit(main())
