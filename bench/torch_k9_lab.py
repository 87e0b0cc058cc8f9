#!/usr/bin/env python3
"""K9 (``tsl_sdr_tpu_torch/csrc/exact_fm.cu``) on the card: against another
tree's K9 in turns, and patched copies of it at several tiles.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 bench/torch_k9_lab.py turns --parent DIR [--pairs 2]
    python3 bench/torch_k9_lab.py variants

``turns``: DIR holds another checkout of the repository (``git archive
<commit>`` unpacked into a directory that ``.gitignore`` lists, such as
``build/parent``). Each tree's ``exact_fm.cu`` is built alone with the
kernel library's flags; at the exact pager block (130,560 x 8),
``etc/multifm_rtlsdr_8ch.json``'s block (6,552 x 8) and the exact wide
banks' (``chip_smoke.K9_WIDE``: 6,552 x 64, 2,176 x 232), on random sums
(``testing/stage_inputs.k9_inputs``), both must equal the plain version
bit for bit, and each is timed (device ms, ``torch.profiler``, 50
launches) in turns: parent, this, this, parent, ``--pairs`` times. A
tree's entry point takes (k, c_n) or, since the tiles, (k, c_n, tk, cb):
which one is read from its source.

``variants``: copies of this tree's ``exact_fm.cu`` patched as VARIANTS
says (the kernel, both divides fed their zero dividends, no cache hints
on the loads and stores, 128 threads a CTA, and the discriminator cut
out, which leaves the loads, derotation, barriers and stores: its PCM is
wrong and not checked) at the same four shapes on
random sums, at the exact pager block on K5's sums of ``chip_smoke``'s
pager capture (real, quiet channels) and at the 8-channel block on quiet
random sums: the kernel at ``fm.exact_fm_tile``'s tile for 132 SMs,
half and twice it (where it fits) and the largest, each patched copy at
the first; every copy checked bit-equal to the plain version, two
timings each. A patch that no longer applies
stops the run with the text it looked for. Writes
``chiprun_out/k9_lab.json``.

Imports neither jax nor the JAX package. Prints the card first and one
JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"exact pager block": (130_560, 8),
          "multifm_rtlsdr_8ch block": (6_552, 8),
          "64 channels": (6_552, 64), "232 channels": (2_176, 232)}
ZERO_Z = ("const float q = __fdiv_rn(none ? 1.0f : mn, none ? 1.0f : hi);",
          "const float q = __fdiv_rn(mn, hi == 0.0f ? 1.0f : hi);")
ZERO_PHI = ("__ddiv_rn(still ? 1.0 : (double)phi, 3.141592653589793)",
            "__ddiv_rn((double)phi, 3.141592653589793)")
HINTS = [("__ldcs(", "__ldg(")] + [
    (f"__stcs(reinterpret_cast<uint4*>({dst}), {val});",
     f"*reinterpret_cast<uint4*>({dst}) = {val};")
    for dst, val in (("ch + g", "c0"), ("ch + g + 4", "c1"))] + [
    ("__stcs(reinterpret_cast<uint4*>(pcm + g),\n"
     "             make_uint4(w[0], w[1], w[2], w[3]));",
     "*reinterpret_cast<uint4*>(pcm + g) =\n"
     "          make_uint4(w[0], w[1], w[2], w[3]);")]
THREADS = ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")
NO_DISC = ("pcm_s[cc * pitch + r] = discriminate(lo16(cur), hi16(cur), pr, pi, "
           "table);", "pcm_s[cc * pitch + r] = (int16_t)(cur ^ pr ^ pi);")
VARIANTS = {"kernel": [], "divides see zeros": [ZERO_Z, ZERO_PHI],
            "no cache hints": HINTS, "128 threads": [THREADS],
            "no discriminator": [NO_DISC]}
INEXACT = ("no discriminator",)   # cut work out: PCM wrong, not checked


def bind(text: str, tag: str):
    """Build one exact_fm.cu's ``text`` alone with the kernel library's
    flags and bind its entry point; the second value tells whether it
    takes the tile arguments."""
    from tsl_sdr_tpu_torch.kernels import build

    src = build.BUILD_DIR / f"k9_{tag}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    lib_path = build.BUILD_DIR / f"k9_{tag}.so"
    build.compile_shared([src], lib_path)
    fn = ctypes.CDLL(str(lib_path)).tsl_exact_fm
    tiles = "int tk" in text
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 8 + [ll, i] + ([i, i] if tiles else []) + [p]
    fn.restype = ctypes.c_int
    return fn, tiles


def patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"torch_k9_lab: a patch no longer applies; "
                             f"exact_fm.cu has no\n{old}")
        text = text.replace(old, new)
    return text


def caller(fn, tiles, ins, want, tk=None, cb=None, check=True):
    """A call of one built K9 on ``ins`` into fresh outputs, after
    checking it bit-equal to ``want`` (unless not ``check``)."""
    import torch

    from tsl_sdr_tpu_torch.ops import atan2

    dev = ins[0].device
    # contiguous, as the wrapper makes them (the plain PCM is a view)
    outs = [torch.empty(w.shape, dtype=w.dtype, device=dev) for w in want]
    k, c = ins[0].shape
    argv = ([t.data_ptr() for t in ins] + [atan2._table(dev).data_ptr()]
            + [t.data_ptr() for t in outs]
            + [k, c, *((tk, cb) if tiles else ()), 0])

    def call():
        err = fn(*argv)
        if err:
            raise RuntimeError(f"tsl_exact_fm returned {err}")

    call()
    torch.cuda.synchronize()
    differ = [int((o != w).sum()) for o, w in zip(outs, want)]
    if check and any(differ):
        raise SystemExit(f"K9 differs from the plain version: pcm, ch, "
                         f"last values {differ}")
    return call


def timed(cs, call) -> float:
    """``chip_smoke.device_ms`` of 50 calls, asked twice more if the
    profiler recorded nothing (it has, once in some hundred windows)."""
    for _ in range(2):
        try:
            return cs.device_ms(call, 50)
        except cs.SmokeFailure:
            pass
    return cs.device_ms(call, 50)


def random_inputs(k, c, seed=None):
    import torch

    from tsl_sdr_tpu_torch.testing.stage_inputs import k9_inputs

    return tuple(torch.from_numpy(a).cuda()
                 for a in k9_inputs("random", k, c, seed=c if seed is None
                                    else seed))


def turns(args, cs) -> dict:
    from tsl_sdr_tpu_torch.kernels import build
    from tsl_sdr_tpu_torch.ops import fm

    src = Path("tsl_sdr_tpu_torch") / "csrc" / "exact_fm.cu"
    kernels = {"parent": bind((args.parent.resolve() / src).read_text(),
                              "parent"),
               "this": bind((ROOT / src).read_text(), "this")}
    res = {}
    for name, (k, c) in SHAPES.items():
        ins = random_inputs(k, c)
        want = fm.exact_fm_plain(*ins)
        tk, cb = fm.exact_fm_tile(k, c, build.sm_count(0))
        calls = {tag: caller(fn, tiles, ins, want, tk, cb)
                 for tag, (fn, tiles) in kernels.items()}
        runs = {"parent": [], "this": []}
        for _ in range(args.pairs):
            for tag in ("parent", "this", "this", "parent"):
                runs[tag].append(cs.device_ms(calls[tag], 50))
        res[name] = {"shape": [k, c], "tile": [tk, cb], **runs}
        print(f"K9 {name} ({k} x {c}) device ms, in turns: parent "
              f"{runs['parent']}, this {runs['this']}", flush=True)
    return res


def pager_sums(cs):
    """K5's Q.14 sums of chip_smoke's pager capture's first block, the
    host rotator and a zero carry: the exact pager block as the exact
    pipeline gives it to K9."""
    import torch

    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.ops import exact_fir as k5
    from tsl_sdr_tpu_torch.runtime.native import rotator_seq
    from tsl_sdr_tpu_torch.testing import pager

    chain = MultifmChain(pager.lpf_taps(), list(pager.OFFSETS_HZ), pager.FS,
                         pager.DECIMATION, exact=True, device="cuda")
    block = 4_177_920
    iq, _ = cs.make_capture(pager, block)
    plan = chain.packed_plan
    v = torch.from_numpy(iq[:plan.carry_len + block].reshape(-1).copy()
                         ).cuda()
    a_re, a_im = k5.exact_fir(chain.taps, v[:plan.carry_vals],
                              v[plan.carry_vals:], "q14")
    c = chain.nr_channels
    k = a_re.numel() // c
    seq = torch.from_numpy(rotator_seq(chain.init_exact_packed_state().rot,
                                       plan.rot_incr_i32, k)).cuda()
    return (a_re.reshape(k, c), a_im.reshape(k, c), seq,
            torch.zeros((c, 2), dtype=torch.int32, device="cuda"))


def variants(args, cs) -> dict:
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import fm
    from tsl_sdr_tpu_torch.testing.stage_inputs import k9_inputs

    text = (ROOT / "tsl_sdr_tpu_torch" / "csrc" / "exact_fm.cu").read_text()
    built = {name: bind(patched(text, p), f"variant{i}")
             for i, (name, p) in enumerate(VARIANTS.items())}
    inputs = {f"{name}, random": random_inputs(*shape)
              for name, shape in SHAPES.items()}
    inputs["exact pager block, K5's sums of the pager capture"] = \
        pager_sums(cs)
    q = k9_inputs("random", 6_552, 8, seed=3)
    quiet = (q[0] % 9 - 4, q[1] % 9 - 4,
             np.broadcast_to(np.array([16384, 0], np.int16), q[2].shape),
             q[3] % 5)
    inputs["multifm_rtlsdr_8ch block, quiet random sums"] = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in quiet)
    res = {}
    for iname, ins in inputs.items():
        k, c = ins[0].shape
        want = fm.exact_fm_plain(*ins)
        tk, cb = fm.exact_fm_tile(k, c, 132)
        most = fm.exact_fm_tile(k, c, 1)[0]
        tks = sorted({max(8, tk // 2 // 8 * 8), tk,
                      min(most, 2 * tk), most})
        for vname, (fn, tiles) in built.items():
            for t in (tks if vname == "kernel" else [tk]):
                call = caller(fn, tiles, ins, want, t, cb,
                              check=vname not in INEXACT)
                ms = [timed(cs, call) for _ in range(2)]
                res[f"{iname} | {vname} | tk {t} cb {cb}"] = ms
                print(f"K9 {iname} ({k} x {c}), {vname}, tile {t} x {cb}: "
                      f"device ms {ms}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k9_lab.json").write_text(json.dumps(res))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("turns")
    t.add_argument("--parent", type=Path, required=True)
    t.add_argument("--pairs", type=int, default=2)
    sub.add_parser("variants")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    for name in ("jax", "jaxlib", "tsl_sdr_tpu"):
        sys.modules[name] = None
    import torch

    if not torch.cuda.is_available():
        print("torch_k9_lab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    res = (turns if args.mode == "turns" else variants)(args, cs)
    print(json.dumps({"card": card, args.mode: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
