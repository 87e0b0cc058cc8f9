#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port, ``tsl_sdr_tpu_torch``.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``tsl_sdr_tpu_torch/csrc`` and drives
the port's main paths: the receive pipeline at the 8-channel pager
deployment (``tsl_sdr_tpu_torch/testing/pager.py``: 1.2288 Msps, decimate by
32, 577 taps, 6 POCSAG + 2 FLEX channels, 4,177,920-sample blocks), the
decoder front end (``decoder-torch``, ``resampler-torch``) at the
reference's resampler settings, and the pipeline at decimation 50:

1. the card's name and power limit; the kernels' build (nvcc) and the
   decoders' native state machines (g++);
2. K1 (fused channelizer + FM, ``csrc/chain.cu``, int8 tensor cores
   through the exact split of ``csrc/imma_split.cuh``) against its plain
   torch version at the pipeline's block (65,280 rows), a block with a
   ragged last tile, a tile-aligned block, and an adversarial one (input
   all -32768 against taps of +-32767): exactly equal (max |diff| 0); a
   block run as two halves must equal the whole; phase 6 repeats all of
   it at the decimation-50 pipeline's shape (16-row tiles, taps from L2);
3. K3 (packed-row resampler, ``csrc/row_resampler.cu``, the same split)
   against its plain version in both output modes (f32 and q14) at its four
   shapes: the pipeline's [2 channels, 85 rows] FLEX 5/12 block, the
   85-row 192/125 block, and the decoder's 192/125 and 16/25 steps; at two
   plans whose K takes several staging passes (1/17, 5/36); and on the
   adversarial input at the pipeline's, the 192/125 step's and the
   multi-pass shapes: exactly equal;
4. the deployment end to end on a synthetic capture (one burst per
   channel, three full blocks and a ragged tail): cs16 through the
   ``pipeline-torch`` CLI, then the same capture as rtl_u8 wire bytes
   through ``ReceivePipeline.push/flush``; every burst must decode, both
   runs must agree, both kernels must have launched, and every decoder must
   run its native tier;
5. wall time per block, wideband Msps, and K1's and K3's times beside their
   plain versions', their bounds and (K3) one float64 ``torch.bmm`` of the
   same product (CUDA events, after warm-up, in turns);
6. K1 at decimation 50 (as in phase 2); K4 (frame-form resampler,
   ``csrc/frame_resampler.cu``) against its plain version, f32 and q14
   outputs, exactly equal: ``resample_capture`` at 147/160 (5,253 taps)
   over 60 s of 48 kHz PCM, the streaming step at the decimation-50
   pipeline's 25/16 group shape, and ``decoder-torch``'s one-channel 25/16
   step;
7. the exact DC blocker (``csrc/dc_blocker.cu``) against its plain version
   over 1.5 M samples in blocks, state carried: exactly equal;
8. ``decoder-torch`` on 60 s of channel audio with 6 bursts each: FLEX
   ``-I 16 -D 25 -F etc/flex_16_25.json``, POCSAG ``-I 192 -D 125 -F
   etc/pocsag_38400_from_25k.json -b`` (exact DC), and POCSAG from 24,576
   Hz ``-I 25 -D 16`` (frame form); every burst must decode, on the native
   decoder tier;
9. ``resampler-torch -I 147 -D 160``, exact and ``--fast``: the output
   file must equal, byte for byte, the same run with ``--device cpu``;
10. the pipeline at decimation 50 (six 24,576 Hz POCSAG channels, one 25/16
   group): every burst must decode, on the native decoder tier;
11. K4's and the exact DC kernel's times beside their plain versions' and
   their bounds at the shapes of those paths, K4's also beside one float64
   ``torch.bmm`` of the same product.

Each path of phases 4, 8, 9 and 10 runs with the kernels' launch counts
set to 0 just before it and read just after; a kernel of the path that
never launched fails the run. jax, jaxlib and the JAX package
(``tsl_sdr_tpu``) are made unimportable first, and none may have loaded at
the end, so the run also proves that the port needs none of them. A
kernel's bound is the larger of its bytes over HBM's rate and its int16
multiply-adds (four int8 tensor-core products each) over the int8 peak,
from the H100's published peaks. Any failed check raises and the exit
code is non-zero. The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_FULL_BLOCKS = 3
BLOCKED = ("jax", "jaxlib", "tsl_sdr_tpu")
TAIL_SAMPLES = 1_000_000


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def pcm_diff(a, b):
    """|a - b| in PCM LSB with the +-pi phase wrap folded."""
    import numpy as np

    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return np.minimum(d, 32768 - d)


def max_err(got, ref) -> float:
    """max |got - ref| over two tensors of one shape, on the host."""
    return float((got.cpu().double() - ref.cpu().double()).abs().max())


def require_native(where: str, tiers) -> None:
    """Every protocol decoder of a path must run its native C++ state
    machine."""
    tiers = set(tiers)
    log(f"{where}: decoder tier {' '.join(sorted(tiers))}")
    require(tiers == {"native"}, f"{where}: decoder tiers {tiers}")


def cli_tiers(stderr: str) -> set:
    """The tiers a CLI reported on its 'decoder tier ...' line."""
    return {t for line in stderr.splitlines() if "decoder tier " in line
            for t in line.split("decoder tier ", 1)[1].split()}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    return {"chain_fm": k1.chain_fm.launches,
            "row_resample": k3.row_resample.launches,
            "row_resample_q14": k3.row_resample.launches_q14,
            "frame_resample": k4.frame_resample.launches,
            "dc_block_exact": dcb.dc_block_exact.launches}


def zero_launch_counts() -> None:
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    k1.chain_fm.launches = 0
    k3.row_resample.launches = 0
    k3.row_resample.launches_q14 = 0
    k4.frame_resample.launches = 0
    dcb.dc_block_exact.launches = 0


def on_path(name: str, kernels, fn, totals: dict):
    """Run one main path with the launch counts set to 0 just before it;
    fail if one of ``kernels`` never launched in it; add its counts to
    ``totals``. Returns what ``fn`` returns."""
    zero_launch_counts()
    res = fn()
    counts = launch_counts()
    log(f"launches on {name}: {counts}")
    missing = [k for k in kernels if counts[k] == 0]
    require(not missing, f"{name}: {missing} never launched: {counts}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return res


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs: the summed durations
    of the kernels and copies it ran, as CUPTI records them
    (``torch.profiler``), after a warm-up. Unlike :func:`time_ms` it leaves
    out the host's time to enqueue them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / reps / 1e3
        log(f"the profiler recorded no device time (attempt {attempt + 1})")
    raise SmokeFailure("the profiler recorded no device time in 3 attempts")


def in_turns(plain, kernel, reps_plain: int, reps_kernel: int,
             timer=time_ms, plain_timer=None):
    """Plain, kernel, kernel, plain; mean of each version's two runs."""
    plain_timer = plain_timer or timer
    p0 = plain_timer(plain, reps_plain)
    k0 = timer(kernel, reps_kernel)
    k1 = timer(kernel, reps_kernel)
    p1 = plain_timer(plain, reps_plain)
    return (k0 + k1) / 2, (p0 + p1) / 2


def kernel_times(plain, kernel, reps_plain: int, reps_kernel: int,
                 library=None, plain_on_host: bool = False) -> dict:
    """A kernel's device time beside its plain version's (its wall time
    where it runs on the host) and, where there is one, one library call's
    (each in turns with the kernel), and its call time (CUDA events around
    back-to-back calls: the larger of device and host enqueue time)."""
    ms, plain_ms = in_turns(plain, kernel, reps_plain, reps_kernel,
                            device_ms, time_ms if plain_on_host else None)
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": None}
    if library is not None:
        ms2, res["library_ms"] = in_turns(library, kernel, reps_kernel,
                                          reps_kernel, device_ms)
        res["ms"] = (ms + ms2) / 2
    res["call_ms"], res["plain_call_ms"] = in_turns(plain, kernel,
                                                    reps_plain, reps_kernel)
    return res


# the H100 SXM's published peaks (NVIDIA's data sheet, dense): int8 tensor
# cores 1,979 T operations/s (two a multiply-add), float32 outside the
# tensor cores 67 T/s, HBM 3.35 TB/s
INT8_TC_OPS = 1979e12
CUDA_CORE_OPS = 67e12
HBM_BYTES = 3.35e12


def bound(int16_macs: float, nbytes: float, core_ops: float = 0.0):
    """(ms, what sets it): the least time the card could take for work of
    ``int16_macs`` int16 multiply-adds (four int8 tensor-core products each,
    the exact split), ``core_ops`` serial CUDA-core operations, and
    ``nbytes`` of inputs read once and outputs written once."""
    t_ops = 8 * int16_macs / INT8_TC_OPS + core_ops / CUDA_CORE_OPS
    t_bytes = nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def make_capture(pager, block_size: int):
    """Three full blocks plus a ragged tail; bursts staggered so several
    straddle block boundaries."""
    n = N_FULL_BLOCKS * block_size + TAIL_SAMPLES
    starts = [2_000_000 + k * 1_500_000 for k in range(6)]
    starts += [200_000, starts[-1] + 800_000]
    return pager.capture(n, starts, seed=7)


def adversarial_chain_taps(taps):
    """``taps`` with every tap of the plan's [U, 2*HC] matrix set to
    +-32767 (random signs), split for the kernel and stacked for the plain
    version: against input of -32768 it drives every byte product to its
    extreme and the int32 sums through many wraps."""
    import copy

    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import imma_split, packed_fir

    plan = taps.plan
    shape = packed_fir.tap_matrix_i16(plan).shape
    rng = np.random.default_rng(17)
    w = np.where(rng.random(shape) < 0.5, -32767, 32767).astype(np.int16)
    adv = copy.copy(taps)
    hi, lo = imma_split.fragment_planes(w)
    dev = taps.w_hi.device
    adv.w_hi = torch.from_numpy(hi).to(dev)
    adv.w_lo = torch.from_numpy(lo).to(dev)
    stack = np.zeros(((plan.cr_rows + 1) * plan.row, shape[1]), np.float64)
    stack[:plan.win] = w
    adv.w_f64 = torch.from_numpy(
        stack.reshape(plan.cr_rows + 1, plan.row, shape[1])).to(dev)
    return adv


def check_chain(pipe, iq, device, where: str = "pager"):
    """Phase 2: K1 vs its plain version at the pipeline's block, a ragged
    block, a tile-aligned block and an adversarial one: exactly equal.
    ``where`` names the pipeline in the log."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import chain as k1

    taps = pipe.chain.taps
    plan = taps.plan
    c_len = plan.carry_len
    tr = taps.tile_rows
    rows_full = pipe.block_size * 2 // plan.row
    rng = np.random.default_rng(11)
    noise = rng.integers(-9000, 9000, size=(tr * 256 * plan.row,),
                         dtype=np.int64).astype(np.int16)
    head = iq[:c_len].reshape(-1)
    cases = {
        "pipeline block": (taps, iq[: c_len + pipe.block_size].reshape(-1)),
        "ragged block (7 rows short)": (
            taps, iq[: c_len + pipe.block_size - 7 * plan.row // 2]
            .reshape(-1)),
        "tile-aligned block": (taps, np.concatenate([head, noise])),
        "adversarial (-32768 against +-32767 taps)": (
            adversarial_chain_taps(taps),
            np.full(plan.carry_vals + (4 * tr + 5) * plan.row, -32768,
                    np.int16)),
    }
    log(f"K1 shapes ({where}): ROW={plan.row} cr={plan.cr_rows} "
        f"U={plan.win} halfcols={plan.halfcols} tile_rows={tr}; "
        f"{rows_full} rows per "
        f"pipeline block ({rows_full % tr} in its last tile); split taps "
        f"{list(taps.w_hi.shape)} x 2 planes")
    worst = 0
    prev0 = torch.zeros((2, plan.nr_channels), dtype=torch.float32,
                        device=device)
    for name, (tp, vals) in cases.items():
        vals = torch.from_numpy(vals.copy()).to(device)
        carry, block = vals[: plan.carry_vals], vals[plan.carry_vals:]
        got, gprev = k1.chain_fm(tp, carry, prev0, block)
        ref, rprev = k1.chain_fm_plain(tp, carry, prev0, block)
        d = pcm_diff(got.cpu().numpy(), ref.cpu().numpy())
        log(f"K1 vs plain ({where}), {name}: rows={got.shape[0]} "
            f"(last tile {got.shape[0] % tr}) max|diff|={int(d.max())} LSB")
        require(d.max() == 0, f"K1 {where} {name}: max diff {d.max()} LSB")
        require(torch.equal(gprev, rprev),
                f"K1 {where} {name}: FM carry differs")
        worst = max(worst, int(d.max()))
        if tp is not taps:
            continue
        # block-boundary invariance: the same block as two halves
        half = (block.numel() // plan.row // 2) * plan.row
        a, p_a = k1.chain_fm(taps, carry, prev0, block[:half])
        b, p_b = k1.chain_fm(taps, block[half - plan.carry_vals:half]
                             .contiguous(), p_a, block[half:])
        require(torch.equal(torch.cat([a, b]), got)
                and torch.equal(p_b, gprev),
                f"K1 {where} {name}: two halves differ from the whole block")
        log(f"K1 ({where}) {name}: two halves == whole block")
    return worst


def k3_shapes(pipe, device) -> dict:
    """The shapes K3 runs at on the main paths: name -> (plan, taps,
    channels, the path's output mode)."""
    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.utils.config import load_lpf_coeffs

    prog = pipe._program(pipe.block_size)
    (gid, idxs), = pipe._rs_groups.items()
    shapes = {"pipeline 5/12": (prog.plans[gid], prog.rs_taps[gid],
                                len(idxs), "f32")}
    pocsag = q14.quantize_q14(
        load_lpf_coeffs(HERE / "etc" / "pocsag_38400_from_25k.json"))
    flex = q14.quantize_q14(load_lpf_coeffs(HERE / "etc" / "flex_16_25.json"))
    for name, coeffs, i_, d_, target, align in (
            ("192/125 85-row block", pocsag, 192, 125, 85 * 384, False),
            ("192/125 decoder step", pocsag, 192, 125, 1024, True),
            ("16/25 decoder step", flex, 16, 25, 1024, True)):
        plan = polyphase.make_resampler_plan(coeffs, i_, d_,
                                             block_out_target=target,
                                             align_k_row=align)
        shapes[name] = (plan, polyphase.row_taps(plan, device=device), 1,
                        "q14")
    return shapes


def adversarial_row_taps(plan, device):
    """The plan's row taps [w0; w1[:spill]] all set to +-32767 (random
    signs), in both forms (see adversarial_chain_taps)."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import imma_split, row_resampler

    rng = np.random.default_rng(18)
    k = plan.row_in + plan.spill
    w = np.where(rng.random((k, plan.k_row)) < 0.5, -32767,
                 32767).astype(np.int16)
    w1 = np.zeros_like(plan.w_spill_i16)
    w1[:plan.spill] = w[plan.row_in:]
    hi, lo = imma_split.fragment_planes(w)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return row_resampler.RowTaps(dev(w[:plan.row_in]), dev(w1), dev(hi),
                                 dev(lo))


def multipass_k3_shapes(device) -> dict:
    """Packed-row plans whose K (row_in + spill, 2,720 and 4,864) passes
    the 2,048 the kernel stages at a time, so it restages in passes with a
    shorter last one; no path above reaches that loop."""
    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.utils.filter_design import (
        design_rational_resampler_filter)

    shapes = {}
    for name, i_, d_, align in (("1/17 (K past 2,048)", 1, 17, False),
                                ("5/36 (K past 4,096)", 5, 36, True)):
        plan = polyphase.make_resampler_plan(
            q14.quantize_q14(design_rational_resampler_filter(i_, d_, 0.4)),
            i_, d_, align_k_row=align)
        require(plan.row_in + plan.spill > 2048,
                f"K3 {name}: K {plan.row_in + plan.spill} fits one pass")
        shapes[name] = (plan, polyphase.row_taps(plan, device=device), 2,
                        "q14")
    return shapes


def check_k3(pipe, device):
    """Phase 3: K3 vs its plain version, both output modes, at each of its
    shapes (random full-range input), at two plans whose K takes several
    staging passes, and on adversarial input at the pipeline's, the
    decoder's 192/125 and the multi-pass shapes: exactly equal. Returns the
    paths' shapes' arguments (for timing) and the largest error."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    rng = np.random.default_rng(12)
    args = {}
    worst = 0.0
    on_paths = k3_shapes(pipe, device)
    multipass = multipass_k3_shapes(device)
    for name, (plan, taps, g, mode) in {**on_paths, **multipass}.items():
        carry = torch.from_numpy(rng.integers(
            -32768, 32767, size=(g, plan.carry_len)).astype(np.int16)).to(
                device)
        block = torch.from_numpy(rng.integers(
            -32768, 32767, size=(g, plan.block_in)).astype(np.int16)).to(
                device)
        cases = [("random", carry, block, taps)]
        if name in ("pipeline 5/12", "192/125 decoder step") \
                or name in multipass:
            cases.append(("adversarial", torch.full_like(carry, -32768),
                          torch.full_like(block, -32768),
                          adversarial_row_taps(plan, device)))
        for kind, c, b, tp in cases:
            for out in ("f32", "q14"):
                got = k3.row_resample(c, b, tp, row_in=plan.row_in, out=out)
                ref = k3.row_resample_plain(c, b, tp, row_in=plan.row_in,
                                            out=out)
                err = max_err(got, ref)
                log(f"K3 vs plain, {name} ({kind}, {out}): carry "
                    f"{list(c.shape)} block {list(b.shape)} row_in "
                    f"{plan.row_in} + spill {plan.spill} -> K "
                    f"{32 * tp.w_hi.shape[0]}, {list(got.shape)}: "
                    f"max|diff|={err}")
                require(torch.equal(got, ref),
                        f"K3 {name} ({kind}, {out}) differs")
                worst = max(worst, err)
        if name in on_paths:
            args[name] = (carry, block, taps, plan, mode)
    return args, worst


def time_k3(args) -> dict:
    """K3's device time at each shape beside its plain version's and one
    float64 torch.bmm of the same product on operands converted beforehand
    (the library yardstick; the port never calls it), in turns: plain,
    kernel, kernel, plain, then library, kernel, kernel, library."""
    import torch

    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    res = {}
    for name, (carry, block, taps, plan, mode) in args.items():
        g, m, k = carry.shape[0], plan.block_out // plan.k_row, \
            plan.row_in + plan.spill
        total = torch.cat([carry, block], 1).to(torch.float64)
        total = torch.nn.functional.pad(total, (0, plan.row_in + k))
        a = total.as_strided((g, m, k), (total.stride(0), plan.row_in, 1)) \
            .contiguous()
        w = torch.cat([taps.w0, taps.w1[:plan.spill]]).to(torch.float64)
        wb = w.expand(g, k, plan.k_row).contiguous()

        def kernel():
            return k3.row_resample(carry, block, taps, row_in=plan.row_in,
                                   out=mode)

        t = kernel_times(
            lambda: k3.row_resample_plain(carry, block, taps,
                                          row_in=plan.row_in, out=mode),
            kernel, 20, 200, library=lambda: torch.bmm(a, wb))
        out_bytes = g * m * plan.k_row * (4 if mode == "f32" else 2)
        t["bound_ms"], t["bound_by"] = bound(
            g * m * plan.k_row * k,
            nbytes(carry, block, taps.w_hi, taps.w_lo) + out_bytes)
        res[name] = t
        log(f"K3 {name} ({mode}): kernel {t['ms']:.4f} ms (call "
            f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f} ms, f64 "
            f"torch.bmm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} "
            f"ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of it")
    return res


def message_keys(results, specs):
    """Decoded messages as comparable tuples, channel by channel."""
    out = []
    for spec, msgs in zip(specs, results):
        for m in msgs:
            text = m.data.decode() if spec.protocol == "pocsag" else m.text
            out.append((spec.center_freq_hz, m.capcode, text))
    return out


def run_main_path(pager, iq, expected, device, tmp: Path):
    """Phase 4: the deployment end to end, through the CLI and push()."""
    from tsl_sdr_tpu_torch.cli import pipeline as cli
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    specs = pager.channel_specs(ChannelSpec)
    want = sorted((s.center_freq_hz, cap, text)
                  for s, exp in zip(specs, expected) for cap, text in exp)

    cap_path = tmp / "capture.cs16"
    iq.reshape(-1).tofile(cap_path)
    cfg_path = tmp / "pager8.json"
    cfg_path.write_text(json.dumps(pager.config(str(cap_path))))
    out_path = tmp / "messages.jsonl"
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main([str(cfg_path), "--iq-file", str(cap_path),
                       "--iq-format", "cs16", "-o", str(out_path),
                       "--device", device])
    cli_s = time.perf_counter() - t0
    require(rc == 0, f"pipeline-torch exited {rc}: {err.getvalue()}")
    require_native("pipeline-torch", cli_tiers(err.getvalue()))
    lines = [json.loads(x) for x in out_path.read_text().splitlines()]
    got_cli = sorted(
        (m["freqHz"], m["capCode"], m["message"]) for m in lines)
    log(f"cs16 via pipeline-torch: {len(lines)} messages in {cli_s:.3f} s "
        f"(build already done)")
    require(got_cli == want,
            f"CLI decoded {got_cli}, expected {want}")

    pipe = ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                           pager.DECIMATION, specs, wire_fmt="rtl_u8",
                           device=device)
    require_native("ReceivePipeline (rtl_u8 push/flush)", pipe.decoder_tiers)
    warm_s = pipe.warm_device()
    flat = pager.to_rtl_u8(iq).reshape(-1)
    pipe.timing = {}
    step = pipe.block_size * 2 // 3 + 1234   # pushes that split blocks
    results = [[] for _ in specs]
    t0 = time.perf_counter()
    for lo in range(0, flat.size, step):
        for i, part in enumerate(pipe.push(flat[lo:lo + step])):
            results[i].extend(part)
    for i, part in enumerate(pipe.flush()):
        results[i].extend(part)
    _sync(device)
    wall = time.perf_counter() - t0
    got_push = sorted(message_keys(results, specs))
    require(got_push == got_cli,
            f"rtl_u8 push/flush decoded {got_push}, cs16 CLI {got_cli}")
    blocks = pipe.stream_stats["blocks"]
    tier = " ".join(sorted(pipe.decoder_tiers))
    log(f"rtl_u8 via push/flush: {len(got_push)} messages == cs16 run; "
        f"warm_device {warm_s:.3f} s; decoder tier {tier}")
    timing = {k: round(v, 6) for k, v in sorted(pipe.timing.items())}
    return {"blocks": blocks, "wall_s": wall, "samples": iq.shape[0],
            "cli_s": cli_s, "tier": tier, "timing": timing}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def frame_library(carry, block, taps, frames: int):
    """One float64 ``torch.bmm`` computing K4's product (the library
    yardstick; the port never calls it): each frame's window of ``S *
    D_rep`` samples against the dense [S * D_rep, I_rep] frame matrix, both
    converted and laid out beforehand. Returns the call."""
    import torch

    g = block.shape[0]
    sd, d = taps.w_frames.shape[0], taps.d_rep
    total = torch.cat([carry, block], 1).to(torch.float64)
    total = torch.nn.functional.pad(
        total, (0, max(0, (frames - 1) * d + sd - total.shape[1])))
    a = total.as_strided((g, frames, sd), (total.stride(0), d, 1)) \
        .contiguous()
    wb = taps.w_frames.to(torch.float64).expand(g, -1, -1).contiguous()
    return lambda: torch.bmm(a, wb)


def check_frame_resampler(dec50, device):
    """Phase 6: K4 vs its plain version, f32 and q14 outputs: the 147/160
    capture entry over 60 s of 48 kHz PCM, the streaming step at the
    decimation-50 pipeline's (``dec50``) 25/16 group shape, and the
    one-channel 25/16 step ``decoder-torch`` runs."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.models.resampler import ResamplerChain
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.testing import channel_audio

    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(channel_audio.resampler_taps(147, 160)), 147, 160)
    taps = k4.frame_taps(plan, device=device)
    rng = np.random.default_rng(13)
    pcm = torch.from_numpy(rng.integers(-32768, 32767, size=2_880_000)
                           .astype(np.int16)).to(device)
    cap = {"plan": plan, "taps": taps, "pcm": pcm}
    worst = 0.0
    for out in ("f32", "q14"):
        got = k4.resample_capture(plan, pcm, taps, out=out)
        ref = k4.frame_resample_plain(pcm.new_zeros((1, 0)), pcm[None], taps,
                                      frames=pcm.numel() // plan.d_rep,
                                      out=out)[0]
        log(f"K4 vs plain, resample_capture 147/160 ({plan.frame_shifts} "
            f"frames of {plan.d_rep} per window, {taps.cols.shape[1]} taps a "
            f"column) over {pcm.numel()} samples -> {got.numel()} {out}: "
            f"max|diff|={max_err(got, ref)}")
        require(torch.equal(got, ref), f"K4 capture ({out}) differs")
        worst = max(worst, max_err(got, ref))

    prog = dec50._program(dec50.block_size)
    (gid, idxs), = dec50._rs_groups.items()
    splan, staps = prog.plans[gid], prog.rs_taps[gid]
    require(gid == (25, 16) and splan.k_row == 0,
            f"decimation 50 should give one frame-form 25/16 group: {gid}")
    chain = ResamplerChain(channel_audio.resampler_taps(25, 16), 25, 16,
                           device=device)
    require(chain.plan.k_row == 0, "decoder-torch 25/16 should be frame form")
    steps = {}
    for name, plan_, taps_, g in (
            ("pipeline step 25/16", splan, staps, len(idxs)),
            ("decoder-torch step 25/16", chain.plan,
             chain._taps[chain.plan.block_in], 1)):
        carry = torch.from_numpy(rng.integers(
            -32768, 32767, size=(g, plan_.carry_len)).astype(np.int16)).to(
                device)
        block = torch.from_numpy(rng.integers(
            -32768, 32767, size=(g, plan_.block_in)).astype(np.int16)).to(
                device)
        frames = plan_.block_out // plan_.i_rep
        for out in ("f32", "q14"):
            got = k4.frame_resample(carry, block, taps_, frames=frames,
                                    out=out)
            ref = k4.frame_resample_plain(carry, block, taps_, frames=frames,
                                          out=out)
            log(f"K4 vs plain, {name}: carry {list(carry.shape)} block "
                f"{list(block.shape)} -> {list(got.shape)} {out}: "
                f"max|diff|={max_err(got, ref)}")
            require(torch.equal(got, ref), f"K4 {name} ({out}) differs")
            worst = max(worst, max_err(got, ref))
        steps[name] = {"carry": carry, "block": block, "taps": taps_,
                       "frames": frames}
    return cap, steps, worst


def check_dc_exact(device):
    """Phase 8: the exact DC blocker vs plain over 1.5 M samples in
    blocks, state carried."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb

    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.integers(-32768, 32767, size=(1, 1_500_000))
                         .astype(np.int16))
    p = dcb.make_pole_coeff(0.9999)
    st_k = torch.zeros((1, 3), dtype=torch.int32, device=device)
    st_p = torch.zeros((1, 3), dtype=torch.int32)
    bounds = [0, 1152, 250_007, 800_000, 1_500_000]
    worst = 0.0
    t0 = time.perf_counter()
    for lo, hi in zip(bounds, bounds[1:]):
        part = x[:, lo:hi].contiguous()
        got = dcb.dc_block_exact(st_k, part.to(device), p)
        ref = dcb.dc_block_exact_plain(st_p, part, p)
        require(torch.equal(got.cpu(), ref) and torch.equal(st_k.cpu(), st_p),
                f"exact DC blocker differs in samples [{lo}, {hi})")
        worst = max(worst, max_err(got, ref))
    log(f"exact DC blocker vs plain: {x.shape[1]} samples in "
        f"{len(bounds) - 1} blocks, state carried: max|diff|={worst} "
        f"({time.perf_counter() - t0:.2f} s with the plain loop)")
    whole = x.to(device)

    def kernel_whole():
        st = torch.zeros((1, 3), dtype=torch.int32, device=device)
        return dcb.dc_block_exact(st, whole, p)

    whole_ms = time_ms(kernel_whole, 3)
    log(f"exact DC blocker kernel over {x.shape[1]} samples in one launch: "
        f"{whole_ms:.3f} ms")
    return p, worst


def decoder_runs(tmp: Path, device):
    """Phase 9: decoder-torch at the reference's resampler settings on 60 s
    of channel audio each; every burst must decode."""
    from tsl_sdr_tpu_torch.cli import decoder
    from tsl_sdr_tpu_torch.testing import channel_audio

    f25_16 = tmp / "pocsag_25_16.json"
    channel_audio.write_filter(f25_16, 25, 16)
    runs = [
        ("flex 16/25", "flex", 25_000, 0,
         ["-m", "flex", "-I", "16", "-D", "25", "-S", "25000",
          "-F", str(HERE / "etc" / "flex_16_25.json")]),
        ("pocsag 192/125 -b", "pocsag", 25_000, 900,
         ["-m", "pocsag", "-I", "192", "-D", "125", "-S", "25000",
          "-F", str(HERE / "etc" / "pocsag_38400_from_25k.json"), "-b"]),
        ("pocsag 25/16", "pocsag", 24_576, 0,
         ["-m", "pocsag", "-I", "25", "-D", "16", "-S", "24576",
          "-F", str(f25_16)]),
    ]
    walls = {}
    for k, (name, proto, rate, dc, argv) in enumerate(runs):
        pcm, expected = channel_audio.capture(proto, rate, 60.0, 6,
                                              seed=20 + k, dc=dc)
        src = tmp / f"dec{k}.pcm"
        pcm.tofile(src)
        out = tmp / f"dec{k}.json"
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = decoder.main([*argv, "-o", str(out), "-c", "--device",
                               device, str(src)])
        walls[name] = time.perf_counter() - t0
        require(rc == 0, f"decoder-torch {name} exited {rc}: "
                f"{err.getvalue()}")
        require_native(f"decoder-torch {name}", cli_tiers(err.getvalue()))
        got = [(m["capCode"], m["message"].rstrip("\0"))
               for m in map(json.loads, out.read_text().splitlines())]
        log(f"decoder-torch {name}: {len(got)} of {len(expected)} bursts "
            f"from {pcm.size} samples at {rate} Hz in {walls[name]:.3f} s")
        require(sorted(got) == sorted(expected),
                f"decoder-torch {name} decoded {got}, expected {expected}")
    return walls


def resampler_runs(tmp: Path, device):
    """Phase 10: resampler-torch -I 147 -D 160, exact and --fast, on the
    card and with --device cpu: the output files must be byte-equal."""
    import numpy as np

    from tsl_sdr_tpu_torch.cli import resampler
    from tsl_sdr_tpu_torch.testing import channel_audio

    filt = tmp / "r147_160.json"
    channel_audio.write_filter(filt, 147, 160)
    rng = np.random.default_rng(16)
    t = np.arange(960_000) / 48_000
    pcm = (8000 * np.sin(2 * np.pi * 1000 * t)
           + rng.normal(scale=2000, size=t.size)).astype(np.int16)
    src = tmp / "r48k.pcm"
    pcm.tofile(src)
    walls = {}
    for tier in ("exact", "fast"):
        outs = {}
        for dev in (device, "cpu"):
            dst = tmp / f"r_{tier}_{dev}.pcm"
            argv = ["-I", "147", "-D", "160", "-S", "48000", "-F", str(filt),
                    "--device", dev, str(src), str(dst)]
            if tier == "fast":
                argv.insert(0, "--fast")
            t0 = time.perf_counter()
            require(resampler.main(argv) == 0,
                    f"resampler-torch {tier} on {dev} failed")
            walls[f"{tier} {dev}"] = time.perf_counter() - t0
            outs[dev] = dst.read_bytes()
        log(f"resampler-torch 147/160 {tier}: {pcm.size} samples -> "
            f"{len(outs[device]) // 2}; {device} "
            f"{walls[f'{tier} {device}']:.3f} s, cpu "
            f"{walls[f'{tier} cpu']:.3f} s; byte-equal "
            f"{outs[device] == outs['cpu']}")
        require(outs[device] == outs["cpu"],
                f"resampler-torch {tier}: {device} output != cpu output")
    return walls


def dec50_run(device):
    """Phase 11: the pipeline at decimation 50 (six POCSAG channels at
    24,576 Hz, one 25/16 frame-form group); every burst must decode."""
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.testing import pager

    specs = pager.dec50_channel_specs(ChannelSpec)
    pipe = ReceivePipeline(pager.dec50_lpf_taps(), pager.CENTER_HZ, pager.FS,
                           pager.DEC50_DECIMATION, specs, device=device)
    require_native("the decimation-50 pipeline", pipe.decoder_tiers)
    starts = [200_000 + k * 1_300_000 for k in range(len(specs))]
    iq, expected = pager.capture(2 * pipe.block_size + TAIL_SAMPLES, starts,
                                 seed=8)
    pipe.warm_device()
    t0 = time.perf_counter()
    res = pipe.process_capture(iq)
    _sync(device)
    wall = time.perf_counter() - t0
    got = sorted(message_keys(res, specs))
    want = sorted((s.center_freq_hz, cap, text)
                  for s, exp in zip(specs, expected) for cap, text in exp)
    got = [(f, c, t.rstrip("\0")) for f, c, t in got]
    log(f"pipeline at decimation 50: {len(got)} of {len(want)} bursts, "
        f"{iq.shape[0]} samples in {pipe.stream_stats['blocks']} blocks, "
        f"{wall:.3f} s")
    require(got == want, f"decimation 50 decoded {got}, expected {want}")
    return wall


def front_end(device, totals: dict) -> dict:
    """Phases 6-11: K1 at decimation 50 and the decoder front end's
    kernels and paths. Returns the runs' walls, the kernels' summaries and
    K1's largest error at decimation 50."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.testing import pager

    dec50 = ReceivePipeline(pager.dec50_lpf_taps(), pager.CENTER_HZ,
                            pager.FS, pager.DEC50_DECIMATION,
                            pager.dec50_channel_specs(ChannelSpec),
                            device=device)
    # K1 at this pipeline's shape: 3,200-value rows, 16-row tiles, taps
    # read from L2 rather than staged
    plan = dec50.chain.taps.plan
    noise = np.random.default_rng(14).integers(
        -9000, 9000, size=(plan.carry_len + dec50.block_size, 2),
        dtype=np.int64).astype(np.int16)
    k1_err = check_chain(dec50, noise, device, "decimation 50")
    cap, steps, k4_err = check_frame_resampler(dec50, device)
    del dec50, noise
    pole, dc_err = check_dc_exact(device)

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs["decoder_s"] = on_path(
            "decoder-torch", ("row_resample_q14", "frame_resample",
                              "dc_block_exact"),
            lambda: decoder_runs(tmp, device), totals)
        runs["resampler_s"] = on_path(
            "resampler-torch", ("frame_resample",),
            lambda: resampler_runs(tmp, device), totals)
    runs["dec50_s"] = on_path("the decimation-50 pipeline",
                              ("chain_fm", "frame_resample"),
                              lambda: dec50_run(device), totals)

    # times at the paths' shapes (after warm-up), each beside one float64
    # torch.bmm of the same product
    k4_times = {}
    for name, st in steps.items():
        carry, block, taps = st["carry"], st["block"], st["taps"]
        frames = st["frames"]
        t = kernel_times(
            lambda: k4.frame_resample_plain(carry, block, taps,
                                            frames=frames),
            lambda: k4.frame_resample(carry, block, taps, frames=frames),
            10, 50, library=frame_library(carry, block, taps, frames))
        n_out = carry.shape[0] * frames * taps.cols.shape[0]
        t["bound_ms"], t["bound_by"] = bound(
            n_out * taps.cols.shape[1],
            nbytes(carry, block, taps.cols, taps.oj) + 4 * n_out)
        k4_times[name] = t
        log(f"K4 {name}: kernel {t['ms']:.4f} ms (call {t['call_ms']:.4f}), "
            f"plain {t['plain_ms']:.4f} ms, f64 torch.bmm "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of it")
    fr_t = k4_times["pipeline step 25/16"]
    pcm, plan, ctaps = cap["pcm"], cap["plan"], cap["taps"]
    cap_ms, cap_plain_ms = in_turns(
        lambda: k4.frame_resample_plain(pcm.new_zeros((1, 0)), pcm[None],
                                        ctaps, frames=pcm.numel()
                                        // plan.d_rep),
        lambda: k4.resample_capture(plan, pcm, ctaps), 3, 20)
    log(f"K4 resample_capture 147/160 over {pcm.numel()} samples: kernel "
        f"{cap_ms:.3f} ms, plain {cap_plain_ms:.3f} ms")
    x = torch.randint(-32768, 32767, (1, 1152), dtype=torch.int16)
    xd = x.to(device)
    st_k = torch.zeros((1, 3), dtype=torch.int32, device=device)
    st_p = torch.zeros((1, 3), dtype=torch.int32)
    dc_t = kernel_times(
        lambda: dcb.dc_block_exact_plain(st_p, x, pole),
        lambda: dcb.dc_block_exact(st_k, xd, pole), 20, 200,
        plain_on_host=True)
    # six integer operations a sample in a serial chain (dc_blocker.cu)
    dc_t["bound_ms"], dc_t["bound_by"] = bound(
        0, 2 * nbytes(xd) + 2 * nbytes(st_k), core_ops=6 * xd.numel())
    log(f"exact DC, 1,152-sample step: kernel {dc_t['ms']:.4f} ms (call "
        f"{dc_t['call_ms']:.4f}), plain {dc_t['plain_ms']:.4f} ms (host "
        f"loop), bound {dc_t['bound_ms']:.7f} ms ({dc_t['bound_by']})")
    return {
        "runs": runs,
        "k4": k4_times,
        "k1_err": k1_err,
        "kernels": [
            {"name": "frame_resample", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/frame_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_resampler.py:28",
             "max_abs_err": k4_err, **fr_t},
            {"name": "dc_block_exact", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/dc_blocker.cu",
             "replaces": "tsl_sdr_tpu/ops/dc_blocker.py:49",
             "max_abs_err": dc_err, **dc_t},
        ],
    }


def smoke(device: str = "cuda") -> dict:
    """Phases 2-11 on ``device``; returns the kernels' summary."""
    import torch

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.testing import pager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = ReceivePipeline(pager.lpf_taps(), pager.CENTER_HZ, pager.FS,
                           pager.DECIMATION, pager.channel_specs(ChannelSpec),
                           device=device)
    t0 = time.perf_counter()
    iq, expected = make_capture(pager, pipe.block_size)
    log(f"synthetic capture: {iq.shape[0]} samples "
        f"({N_FULL_BLOCKS} x {pipe.block_size} + {TAIL_SAMPLES}), "
        f"{sum(map(len, expected))} bursts, made in "
        f"{time.perf_counter() - t0:.1f} s")

    k1_err = check_chain(pipe, iq, device)
    k3_args, k3_err = check_k3(pipe, device)

    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = on_path("the pager pipeline", ("chain_fm", "row_resample"),
                      lambda: run_main_path(pager, iq, expected, device,
                                            Path(tmp)), totals)

    # phase 5: kernel times at the main paths' shapes
    taps = pipe.chain.taps
    plan = taps.plan
    vals = torch.from_numpy(
        iq[: plan.carry_len + pipe.block_size].reshape(-1).copy()).to(device)
    carry, block = vals[: plan.carry_vals], vals[plan.carry_vals:]
    prev = torch.zeros((2, plan.nr_channels), dtype=torch.float32,
                       device=device)
    k1_t = kernel_times(
        lambda: k1.chain_fm_plain(taps, carry, prev, block),
        lambda: k1.chain_fm(taps, carry, prev, block), 5, 50)
    rows = block.numel() // plan.row
    k1_t["bound_ms"], k1_t["bound_by"] = bound(
        rows * plan.win * 2 * plan.halfcols,
        nbytes(carry, block, taps.w_hi, taps.w_lo, taps.omega_row, prev)
        + 2 * rows * plan.halfcols + nbytes(prev))
    log(f"K1 pipeline block ({rows} rows): kernel {k1_t['ms']:.4f} ms (call "
        f"{k1_t['call_ms']:.4f}), plain {k1_t['plain_ms']:.4f} ms, bound "
        f"{k1_t['bound_ms']:.5f} ms ({k1_t['bound_by']}), "
        f"{k1_t['bound_ms'] / k1_t['ms']:.1%} of it")
    k3_times = time_k3(k3_args)
    # the whole device step of one block (every stage, K1 and K3 included):
    # back-to-back steps, so it is the larger of device time and host
    # enqueue time
    pipe._stream_init(iq[: plan.carry_len])
    prog = pipe._program(pipe.block_size)
    st = pipe._stream["st"]
    run["step_ms"] = time_ms(lambda: prog.dev_step(st, block), 10)
    pipe.stream_reset()
    del iq, vals, carry, block

    front = front_end(device, totals)
    k3_f32 = k3_times["pipeline 5/12"]
    k3_q14 = k3_times["192/125 decoder step"]
    return {
        "run": run,
        "front": front["runs"],
        "k3": k3_times,
        "k4": front["k4"],
        "kernels": [
            {"name": "chain_fm", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/chain.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_chain.py:279",
             "max_abs_err": max(k1_err, front["k1_err"]), **k1_t},
            {"name": "row_resample", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/row_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_resampler.py:119",
             "max_abs_err": k3_err, **k3_f32},
            {"name": "row_resample_q14", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/row_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/polyphase.py:318",
             "max_abs_err": k3_err, **k3_q14},
            *front["kernels"],
        ],
        "launches": totals,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (HERE / "tsl_sdr_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no tsl_sdr_tpu_torch package beside {HERE}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    # the port stands alone: neither jax nor the JAX package may load
    for name in BLOCKED:
        sys.modules[name] = None

    card = card_line()
    log(card)
    from tsl_sdr_tpu_torch.kernels import build

    build.load()
    log(f"kernels built in {build.build_seconds:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for line in build.ptxas_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    from tsl_sdr_tpu_torch.runtime import native

    t0 = time.perf_counter()
    native.load()
    log(f"decoders' native state machines loaded in "
        f"{time.perf_counter() - t0:.1f} s ({native.lib_path().name}, g++ "
        f"{' '.join(native.CXX_FLAGS)})")

    summary = smoke("cuda")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED
                    and sys.modules[m] is not None)
    require(not loaded, f"blocked modules were imported: {loaded}")
    run = summary["run"]
    per_block = run["wall_s"] / run["blocks"]
    log(f"{card} | main path (rtl_u8 push/flush): {run['blocks']} blocks "
        f"in {run['wall_s']:.3f} s = {per_block * 1e3:.1f} ms/block, "
        f"{run['samples'] / run['wall_s'] / 1e6:.1f} Msps wideband; "
        f"cs16 CLI run {run['cli_s']:.3f} s; decoder tier {run['tier']}")
    log(f"{card} | host-blocked seconds by phase: {json.dumps(run['timing'])}")
    log(f"{card} | device step (all stages of one block, back to back): "
        f"{run['step_ms']:.3f} ms per block")
    front = summary["front"]
    log(f"{card} | decoder-torch wall s (60 s of audio each): "
        f"{json.dumps(front['decoder_s'])}")
    log(f"{card} | resampler-torch 147/160 wall s (20 s of 48 kHz): "
        f"{json.dumps(front['resampler_s'])}")
    log(f"{card} | pipeline at decimation 50: {front['dec50_s']:.3f} s")
    for kernel in ("k3", "k4"):
        for name, k in summary[kernel].items():
            log(f"{card} | {kernel.upper()} {name}: {json.dumps(k)}")
    kernels = [dict(k, launches=summary["launches"][k["name"]])
               for k in summary["kernels"]]
    for k in kernels:
        log(f"{card} | {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
            f"({k['bound_by']}), library {k['library_ms']} ms; "
            f"{k['launches']} launches on the paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
