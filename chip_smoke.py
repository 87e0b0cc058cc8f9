#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port, ``tsl_sdr_tpu_torch``.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``tsl_sdr_tpu_torch/csrc`` and drives
the port's main paths: the receive pipeline at the 8-channel pager
deployment (``tsl_sdr_tpu_torch/testing/pager.py``: 1.2288 Msps, decimate by
32, 577 taps, 6 POCSAG + 2 FLEX channels, 4,177,920-sample blocks), the
decoder front end (``decoder-torch``, ``resampler-torch``) at the
reference's resampler settings, the pipeline at decimation 50, the
bit-exact tier, ``multifm-torch`` at ``etc/multifm_rtlsdr_8ch.json``,
wide channel banks (BENCH_SUITE's 64 and 256 channels, the Airspy band's
232), and the Costas coherent chain (BENCH_SUITE's costas_chain_device
row):

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
   ``csrc/frame_resampler.cu``, the same split over the dense frame
   matrix) against its plain version, f32 and q14 outputs, exactly equal:
   ``resample_capture`` at 147/160 (5,253 taps) over 60 s of 48 kHz PCM,
   the streaming step at the decimation-50 pipeline's 25/16 group shape,
   ``decoder-torch``'s one-channel 25/16 step, and adversarial input (all
   -32768 against a frame matrix of +-32767, rows off the 16-byte grid) at
   the 147/160 capture and a 64/1 stream; the compiled SASS of every K4
   instantiation must hold IMMA;
7. the exact DC blocker (``csrc/dc_blocker.cu``) against its plain version
   over 1.5 M samples in blocks, state carried, and at 1, 6 and 33 streams
   on random and full-scale alternating input from states whose acc wraps
   and whose y_prev is not acc >> 14, at poles 0.9999 and 0.5, across
   staged chunks and rows off the 16-byte grid: exactly equal, output and
   state;
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
   their bounds at the shapes of those paths and at the 147/160 capture,
   K4's also beside one float64 ``torch.bmm`` of the same product. The DC
   kernel's bound is a latency: the step's samples times one turn of its
   dependent chain, measured on the card (``bench/dc_chain_probe.cu``,
   built beside the kernel library: cycles and nanoseconds of the chain on
   registers alone), with the chain's instructions read from the probe's
   SASS and the SM clock from nvidia-smi;
12. live streaming through ``pipeline-torch --follow`` at the pager
   deployment's full block on phase 4's capture: (a) a FIFO fed in 1 MiB
   writes with the drain worker on and (b) off (``--no-drain-async``), in
   turns, with walls and host-blocked phases; (c) kill and resume through
   ``--state-file`` on a regular file cut where no burst is on air (the
   rest appended with a block of silence, which makes the capture's tail
   the block phase 4's flush padded), the checkpoint's size and its save
   and restore times; (d) the port's mock RTL-SDR library (built with
   gcc) delivering the capture's rtl_u8 bytes; (e) ``--realtime`` on the
   capture file, each message's delay from the delivery of its burst's
   last sample, under (inflight_depth + 2) blocks. Every run must decode
   phase 4's messages on native decoders;
13. K5 (the bit-exact tier's packed FIR, ``csrc/bank.cu``: a persistent
   grid with resident taps, K5's own tiles) against its plain version,
   both epilogues (Q.14 planes, raw int32 sums), at the pager block and at
   ``multifm_rtlsdr_8ch``'s 262,144-sample block, each also with a ragged
   last tile, on adversarial input, and as two halves against the whole:
   exactly equal; its times beside its plain version's, one float64
   ``torch.matmul`` of the same product and its bound; the host rotator's
   cost a pager block (native sequence, upload);
14. the bit-exact pipeline on phase 4's capture (with a ``pcm`` channel):
   cs16 through ``pipeline-torch --exact`` and rtl_u8 through
   ``ReceivePipeline(exact=True).push/flush``, then the same at decimation
   50; every burst must decode, and the pcm channel must equal, bit for
   bit, the same run with every kernel swapped for its plain version;
15. a POCSAG + FLEX + AIS capture through ``pipeline-torch``, production
   and ``--exact``: all three bursts, the AIS one included, must decode;
16. ``multifm-torch`` on ``etc/multifm_rtlsdr_8ch.json`` fed a synthetic
   rtl_u8 capture with one POCSAG burst per channel: both tiers under both
   I/O runtimes, and the production tier through the mock RTL-SDR; each
   channel's PCM must decode its burst, and each tier's PCM must equal the
   plain-version run byte for byte; walls and Msps per run;
17. wide channel banks: (a) K1 and K5 at BENCH_SUITE's channelizer block
   (16,711,680 samples at 1 Msps, decimation 40, 128 taps) at 64 and 256
   channels (K1 on its bank body in sub-blocks of 16 channels, K5 in
   sub-blocks of 32 tap tiles), with the chain's grouped operands (each
   tap tile's non-zero k-steps only) and with full-window ones
   (``grouped=False``): both kernels, both K5 epilogues, against their
   plain versions on the block, a ragged block, adversarial input and two
   halves, exactly equal; device times of each form in turns,
   beside the plain version, the bound and, for K5's raw sums, one float64
   ``torch.matmul`` of the same product; (b) ``multifm-torch`` at
   ``etc/multifm_airspy.json``'s rate, decimation and taps widened to 232
   channels (12.5 kHz apart within +-1.45 MHz) on a 3 s cs16 capture with
   a POCSAG burst on 8 of them: both tiers, grouped launches counted,
   every burst decoded, each tier's PCM equal to the plain-version run
   byte for byte on all 232 channels; (c) the same at BENCH_SUITE's
   channelizer settings (1 Msps, decimation 40, 128 taps) on 64 channels
   12.5 kHz apart (a 2 s capture, 7 bursts), where K1 runs its bank body:
   the production run must launch it (``chain_fm.bank_launches``);
18. the Costas coherent chain (``CostasChannelizer``: K5's raw sums, the
   integer NCO, K6 ``csrc/costas.cu``) at BENCH_SUITE's costas_chain_device
   settings (8 channels, 1 Msps, decimation 8, 64 taps, 2,000,000-sample
   blocks, chunk 22): (a) K6 against its plain version on the chain's own
   planes (250,000 x 8), at chunks 32 and 512 on 1 and 33 channels, on
   adversarial planes and as two halves against the whole, exactly equal,
   outputs and state; (b) the chain over 4 blocks, state carried, equal to
   the run with every kernel swapped for its plain version; (c) an 8-channel
   BPSK capture locks on every channel through ``step`` and through
   ``process_array_native`` (the serial loop in C); (d) K6's device time in
   turns with its plain version beside its latency bound (its chunks times
   one turn of its chain, ``bench/costas_chain_probe.cu``), the chain's
   wall a block (8 trials) and the native path's Msps;
19. the mesh and multi-process paths (``tsl_sdr_tpu_torch/parallel``) on
   meshes whose every entry is cuda:0 (the one card standing in for
   several; no scaling figure comes from it): (a) the sharded channelizer
   at the pager's plan and block on (1, 1), (2, 2), (4, 1) and (1, 8) and
   at BENCH_SUITE's 64-channel bank on (2, 2), each equal to one K1 launch
   over the whole capture, K1 launched once a (time span, channel shard);
   (b) the sharded resampler at 16/25 over 4 shards on a packed-row (K3)
   and a residue (K4) length, equal to the single-device run; (c)
   ``ReceivePipeline(mesh=)`` at the pager deployment on phase 4's
   capture (rtl_u8 push/flush) on the same four meshes: phase 4's
   messages, the ``fetched`` counters of the run without a mesh, K1
   launched blocks x spans x shards times; with the FLEX channels as
   ``pcm`` (one DC-blocked) on (2, 2) and (4, 1), PCM equal to the run
   without a mesh; the decimation-50 band on (2, 1); (d) ``pipeline-torch
   --time-shards 2`` exits 2 with the device-count message; (e)
   ``pipeline-torch --distributed`` as two processes on cuda:0 (gloo):
   rank 0 writes phase 4's messages, rank 1 nothing, each rank's upload
   and halo bytes a block; (f) the pager pipeline's wall a block without a
   mesh, on (1, 1) and on (2, 2), in turns, 6 trials each: the sharding's
   overhead on one card.

Each path of phases 4, 8, 9, 10, 14, 15, 16, 17, 18 and 19 and each run
of phase 12 runs with the
kernels' launch counts set to 0 just before it and read just after; a
kernel of the path that never launched fails the run. jax, jaxlib and
the JAX package (``tsl_sdr_tpu``) are made unimportable first, and none
may have loaded at the end, so the run also proves that the port needs
none of them. A
kernel's bound is the larger of its bytes over HBM's rate and its int16
multiply-adds (four int8 tensor-core products each) over the int8 peak,
from the H100's published peaks; the DC kernel's and K6's are their
chains' latency.
Any failed check raises and the exit code is non-zero. The last two lines
are the kernels' JSON summary and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
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


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now, in MHz."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0])


def sass_by_kernel(lib_path=None) -> dict:
    """A built library's SASS (``cuobjdump -sass``; by default the kernel
    library's): kernel name -> its instructions."""
    from tsl_sdr_tpu_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass",
                          str(lib_path or build.BUILD_DIR / build.LIB_NAME)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    funcs, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            funcs[cur].append(line.split("/*")[1].split("*/", 1)[1]
                              .strip().rstrip(" ;"))
    return funcs


def mnemonics(instrs) -> dict:
    """How often each opcode (predicate and modifiers dropped) occurs."""
    ops = {}
    for ins in instrs:
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        ops[op] = ops.get(op, 0) + 1
    return ops


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
    from tsl_sdr_tpu_torch.ops import costas as k6
    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import exact_fir as k5
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    return {"chain_fm": k1.chain_fm.launches,
            "chain_fm_grouped": k1.chain_fm.grouped_launches,
            "chain_fm_bank": k1.chain_fm.bank_launches,
            "exact_fir": k5.exact_fir.launches,
            "exact_fir_grouped": k5.exact_fir.grouped_launches,
            "row_resample": k3.row_resample.launches,
            "row_resample_q14": k3.row_resample.launches_q14,
            "frame_resample": k4.frame_resample.launches,
            "dc_block_exact": dcb.dc_block_exact.launches,
            "costas_chunks": k6.costas_block_planes.launches}


def zero_launch_counts() -> None:
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import costas as k6
    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import exact_fir as k5
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    k1.chain_fm.launches = 0
    k1.chain_fm.grouped_launches = 0
    k1.chain_fm.bank_launches = 0
    k5.exact_fir.launches = 0
    k5.exact_fir.grouped_launches = 0
    k3.row_resample.launches = 0
    k3.row_resample.launches_q14 = 0
    k4.frame_resample.launches = 0
    dcb.dc_block_exact.launches = 0
    k6.costas_block_planes.launches = 0


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
    out the host's time to enqueue them. Each run launches the same work,
    so a kernel recorded ``n`` times ran ``round(n / reps)`` times a run;
    the profiler now and then drops a record of a window (49 of 50, 15 of
    20 seen), so each kernel counts at its mean duration times that many
    (its total over ``reps`` where ``n`` is a multiple of ``reps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        timed = [e for e in prof.key_averages() if e.self_device_time_total]
        if timed:
            return sum(e.self_device_time_total / e.count
                       * max(1, round(e.count / reps)) for e in timed) / 1e3
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


def fir_macs(plan, rows: int) -> int:
    """The int16 multiply-adds that K1's and K5's product needs for
    ``rows`` packed rows: each of a row's 2*halfcols columns sums its
    2*nr_taps non-zero taps (re and im value of each tap). The rest of
    the plan's ``win``-value window is zeros of its layout (the shift of
    a row's later outputs), which the kernels multiply but need not."""
    return rows * 2 * plan.halfcols * 2 * plan.nr_taps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# wideband sample where each channel's burst starts: channels 1 and 7 are
# on air across the first and the third block boundary; the second one
# (8,356,416 at the pager's block and carry) is clear, so phase 12 can
# restart the decoders there
BURST_STARTS = (2_000_000, 3_500_000, 5_000_000, 6_500_000, 8_500_000,
                9_500_000, 200_000, 10_300_000)


def make_capture(pager, block_size: int):
    """Three full blocks plus a ragged tail; bursts staggered so that two
    straddle block boundaries."""
    n = N_FULL_BLOCKS * block_size + TAIL_SAMPLES
    return pager.capture(n, BURST_STARTS, seed=7)


def adversarial_chain_taps(taps):
    """``taps`` (a ChainTaps) rebuilt with every tap its layout may hold
    set to +-32767 (random signs), in the same form: against input of
    -32768 it drives every byte product to its extreme and the int32 sums
    through many wraps. Chunked taps get the whole [U, 2*HC] matrix;
    grouped ones keep the layout's zeros, which the grouped form leaves
    out."""
    import numpy as np

    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import packed_fir

    plan = taps.plan
    support = packed_fir.tap_support(plan)
    rng = np.random.default_rng(17)
    w = np.where(rng.random(support.shape) < 0.5, -32767, 32767)
    if taps.grouped:
        w = np.where(support, w, 0)
    return k1.ChainTaps(packed_fir.with_taps_i16(plan, w.astype(np.int16)),
                        taps.omega_c.cpu().numpy(), device=taps.w_hi.device,
                        grouped=taps.grouped)


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


class StampedLines(io.TextIOBase):
    """A text stream that keeps every line written to it with the
    ``perf_counter`` time at which the line was completed."""

    def __init__(self):
        super().__init__()
        self.lines = []
        self._part = ""

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        t = time.perf_counter()
        *done, self._part = (self._part + text).split("\n")
        self.lines.extend((t, line) for line in done)
        return len(text)

    def text(self) -> str:
        return "\n".join(line for _, line in self.lines) + self._part

    def first(self, token: str) -> float:
        return next(t for t, line in self.lines if token in line)


@contextlib.contextmanager
def timed_pipelines():
    """Every ReceivePipeline made inside gets ``timing = {}``, emptied
    again after its warm-up block; yields the list of them."""
    from tsl_sdr_tpu_torch.models import pipeline as mp

    made = []
    base = mp.ReceivePipeline

    class Timed(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.timing = {}
            made.append(self)

        def warm_device(self):
            spent = super().warm_device()
            self.timing = {}
            return spent

    mp.ReceivePipeline = Timed
    try:
        yield made
    finally:
        mp.ReceivePipeline = base


def follow_cli(argv, device) -> dict:
    """``pipeline-torch --follow`` in this process, its JSON lines on a
    stamped stdout: the messages (freqHz, capCode, message) with the time
    each line appeared, the stderr, the pipeline (its timing and stream
    stats) and the wall from its 'following' line to its return."""
    from tsl_sdr_tpu_torch.cli import pipeline as cli

    out, err = StampedLines(), StampedLines()
    with timed_pipelines() as made, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main([*map(str, argv), "--follow", "--device", device])
    t_end = time.perf_counter()
    require(rc == 0, f"pipeline-torch --follow exited {rc}: {err.text()}")
    require_native("pipeline-torch --follow", cli_tiers(err.text()))
    msgs = [(t, json.loads(line)) for t, line in out.lines]
    return {"msgs": [(t, (m["freqHz"], m["capCode"], m["message"]))
                     for t, m in msgs],
            "err": err, "pipe": made[0],
            "wall_s": t_end - err.first("following")}


def live_runs(pager, iq, expected, device, tmp: Path, totals: dict,
              block_size: int, carry_len: int) -> dict:
    """Phase 12: ``pipeline-torch --follow`` at the pager deployment's full
    block on phase 4's capture, each run with the launch counts set to 0
    before it: (a) a FIFO fed in 1 MiB writes, drain worker on, and (b)
    the same with --no-drain-async, in turns (a, b, b, a); (c) kill and
    resume through --state-file on a regular file cut where no burst is on
    air, the decoders restarting at a block boundary no burst crosses, the
    rest appended with a block of silence; (d)
    the mock RTL-SDR delivering the capture's rtl_u8 bytes; (e) --realtime
    on the capture file, with each message's delay from the delivery of
    its burst's last sample. Every run must decode phase 4's messages."""
    import os
    import threading

    import numpy as np

    from tsl_sdr_tpu_torch.testing import mock_radios

    want = sorted((s_off + pager.CENTER_HZ, cap, text)
                  for s_off, exp in zip(pager.OFFSETS_HZ, expected)
                  for cap, text in exp)
    n = iq.shape[0]
    cap_path = tmp / "live.cs16"
    iq.tofile(cap_path)
    raw = iq.tobytes()
    kernels = ("chain_fm", "row_resample")
    res = {"fifo": []}

    def keys(run):
        return sorted(k for _, k in run["msgs"])

    def fifo_run(k: int, flags):
        fifo = tmp / f"live{k}.fifo"
        os.mkfifo(fifo)
        cfg = tmp / f"live{k}.json"
        cfg.write_text(json.dumps(pager.config(str(fifo))))

        def writer():
            with open(fifo, "wb") as f:
                for o in range(0, len(raw), 1 << 20):
                    f.write(raw[o:o + (1 << 20)])

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        run = follow_cli([cfg, *flags], device)
        t.join(timeout=60)
        require(not t.is_alive(), "the FIFO writer did not finish")
        require(keys(run) == want, f"--follow {flags} on a FIFO decoded "
                f"{keys(run)}, expected {want}")
        pipe = run["pipe"]
        st = pipe.stream_stats
        return {"drain": "sync" if flags else "async",
                "wall_s": run["wall_s"], "blocks": st["blocks"],
                "ms_per_block": run["wall_s"] / st["blocks"] * 1e3,
                "msps": n / run["wall_s"] / 1e6,
                "fetched": st["fetched"].tolist(),
                "timing": {k: round(v, 6) for k, v in
                           sorted(pipe.timing.items())}}

    for k, flags in enumerate([[], ["--no-drain-async"],
                               ["--no-drain-async"], []]):
        name = f"live (a/b) FIFO {'sync' if flags else 'async'} drain"
        r = on_path(name, kernels, lambda: fifo_run(k, flags), totals)
        res["fifo"].append(r)
        log(f"{name}: {r['blocks']} blocks in {r['wall_s']:.3f} s = "
            f"{r['ms_per_block']:.1f} ms/block, {r['msps']:.1f} Msps; "
            f"fetched {r['fetched']}; host-blocked s {r['timing']}")

    # (c): the decoders restart at the last whole block before the cut
    # (the partial block rides in the checkpoint): find a boundary no
    # burst crosses, cut midway to the next burst
    spans = pager.burst_spans(BURST_STARTS)
    bounds = [carry_len + j * block_size for j in range(1, N_FULL_BLOCKS + 1)]
    clear = [b for b in bounds if not any(lo <= b < hi for lo, hi in spans)]
    require(bool(clear), f"every block boundary {bounds} has a burst on air")
    b = clear[0]
    cut = (b + min([lo for lo, _ in spans if lo > b] + [n])) // 2
    require(not any(lo <= cut < hi for lo, hi in spans), "cut on air")
    path, state = tmp / "resume.cs16", tmp / "resume.npz"
    iq[:cut].tofile(path)
    cfg = tmp / "resume.json"
    cfg.write_text(json.dumps(pager.config(str(path))))
    legs = []

    def resume_leg():
        run = follow_cli([cfg, "--idle-exit", "0.3", "--state-file", state],
                         device)
        text = run["err"].text()
        saved = re.search(r"state saved to \S+ in ([0-9.]+)s", text)
        restored = re.search(r"resumed from .* in ([0-9.]+)s", text)
        require(saved is not None, f"no checkpoint written: {text}")
        return {"msgs": keys(run), "save_s": float(saved.group(1)),
                "restore_s": float(restored.group(1)) if restored else None,
                "bytes": state.stat().st_size}

    legs.append(on_path("live (c) kill, leg 1", kernels, resume_leg, totals))
    # the rest, and a block of silence: leg 2 saves its partial block too,
    # so the capture's tail must fill a whole block to be decoded; with the
    # zeros it is the very block phase 4's flush padded
    with open(path, "ab") as f:
        iq[cut:].tofile(f)
        np.zeros((block_size, 2), np.int16).tofile(f)
    legs.append(on_path("live (c) resume, leg 2", kernels, resume_leg,
                        totals))
    got = sorted(legs[0]["msgs"] + legs[1]["msgs"])
    require(got == want, f"kill and resume decoded {got}, expected {want}")
    res["resume"] = {"cut": cut, "boundary": b, "legs": legs}
    log(f"live (c) kill at sample {cut} (decoders restart at {b}): leg 1 "
        f"{len(legs[0]['msgs'])} messages, checkpoint {legs[0]['bytes']} B "
        f"saved in {legs[0]['save_s']:.3f} s; leg 2 {len(legs[1]['msgs'])} "
        f"messages, restored in {legs[1]['restore_s']:.3f} s; together "
        f"== phase 4's")

    # (d): the mock RTL-SDR library delivers the rtl_u8 wire bytes
    wire = tmp / "wire.u8"
    pager.to_rtl_u8(iq).tofile(wire)
    cfg = tmp / "rtl.json"
    conf = pager.config(str(wire))
    conf["device"] = {"type": "rtlsdr", "deviceIndex": 0}
    cfg.write_text(json.dumps(conf))
    env = {mock_radios.ENV_VARS["rtlsdr"]: str(mock_radios.build("rtlsdr")),
           "MOCK_RTLSDR_DATA": str(wire)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        run = on_path("live (d) mock RTL-SDR", kernels,
                      lambda: follow_cli([cfg], device), totals)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(keys(run) == want, f"the mock RTL-SDR run decoded {keys(run)}, "
            f"expected {want}")
    res["rtl"] = {"wall_s": run["wall_s"],
                  "blocks": run["pipe"].stream_stats["blocks"]}
    log(f"live (d) mock RTL-SDR: {len(keys(run))} messages == phase 4's "
        f"rtl_u8 run, {res['rtl']['blocks']} blocks in "
        f"{run['wall_s']:.3f} s")

    # (e): --realtime paces the file at 1.2288 Msps in 1 MiB reads; a
    # sample is delivered with the read that holds it
    cfg = tmp / "realtime.json"
    cfg.write_text(json.dumps(pager.config(str(cap_path))))
    run = on_path("live (e) --realtime", kernels,
                  lambda: follow_cli([cfg, "--realtime", "--idle-exit",
                                      "0.5"], device), totals)
    require(keys(run) == want, f"--realtime decoded {keys(run)}")
    t0 = run["err"].first("following")
    chunk = (1 << 20) // 4
    depth = run["pipe"].inflight_depth
    limit = (depth + 2) * block_size / pager.FS
    delays = {}
    for t, (freq, capcode, _) in run["msgs"]:
        ch = pager.OFFSETS_HZ.index(freq - pager.CENTER_HZ)
        end = spans[ch][1]
        delivered = min(n, -(-end // chunk) * chunk)
        delays[ch] = t - (t0 + delivered / pager.FS)
    require(max(delays.values()) < limit,
            f"live latency {delays} over {(depth + 2)} blocks ({limit:.2f} s)")
    res["latency"] = {"delays_s": [round(delays[c], 4)
                                   for c in sorted(delays)],
                      "max_s": max(delays.values()), "limit_s": limit,
                      "wall_s": run["wall_s"]}
    log(f"live (e) --realtime: {n / pager.FS:.2f} s of signal in "
        f"{run['wall_s']:.2f} s; delay from a burst's last sample to its "
        f"JSON line by channel {res['latency']['delays_s']} s, max "
        f"{res['latency']['max_s']:.3f} s (limit {limit:.2f} s)")
    return res


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
            f"frames of {plan.d_rep} per window, "
            f"{plan.taps_sel_i16.shape[1]} taps a column) over "
            f"{pcm.numel()} samples -> {got.numel()} {out}: "
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
                       "frames": frames, "plan": plan_}
    worst = max(worst, check_k4_adversarial(device))
    return cap, steps, worst


def check_k4_adversarial(device) -> float:
    """K4 on all -32768 samples against a frame matrix of +-32767 taps
    (random signs; every byte product at its extreme, the int32 sums
    through many wraps), the rows off the 16-byte grid: the 147/160
    capture and a 3-channel 64/1 stream (D_rep 1: funnel-shifted A)."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.testing import channel_audio

    worst = 0.0
    for (i_, d_), g, n_carry, frames in (((147, 160), 1, 0, 18_000),
                                         ((64, 1), 3, 35, 4_096)):
        plan = polyphase.make_resampler_plan(
            q14.quantize_q14(channel_audio.resampler_taps(i_, d_)), i_, d_)
        rng = np.random.default_rng(i_ + d_)
        w = np.where(rng.random(plan.w_frames_i16.shape) < 0.5, -32767,
                     32767).astype(np.int16)
        taps = k4.frame_taps_of(w, plan.d_rep, device=device)
        carry = torch.full((g, n_carry), -32768, dtype=torch.int16,
                           device=device)
        n = frames * plan.d_rep - 5
        buf = torch.full((g * n + 3,), -32768, dtype=torch.int16,
                         device=device)
        block = buf[3:].view(g, n)          # 6 bytes past the 16-byte grid
        for out in ("f32", "q14"):
            got = k4.frame_resample(carry, block, taps, frames=frames,
                                    out=out)
            ref = k4.frame_resample_plain(carry, block, taps, frames=frames,
                                          out=out)
            err = max_err(got, ref)
            log(f"K4 vs plain, adversarial {i_}/{d_} (-32768 against "
                f"+-32767 taps, {k4_launch_shape(taps, frames, out)}): "
                f"carry "
                f"{list(carry.shape)} "
                f"block {list(block.shape)} off the 16-byte grid -> "
                f"{list(got.shape)} {out}: max|diff|={err}")
            require(torch.equal(got, ref),
                    f"K4 adversarial {i_}/{d_} ({out}) differs")
            worst = max(worst, err)
    return worst


def k4_launch_shape(taps, frames: int, out: str = "f32") -> str:
    """K4's launch at ``frames`` frames, from the rule the wrapper passes
    to the kernel (``k4.launch_shape``)."""
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4

    s = k4.launch_shape(taps, frames, out)
    return (f"K {s.k_pad}, N {8 * s.n_tiles}, {s.n_live} of "
            f"{s.k_pad // 32 * s.n_tiles} tap tiles kept, TM {s.tm}, "
            f"{s.warps} warps, {-(-frames // s.tm)} frame tiles a channel, "
            f"{s.smem} B of dynamic shared memory")


def check_k4_sass(sass: dict) -> None:
    """Every K4 instantiation (two epilogues x ldmatrix or funnel-shifted A
    fragments) computes on the int8 tensor cores: its SASS holds IMMA."""
    k4 = {name: sum(c for op, c in mnemonics(ins).items()
                    if op.startswith("IMMA"))
          for name, ins in sass.items() if "frame_resample_kernel" in name}
    log(f"K4 SASS: IMMA instructions per instantiation "
        f"{sorted(k4.values())} ({len(k4)} instantiations)")
    require(len(k4) == 4 and all(k4.values()),
            f"K4 instantiations without IMMA: {k4}")


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
    return p, max(worst, check_dc_adversarial(device))


# (x_prev, y_prev, acc): the two near 2^31 wrap acc on their first sample
# whatever it is, and no y_prev here is acc >> 14 (as in
# tests/test_torch_dc_exact.py)
DC_STATES = [(0, 0, 0), (-(32768 << 14), -4000, (1 << 31) - 2000),
             (32767 << 14, 4000, -(1 << 31) + 2000), (5 << 14, 12_345, 0)]


def check_dc_adversarial(device) -> float:
    """The exact DC kernel vs plain at 1, 6 and 33 streams, poles 0.9999
    and 0.5: random input with every other stream full-scale alternating
    (the int16 cast of y wraps), states from DC_STATES, 5,000 samples
    (more than a staged chunk) in uneven blocks whose rows sit off the
    16-byte grid: output and state exactly equal."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb

    n = 5_000
    cuts = [(0, 3), (3, 1155), (1155, 1155), (1155, 3500), (3500, n)]
    worst = 0.0
    for g in (1, 6, 33):
        for pole in (0.9999, 0.5):
            rng = np.random.default_rng(g)
            x = rng.integers(-32768, 32768, size=(g, n)).astype(np.int16)
            x[1::2] = np.where(np.arange(n) % 2, 32767, -32768)
            st0 = torch.tensor([DC_STATES[i % 4] for i in range(g)],
                               dtype=torch.int32)
            p = dcb.make_pole_coeff(pole)
            st_k, st_p = st0.to(device), st0.clone()
            for off, (lo, hi) in enumerate(cuts):
                part = torch.from_numpy(np.ascontiguousarray(x[:, lo:hi]))
                buf = torch.zeros(part.numel() + off, dtype=torch.int16,
                                  device=device)
                buf[off:] = part.reshape(-1).to(device)
                got = dcb.dc_block_exact(st_k, buf[off:].view(part.shape),
                                         p)
                ref = dcb.dc_block_exact_plain(st_p, part, p)
                require(torch.equal(got.cpu(), ref)
                        and torch.equal(st_k.cpu(), st_p),
                        f"exact DC blocker, {g} streams, pole {pole}: "
                        f"differs in samples [{lo}, {hi})")
                if hi > lo:
                    worst = max(worst, max_err(got, ref))
    log(f"exact DC blocker vs plain, adversarial: 1, 6 and 33 streams, "
        f"poles 0.9999 and 0.5, random and alternating full-scale input, "
        f"states with acc near +-2^31 and y_prev != acc >> 14, {n} samples "
        f"in blocks {cuts} off the 16-byte grid: max|diff|={worst}, states "
        f"equal")
    return worst


def chain_probe(device, stem: str, turns: int, *args) -> tuple:
    """A kernel's dependent chain alone on registers:
    ``bench/<stem>.cu`` built beside the kernel library, its
    ``tsl_<stem>(out, turns, *args, stream)`` run for ``turns`` turns
    (clock64 cycles and globaltimer nanoseconds), beside nvidia-smi's SM
    clock. Returns (the per-turn numbers, the opcodes of the probe's
    kernel from its SASS, its instruction count)."""
    import ctypes

    import torch

    from tsl_sdr_tpu_torch.kernels import build

    path = build.BUILD_DIR / "probe" / f"lib{stem}.so"
    t0 = time.perf_counter()
    build.compile_shared([HERE / "bench" / f"{stem}.cu"], path)
    fn = getattr(ctypes.CDLL(str(path)), f"tsl_{stem}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                   *[ctypes.c_int] * len(args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    log(f"{stem} built in {time.perf_counter() - t0:.1f} s")
    buf = torch.zeros(4, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for t in (16, turns):
        build.check(fn(buf.data_ptr(), t, *args, stream), f"tsl_{stem}")
    torch.cuda.synchronize()
    cycles, ns, _, _ = buf.cpu().tolist()
    probe = next(ins for name, ins in sass_by_kernel(path).items()
                 if f"{stem}_kernel" in name)
    return ({"cycles_per_turn": cycles / turns, "ns_per_turn": ns / turns,
             "probe_ghz": cycles / ns, "smi_sm_mhz": sm_clock_mhz()},
            mnemonics(probe), len(probe))


def dc_chain_latency(device, turns: int = 1 << 20) -> dict:
    """The DC kernel's bound per sample: one turn of its dependent chain,
    run alone on registers by ``bench/dc_chain_probe.cu``, beside the
    opcodes of the probe's 16-turn loop from its SASS."""
    res, ops, _ = chain_probe(device, "dc_chain_probe", turns)
    res["sass_ops"] = {op: ops.get(op, 0)
                       for op in ("SHF.R.S32.HI", "IMAD", "IADD3")}
    log(f"exact DC chain: {res['cycles_per_turn']:.3f} cycles = "
        f"{res['ns_per_turn']:.4f} ns a turn ({turns} turns alone on "
        f"registers; {res['probe_ghz']:.3f} GHz in the probe, nvidia-smi "
        f"clocks.sm {res['smi_sm_mhz']:.0f} MHz); the probe's loop SASS "
        f"(16 turns): {res['sass_ops']}")
    return res


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
    kernels and paths. Returns the runs' walls, the kernels' summaries
    and K1's largest error at decimation 50."""
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
    pcm, cplan, ctaps = cap["pcm"], cap["plan"], cap["taps"]
    steps["147/160 capture"] = {
        "carry": pcm.new_zeros((1, 0)), "block": pcm[None], "taps": ctaps,
        "frames": pcm.numel() // cplan.d_rep, "plan": cplan}
    for name, st in steps.items():
        carry, block, taps = st["carry"], st["block"], st["taps"]
        frames, plan = st["frames"], st["plan"]
        reps = 20 if name == "147/160 capture" else 50
        t = kernel_times(
            lambda: k4.frame_resample_plain(carry, block, taps,
                                            frames=frames),
            lambda: k4.frame_resample(carry, block, taps, frames=frames),
            reps // 5, reps, library=frame_library(carry, block, taps,
                                                   frames))
        # the function needs P multiply-adds an output (the banded form),
        # and reads each of the I_rep phase filters (P int16 taps) and its
        # window offset (int32) once
        n_out = carry.shape[0] * frames * plan.i_rep
        taps_bytes = (plan.taps_sel_i16[:plan.i_rep].nbytes
                      + plan.offsets[:plan.i_rep].nbytes)
        t["bound_ms"], t["bound_by"] = bound(
            n_out * plan.taps_sel_i16.shape[1],
            nbytes(carry, block) + taps_bytes + 4 * n_out)
        k4_times[name] = t
        log(f"K4 {name}: {k4_launch_shape(taps, frames)}")
        log(f"K4 {name}: kernel {t['ms']:.4f} ms (call {t['call_ms']:.4f}), "
            f"plain {t['plain_ms']:.4f} ms, f64 torch.bmm "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of it")
    fr_t = k4_times["pipeline step 25/16"]
    x = torch.randint(-32768, 32767, (1, 1152), dtype=torch.int16)
    xd = x.to(device)
    st_k = torch.zeros((1, 3), dtype=torch.int32, device=device)
    st_p = torch.zeros((1, 3), dtype=torch.int32)
    dc_t = kernel_times(
        lambda: dcb.dc_block_exact_plain(st_p, x, pole),
        lambda: dcb.dc_block_exact(st_k, xd, pole), 20, 200,
        plain_on_host=True)
    # a latency: the step's samples, one dependent chain turn each
    chain = dc_chain_latency(device)
    dc_t["bound_ms"] = max(xd.numel() * chain["ns_per_turn"] * 1e-6,
                           (2 * nbytes(xd) + 2 * nbytes(st_k)) / HBM_BYTES
                           * 1e3)
    # the summary's bound_by takes "bytes" or "operations": the chain's
    # operations, at their latency one after another; bound_kind says so
    dc_t["bound_by"], dc_t["bound_kind"] = "operations", "latency"
    dc_t["chain"] = chain
    log(f"exact DC, 1,152-sample step: kernel {dc_t['ms']:.4f} ms (call "
        f"{dc_t['call_ms']:.4f}), plain {dc_t['plain_ms']:.4f} ms (host "
        f"loop), bound {dc_t['bound_ms']:.5f} ms (latency: 1,152 turns of "
        f"{chain['cycles_per_turn']:.2f} cycles), "
        f"{dc_t['bound_ms'] / dc_t['ms']:.1%} of it")
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


# -- phases 13-16: the bit-exact tier, AIS and multifm-torch --------------

@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper swapped for its plain torch version wherever a
    module of the port calls it (the same run with no hand kernel: the
    reference a card run is held to, there being no JAX on the card)."""
    from tsl_sdr_tpu_torch.models import channelizer, costas_channel, resampler
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import costas as k6
    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import exact_fir as k5
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import polyphase
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    plain = {"chain_fm": k1.chain_fm_plain, "exact_fir": k5.exact_fir_plain,
             "row_resample": k3.row_resample_plain,
             "frame_resample": k4.frame_resample_plain,
             "dc_block_exact": dcb.dc_block_exact_plain,
             "costas_block_planes": k6.costas_block_planes_plain}
    before = launch_counts()
    saved = []
    for mod in (channelizer, resampler, polyphase, k4, dcb, costas_channel,
                k6):
        for name, fn in plain.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    require(launch_counts() == before,
            f"a kernel launched with every kernel swapped for its plain "
            f"version: {before} -> {launch_counts()}")


def k5_library(taps, carry, block):
    """One float64 ``torch.matmul`` computing K5's product (the library
    yardstick; the port never calls it): the stream's overlapping windows
    of (cr + 1) rows as one [rows, (cr + 1) * ROW] matrix, converted and
    laid out beforehand, against the stacked tap chunks."""
    import torch

    import numpy as np

    plan = taps.plan
    total = torch.cat([carry, block]).to(torch.float64)
    rows = block.numel() // plan.row
    k = (plan.cr_rows + 1) * plan.row
    a = total.as_strided((rows, k), (plan.row, 1)).contiguous()
    w = torch.from_numpy(np.concatenate(plan.w_chunks_i16).astype(
        np.float64)).to(block.device)
    return lambda: torch.matmul(a, w)


def check_exact_fir(shapes: dict, device):
    """Phase 13: K5 against its plain version, both epilogues (q14 and
    raw), EXACTLY equal, at each ``shapes`` entry (name -> (chain, flat
    values of carry ++ block)); a block with a ragged last tile; the
    adversarial input (all -32768 against taps of +-32767); two halves of
    a block against the whole. Returns the largest difference (0)."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import exact_fir as k5

    worst = 0
    for name, (chain, vals) in shapes.items():
        taps = chain.taps
        plan = taps.plan
        xt = taps.exact
        tr = xt.tile_rows
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        rows = (vals.size - plan.carry_vals) // plan.row
        cases = {
            name: (taps, vals),
            f"{name}, ragged (7 rows short)": (taps, vals[:-7 * plan.row]),
            f"{name}, adversarial (-32768 against +-32767 taps)": (
                adversarial_chain_taps(taps),
                np.full(plan.carry_vals + (3 * tr + 5) * plan.row, -32768,
                        np.int16)),
        }
        log(f"K5 shapes ({name}): ROW={plan.row} cr={plan.cr_rows} "
            f"U={plan.win} halfcols={plan.halfcols}; K5's tile_rows={tr} "
            f"(this block: {xt.launch_rows(rows, n_sm)}), "
            f"{xt.n_sub} sub-blocks of {xt.tiles_per_block} tap tiles, "
            f"{xt.stages} row buffers, taps "
            f"{'resident' if xt.staged else 'from L2'}; {rows} rows")
        for case, (tp, v) in cases.items():
            v = torch.from_numpy(v.copy()).to(device)
            carry, block = v[:plan.carry_vals], v[plan.carry_vals:]
            for out in ("q14", "raw"):
                got = k5.exact_fir(tp, carry, block, out)
                ref = k5.exact_fir_plain(tp, carry, block, out)
                if out == "q14":
                    got, ref = torch.stack(got), torch.stack(ref)
                err = max_err(got, ref)
                log(f"K5 vs plain, {case} ({out}): {list(got.shape)} "
                    f"max|diff|={err:g}")
                require(err == 0, f"K5 {case} {out}: max diff {err}")
                worst = max(worst, err)
            if tp is not taps or "ragged" in case:
                continue
            half = (block.numel() // plan.row // 2) * plan.row
            a = k5.exact_fir(taps, carry, block[:half])
            b = k5.exact_fir(taps, block[half - plan.carry_vals:half]
                             .contiguous(), block[half:])
            whole = k5.exact_fir(taps, carry, block)
            require(all(torch.equal(torch.cat([a[i], b[i]]), whole[i])
                        for i in range(2)),
                    f"K5 {case}: two halves differ from the whole block")
            log(f"K5 ({case}): two halves == whole block")
    return worst


def time_exact_fir(chain, vals, device) -> dict:
    """K5's device time at the pager block beside its plain version's and
    one float64 torch.matmul of the same product, its call time, and its
    bound (the product's non-zero multiply-adds; the block in, the two
    int16 planes out)."""
    import torch

    from tsl_sdr_tpu_torch.ops import exact_fir as k5

    taps = chain.taps
    plan = taps.plan
    v = torch.from_numpy(vals.copy()).to(device)
    carry, block = v[:plan.carry_vals], v[plan.carry_vals:]
    t = kernel_times(lambda: k5.exact_fir_plain(taps, carry, block),
                     lambda: k5.exact_fir(taps, carry, block), 5, 50,
                     library=k5_library(taps, carry, block))
    rows = block.numel() // plan.row
    t["bound_ms"], t["bound_by"] = bound(
        fir_macs(plan, rows),
        nbytes(carry, block, taps.exact.w_hi, taps.exact.w_lo)
        + 2 * rows * plan.halfcols * 2)
    log(f"K5 pager block ({rows} rows): kernel {t['ms']:.4f} ms (call "
        f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f} ms, f64 "
        f"torch.matmul {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} "
        f"ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of it")
    return t


def time_rotator(chain, rows: int, device) -> dict:
    """What the exact tier's host rotator costs a block of ``rows`` K5 rows:
    the native serial sequence's wall ms on the host, and its upload's
    (pinned staging and the host->device copy, synchronised), 10 runs
    each after one warm-up."""
    from tsl_sdr_tpu_torch.models.channelizer import upload
    from tsl_sdr_tpu_torch.runtime.native import rotator_seq

    plan = chain.packed_plan
    k = rows * plan.halfcols // chain.nr_channels
    rot = chain.init_exact_packed_state().rot
    reps = 10
    seq = rotator_seq(rot, plan.rot_incr_i32, k)
    t0 = time.perf_counter()
    for _ in range(reps):
        seq = rotator_seq(rot, plan.rot_incr_i32, k)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    upload(seq, device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        upload(seq, device)
    _sync(device)
    upload_ms = (time.perf_counter() - t0) / reps * 1e3
    res = {"outputs": k, "bytes": seq.nbytes, "host_ms": host_ms,
           "upload_ms": upload_ms}
    log(f"exact tier's rotator, one pager block ({k} outputs x "
        f"{chain.nr_channels} channels, {seq.nbytes} B): native sequence "
        f"{host_ms:.3f} ms on the host, upload {upload_ms:.3f} ms")
    return res


def exact_pipeline_run(mod_specs, lpf, decimation, iq, expected, device,
                       tmp: Path, name: str, pcm_offset: int):
    """Phase 14 for one deployment: the bit-exact tier with a ``pcm``
    channel added at ``pcm_offset``, cs16 through ``pipeline-torch
    --exact`` and rtl_u8 wire bytes through ``ReceivePipeline(exact=True)
    .push/flush``; every burst must decode (native decoders), and each
    run's pcm channel must equal, bit for bit, the same run with every
    kernel swapped for its plain version. Returns the walls."""
    import numpy as np

    from tsl_sdr_tpu_torch.cli import pipeline as cli
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.testing import pager

    specs = [*mod_specs, ChannelSpec(pager.CENTER_HZ + pcm_offset, "pcm")]
    want = sorted((s.center_freq_hz, cap, text)
                  for s, exp in zip(specs, expected) for cap, text in exp)
    cap_path = tmp / f"{name}.cs16"
    iq.reshape(-1).tofile(cap_path)
    cfg = {
        "device": {"type": "file", "filename": str(cap_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": pager.FS, "centerFreqHz": pager.CENTER_HZ,
        "decimationFactor": decimation,
        "lpfTaps": [float(t) for t in lpf],
        "channels": [{"chanCenterFreq": s.center_freq_hz,
                      "protocol": s.protocol, "dcBlock": s.dc_block}
                     for s in specs],
    }

    def cli_run(tag):
        cfg["channels"][-1]["outFifo"] = str(tmp / f"{name}_{tag}.pcm")
        cfg_path = tmp / f"{name}_{tag}.json"
        cfg_path.write_text(json.dumps(cfg))
        out_path = tmp / f"{name}_{tag}.jsonl"
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main([str(cfg_path), "--exact", "-o", str(out_path),
                           "--device", device])
        wall = time.perf_counter() - t0
        require(rc == 0, f"pipeline-torch --exact exited {rc}: "
                f"{err.getvalue()}")
        require_native(f"pipeline-torch --exact ({name})",
                       cli_tiers(err.getvalue()))
        got = sorted((m["freqHz"], m["capCode"], m["message"].rstrip("\0"))
                     for m in map(json.loads,
                                  out_path.read_text().splitlines()))
        pcm = np.fromfile(tmp / f"{name}_{tag}.pcm", np.int16)
        return got, pcm, wall

    def push_run():
        pipe = ReceivePipeline(lpf, pager.CENTER_HZ, pager.FS, decimation,
                               specs, exact=True, wire_fmt="rtl_u8",
                               device=device)
        require_native(f"ReceivePipeline(exact=True) ({name})",
                       pipe.decoder_tiers)
        flat = pager.to_rtl_u8(iq).reshape(-1)
        # wire bytes, two per sample: an even step keeps pushes whole
        step = (pipe.block_size * 2 // 3 + 1234) // 2 * 2
        results = [[] for _ in specs]
        t0 = time.perf_counter()
        for lo in range(0, flat.size, step):
            for i, part in enumerate(pipe.push(flat[lo:lo + step])):
                results[i].extend(part)
        for i, part in enumerate(pipe.flush()):
            results[i].extend(part)
        _sync(device)
        wall = time.perf_counter() - t0
        got = sorted((f, c, t.rstrip("\0")) for f, c, t in
                     message_keys(results[:-1], specs[:-1]))
        return got, np.concatenate(results[-1]), wall

    res = {}
    for tag, fn in (("cli", cli_run), ("push", push_run)):
        got, pcm, wall = fn(tag) if tag == "cli" else fn()
        require(got == [(f, c, t.rstrip("\0")) for f, c, t in want],
                f"exact {name} {tag} decoded {got}, expected {want}")
        with plain_kernels():
            _, pcm_plain, plain_wall = (fn(f"{tag}_plain") if tag == "cli"
                                        else fn())
        require(pcm.size > 0 and pcm.tobytes() == pcm_plain.tobytes(),
                f"exact {name} {tag}: the pcm channel ({pcm.size} samples) "
                f"differs from the plain-version run ({pcm_plain.size})")
        res[tag] = {"wall_s": wall, "plain_wall_s": plain_wall,
                    "msps": iq.shape[0] / wall / 1e6,
                    "pcm_samples": int(pcm.size)}
        log(f"exact {name} ({'cs16 pipeline-torch --exact' if tag == 'cli' else 'rtl_u8 push/flush'}): "
            f"{len(got)} bursts decoded, {iq.shape[0]} samples in "
            f"{wall:.3f} s ({res[tag]['msps']:.2f} Msps); pcm channel "
            f"{pcm.size} samples == plain-version run ({plain_wall:.3f} s)")
    return res


def ais_capture():
    """POCSAG + FLEX + AIS bursts and an inverted audio channel at 1.2288
    Msps / 32 (tests/test_torch_pipeline.py's deployment), made with the
    port's generators: (config channels, iq, expected (freq, kind))."""
    import numpy as np

    from tsl_sdr_tpu_torch.testing import ais_gen, flex_gen, pager, \
        pocsag_gen

    fs, c = pager.FS, pager.CENTER_HZ
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=1122334, function=2, kind="alpha",
                                content="AIS RUN POCSAG")],
        baud=1200, amplitude=4096, tail_bits=256)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=1234567, kind="alnum",
                                   content="AIS RUN FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999111, longitude=-70.9,
                                      latitude=42.36)], amplitude=9000)
    parts = [pager.fm_mod(p_bb, 38_400, 250_000, fs, amp=9000),
             pager.fm_mod(f_bb, 16_000, -180_000, fs, amp=7000),
             pager.fm_mod(a_bb, 48_000, 400_000, fs, amp=7000, dev_hz=4800)]
    iq = np.zeros((max(map(len, parts)) + 600_000, 2))
    for p in parts:
        iq[300_000:300_000 + len(p)] += p
    iq += np.random.default_rng(21).normal(scale=120, size=iq.shape)
    iq = np.clip(np.round(iq), -32768, 32767).astype(np.int16)
    channels = [
        {"chanCenterFreq": c + 250_000, "protocol": "pocsag"},
        {"chanCenterFreq": c - 180_000, "protocol": "flex", "dcBlock": True},
        {"chanCenterFreq": c + 400_000, "protocol": "ais"},
        {"chanCenterFreq": c - 50_000, "protocol": "pcm", "invert": True},
    ]
    return channels, iq


def ais_runs(device, tmp: Path, totals: dict) -> dict:
    """Phase 15: the POCSAG + FLEX + AIS capture through ``pipeline-torch``,
    production and ``--exact``: all three bursts decode, the AIS one
    included, on native decoders."""
    from tsl_sdr_tpu_torch.cli import pipeline as cli
    from tsl_sdr_tpu_torch.testing import pager
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    channels, iq = ais_capture()
    cap_path = tmp / "ais.cs16"
    iq.tofile(cap_path)
    cfg = {"device": {"type": "file", "filename": str(cap_path),
                      "fileFormat": "cs16"},
           "sampleRateHz": pager.FS, "centerFreqHz": pager.CENTER_HZ,
           "decimationFactor": pager.DECIMATION,
           "lpfTaps": [float(t) for t in
                       firdes_low_pass(1.0, pager.FS, 12_000, 8_000)],
           "channels": channels}
    cfg_path = tmp / "ais.json"
    cfg_path.write_text(json.dumps(cfg))
    res = {}
    for tier, flags, kernels in (
            ("production", [], ("chain_fm", "row_resample")),
            ("exact", ["--exact"], ("exact_fir", "row_resample_q14",
                                    "dc_block_exact"))):
        out = tmp / f"ais_{tier}.jsonl"

        def run():
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main([str(cfg_path), *flags, "-o", str(out),
                               "--device", device])
            require(rc == 0, f"pipeline-torch {flags} on the AIS capture "
                    f"exited {rc}: {err.getvalue()}")
            require_native(f"pipeline-torch {tier} (AIS capture)",
                           cli_tiers(err.getvalue()))
            return time.perf_counter() - t0

        wall = on_path(f"the AIS capture, {tier}", kernels, run, totals)
        msgs = [json.loads(x) for x in out.read_text().splitlines()]
        got = sorted((m["proto"], m.get("mmsi", m.get("capCode")))
                     for m in msgs)
        want = [("ais", 367999111), ("flex", 1234567), ("pocsag", 1122334)]
        require(got == want, f"the AIS capture ({tier}) decoded {got}, "
                f"expected {want}")
        ais = next(m for m in msgs if m["proto"] == "ais")
        log(f"AIS capture, {tier}: {len(msgs)} messages in {wall:.3f} s; "
            f"AIS {ais['type']} mmsi {ais['mmsi']} at "
            f"{ais['geoPosition']}")
        res[tier] = wall
    return res


# etc/multifm_rtlsdr_8ch.json's channels; burst k starts at MULTIFM_STARTS[k]
# (wideband samples at 1 Msps). Channels 2 and 4 sit 26 kHz apart and are
# on air one after the other.
MULTIFM_STARTS = (100_000, 250_000, 100_000, 400_000, 1_500_000, 550_000,
                  700_000, 850_000)


def multifm_capture(cfg):
    """rtl_u8 wire bytes of one POCSAG burst per channel of ``cfg`` (a
    MultifmConfig). Returns (u8 [n, 2], expected (capcode, text) per
    channel)."""
    import numpy as np

    from tsl_sdr_tpu_torch.testing import pager, pocsag_gen

    fs = cfg.sample_rate_hz
    sigs, expected = [], []
    for k, off in enumerate(cfg.channel_offsets_hz):
        cap, text = 1_200_000 + 100 * k, f"MULTIFM 8CH CH{k}"
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        sigs.append(pager.fm_mod(bb, 38_400, off, fs, amp=2000))
        expected.append((cap, text))
    n = max(s + len(x) for s, x in zip(MULTIFM_STARTS, sigs)) + 300_000
    iq = np.random.default_rng(12).normal(scale=60, size=(n, 2))
    for s, x in zip(MULTIFM_STARTS, sigs):
        iq[s:s + len(x)] += x
    return pager.to_rtl_u8(iq), expected


def decode_25k(pcm, device):
    """POCSAG messages of 25 kHz channel PCM: resampled 192/125 to the
    decoder's 38,400 Hz (etc/pocsag_38400_from_25k.json's filter, exact
    tier), then the native decoder."""
    from tsl_sdr_tpu_torch.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu_torch.models.resampler import ResamplerChain
    from tsl_sdr_tpu_torch.utils.config import load_lpf_coeffs

    rs = ResamplerChain(load_lpf_coeffs(HERE / "etc"
                                        / "pocsag_38400_from_25k.json"),
                        192, 125, exact=True, device=device)
    dec = PocsagDecoder()
    require(dec._nat is not None, "POCSAG decoder is not on its native tier")
    return [(m.capcode, m.data.rstrip(b"\0").decode())
            for m in dec.scan(rs.process_array(pcm))]


def multifm_runs(device, tmp: Path, totals: dict) -> dict:
    """Phase 16: ``multifm-torch`` on etc/multifm_rtlsdr_8ch.json (1 Msps,
    decimation 40, 365 taps, 8 channels) fed the rtl_u8 capture through
    ``--iq-file``: both tiers under both I/O runtimes, and the production
    tier through the mock RTL-SDR; every channel's PCM must decode its
    burst; each tier's PCM must equal, byte for byte, the same run with the
    kernels swapped for their plain versions (K5's for the exact tier, K1
    against chain_fm_plain for the production tier). Walls and Msps per
    run."""
    import os

    import numpy as np

    from tsl_sdr_tpu_torch.cli import multifm
    from tsl_sdr_tpu_torch.testing import mock_radios
    from tsl_sdr_tpu_torch.utils.config import MultifmConfig

    base = HERE / "etc" / "multifm_rtlsdr_8ch.json"
    cfg = MultifmConfig.load(base)
    wire, expected = multifm_capture(cfg)
    wire_path = tmp / "mf8.u8"
    wire.tofile(wire_path)
    n = wire.shape[0]
    nch = len(cfg.channels)

    def run(tag, flags, kernels, plain=False, mock=False):
        over = tmp / f"mf_{tag}.json"
        doc = {"channels": [{"outFifo": str(tmp / f"mf_{tag}_ch{k}.pcm"),
                             "chanCenterFreq": ch.chan_center_freq}
                            for k, ch in enumerate(cfg.channels)]}
        over.write_text(json.dumps(doc))
        argv = [str(base), str(over), "--device", device, *flags]
        if not mock:
            argv += ["--iq-file", str(wire_path), "--iq-format", "rtl_u8"]

        def go():
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                if plain:
                    with plain_kernels():
                        rc = multifm.main(argv)
                else:
                    rc = multifm.main(argv)
            wall = time.perf_counter() - t0
            require(rc == 0, f"multifm-torch {tag} exited {rc}: "
                    f"{err.getvalue()}")
            return wall

        wall = (go() if plain else
                on_path(f"multifm-torch {tag}", kernels, go, totals))
        pcm = [np.fromfile(tmp / f"mf_{tag}_ch{k}.pcm", np.int16)
               for k in range(nch)]
        return pcm, wall

    res = {}
    pcms = {}
    for tier, flags, kernels in (("exact", ["--exact"], ("exact_fir",)),
                                 ("production", [], ("chain_fm",))):
        for runtime in ("native", "python"):
            tag = f"{tier}_{runtime}"
            pcm, wall = run(tag, [*flags, "--runtime", runtime], kernels)
            for k in range(nch):
                got = decode_25k(pcm[k], device)
                require(got == [expected[k]], f"multifm-torch {tag} channel "
                        f"{k} decoded {got}, expected {expected[k]}")
            pcms[tag] = pcm
            res[tag] = {"wall_s": wall, "msps": n / wall / 1e6,
                        "samples": int(n)}
            log(f"multifm-torch {tag}: 8 of 8 channels decode; {n} samples "
                f"in {wall:.3f} s = {n / wall / 1e6:.2f} Msps")
        # the plain-version run (python runtime) against the kernels' run
        pcm, wall = run(f"{tier}_plain", [*flags, "--runtime", "python"], (),
                        plain=True)
        for k in range(nch):
            require(pcm[k].tobytes() == pcms[f"{tier}_python"][k].tobytes(),
                    f"multifm-torch {tier} channel {k}: PCM differs from the "
                    f"plain-version run")
        # the native runtime consumes to quantum granularity, the python
        # one drops the sub-block tail: their common prefix is the same
        for k in range(nch):
            a, b = pcms[f"{tier}_native"][k], pcms[f"{tier}_python"][k]
            m = min(a.size, b.size)
            require(m > 0.9 * max(a.size, b.size)
                    and a[:m].tobytes() == b[:m].tobytes(),
                    f"multifm-torch {tier} channel {k}: the runtimes differ")
        res[f"{tier}_plain"] = {"wall_s": wall}
        log(f"multifm-torch {tier}: PCM == the plain-version run byte for "
            f"byte on all 8 channels ({wall:.3f} s), both runtimes agree")

    env = {mock_radios.ENV_VARS["rtlsdr"]: str(mock_radios.build("rtlsdr")),
           "MOCK_RTLSDR_DATA": str(wire_path)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        pcm, wall = run("mock_rtlsdr", [], ("chain_fm",), mock=True)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for k in range(nch):
        got = decode_25k(pcm[k], device)
        require(got == [expected[k]], f"multifm-torch on the mock RTL-SDR "
                f"channel {k} decoded {got}")
    res["mock_rtlsdr"] = {"wall_s": wall, "msps": n / wall / 1e6}
    log(f"multifm-torch on the mock RTL-SDR: 8 of 8 channels decode; "
        f"{wall:.3f} s")
    return res


def exact_phases(pipe, iq, expected, device, totals: dict) -> dict:
    """Phases 13-16: K5 against its plain version and its times, the
    bit-exact pipeline on phase 4's capture and at decimation 50, the AIS
    capture, and multifm-torch at etc/multifm_rtlsdr_8ch.json."""
    import numpy as np

    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec
    from tsl_sdr_tpu_torch.testing import pager
    from tsl_sdr_tpu_torch.utils.config import MultifmConfig

    chain = pipe.chain
    plan = chain.packed_plan
    pager_vals = iq[:plan.carry_len + pipe.block_size].reshape(-1)
    cfg8 = MultifmConfig.load(HERE / "etc" / "multifm_rtlsdr_8ch.json")
    ch8 = MultifmChain.from_config(cfg8, exact=True, device=device)
    p8 = ch8.packed_plan
    # multifm-torch's default --block-size, cut to the block quantum
    block8 = 262_144 - 262_144 % ch8.block_quantum
    vals8 = np.random.default_rng(15).integers(
        -32768, 32768, size=p8.carry_vals + 2 * block8).astype(np.int16)
    k5_err = check_exact_fir({"pager block": (chain, pager_vals),
                              "multifm_rtlsdr_8ch block": (ch8, vals8)},
                             device)
    k5_t = time_exact_fir(chain, pager_vals, device)

    res = {"k5": k5_t, "k5_err": k5_err,
           "rotator": time_rotator(chain, pipe.block_size * 2 // plan.row,
                                   device)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        res["exact_pager"] = on_path(
            "the exact pager pipeline",
            ("exact_fir", "row_resample_q14", "dc_block_exact"),
            lambda: exact_pipeline_run(
                pager.channel_specs(ChannelSpec), pager.lpf_taps(),
                pager.DECIMATION, iq, [*expected, []], device, tmp, "pager",
                pager.OFFSETS_HZ[1]), totals)
        d50_specs = pager.dec50_channel_specs(ChannelSpec)
        starts = [200_000 + k * 1_300_000 for k in range(len(d50_specs))]
        d50_iq, d50_exp = pager.capture(2 * 4_194_304 + TAIL_SAMPLES, starts,
                                        seed=8)
        res["exact_dec50"] = on_path(
            "the exact pipeline at decimation 50",
            ("exact_fir", "frame_resample"),
            lambda: exact_pipeline_run(
                d50_specs, pager.dec50_lpf_taps(), pager.DEC50_DECIMATION,
                d50_iq, [*d50_exp[:len(d50_specs)], []], device, tmp,
                "dec50", pager.OFFSETS_HZ[1]), totals)
        del d50_iq
        res["ais"] = ais_runs(device, tmp, totals)
        res["multifm"] = multifm_runs(device, tmp, totals)
    res["kernel"] = {"name": "exact_fir", "route": "cuda",
                     "source": "tsl_sdr_tpu_torch/csrc/bank.cu",
                     "replaces": "tsl_sdr_tpu/ops/packed_fir.py:406",
                     "max_abs_err": k5_err, **k5_t}
    return res


# -- phase 17: wide channel banks (grouped operands, channel blocks) --------

# BENCH_SUITE's channelizer block (bench_suite.py prep_multifm): 52,224
# packed rows of 640 values at 1 Msps / decimation 40
WIDE_BLOCK = 16_711_680
WIDE_CHANNELS = (64, 256)


def bench_bank(nr_ch: int):
    """BENCH_SUITE's channelizer shape (bench_suite.py prep_multifm): 1
    Msps, decimation 40, a 128-tap low-pass, ``nr_ch`` channels."""
    import numpy as np

    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = 1_000_000
    offs = np.random.default_rng(0).integers(-fs // 3, fs // 3, size=nr_ch)
    return firdes_low_pass(1.0, fs, 12_500, 9_000)[:128], offs, fs, 40


def check_wide(forms: dict, carry, block, prev, where: str) -> int:
    """K1 and K5 (both epilogues) against their plain versions with each
    of ``forms`` (name -> ChainTaps): the whole block, 7 rows short of it
    and adversarial input, then two halves against the whole. Exactly
    equal; returns the largest difference (0)."""
    import torch

    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import exact_fir as k5

    worst = 0
    for form, taps in forms.items():
        plan = taps.plan
        tr = max(taps.tile_rows, taps.exact.tile_rows)
        adv = adversarial_chain_taps(taps)
        adv_vals = torch.full((plan.carry_vals + (3 * tr + 5) * plan.row,),
                              -32768, dtype=torch.int16, device=block.device)
        cases = {
            "block": (taps, carry, block),
            "7 rows short": (taps, carry, block[:-7 * plan.row]),
            "adversarial": (adv, adv_vals[:plan.carry_vals],
                            adv_vals[plan.carry_vals:]),
        }
        for case, (tp, c, b) in cases.items():
            got, gprev = k1.chain_fm(tp, c, prev, b)
            ref, rprev = k1.chain_fm_plain(tp, c, prev, b)
            errs = [max_err(got, ref), max_err(gprev, rprev)]
            for out in ("q14", "raw"):
                g5 = k5.exact_fir(tp, c, b, out)
                r5 = k5.exact_fir_plain(tp, c, b, out)
                if out == "q14":
                    g5, r5 = torch.stack(g5), torch.stack(r5)
                errs.append(max_err(g5, r5))
            del got, ref, g5, r5
            log(f"K1/K5 vs plain, {where} {form} (K1 {tp.body} body, "
                f"{tp.tile_rows}-row tiles, {tp.chans_per_block} channels a "
                f"block; K5 {tp.exact.tile_rows}-row tiles), {case}: "
                f"max|diff| "
                f"K1 {errs[0]:g}, carry {errs[1]:g}, K5 q14 {errs[2]:g}, "
                f"raw {errs[3]:g}")
            require(max(errs) == 0, f"{where} {form} {case}: {errs}")
            worst = max(worst, max(errs))
        half = (block.numel() // plan.row // 2) * plan.row
        carry2 = block[half - plan.carry_vals:half].contiguous()
        whole, wprev = k1.chain_fm(taps, carry, prev, block)
        a, p_a = k1.chain_fm(taps, carry, prev, block[:half])
        b, p_b = k1.chain_fm(taps, carry2, p_a, block[half:])
        require(torch.equal(torch.cat([a, b]), whole)
                and torch.equal(p_b, wprev),
                f"K1 {where} {form}: two halves differ from the whole")
        del whole, a, b
        whole = k5.exact_fir(taps, carry, block, "raw")
        parts = torch.cat([k5.exact_fir(taps, carry, block[:half], "raw"),
                           k5.exact_fir(taps, carry2, block[half:], "raw")])
        require(torch.equal(parts, whole),
                f"K5 {where} {form}: two halves differ from the whole")
        del whole, parts
        log(f"K1/K5 ({where} {form}): two halves == whole block")
    return worst


def time_wide(forms: dict, carry, block, prev) -> dict:
    """Device times at one wide shape: K1 and K5 (raw, and q14) with
    grouped operands beside their plain versions (and, for K5 raw, one
    float64 torch.matmul of the same product), then each kernel grouped
    against the full window (grouped=False), in turns."""
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import exact_fir as k5

    g, f = forms["grouped"], forms["full"]
    plan = g.plan
    rows = block.numel() // plan.row
    io = nbytes(carry, block, g.w_hi, g.w_lo, g.ktab)
    io5 = nbytes(carry, block, g.exact.w_hi, g.exact.w_lo, g.exact.ktab)
    macs = fir_macs(plan, rows)
    res = {}
    k1_t = kernel_times(lambda: k1.chain_fm_plain(g, carry, prev, block),
                        lambda: k1.chain_fm(g, carry, prev, block), 3, 20)
    k1_t["bound_ms"], k1_t["bound_by"] = bound(
        macs, io + nbytes(g.omega_row) + 2 * nbytes(prev)
        + 2 * rows * plan.halfcols)
    k5_t = kernel_times(lambda: k5.exact_fir_plain(g, carry, block, "raw"),
                        lambda: k5.exact_fir(g, carry, block, "raw"), 3, 20,
                        library=k5_library(g, carry, block))
    k5_t["bound_ms"], k5_t["bound_by"] = bound(
        macs, io5 + 4 * rows * 2 * plan.halfcols)
    res["chain_fm"], res["exact_fir_raw"] = k1_t, k5_t
    pairs = {
        "chain_fm": lambda t: k1.chain_fm(t, carry, prev, block),
        "exact_fir_raw": lambda t: k5.exact_fir(t, carry, block, "raw"),
        "exact_fir_q14": lambda t: k5.exact_fir(t, carry, block, "q14"),
    }
    for name, fn in pairs.items():
        g_ms, f_ms = in_turns(lambda: fn(f), lambda: fn(g), 20, 20,
                              device_ms)
        res.setdefault(name, {}).update(grouped_ms=g_ms, full_ms=f_ms)
    res["exact_fir_q14"]["bound_ms"] = bound(
        macs, io5 + 2 * rows * 2 * plan.halfcols)[0]
    return res


def wide_kernels(device) -> dict:
    """Phase 17 (a): K1 and K5 at BENCH_SUITE's block (16,711,680 samples)
    at 64 and 256 channels, with the chain's grouped operands and with
    full-window ones (``grouped=False``): checks and times."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.ops.chain import ChainTaps

    res = {"err": 0}
    for nr_ch in WIDE_CHANNELS:
        chain = MultifmChain(*bench_bank(nr_ch), device=device)
        plan = chain.packed_plan
        require(chain.grouped_plan is not None and chain.taps.grouped,
                f"{nr_ch} channels: the chain did not pick the grouped form")
        forms = {"grouped": chain.taps,
                 "full": ChainTaps(plan, chain._omega_reduced, device=device,
                                   grouped=False)}
        rng = np.random.default_rng(nr_ch)
        vals = torch.from_numpy(rng.integers(
            -8000, 8000, size=plan.carry_vals + 2 * WIDE_BLOCK).astype(
                np.int16)).to(device)
        carry, block = vals[:plan.carry_vals], vals[plan.carry_vals:]
        prev = torch.from_numpy(rng.normal(
            scale=1e5, size=(2, nr_ch)).astype(np.float32)).to(device)
        ktab = chain.taps.ktab.cpu().numpy()
        log(f"wide bank, {nr_ch} channels: ROW={plan.row} U={plan.win} "
            f"halfcols={plan.halfcols}; {block.numel() // plan.row} rows; "
            f"grouped: K1 {chain.taps.body} body, {chain.taps.tile_rows}-row "
            f"tiles x {chain.taps.chans_per_block} channels a block, "
            f"{chain.taps.stages} row buffers; K5 "
            f"{chain.taps.exact.tile_rows}-row tiles, "
            f"{chain.taps.exact.n_sub} sub-blocks, "
            f"{int((ktab[:, 1] - ktab[:, 0]).sum())} tile k-steps of "
            f"{-(-plan.win // 32) * ktab.shape[0]}, taps "
            f"{chain.taps.tap_block_bytes} B a block")
        res["err"] = max(res["err"], check_wide(forms, carry, block, prev,
                                                f"{nr_ch} ch"))
        t = time_wide(forms, carry, block, prev)
        for name, r in t.items():
            log(f"{name} at {nr_ch} channels: grouped {r['grouped_ms']:.4f} "
                f"ms, full window {r['full_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.5f} ms; {json.dumps(r)}")
        res[nr_ch] = t
        del vals, carry, block, forms, chain
        torch.cuda.empty_cache()
    return res


# the 232 channels etc/multifm_airspy.json's settings hold at 12.5 kHz
# within +-1.45 MHz; a POCSAG burst on every 28th from channel 5
AIRSPY_CHANNELS = 232
AIRSPY_BURSTS = tuple(5 + 28 * i for i in range(8))
AIRSPY_SAMPLES = 9_000_000      # 3 s at 3 Msps
# BENCH_SUITE's channelizer settings (1 Msps, decimation 40, 128 taps) at
# 64 channels 12.5 kHz apart within +-400 kHz, where K1 runs its bank body;
# a POCSAG burst on every 9th from channel 3
BANK_CHANNELS = 64
BANK_BURSTS = tuple(3 + 9 * i for i in range(7))
BANK_SAMPLES = 2_000_000        # 2 s at 1 Msps


def bank_capture(offsets, fs, bursts, n, label):
    """cs16 IQ of ``n`` samples with one POCSAG burst on each ``bursts``
    channel, 60,000 samples apart (at 3 Msps; in proportion at ``fs``),
    in noise. Returns (iq [n, 2] int16, expected (capcode, text) per
    burst)."""
    import numpy as np

    from tsl_sdr_tpu_torch.testing import pager, pocsag_gen

    iq = np.random.default_rng(13).normal(scale=60, size=(n, 2))
    expected = []
    step = 60_000 * fs // 3_000_000
    for i, k in enumerate(bursts):
        cap, text = 1_300_000 + 100 * i, f"{label} CH{k}"
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        x = pager.fm_mod(bb, 38_400, offsets[k], fs, amp=3000)
        s = 100_000 * fs // 3_000_000 + step * i
        iq[s:s + len(x)] += x
        expected.append((cap, text))
    return np.clip(np.round(iq), -32768, 32767).astype(np.int16), expected


def wide_multifm_runs(device, tmp: Path, totals: dict, label: str, base,
                      offsets, bursts, n: int, kernels: dict) -> dict:
    """Phase 17 (b), (c): ``multifm-torch`` with ``base``'s rate,
    decimation and taps at the channel ``offsets`` (Hz), on a cs16
    ``--iq-file`` of ``n`` samples with a POCSAG burst on each ``bursts``
    channel: both tiers (python runtime) with the launch counts read around
    each run, which must show ``kernels[tier]``; every burst decodes; each
    tier's PCM equals its plain-version run byte for byte on every
    channel."""
    import numpy as np

    from tsl_sdr_tpu_torch.cli import multifm

    fs = base["sampleRateHz"]
    iq, expected = bank_capture(offsets, fs, bursts, n, label.upper())
    cap_path = tmp / f"{label}.cs16"
    iq.tofile(cap_path)
    del iq

    def run(tag, flags, kernels, plain=False):
        cfg = {k: v for k, v in base.items() if k != "channels"}
        cfg["channels"] = [
            {"outFifo": str(tmp / f"{label}_{tag}_ch{k}.pcm"),
             "chanCenterFreq": base["centerFreqHz"] + int(off)}
            for k, off in enumerate(offsets)]
        cfg_path = tmp / f"{label}_{tag}.json"
        cfg_path.write_text(json.dumps(cfg))
        argv = [str(cfg_path), "--iq-file", str(cap_path), "--iq-format",
                "cs16", "--runtime", "python", "--device", device, *flags]

        def go():
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                if plain:
                    with plain_kernels():
                        rc = multifm.main(argv)
                else:
                    rc = multifm.main(argv)
            require(rc == 0, f"multifm-torch {label} {tag} exited {rc}: "
                    f"{err.getvalue()}")
            return time.perf_counter() - t0

        wall = go() if plain else on_path(f"multifm-torch {label} {tag}",
                                          kernels, go, totals)
        pcm = [np.fromfile(tmp / f"{label}_{tag}_ch{k}.pcm", np.int16)
               for k in range(len(offsets))]
        return pcm, wall

    res = {}
    for tier, flags in (("exact", ["--exact"]), ("production", [])):
        pcm, wall = run(tier, flags, kernels[tier])
        for i, k in enumerate(bursts):
            got = decode_25k(pcm[k], device)
            require(got == [expected[i]], f"multifm-torch {label} {tier} "
                    f"channel {k} decoded {got}, expected {expected[i]}")
        plain_pcm, plain_wall = run(f"{tier}_plain", flags, (), plain=True)
        require(all(p.size > 0 and p.tobytes() == q.tobytes()
                    for p, q in zip(pcm, plain_pcm)),
                f"multifm-torch {label} {tier}: PCM differs from the "
                f"plain-version run")
        res[tier] = {"wall_s": wall, "plain_wall_s": plain_wall,
                     "msps": n / wall / 1e6, "samples": n}
        log(f"multifm-torch {label} ({len(offsets)} channels) {tier}: "
            f"{len(bursts)} of {len(bursts)} bursts decode; {n} samples in "
            f"{wall:.3f} s = {n / wall / 1e6:.2f} Msps; PCM of all "
            f"{len(offsets)} channels == the plain-version run "
            f"({plain_wall:.3f} s)")
    return res


def wide_phase(device, totals: dict) -> dict:
    """Phase 17: wide channel banks, K1 and K5 at BENCH_SUITE's block, then
    multifm-torch at 232 channels."""
    import numpy as np

    res = {"kernels": wide_kernels(device)}
    airspy = json.loads((HERE / "etc" / "multifm_airspy.json").read_text())
    bank = json.loads((HERE / "etc" / "multifm_rtlsdr_8ch.json").read_text())
    bank["lpfTaps"] = [float(v) for v in bench_bank(BANK_CHANNELS)[0]]
    with tempfile.TemporaryDirectory() as tmp:
        res["multifm"] = wide_multifm_runs(
            device, Path(tmp), totals, "airspy232", airspy,
            -1_450_000 + 12_500 * np.arange(AIRSPY_CHANNELS), AIRSPY_BURSTS,
            AIRSPY_SAMPLES,
            {"exact": ("exact_fir", "exact_fir_grouped"),
             "production": ("chain_fm", "chain_fm_grouped")})
        res["multifm_bank"] = wide_multifm_runs(
            device, Path(tmp), totals, "bank64", bank,
            -400_000 + 12_500 * np.arange(BANK_CHANNELS), BANK_BURSTS,
            BANK_SAMPLES,
            {"exact": ("exact_fir", "exact_fir_grouped"),
             "production": ("chain_fm", "chain_fm_grouped",
                            "chain_fm_bank")})
    return res


# -- phase 18: the Costas coherent chain ------------------------------------

# BENCH_SUITE's costas_chain_device row (bench_suite.py prep_costas_device):
# 8 channels at 1 Msps, decimation 8, a 64-tap low-pass, blocks of
# 2,000,000 samples, loop gains 0.05 / 0.002
COSTAS_BLOCK = 2_000_000
COSTAS_BLOCKS = 4
# the lock capture (tests/test_costas_channel.py) widened to 8 channels
LOCK_FS = 256_000
LOCK_OFFSETS = (-105_000, -75_000, -45_000, -15_000, 15_000, 45_000,
                75_000, 105_000)


def costas_bench_chain(device):
    """BENCH_SUITE's costas_chain_device chain: 8 channels at offsets drawn
    within +-fs/3, 1 Msps, decimation 8, 64 taps."""
    import numpy as np

    from tsl_sdr_tpu_torch.models.costas_channel import CostasChannelizer
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = 1_000_000
    lpf = firdes_low_pass(1.0, fs, 40_000, 20_000)[:64]
    offsets = np.random.default_rng(0).integers(-fs // 3, fs // 3, size=8)
    return CostasChannelizer(lpf, offsets, fs, 8, alpha=0.05, beta=0.002,
                             e_max_q14=8192, device=device)


def costas_equal(params, st, xr, xi, chunk, where: str) -> float:
    """K6 and its plain version on the card from the same planes and
    state: outputs and state exactly equal. Returns the largest
    difference (0)."""
    from tsl_sdr_tpu_torch.ops import costas as k6

    got = k6.costas_block_planes(params, st, xr, xi, chunk)
    want = k6.costas_block_planes_plain(params, st, xr, xi, chunk)
    pairs = ((got[1], want[1]), (got[2], want[2]),
             (got[0].last_phase, want[0].last_phase),
             (got[0].f_dev, want[0].f_dev))
    worst = max(max_err(a, b) for a, b in pairs)
    names = ("o_re", "o_im", "phase", "f_dev")
    diff = [n for n, (a, b) in zip(names, pairs) if not a.equal(b)]
    require(not diff, f"K6 {where}: {diff} differ from the plain version "
            f"(max |diff| {worst})")
    return worst


def slice_planes(chain, iq, block: int, device):
    """The loop's input planes of the capture's first block: K5's raw sums
    derotated by the NCO and scaled by 2^-14 twice, as ``chain.step``
    hands them to K6 ([K, C] float32 on ``device``)."""
    import numpy as np
    import torch

    vals = torch.from_numpy(iq[:chain.carry_len + block].reshape(-1)
                            .copy()).to(device)
    yr, yi = chain._baseband(vals[:2 * chain.carry_len],
                             vals[2 * chain.carry_len:], 0)
    scale = float(np.float32(1.0 / 16384.0))
    return yr * scale * scale, yi * scale * scale


def check_costas(chain, iq, block: int, device) -> float:
    """Phase 18 (a): K6 against its plain version on the card, exactly
    equal: the slice's planes (the chain's first block, K = 250,000 at 8
    channels, auto chunk 22 and its remainder of 14), random planes at
    chunks 32 and 512 at 1 and 33 channels, adversarial planes (full scale
    past the error clip, gains far past stable, states past both f_dev
    clamps and at phase 0 with f_dev < 0), and a block as two halves split
    at a multiple of the chunk against the whole."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import costas as k6

    params = chain.params
    xr, xi = slice_planes(chain, iq, block, device)
    st = k6.init_costas_state(params, chain.nr_channels, device)
    chunk = k6.stable_chunk(params)
    worst = costas_equal(params, st, xr, xi, None, "slice block")
    log(f"K6 vs plain, the slice's block ({xr.shape[0]} x {xr.shape[1]}, "
        f"chunk {chunk}, remainder {xr.shape[0] % chunk}): exactly equal")
    rng = np.random.default_rng(18)
    cases = []
    for ch, c in ((32, 1), (32, 33), (512, 1), (512, 33)):
        k = 40 * ch + 7
        planes = [torch.from_numpy(rng.normal(scale=0.4, size=(k, c))
                                   .astype(np.float32)).to(device)
                  for _ in range(2)]
        st_r = k6.CostasState(
            torch.from_numpy(rng.uniform(0, 2 * np.pi, size=c)
                             .astype(np.float32)).to(device),
            torch.from_numpy(rng.uniform(-0.05, 0.05, size=c)
                             .astype(np.float32)).to(device))
        worst = max(worst, costas_equal(params, st_r, *planes, ch,
                                        f"random {k} x {c} chunk {ch}"))
        cases.append(f"{k}x{c}/{ch}")
    adv = k6.make_costas_params(1e-3, 0.5, 0.05, 8192)
    for ch in (32, 512):
        k = 6 * ch + 3
        t = np.arange(k, dtype=np.float64)[:, None]
        rot = np.array([0.9, -0.9, 2.5, -2.5, 0.0, 3.1])[None, :]
        planes = [torch.from_numpy((1.99 * f(rot * t)).astype(np.float32))
                  .to(device) for f in (np.cos, np.sin)]
        st_a = k6.CostasState(
            torch.tensor([0.0, 6.2831, 1e-7, 3.0, 6.28318, 0.5],
                         device=device),
            torch.tensor([-0.3, 0.3, 0.0, -0.29, 0.31, -0.31],
                         device=device))
        worst = max(worst, costas_equal(adv, st_a, *planes, ch,
                                        f"adversarial chunk {ch}"))
        _, o_re, o_im = k6.costas_block_planes(adv, st_a, *planes, ch)
        require(float((o_re * o_im).abs().max()) > adv.e_max,
                "K6 adversarial: the error clip never saturated")
    cut = chunk * (xr.shape[0] // chunk // 2)
    s1, r1, i1 = k6.costas_block_planes(params, st, xr[:cut], xi[:cut])
    s2, r2, i2 = k6.costas_block_planes(params, s1, xr[cut:], xi[cut:])
    sw, rw, iw = k6.costas_block_planes(params, st, xr, xi)
    require(torch.equal(torch.cat([r1, r2]), rw)
            and torch.equal(torch.cat([i1, i2]), iw)
            and torch.equal(s2.last_phase, sw.last_phase)
            and torch.equal(s2.f_dev, sw.f_dev),
            "K6: two halves split at a multiple of the chunk differ from "
            "the whole")
    log(f"K6 vs plain: random planes {cases}, adversarial at chunks 32 and "
        f"512 (error clip saturated; states past both f_dev clamps and at "
        f"phase 0 with f_dev < 0), two halves split at {cut} == the whole: "
        f"max|diff|={worst}")
    return worst


def costas_capture(chain, n_blocks: int):
    """BENCH_SUITE's costas_chain_device input (random int16 IQ within
    +-8,000), ``n_blocks`` blocks after the carry."""
    import numpy as np

    block = COSTAS_BLOCK // chain.block_quantum * chain.block_quantum
    return np.random.default_rng(0).integers(
        -8000, 8000, size=(chain.carry_len + n_blocks * block, 2),
        dtype=np.int64).astype(np.int16), block


def costas_run(chain, iq, block: int):
    """The chain over the capture's blocks, state carried: the output
    [C, K, 2] int16 on the card and the final state."""
    import torch

    st = chain.init_state(prefix=iq[:chain.carry_len])
    outs = []
    for lo in range(chain.carry_len, iq.shape[0], block):
        st, out = chain.step(st, iq[lo:lo + block])
        outs.append(out)
    return torch.cat(outs, 1), st


def lock_capture(n: int):
    """tests/test_costas_channel.py's BPSK capture (256 ksps, 2 ksym/s, a
    35 Hz carrier error, noise) widened to 8 channels at LOCK_OFFSETS."""
    import numpy as np

    rng = np.random.default_rng(33)
    t = np.arange(n) / LOCK_FS
    iq = np.zeros((n, 2))
    for off in LOCK_OFFSETS:
        sym = rng.choice([-1.0, 1.0], size=n // 128 + 2)
        bb = np.repeat(sym, 128)[:n]
        ph = 2 * np.pi * (off + 35.0) * t
        iq += np.stack([np.cos(ph) * bb, np.sin(ph) * bb], -1) * 3000
    return (iq + rng.normal(scale=60, size=iq.shape)).astype(np.int16)


def lock_verdicts(out) -> list:
    """tests/test_costas_channel.py's lock test on each channel of
    [C, K, 2]: (real-rail power / imaginary-rail power in the tail, mean
    |re| in the tail)."""
    import numpy as np

    res = []
    for ch in np.asarray(out, np.float64):
        tail = ch[ch.shape[0] // 2:]
        res.append((float(np.mean(tail[:, 0] ** 2)
                          / max(np.mean(tail[:, 1] ** 2), 1e-9)),
                    float(np.mean(np.abs(tail[:, 0])))))
    return res


def check_lock(device, totals: dict) -> dict:
    """Phase 18 (c): the 8-channel BPSK capture on the card's step path
    and on process_array_native; every channel must lock on both (real
    rail > 20 x imaginary rail, mean |re| > 1000 in the tail)."""
    from tsl_sdr_tpu_torch.models.costas_channel import CostasChannelizer
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    n = LOCK_FS
    iq = lock_capture(n)
    chain = CostasChannelizer(firdes_low_pass(1.0, LOCK_FS, 6_000, 4_000),
                              LOCK_OFFSETS, LOCK_FS, 8, alpha=0.1,
                              beta=0.005, e_max_q14=8192, device=device)
    q = chain.block_quantum
    block = (n - chain.carry_len) // 4 // q * q
    iq = iq[:chain.carry_len + 4 * block]

    def step_path():
        return costas_run(chain, iq, block)[0].cpu().numpy()

    res = {}
    for tier, fn, kernels in (
            ("step", step_path, ("exact_fir", "costas_chunks")),
            ("native", lambda: chain.process_array_native(iq, block),
             ("exact_fir",))):
        out = on_path(f"the Costas lock capture ({tier})", kernels, fn,
                      totals)
        v = lock_verdicts(out)
        res[tier] = v
        bad = [i for i, (ratio, mag) in enumerate(v)
               if not (ratio > 20 and mag > 1000)]
        require(not bad, f"Costas {tier}: channels {bad} did not lock: {v}")
        log(f"Costas lock ({tier}): all 8 channels locked; re/im power "
            f"{[round(r, 1) for r, _ in v]}, mean |re| "
            f"{[round(m) for _, m in v]}")
    return res


def costas_chain_latency(device, n: int, turns: int = 1 << 16) -> dict:
    """K6's bound a chunk: one turn of its dependent chain on one warp,
    alone on registers (``bench/costas_chain_probe.cu``, ``turns`` turns
    of ``n`` samples), beside the opcodes of the probe's loop from its
    SASS."""
    res, ops, count = chain_probe(device, "costas_chain_probe", turns, n)
    res["sass_instructions"] = count
    res["sass_ops"] = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
    log(f"K6 chain: {res['cycles_per_turn']:.1f} cycles = "
        f"{res['ns_per_turn']:.2f} ns a chunk turn of {n} samples ({turns} "
        f"turns alone on registers; {res['probe_ghz']:.3f} GHz in the "
        f"probe, nvidia-smi clocks.sm {res['smi_sm_mhz']:.0f} MHz); the "
        f"probe's {count} SASS instructions, most frequent "
        f"{res['sass_ops']}")
    return res


def costas_phase(device, totals: dict) -> dict:
    """Phase 18: the Costas coherent chain at BENCH_SUITE's
    costas_chain_device settings: K6 against its plain version, the chain
    over several blocks against the plain-version run, lock on both tiers,
    and times."""
    import torch

    from tsl_sdr_tpu_torch.ops import costas as k6

    chain = costas_bench_chain(device)
    plan = chain.packed_plan
    iq, block = costas_capture(chain, COSTAS_BLOCKS)
    log(f"Costas chain: {chain.nr_channels} channels, plan ROW {plan.row}, "
        f"cr_rows {plan.cr_rows}, opr {plan.opr}, quantum "
        f"{chain.block_quantum}, carry {chain.carry_len}, grouped "
        f"{chain.taps.grouped}; chunk {k6.stable_chunk(chain.params)}; "
        f"{COSTAS_BLOCKS} blocks of {block} samples")
    err = check_costas(chain, iq, block, device)

    # (b) the chain end to end, against the run with every kernel swapped
    # for its plain version
    t0 = time.perf_counter()
    got, st_k = on_path("the Costas chain", ("exact_fir", "costas_chunks"),
                        lambda: costas_run(chain, iq, block), totals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with plain_kernels():
        want, st_p = costas_run(chain, iq, block)
    plain_wall = time.perf_counter() - t0
    require(got.shape == (chain.nr_channels, COSTAS_BLOCKS * block // 8, 2)
            and got.dtype == torch.int16, f"Costas chain output {got.shape}")
    require(torch.equal(got, want)
            and torch.equal(st_k.costas.last_phase, st_p.costas.last_phase)
            and torch.equal(st_k.costas.f_dev, st_p.costas.f_dev),
            f"Costas chain: the output differs from the plain-version run "
            f"in {int((got != want).sum())} values")
    log(f"Costas chain: {COSTAS_BLOCKS} blocks, state carried: int16 output "
        f"{list(got.shape)} and state equal to the plain-version run "
        f"({wall:.3f} s with the kernels, {plain_wall:.1f} s plain)")
    del got, want

    res = {"lock": check_lock(device, totals)}

    # (d) times: K6 at the slice's block in turns with its plain version
    xr, xi = slice_planes(chain, iq, block, device)
    st = k6.init_costas_state(chain.params, chain.nr_channels, device)
    chunk = k6.stable_chunk(chain.params)
    k6_t = kernel_times(
        lambda: k6.costas_block_planes_plain(chain.params, st, xr, xi),
        lambda: k6.costas_block_planes(chain.params, st, xr, xi), 1, 20,
        plain_on_host=True)
    chunks = -(-xr.shape[0] // chunk)
    lat = costas_chain_latency(device, chunk)
    # a latency: the block's chunks, one dependent chain turn each (the
    # channels run side by side); the bytes: xr, xi in, o_re, o_im out
    t_lat = chunks * lat["ns_per_turn"] * 1e-6
    t_bytes = 4 * nbytes(xr) / HBM_BYTES * 1e3
    k6_t["bound_ms"] = max(t_lat, t_bytes)
    k6_t["bound_by"], k6_t["bound_kind"] = "operations", "latency"
    k6_t["chain"] = lat
    k6_t["bytes_ms"] = t_bytes
    log(f"K6 slice block ({xr.shape[0]} x {xr.shape[1]}, {chunks} chunks): "
        f"kernel {k6_t['ms']:.4f} ms (call {k6_t['call_ms']:.4f}), plain "
        f"{k6_t['plain_ms']:.1f} ms (a Python loop of chunks), bound "
        f"{k6_t['bound_ms']:.4f} ms (latency: {chunks} turns of "
        f"{lat['cycles_per_turn']:.1f} cycles; bytes alone {t_bytes:.4f} ms), "
        f"{k6_t['bound_ms'] / k6_t['ms']:.1%} of it; no library call (torch "
        f"has no scan)")

    # the chain's wall a block (CUDA events around one step, after
    # warm-up), 8 trials
    st0 = chain.init_state(prefix=iq[:chain.carry_len])
    blk = torch.from_numpy(iq[chain.carry_len:chain.carry_len + block]
                           .copy()).to(device)
    chain.step(st0, blk)
    trials = sorted(time_ms(lambda: chain.step(st0, blk), 1)
                    for _ in range(8))
    med = (trials[3] + trials[4]) / 2
    res["chain"] = {"block": block, "trials_ms": trials, "median_ms": med,
                    "msps": block / med / 1e3}
    log(f"Costas chain a {block}-sample block (8 trials, device input): "
        f"median {med:.3f} ms, spread {trials[0]:.3f}-{trials[-1]:.3f} ms, "
        f"{block / med / 1e3:.1f} Msps wideband")
    walls = []
    n_native = chain.carry_len + COSTAS_BLOCKS * block
    for _ in range(3):
        t0 = time.perf_counter()
        chain.process_array_native(iq[:n_native], block)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    res["native"] = {"samples": COSTAS_BLOCKS * block, "walls_s": walls,
                     "msps": COSTAS_BLOCKS * block / walls[1] / 1e6}
    log(f"Costas native path (K5 + NCO on the card, the serial loop in C a "
        f"channel): {COSTAS_BLOCKS * block} samples in {walls[1]:.3f} s "
        f"(median of 3, {walls[0]:.3f}-{walls[2]:.3f}), "
        f"{res['native']['msps']:.1f} Msps wideband")
    res["k6"] = k6_t
    res["kernel"] = {"name": "costas_chunks", "route": "cuda",
                     "source": "tsl_sdr_tpu_torch/csrc/costas.cu",
                     "replaces": "tsl_sdr_tpu/ops/costas.py:94",
                     "max_abs_err": err, **k6_t}
    return res


# -- phase 19: the mesh and multi-process paths on the one card -------------

MESH_SHAPES = ((1, 1), (2, 2), (4, 1), (1, 8))


def card_mesh(shape):
    """A (time, channels) mesh whose every entry is cuda:0."""
    import torch

    from tsl_sdr_tpu_torch.parallel.mesh import make_mesh

    t, c = shape
    return make_mesh(t, c, devices=[torch.device("cuda", 0)] * (t * c))


def mesh_channelizer(iq, totals: dict) -> dict:
    """(a) ``make_sharded_multifm`` at the pager's plan on the pager block
    over MESH_SHAPES and at BENCH_SUITE's 64-channel bank on (2, 2): each
    equal to the (1, 1) mesh (one K1 launch over the whole capture) and,
    from output 1 on, to the primed streaming chain; K1 launched once a
    (time span, channel shard)."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.parallel.channelizer import make_sharded_multifm
    from tsl_sdr_tpu_torch.testing import pager

    cases = [("pager", MultifmChain(pager.lpf_taps(), pager.OFFSETS_HZ,
                                    pager.FS, pager.DECIMATION,
                                    device="cuda"),
              iq[:4_177_920], MESH_SHAPES)]
    lpf, offs, fs, decim = bench_bank(64)
    wide = np.random.default_rng(19).integers(
        -9000, 9000, size=(WIDE_BLOCK, 2), dtype=np.int64).astype(np.int16)
    cases.append(("64 channels", MultifmChain(lpf, offs, fs, decim,
                                              device="cuda"),
                  wide, ((1, 1), (2, 2))))
    res = {}

    def run():
        for name, chain, x, shapes in cases:
            c_len, q = chain.carry_len, chain.block_quantum
            _, stream = chain.step(chain.init_state(prefix=x[:c_len]),
                                   x[c_len:][: (len(x) - c_len) // q * q])
            outs = {}
            for shape in shapes:
                before = k1.chain_fm.launches
                outs[shape] = make_sharded_multifm(
                    chain.packed_plan, card_mesh(shape))(x)
                torch.cuda.synchronize()
                n = k1.chain_fm.launches - before
                require(n == shape[0] * shape[1],
                        f"sharded channelizer {name} {shape}: {n} K1 "
                        f"launches")
            ref = outs[(1, 1)]
            k = stream.shape[1]
            require(torch.equal(ref[:, 1:k], stream[:, 1:]),
                    f"sharded channelizer {name}: the (1, 1) mesh differs "
                    f"from the streaming chain")
            for shape, out in outs.items():
                require(torch.equal(out, ref),
                        f"sharded channelizer {name} {shape}: max |diff| "
                        f"{max_err(out, ref)} from the (1, 1) mesh")
            res[name] = [list(s) for s in shapes]
            log(f"sharded channelizer {name} ({len(x)} samples, "
                f"{chain.nr_channels} channels, body "
                f"{chain.taps.body}): meshes {res[name]} == one K1 launch "
                f"over the capture, exactly")

    on_path("the sharded channelizer", ("chain_fm",), run, totals)
    return res


def mesh_resampler(totals: dict) -> dict:
    """(b) ``make_sharded_resampler`` at 16/25 over 4 time shards, on a
    packed-row length (K3 a shard) and a residue length (K4 a shard):
    each equal to the single-device streaming run exactly."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.parallel.resampler import make_sharded_resampler
    from tsl_sdr_tpu_torch.utils.filter_design import (
        design_rational_resampler_filter)

    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(design_rational_resampler_filter(16, 25, 0.4)),
        16, 25, block_out_target=1024)
    taps = polyphase.plan_taps(plan, device="cuda")
    n_row = 4 * plan.row_in * 1_500
    lengths = {"packed-row": n_row, "residue": n_row + 4 * plan.d_rep}
    x = np.random.default_rng(25).integers(
        -12000, 12000, size=lengths["residue"], dtype=np.int64).astype(
        np.int16)

    def single(xx):
        st = polyphase.init_resampler_carry(
            plan, 1, device="cuda", prefix=xx[:plan.carry_len])
        xp = torch.from_numpy(np.concatenate(
            [xx, np.zeros(plan.block_in, np.int16)])).cuda()
        outs, pos = [], plan.carry_len
        while pos + plan.block_in <= xp.numel():
            st, o = polyphase.resample_step(
                plan, st, xp[None, pos:pos + plan.block_in], taps)
            outs.append(o[0])
            pos += plan.block_in
        return torch.cat(outs)

    fn = make_sharded_resampler(plan, card_mesh((4, 1)))

    def run():
        for name, n in lengths.items():
            got = fn(x[:n])
            want = single(x[:n])[:got.numel()]
            require(got.numel() == n * 16 // 25 and torch.equal(got, want),
                    f"sharded resampler {name}: max |diff| "
                    f"{max_err(got, want)}")
            log(f"sharded resampler 16/25, {name} length {n} over 4 shards "
                f"== the single-device run, exactly")

    on_path("the sharded resampler", ("row_resample", "frame_resample"),
            run, totals)
    return {k: int(v) for k, v in lengths.items()}


def check_span_resamplers(pipe, seen: set) -> int:
    """K3 and K4 against their plain versions at every resampler program
    ``pipe`` built (on a mesh: each time span's length and each channel
    shard's ratio group), on the group's carry and block shapes, random
    and adversarial input (-32768 against +-32767 taps), f32 and q14:
    exactly equal. Shapes in ``seen`` are skipped; returns how many were
    checked."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    rng = np.random.default_rng(19)
    n = 0
    for prog in list(pipe._programs.values()):
        dev = prog.bank.device
        for gid, idxs in prog.bank.rs_groups.items():
            plan, taps = prog.plans[gid], prog.rs_taps[gid]
            key = (gid, len(idxs), plan.block_in, str(dev))
            if key in seen:
                continue
            seen.add(key)
            shape_c, shape_b = (len(idxs), plan.carry_len), \
                (len(idxs), plan.block_in)
            if plan.k_row:
                name = "K3"
                adv = adversarial_row_taps(plan, dev)

                def both(c, b, tp, out):
                    return (k3.row_resample(c, b, tp, row_in=plan.row_in,
                                            out=out),
                            k3.row_resample_plain(c, b, tp,
                                                  row_in=plan.row_in,
                                                  out=out))
            else:
                name = "K4"
                w = np.where(rng.random(plan.w_frames_i16.shape) < 0.5,
                             -32767, 32767).astype(np.int16)
                adv = k4.frame_taps_of(w, plan.d_rep, device=dev)
                frames = plan.block_out // plan.i_rep

                def both(c, b, tp, out):
                    return (k4.frame_resample(c, b, tp, frames=frames,
                                              out=out),
                            k4.frame_resample_plain(c, b, tp, frames=frames,
                                                    out=out))
            cases = (
                ("random",
                 torch.from_numpy(rng.integers(-32768, 32767, size=shape_c)
                                  .astype(np.int16)).to(dev),
                 torch.from_numpy(rng.integers(-32768, 32767, size=shape_b)
                                  .astype(np.int16)).to(dev), taps),
                ("adversarial",
                 torch.full(shape_c, -32768, dtype=torch.int16, device=dev),
                 torch.full(shape_b, -32768, dtype=torch.int16, device=dev),
                 adv))
            for kind, c, b, tp in cases:
                for out in ("f32", "q14"):
                    got, ref = both(c, b, tp, out)
                    require(torch.equal(got, ref),
                            f"{name} {gid[0]}/{gid[1]} at a span program "
                            f"[{len(idxs)}, {plan.block_in}] ({kind}, "
                            f"{out}): max |diff| {max_err(got, ref)}")
            n += 1
            log(f"{name} {gid[0]}/{gid[1]} at a span program: carry "
                f"{list(shape_c)} block {list(shape_b)} -> "
                f"{plan.block_out} a row, random and adversarial, f32 and "
                f"q14 == its plain version, exactly")
    return n


def mesh_pipelines(pager, iq, expected, totals: dict) -> dict:
    """(c) ``ReceivePipeline(mesh=)`` at the pager deployment (phase 4's
    capture as rtl_u8, push/flush) on MESH_SHAPES: phase 4's messages with
    the ``fetched`` counters of the run without a mesh, K1 launched
    blocks x time spans x channel shards times; the same with the two FLEX
    channels as ``pcm`` (the DC-blocked one included) on (2, 2) and (4, 1):
    PCM equal to the run without a mesh; the decimation-50 band on (2, 1):
    every burst. Each pipeline's K3 and K4 are then held against their
    plain versions at every span program it built."""
    import numpy as np

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    specs = pager.channel_specs(ChannelSpec)
    want = sorted((s.center_freq_hz, cap, text)
                  for s, exp in zip(specs, expected) for cap, text in exp)
    flat = pager.to_rtl_u8(iq).reshape(-1)

    def run(specs, shape):
        pipe = ReceivePipeline(
            pager.lpf_taps(), pager.CENTER_HZ, pager.FS, pager.DECIMATION,
            specs, wire_fmt="rtl_u8", device="cuda",
            mesh=None if shape is None else card_mesh(shape))
        step = pipe.block_size * 2 // 3 + 1234
        results = [[] for _ in specs]
        for lo in range(0, flat.size, step):
            for i, part in enumerate(pipe.push(flat[lo:lo + step])):
                results[i].extend(part)
        for i, part in enumerate(pipe.flush()):
            results[i].extend(part)
        return results, pipe.stream_stats, launch_counts(), pipe

    res = {}
    seen = set()
    base, base_st, _, _ = on_path("the pager pipeline without a mesh",
                                  ("chain_fm", "row_resample"),
                                  lambda: run(specs, None), totals)
    require(sorted(message_keys(base, specs)) == want,
            "the pager pipeline without a mesh lost a burst")
    for shape in MESH_SHAPES:
        out, st, counts, pipe = on_path(
            f"the pager pipeline on a {shape} mesh",
            ("chain_fm", "row_resample"), lambda: run(specs, shape), totals)
        n_rs = check_span_resamplers(pipe, seen)
        got = sorted(message_keys(out, specs))
        require(got == want, f"mesh {shape} decoded {got}, expected {want}")
        require(np.array_equal(st["fetched"], base_st["fetched"]),
                f"mesh {shape}: fetched {st['fetched']} != "
                f"{base_st['fetched']}")
        k1_want = st["blocks"] * shape[0] * shape[1]
        require(counts["chain_fm"] == k1_want,
                f"mesh {shape}: {counts['chain_fm']} K1 launches, want "
                f"{k1_want}")
        res[str(shape)] = {"blocks": st["blocks"], "k1": counts["chain_fm"],
                           "halo_bytes": st["halo_bytes"],
                           "resampler_shapes_checked": n_rs}
        log(f"pager pipeline on a {shape} mesh of cuda:0: {len(got)} "
            f"messages == phase 4's, fetched {st['fetched'].tolist()} == "
            f"without a mesh, K1 launches {counts['chain_fm']} = "
            f"{st['blocks']} blocks x {shape[0] * shape[1]}, halo "
            f"{st['halo_bytes']} B")

    pcm_specs = [ChannelSpec(s.center_freq_hz, "pcm", dc_block=s.dc_block)
                 if s.protocol == "flex" else s for s in specs]
    pcm_base, _, _, _ = run(pcm_specs, None)
    for shape in ((2, 2), (4, 1)):
        # pcm channels take no resampler: K1 alone on this path
        out, _, _, _ = on_path(f"the pager pipeline with pcm channels on a "
                            f"{shape} mesh", ("chain_fm",),
                            lambda: run(pcm_specs, shape), totals)
        for i, spec in enumerate(pcm_specs):
            if spec.protocol != "pcm":
                continue
            a, b = np.concatenate(out[i]), np.concatenate(pcm_base[i])
            require(a.shape == b.shape and np.array_equal(a, b),
                    f"mesh {shape} pcm channel {i} "
                    f"(dc_block={spec.dc_block}): max |diff| "
                    f"{np.abs(a.astype(np.int32) - b).max()}")
        log(f"pager pcm channels on a {shape} mesh (one DC-blocked): "
            f"{b.size} samples each == without a mesh, exactly")

    dspecs = pager.dec50_channel_specs(ChannelSpec)
    starts = [200_000 + k * 1_300_000 for k in range(len(dspecs))]

    def dec50(shape):
        pipe = ReceivePipeline(pager.dec50_lpf_taps(), pager.CENTER_HZ,
                               pager.FS, pager.DEC50_DECIMATION, dspecs,
                               device="cuda",
                               mesh=None if shape is None else
                               card_mesh(shape))
        cap, exp = pager.capture(2 * pipe.block_size + TAIL_SAMPLES, starts,
                                 seed=8)
        got = [(f, c, t.rstrip("\0")) for f, c, t in
               sorted(message_keys(pipe.process_capture(cap), dspecs))]
        want = sorted((s.center_freq_hz, c, t)
                      for s, e in zip(dspecs, exp) for c, t in e)
        require(got == want, f"decimation 50 on {shape} decoded {got}")
        return pipe.stream_stats, pipe

    st0, _ = dec50(None)
    st, pipe = on_path("the decimation-50 pipeline on a (2, 1) mesh",
                       ("chain_fm", "frame_resample"),
                       lambda: dec50((2, 1)), totals)
    n_rs = check_span_resamplers(pipe, seen)
    require(n_rs > 0, "decimation 50 on (2, 1): no K4 span program")
    require(np.array_equal(st["fetched"], st0["fetched"]),
            f"decimation 50 on (2, 1): fetched {st['fetched']} != "
            f"{st0['fetched']}")
    log(f"decimation-50 band on a (2, 1) mesh: every burst, "
        f"{st['blocks']} blocks, fetched {st['fetched'].tolist()} == "
        f"without a mesh")
    res["dec50 (2, 1)"] = {"blocks": st["blocks"],
                           "resampler_shapes_checked": n_rs}
    return res


def mesh_cli(pager, iq, expected, tmp: Path) -> dict:
    """(d) ``pipeline-torch --time-shards 2`` on one card exits 2 with the
    device-count message; (e) ``pipeline-torch --distributed`` over two
    processes on cuda:0 (gloo): rank 0 writes phase 4's messages, rank 1
    nothing; each rank's upload and halo bytes a block."""
    import socket

    import torch

    from tsl_sdr_tpu_torch.cli import pipeline as cli
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec

    cap_path = tmp / "capture.cs16"
    iq.reshape(-1).tofile(cap_path)
    cfg_path = tmp / "pager8.json"
    cfg_path.write_text(json.dumps(pager.config(str(cap_path))))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([str(cfg_path), "--time-shards", "2",
                       "--device", "cuda"])
    n = torch.cuda.device_count()
    msg = (f"pipeline-torch: --time-shards 2 x --channel-shards 1 needs 2 "
           f"devices, have {n}")
    require(rc == 2 and err.getvalue().strip() == msg,
            f"--time-shards 2 on {n} card(s): rc {rc}, {err.getvalue()!r}")
    log(f"(d) pipeline-torch --time-shards 2: exit 2, {msg!r}")

    specs = pager.channel_specs(ChannelSpec)
    want = sorted((s.center_freq_hz, cap, text)
                  for s, exp in zip(specs, expected) for cap, text in exp)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in BLOCKED)
            + f"sys.path.insert(0, {str(HERE)!r})\n"
            "from tsl_sdr_tpu_torch.cli import pipeline\n"
            "sys.exit(pipeline.main(sys.argv[1:]))\n")
    outs = {r: tmp / f"dist{r}.jsonl" for r in (0, 1)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(cfg_path), "--iq-file",
         str(cap_path), "--iq-format", "cs16", "-o", str(outs[r]),
         "--device", "cuda", "--distributed", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    for r, proc in enumerate(procs):
        require(proc.returncode == 0,
                f"--distributed rank {r} exited {proc.returncode}: "
                f"{logs[r][-3000:]}")
    lines = [json.loads(x) for x in outs[0].read_text().splitlines()]
    got = sorted((m["freqHz"], m["capCode"], m["message"]) for m in lines)
    require(got == want, f"--distributed rank 0 wrote {got}")
    require(not outs[1].exists(), "--distributed rank 1 wrote messages")
    ranks = {}
    for r, text in enumerate(logs):
        m = re.search(r"process (\d) of 2: blocks=(\d+) upload_bytes=(\d+) "
                      r"halo_bytes=(\d+)", text)
        require(m is not None and int(m.group(1)) == r,
                f"--distributed rank {r} printed no stats: {text[-2000:]}")
        blocks, up, halo = map(int, m.group(2, 3, 4))
        ranks[r] = {"blocks": blocks, "upload_bytes": up,
                    "halo_bytes": halo,
                    "upload_bytes_per_block": up / blocks,
                    "halo_bytes_per_block": halo / blocks}
    log(f"(e) pipeline-torch --distributed, 2 processes on cuda:0 (gloo): "
        f"rank 0 wrote phase 4's {len(got)} messages, rank 1 none, in "
        f"{wall:.1f} s; per rank {json.dumps(ranks)}")
    return {"wall_s": wall, "ranks": ranks}


def mesh_walls(pager, iq, trials: int = 6) -> dict:
    """(f) Wall time a block of the pager pipeline (phase 4's capture as
    rtl_u8, ``process_capture``) without a mesh, on (1, 1) and on (2, 2)
    of cuda:0, in turns (none, (1, 1), (2, 2), (2, 2), (1, 1), none, ...):
    the sharding's overhead on one card, not a scaling figure."""
    import numpy as np

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    flat = pager.to_rtl_u8(iq).reshape(-1)
    pipes = {}
    for name, shape in (("no mesh", None), ("(1, 1)", (1, 1)),
                        ("(2, 2)", (2, 2))):
        pipes[name] = ReceivePipeline(
            pager.lpf_taps(), pager.CENTER_HZ, pager.FS, pager.DECIMATION,
            pager.channel_specs(ChannelSpec), wire_fmt="rtl_u8",
            device="cuda", mesh=None if shape is None else card_mesh(shape))
        pipes[name].warm_device()
    order = list(pipes)
    walls = {name: [] for name in pipes}
    for k in range(trials):
        for name in (order if k % 2 == 0 else order[::-1]):
            pipe = pipes[name]
            t0 = time.perf_counter()
            pipe.process_capture(flat)
            _sync("cuda")
            walls[name].append((time.perf_counter() - t0) * 1e3
                               / pipe.stream_stats["blocks"])
    return {name: {"median_ms": float(np.median(w)), "min_ms": min(w),
                   "max_ms": max(w), "trials_ms": [round(x, 3) for x in w]}
            for name, w in walls.items()}


def mesh_phase(pager, iq, expected, totals: dict) -> dict:
    """Phase 19: the mesh and multi-process paths on the one card."""
    res = {"channelizer": mesh_channelizer(iq, totals),
           "resampler": mesh_resampler(totals),
           "pipelines": mesh_pipelines(pager, iq, expected, totals)}
    with tempfile.TemporaryDirectory() as tmp:
        res["distributed"] = mesh_cli(pager, iq, expected, Path(tmp))
    res["walls"] = mesh_walls(pager, iq)
    return res


def smoke(device: str) -> dict:
    """Phases 2-19 on ``device``; returns the kernels' summary."""
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
        fir_macs(plan, rows),
        nbytes(carry, block, taps.w_hi, taps.w_lo, taps.omega_row, prev)
        + 2 * rows * plan.halfcols + nbytes(prev))
    log(f"K1 pipeline block ({rows} rows): kernel {k1_t['ms']:.4f} ms (call "
        f"{k1_t['call_ms']:.4f}), plain {k1_t['plain_ms']:.4f} ms, bound "
        f"{k1_t['bound_ms']:.5f} ms ({k1_t['bound_by']}), "
        f"{k1_t['bound_ms'] / k1_t['ms']:.1%} of it")
    k3_times = time_k3(k3_args)
    # the engine's whole step of one block (its upload and every device
    # stage, K1 and K3 included): back-to-back steps, so it is the larger
    # of device time and host time
    pipe._stream_init(iq[: plan.carry_len])
    st = pipe._stream["st"]
    flat = iq[plan.carry_len: plan.carry_len + pipe.block_size].reshape(-1)
    run["step_ms"] = time_ms(
        lambda: pipe._engine.step(st, flat, pipe._stream), 10)
    pipe.stream_reset()
    del vals, carry, block

    # phase 12: live streaming through pipeline-torch --follow
    with tempfile.TemporaryDirectory() as tmp:
        live = live_runs(pager, iq, expected, device, Path(tmp), totals,
                         pipe.block_size, plan.carry_len)
    exact = exact_phases(pipe, iq, expected, device, totals)
    mesh = mesh_phase(pager, iq, expected, totals)
    del iq
    wide = wide_phase(device, totals)
    wide_k = wide["kernels"]

    front = front_end(device, totals)
    costas = costas_phase(device, totals)
    k3_f32 = k3_times["pipeline 5/12"]
    k3_q14 = k3_times["192/125 decoder step"]
    return {
        "run": run,
        "live": live,
        "exact": exact,
        "wide": wide,
        "front": front["runs"],
        "k3": k3_times,
        "k4": front["k4"],
        "costas": costas,
        "mesh": mesh,
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
            exact["kernel"],
            {"name": "chain_fm_bank", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/bank.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_chain.py:279",
             "max_abs_err": wide_k["err"], **wide_k[64]["chain_fm"]},
            {"name": "chain_fm_grouped", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/bank.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_chain.py:167",
             "max_abs_err": wide_k["err"], **wide_k[256]["chain_fm"]},
            {"name": "exact_fir_grouped", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/bank.cu",
             "replaces": "tsl_sdr_tpu/ops/packed_fir.py:286",
             "max_abs_err": wide_k["err"], **wide_k[256]["exact_fir_raw"]},
            costas["kernel"],
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
    check_k4_sass(sass_by_kernel())
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
    log(f"{card} | engine step (the upload and all device stages of one "
        f"block, back to back): "
        f"{run['step_ms']:.3f} ms per block")
    live = summary["live"]
    for r in live["fifo"]:
        log(f"{card} | live FIFO, {r['drain']} drain: {r['blocks']} blocks "
            f"in {r['wall_s']:.4f} s = {r['ms_per_block']:.2f} ms/block, "
            f"{r['msps']:.1f} Msps; host-blocked s {json.dumps(r['timing'])}")
    legs = live["resume"]["legs"]
    log(f"{card} | live kill/resume: checkpoint {legs[0]['bytes']} B, saved "
        f"in {legs[0]['save_s']:.3f} s, restored in "
        f"{legs[1]['restore_s']:.3f} s")
    log(f"{card} | live mock RTL-SDR: {live['rtl']['wall_s']:.3f} s")
    lat = live["latency"]
    log(f"{card} | live --realtime latency s by channel {lat['delays_s']}, "
        f"max {lat['max_s']:.3f} (limit {lat['limit_s']:.2f})")
    front = summary["front"]
    log(f"{card} | decoder-torch wall s (60 s of audio each): "
        f"{json.dumps(front['decoder_s'])}")
    log(f"{card} | resampler-torch 147/160 wall s (20 s of 48 kHz): "
        f"{json.dumps(front['resampler_s'])}")
    log(f"{card} | pipeline at decimation 50: {front['dec50_s']:.3f} s")
    exact = summary["exact"]
    for name in ("exact_pager", "exact_dec50"):
        for tag, r in exact[name].items():
            log(f"{card} | {name} ({tag}): {json.dumps(r)}")
    log(f"{card} | exact tier's rotator a pager block: "
        f"{json.dumps(exact['rotator'])}")
    log(f"{card} | AIS capture walls s: {json.dumps(exact['ais'])}")
    for tag, r in exact["multifm"].items():
        log(f"{card} | multifm-torch {tag}: {json.dumps(r)}")
    for tier, r in summary["wide"]["multifm"].items():
        log(f"{card} | multifm-torch 232 channels {tier}: {json.dumps(r)}")
    for tier, r in summary["wide"]["multifm_bank"].items():
        log(f"{card} | multifm-torch 64 channels (bank body) {tier}: "
            f"{json.dumps(r)}")
    for nr_ch in WIDE_CHANNELS:
        for name, r in summary["wide"]["kernels"][nr_ch].items():
            log(f"{card} | {name} at {nr_ch} channels: {json.dumps(r)}")
    costas = summary["costas"]
    log(f"{card} | Costas chain ({costas['chain']['block']}-sample blocks, "
        f"8 channels): median {costas['chain']['median_ms']:.3f} ms a block, "
        f"{costas['chain']['msps']:.1f} Msps wideband; trials ms "
        f"{costas['chain']['trials_ms']}")
    log(f"{card} | Costas native path: {json.dumps(costas['native'])}")
    log(f"{card} | Costas lock (re/im power, mean |re|) by channel: "
        f"{json.dumps(costas['lock'])}")
    log(f"{card} | K6 slice block: {json.dumps(costas['k6'])}")
    mesh = summary["mesh"]
    for name, w in mesh["walls"].items():
        log(f"{card} | pager pipeline ms a block, {name} (cuda:0 only; "
            f"the sharding's overhead, no scaling): median "
            f"{w['median_ms']:.3f}, min {w['min_ms']:.3f}, max "
            f"{w['max_ms']:.3f}; trials {w['trials_ms']}")
    for r, st in mesh["distributed"]["ranks"].items():
        log(f"{card} | --distributed rank {r}: "
            f"{st['upload_bytes_per_block']:.0f} upload B a block, "
            f"{st['halo_bytes_per_block']:.0f} halo B a block "
            f"({st['blocks']} blocks)")
    log(f"{card} | mesh pipelines: {json.dumps(mesh['pipelines'])}")
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
