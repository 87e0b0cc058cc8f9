#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port, ``tsl_sdr_tpu_torch``.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``tsl_sdr_tpu_torch/csrc`` and drives
the port's receive pipeline at the 8-channel pager deployment
(``tsl_sdr_tpu_torch/testing/pager.py``: 1.2288 Msps, decimate by 32, 577
taps, 6 POCSAG + 2 FLEX channels, 4,177,920-sample blocks):

1. the card's name and power limit; the kernels' build;
2. K1 (fused channelizer + FM, ``csrc/chain.cu``) against its plain torch
   version at the pipeline's block shape (65,280 rows, ragged last tile)
   and at a tile-aligned block: max |diff| <= 1 PCM LSB and >= 99.9 %
   exactly equal; the block run as two halves must equal the whole;
3. K3 (packed-row resampler, ``csrc/row_resampler.cu``) against its plain
   version at [2 channels, 85 rows x 1536] -> [2, 85, 640] plus spill:
   exactly equal;
4. the deployment end to end on a synthetic capture (one burst per
   channel, three full blocks and a ragged tail): cs16 through the
   ``pipeline-torch`` CLI, then the same capture as rtl_u8 wire bytes
   through ``ReceivePipeline.push/flush``; every burst must decode, both
   runs must agree, and both kernels must have launched;
5. wall time per block, wideband Msps, and each kernel's time beside its
   plain version's (CUDA events, after warm-up).

jax is made unimportable first, so the run also proves that the port needs
none. Any failed check raises and the exit code is non-zero. The last two lines
are the kernels' JSON summary and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_FULL_BLOCKS = 3
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


def in_turns(plain, kernel, reps_plain: int, reps_kernel: int):
    """Plain, kernel, kernel, plain; mean of each version's two runs."""
    p0 = time_ms(plain, reps_plain)
    k0 = time_ms(kernel, reps_kernel)
    k1 = time_ms(kernel, reps_kernel)
    p1 = time_ms(plain, reps_plain)
    return (k0 + k1) / 2, (p0 + p1) / 2


def make_capture(pager, block_size: int):
    """Three full blocks plus a ragged tail; bursts staggered so several
    straddle block boundaries."""
    n = N_FULL_BLOCKS * block_size + TAIL_SAMPLES
    starts = [2_000_000 + k * 1_500_000 for k in range(6)]
    starts += [200_000, starts[-1] + 800_000]
    return pager.capture(n, starts, seed=7)


def check_chain(pipe, iq, device):
    """Phase 2: K1 vs its plain version at the pipeline's shapes."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import chain as k1

    taps = pipe.chain.taps
    plan = taps.plan
    c_len = plan.carry_len
    rows_full = pipe.block_size * 2 // plan.row
    rows_aligned = taps.tile_rows * 256
    rng = np.random.default_rng(11)
    noise = rng.integers(-9000, 9000, size=(rows_aligned * plan.row,),
                         dtype=np.int64).astype(np.int16)
    cases = {
        "pipeline block (ragged last tile)":
            iq[: c_len + pipe.block_size].reshape(-1),
        "tile-aligned block": np.concatenate(
            [iq[:c_len].reshape(-1), noise]),
    }
    log(f"K1 shapes: ROW={plan.row} cr={plan.cr_rows} U={plan.win} "
        f"halfcols={plan.halfcols} tile_rows={taps.tile_rows}; "
        f"{rows_full} rows per pipeline block "
        f"(last tile {rows_full % taps.tile_rows} rows)")
    worst = 0
    prev0 = torch.zeros((2, plan.nr_channels), dtype=torch.float32,
                        device=device)
    for name, vals in cases.items():
        vals = torch.from_numpy(vals.copy()).to(device)
        carry, block = vals[: plan.carry_vals], vals[plan.carry_vals:]
        got, gprev = k1.chain_fm(taps, carry, prev0, block)
        ref, rprev = k1.chain_fm_plain(taps, carry, prev0, block)
        d = pcm_diff(got.cpu().numpy(), ref.cpu().numpy())
        exact = float((d == 0).mean())
        log(f"K1 vs plain, {name}: rows={got.shape[0]} "
            f"max|diff|={int(d.max())} LSB, exact={exact:.6f}")
        require(d.max() <= 1, f"K1 {name}: max diff {d.max()} > 1 LSB")
        require(exact >= 0.999, f"K1 {name}: only {exact:.6f} exact")
        require(torch.equal(gprev, rprev), f"K1 {name}: FM carry differs")
        worst = max(worst, int(d.max()))
        # block-boundary invariance: the same block as two halves
        half = (block.numel() // plan.row // 2) * plan.row
        a, p_a = k1.chain_fm(taps, carry, prev0, block[:half])
        b, p_b = k1.chain_fm(taps, block[half - plan.carry_vals:half]
                             .contiguous(), p_a, block[half:])
        require(torch.equal(torch.cat([a, b]), got)
                and torch.equal(p_b, gprev),
                f"K1 {name}: two halves differ from the whole block")
        log(f"K1 {name}: two halves == whole block")
    return worst


def check_resampler(pipe, device):
    """Phase 3: K3 vs its plain version at the FLEX group's shapes."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    prog = pipe._program(pipe.block_size)
    (gid, idxs), = pipe._rs_groups.items()
    plan, taps = prog.plans[gid], prog.rs_taps[gid]
    rng = np.random.default_rng(12)
    g = len(idxs)
    carry = torch.from_numpy(rng.integers(
        -12000, 12000, size=(g, plan.carry_len)).astype(np.int16)).to(device)
    block = torch.from_numpy(rng.integers(
        -12000, 12000, size=(g, plan.block_in)).astype(np.int16)).to(device)
    got = k3.row_resample(carry, block, taps.w0, taps.w1, row_in=plan.row_in)
    ref = k3.row_resample_plain(carry, block, taps.w0, taps.w1,
                                row_in=plan.row_in)
    err = float((got - ref).abs().max())
    log(f"K3 vs plain: ratio {gid[0]}/{gid[1]} carry {list(carry.shape)} "
        f"block {list(block.shape)} w0 {list(taps.w0.shape)} "
        f"w1 {list(taps.w1.shape)} -> {list(got.shape)}: max|diff|={err}")
    require(torch.equal(got, ref), "K3 differs from its plain version")
    return (carry, block, taps, plan.row_in), err


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
    t0 = time.perf_counter()
    rc = cli.main([str(cfg_path), "--iq-file", str(cap_path),
                   "--iq-format", "cs16", "-o", str(out_path),
                   "--device", device])
    cli_s = time.perf_counter() - t0
    require(rc == 0, f"pipeline-torch exited {rc}")
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
    tier = "native" if pipe._decoders[0]._nat is not None else "numpy"
    log(f"rtl_u8 via push/flush: {len(got_push)} messages == cs16 run; "
        f"warm_device {warm_s:.3f} s; decoder tier: {tier}")
    timing = {k: round(v, 6) for k, v in sorted(pipe.timing.items())}
    return {"blocks": blocks, "wall_s": wall, "samples": iq.shape[0],
            "cli_s": cli_s, "tier": tier, "timing": timing}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def smoke(device: str = "cuda") -> dict:
    """Phases 2-5 on ``device``; returns the kernels' summary."""
    import torch

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import row_resampler as k3
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
    k3_args, k3_err = check_resampler(pipe, device)

    k1.chain_fm.launches = 0
    k3.row_resample.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        run = run_main_path(pager, iq, expected, device, Path(tmp))
    launches = {"chain_fm": k1.chain_fm.launches,
                "row_resample": k3.row_resample.launches}
    log(f"launches in the main-path run: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")

    # phase 5: kernel times at the main path's shapes
    taps = pipe.chain.taps
    vals = torch.from_numpy(
        iq[: taps.plan.carry_len + pipe.block_size].reshape(-1).copy()
    ).to(device)
    carry, block = vals[: taps.plan.carry_vals], vals[taps.plan.carry_vals:]
    prev = torch.zeros((2, taps.plan.nr_channels), dtype=torch.float32,
                       device=device)
    k1_ms, k1_plain_ms = in_turns(
        lambda: k1.chain_fm_plain(taps, carry, prev, block),
        lambda: k1.chain_fm(taps, carry, prev, block), 5, 20)
    rc, rb, rt, row_in = k3_args
    k3_ms, k3_plain_ms = in_turns(
        lambda: k3.row_resample_plain(rc, rb, rt.w0, rt.w1, row_in=row_in),
        lambda: k3.row_resample(rc, rb, rt.w0, rt.w1, row_in=row_in), 20, 50)
    # the whole device step of one block (every stage, K1 and K3 included):
    # back-to-back steps, so it is the larger of device time and host
    # enqueue time
    pipe._stream_init(iq[: taps.plan.carry_len])
    prog = pipe._program(pipe.block_size)
    st = pipe._stream["st"]
    run["step_ms"] = time_ms(lambda: prog.dev_step(st, block), 10)
    pipe.stream_reset()
    return {
        "run": run,
        "kernels": [
            {"name": "chain_fm", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/chain.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_chain.py:279",
             "launches": launches["chain_fm"], "max_abs_err": k1_err,
             "ms": k1_ms, "plain_ms": k1_plain_ms},
            {"name": "row_resample", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/row_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_resampler.py:119",
             "launches": launches["row_resample"], "max_abs_err": k3_err,
             "ms": k3_ms, "plain_ms": k3_plain_ms},
        ],
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
    # The port must run where jax is absent. The JAX package's native
    # decoder loader (tsl_sdr_tpu/runtime/__init__.py) imports jax where it
    # is installed, so block jax here: the decoders run their numpy tiers.
    for name in ("jax", "jaxlib"):
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

    summary = smoke("cuda")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib")
                    and sys.modules[m] is not None)
    require(not loaded, f"jax modules were imported: {loaded}")
    run = summary["run"]
    per_block = run["wall_s"] / run["blocks"]
    log(f"{card} | main path (rtl_u8 push/flush): {run['blocks']} blocks "
        f"in {run['wall_s']:.3f} s = {per_block * 1e3:.1f} ms/block, "
        f"{run['samples'] / run['wall_s'] / 1e6:.1f} Msps wideband; "
        f"cs16 CLI run {run['cli_s']:.3f} s; decoder tier {run['tier']}")
    log(f"{card} | host-blocked seconds by phase: {json.dumps(run['timing'])}")
    log(f"{card} | device step (all stages of one block, back to back): "
        f"{run['step_ms']:.3f} ms per block")
    for k in summary["kernels"]:
        log(f"{card} | {k['name']}: kernel {k['ms']:.3f} ms, plain "
            f"{k['plain_ms']:.3f} ms per block")
    print(json.dumps({"kernels": summary["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
