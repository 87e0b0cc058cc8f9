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
   plain version's (CUDA events, after warm-up);
6. K4 (frame-form resampler, ``csrc/frame_resampler.cu``) against its plain
   version, f32 and q14 outputs, exactly equal: ``resample_capture`` at
   147/160 (5,253 taps) over 60 s of 48 kHz PCM, and the streaming step at
   the decimation-50 pipeline's 25/16 group shape;
7. K3's exact (q14) epilogue against its plain version at the 192/125 plan
   of ``etc/pocsag_38400_from_25k.json`` (6,303 taps): exactly equal;
8. the exact DC blocker (``csrc/dc_blocker.cu``) against its plain version
   over 1.5 M samples in blocks, state carried: exactly equal;
9. ``decoder-torch`` on 60 s of channel audio with 6 bursts each: FLEX
   ``-I 16 -D 25 -F etc/flex_16_25.json``, POCSAG ``-I 192 -D 125 -F
   etc/pocsag_38400_from_25k.json -b`` (exact DC), and POCSAG from 24,576
   Hz ``-I 25 -D 16`` (frame form); every burst must decode;
10. ``resampler-torch -I 147 -D 160``, exact and ``--fast``: the output
   file must equal, byte for byte, the same run with ``--device cpu``;
11. the pipeline at decimation 50 (six 24,576 Hz POCSAG channels, one 25/16
   group): every burst must decode;
12. the new kernels' times beside their plain versions' at the shapes of
   those paths.

Each path of phases 4, 9, 10 and 11 runs with the kernels' launch counts
set to 0 just before it and read just after; a kernel of the path that
never launched fails the run. jax is made unimportable first, so the run
also proves that the port needs none. Any failed check raises and the exit
code is non-zero. The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
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


def max_err(got, ref) -> float:
    """max |got - ref| over two tensors of one shape, on the host."""
    return float((got.cpu().double() - ref.cpu().double()).abs().max())


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


def check_frame_resampler(device):
    """Phase 6: K4 vs its plain version, f32 and q14 outputs: the 147/160
    capture entry over 60 s of 48 kHz PCM, and the streaming step at the
    decimation-50 pipeline's 25/16 group shape."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.testing import channel_audio, pager

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

    pipe = ReceivePipeline(pager.dec50_lpf_taps(), pager.CENTER_HZ, pager.FS,
                           pager.DEC50_DECIMATION,
                           pager.dec50_channel_specs(ChannelSpec),
                           device=device)
    prog = pipe._program(pipe.block_size)
    (gid, idxs), = pipe._rs_groups.items()
    splan, staps = prog.plans[gid], prog.rs_taps[gid]
    require(gid == (25, 16) and splan.k_row == 0,
            f"decimation 50 should give one frame-form 25/16 group: {gid}")
    g = len(idxs)
    carry = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, splan.carry_len)).astype(np.int16)).to(device)
    block = torch.from_numpy(rng.integers(
        -32768, 32767, size=(g, splan.block_in)).astype(np.int16)).to(device)
    frames = splan.block_out // splan.i_rep
    for out in ("f32", "q14"):
        got = k4.frame_resample(carry, block, staps, frames=frames, out=out)
        ref = k4.frame_resample_plain(carry, block, staps, frames=frames,
                                      out=out)
        log(f"K4 vs plain, pipeline step 25/16: carry {list(carry.shape)} "
            f"block {list(block.shape)} -> {list(got.shape)} {out}: "
            f"max|diff|={max_err(got, ref)}")
        require(torch.equal(got, ref), f"K4 step ({out}) differs")
        worst = max(worst, max_err(got, ref))
    step = {"carry": carry, "block": block, "taps": staps, "frames": frames}
    return cap, step, worst


def check_row_q14(device):
    """Phase 7: K3's q14 epilogue vs plain at the 192/125 plan of
    etc/pocsag_38400_from_25k.json: the decoder's step shape and a long
    block."""
    import numpy as np
    import torch

    from tsl_sdr_tpu_torch.ops import polyphase, q14
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    doc = json.loads((HERE / "etc" / "pocsag_38400_from_25k.json").read_text())
    coeffs = doc["rationalResampler"]["lpfCoeffs"]
    rng = np.random.default_rng(14)
    shapes = {}
    worst = 0.0
    for name, target, align in (("decoder step", 1024, True),
                                ("85-row block", 85 * 384, False)):
        plan = polyphase.make_resampler_plan(
            q14.quantize_q14(coeffs), 192, 125, block_out_target=target,
            align_k_row=align)
        taps = polyphase.row_taps(plan, device=device)
        carry = torch.from_numpy(rng.integers(
            -32768, 32767, size=(1, plan.carry_len)).astype(np.int16)).to(
                device)
        block = torch.from_numpy(rng.integers(
            -32768, 32767, size=(1, plan.block_in)).astype(np.int16)).to(
                device)
        got = k3.row_resample(carry, block, taps.w0, taps.w1,
                              row_in=plan.row_in, out="q14")
        ref = k3.row_resample_plain(carry, block, taps.w0, taps.w1,
                                    row_in=plan.row_in, out="q14")
        log(f"K3 q14 vs plain, 192/125 ({len(coeffs)} taps) {name}: block "
            f"{list(block.shape)} w0 {list(taps.w0.shape)} -> "
            f"{list(got.shape)}: max|diff|={max_err(got, ref)}")
        require(torch.equal(got, ref), f"K3 q14 {name} differs")
        worst = max(worst, max_err(got, ref))
        shapes[name] = (carry, block, taps, plan.row_in)
    return shapes, worst


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
        t0 = time.perf_counter()
        rc = decoder.main([*argv, "-o", str(out), "-c", "--device", device,
                           str(src)])
        walls[name] = time.perf_counter() - t0
        require(rc == 0, f"decoder-torch {name} exited {rc}")
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
    """Phases 6-12: the decoder front end's kernels and paths."""
    import torch

    from tsl_sdr_tpu_torch.ops import dc_blocker as dcb
    from tsl_sdr_tpu_torch.ops import frame_resampler as k4
    from tsl_sdr_tpu_torch.ops import row_resampler as k3

    cap, step, k4_err = check_frame_resampler(device)
    q14_shapes, q14_err = check_row_q14(device)
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

    # phase 12: times at the paths' shapes (CUDA events, after warm-up)
    args = (step["carry"], step["block"], step["taps"])
    fr_ms, fr_plain_ms = in_turns(
        lambda: k4.frame_resample_plain(*args, frames=step["frames"]),
        lambda: k4.frame_resample(*args, frames=step["frames"]), 10, 50)
    pcm, plan, taps = cap["pcm"], cap["plan"], cap["taps"]
    cap_ms, cap_plain_ms = in_turns(
        lambda: k4.frame_resample_plain(pcm.new_zeros((1, 0)), pcm[None],
                                        taps, frames=pcm.numel()
                                        // plan.d_rep),
        lambda: k4.resample_capture(plan, pcm, taps), 3, 20)
    log(f"K4 resample_capture 147/160 over {pcm.numel()} samples: kernel "
        f"{cap_ms:.3f} ms, plain {cap_plain_ms:.3f} ms")
    rc, rb, rt, row_in = q14_shapes["decoder step"]
    q_ms, q_plain_ms = in_turns(
        lambda: k3.row_resample_plain(rc, rb, rt.w0, rt.w1, row_in=row_in,
                                      out="q14"),
        lambda: k3.row_resample(rc, rb, rt.w0, rt.w1, row_in=row_in,
                                out="q14"), 50, 200)
    rc, rb, rt, row_in = q14_shapes["85-row block"]
    q85_ms, q85_plain_ms = in_turns(
        lambda: k3.row_resample_plain(rc, rb, rt.w0, rt.w1, row_in=row_in,
                                      out="q14"),
        lambda: k3.row_resample(rc, rb, rt.w0, rt.w1, row_in=row_in,
                                out="q14"), 10, 50)
    log(f"K3 q14 192/125 85-row block: kernel {q85_ms:.3f} ms, plain "
        f"{q85_plain_ms:.3f} ms")
    x = torch.randint(-32768, 32767, (1, 1152), dtype=torch.int16)
    xd = x.to(device)
    st_k = torch.zeros((1, 3), dtype=torch.int32, device=device)
    st_p = torch.zeros((1, 3), dtype=torch.int32)
    dc_ms, dc_plain_ms = in_turns(
        lambda: dcb.dc_block_exact_plain(st_p, x, pole),
        lambda: dcb.dc_block_exact(st_k, xd, pole), 20, 200)
    return {
        "runs": runs,
        "kernels": [
            {"name": "row_resample_q14", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/row_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/polyphase.py:318",
             "max_abs_err": q14_err, "ms": q_ms, "plain_ms": q_plain_ms},
            {"name": "frame_resample", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/frame_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_resampler.py:28",
             "max_abs_err": k4_err, "ms": fr_ms, "plain_ms": fr_plain_ms},
            {"name": "dc_block_exact", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/dc_blocker.cu",
             "replaces": "tsl_sdr_tpu/ops/dc_blocker.py:49",
             "max_abs_err": dc_err, "ms": dc_ms, "plain_ms": dc_plain_ms},
        ],
    }


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

    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = on_path("the pager pipeline", ("chain_fm", "row_resample"),
                      lambda: run_main_path(pager, iq, expected, device,
                                            Path(tmp)), totals)

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
    del iq, vals, carry, block

    front = front_end(device, totals)
    return {
        "run": run,
        "front": front["runs"],
        "kernels": [
            {"name": "chain_fm", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/chain.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_chain.py:279",
             "launches": totals["chain_fm"], "max_abs_err": k1_err,
             "ms": k1_ms, "plain_ms": k1_plain_ms},
            {"name": "row_resample", "route": "cuda",
             "source": "tsl_sdr_tpu_torch/csrc/row_resampler.cu",
             "replaces": "tsl_sdr_tpu/ops/pallas_resampler.py:119",
             "launches": totals["row_resample"], "max_abs_err": k3_err,
             "ms": k3_ms, "plain_ms": k3_plain_ms},
            *[dict(k, launches=totals[k["name"]]) for k in front["kernels"]],
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
    front = summary["front"]
    log(f"{card} | decoder-torch wall s (60 s of audio each): "
        f"{json.dumps(front['decoder_s'])}")
    log(f"{card} | resampler-torch 147/160 wall s (20 s of 48 kHz): "
        f"{json.dumps(front['resampler_s'])}")
    log(f"{card} | pipeline at decimation 50: {front['dec50_s']:.3f} s")
    for k in summary["kernels"]:
        log(f"{card} | {k['name']}: kernel {k['ms']:.3f} ms, plain "
            f"{k['plain_ms']:.3f} ms per call at its main path's shape")
    print(json.dumps({"kernels": summary["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
