#!/usr/bin/env python3
"""Randomized fused-vs-host ReceivePipeline soak of the PyTorch port.

Random channel mixes (pocsag/flex/ais) at a decimation that forces real
resampler ratios for every protocol (channel rate 51200: POCSAG 3/4,
FLEX 5/16, AIS 15/16); the fused streaming engine must produce the same
messages as the stage-by-stage host path, and every seed must decode
something. Signals are sized to fit the capture: a burst truncated by EOF
legitimately decodes differently between paths (their tails end samples
apart). The captures, seeds and draws are those of
``bench/soak_pipeline.py``, so both packages soak the same input.

On a GPU the engine runs K1, K3 (3/4 and 5/16), K4 (15/16) and K7; with
``--exact`` the streaming exact engine runs K5, K9, and K3 and K4 with the
Q.14 epilogue, at random push split points. The host path runs the same
kernels stage by stage.

Usage: python bench/torch_soak_pipeline.py [n_seeds] [--exact]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tsl_sdr_tpu_torch.models.pipeline import (  # noqa: E402
    ChannelSpec, ReceivePipeline)
from tsl_sdr_tpu_torch.testing import ais_gen, flex_gen, pocsag_gen  # noqa: E402
from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass  # noqa: E402

DECIM = 24
FS = 51200 * DECIM
CENTER = 929_500_000
BLOCK_SIZE = 393_216


def _fm_mod(baseband, channel_rate, offset, fs, amp=9000, dev_hz=None):
    dev = baseband.astype(np.float64) / 16384.0 * (
        dev_hz if dev_hz is not None else channel_rate / 2
    )
    n_out = int(len(dev) * fs / channel_rate)
    idx = np.minimum(
        (np.arange(n_out) * channel_rate / fs).astype(np.int64), len(dev) - 1
    )
    inst = 2 * np.pi * (offset + dev[idx]) / fs
    phase = np.cumsum(inst)
    return np.stack([np.cos(phase), np.sin(phase)], -1) * amp


def _signal(rng, proto, off):
    if proto == "pocsag":
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=int(rng.integers(1, 2**20)),
                                    function=1, kind="alpha",
                                    content="SOAK %d" % off)],
            baud=int(rng.choice([512, 1200, 2400])), tail_bits=128)
        return _fm_mod(bb, 38400, off, FS)
    if proto == "flex":
        bb, _ = flex_gen.generate(
            [flex_gen.FlexBurstMessage(capcode=int(rng.integers(1, 2**20)),
                                       kind="alnum", content="SOAK FLEX")],
            baud=1600, fsk_levels=2, amplitude=6144, tail_bits=200)
        return _fm_mod(bb, 16000, off, FS, amp=7000)
    bb = ais_gen.generate(
        [ais_gen.make_position_report(366000000 + int(rng.integers(1000)))],
        amplitude=9000)
    return _fm_mod(bb, 48000, off, FS, amp=7000, dev_hz=4800)


def _keys(results):
    out = []
    for msgs in results:
        ch = []
        for m in (msgs if isinstance(msgs, list) else []):
            if hasattr(m, "capcode"):
                ch.append(("pg", m.capcode, bytes(m.data)))
            elif hasattr(m, "mmsi"):
                ch.append(("ais", m.mmsi))
        out.append(ch)
    return out


def _channels(rng):
    nch = int(rng.integers(2, 4))
    protos = [str(p) for p in rng.choice(["pocsag", "flex", "ais"],
                                         size=nch)]
    offs = [int(o) for o in rng.choice(
        np.arange(-500_000, 500_001, 100_000), size=nch, replace=False)]
    return protos, offs


def channels(seed: int):
    """Seed ``seed``'s (protocols, offsets in Hz), its first draws."""
    return _channels(np.random.default_rng(1000 + seed))


def _capture(seed: int):
    rng = np.random.default_rng(1000 + seed)
    protos, offs = _channels(rng)
    sigs = [_signal(rng, p, o) for p, o in zip(protos, offs)]
    n = max(len(s) for s in sigs) + 600_000
    iq = np.zeros((n, 2))
    for s in sigs:
        start = int(rng.integers(100_000, n - len(s) - 100_000))
        iq[start : start + len(s)] += s
    iq = (iq + rng.normal(scale=100, size=iq.shape)).astype(np.int16)
    return rng, protos, offs, iq


def capture(seed: int):
    """Seed ``seed``'s (protocols, offsets, cs16 capture [n, 2])."""
    return _capture(seed)[1:]


def _pipeline(protos, offs, *, exact: bool, device):
    """The soak's ReceivePipeline for one channel mix."""
    specs = [ChannelSpec(CENTER + o, p) for p, o in zip(protos, offs)]
    return ReceivePipeline(firdes_low_pass(1.0, FS, 12_000, 8_000), CENTER,
                           FS, DECIM, specs, exact=exact,
                           block_size=BLOCK_SIZE, device=device)


def run_seed(seed: int, *, exact: bool, device="cuda"):
    """One seed: (the engine's messages, the host path's), each as
    ``_keys`` gives them. The engine is ``process_capture``'s fused one, or
    with ``exact`` the streaming exact engine pushed at random split points
    between 50,000 and 400,000 samples."""
    rng, protos, offs, iq = _capture(seed)
    pipe = _pipeline(protos, offs, exact=exact, device=device)
    want = _keys(pipe._process_capture_host(iq, device_decode=False))
    pipe2 = _pipeline(protos, offs, exact=exact, device=device)
    if not exact:
        return _keys(pipe2.process_capture(iq)), want
    got = [[] for _ in protos]
    i0 = 0
    while i0 < len(iq):
        ln = int(rng.integers(50_000, 400_000))
        for c, part in enumerate(pipe2.push(iq[i0 : i0 + ln])):
            got[c].extend(part)
        i0 += ln
    for c, part in enumerate(pipe2.flush()):
        got[c].extend(part)
    return _keys(got), want


def main(n_seeds=5, exact=False, device="cuda"):
    label = "exact-stream" if exact else "fused"
    fails = 0
    walls = []
    for seed in range(n_seeds):
        t0 = time.perf_counter()
        got, want = run_seed(seed, exact=exact, device=device)
        walls.append(round(time.perf_counter() - t0, 3))
        n_got = sum(len(c) for c in got)
        n_want = sum(len(c) for c in want)
        ok = got == want and n_want > 0
        fails += 0 if ok else 1
        print(f"seed {seed}: {channels(seed)[0]} -> {label} {n_got}, host "
              f"{n_want} [{'OK' if ok else 'DIFF'}]", flush=True)
        if not ok:
            print(f"  {label}:", got, "\n  host:", want, flush=True)
    print("wall s a seed (capture, host path and engine):", walls)
    print("fails:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=5)
    ap.add_argument("--exact", action="store_true",
                    help="soak the streaming exact engine instead")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    a = ap.parse_args()
    sys.exit(main(a.n_seeds, exact=a.exact, device=a.device))
