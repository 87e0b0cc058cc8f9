"""One run of one cell: set-up, the timed window, the check, the metrics.

Everything a cell names is found by that name: its configuration in the
file ``BENCHMARK.json`` gives it, its traffic mix in
``sdrbench/traffic/<traffic>.json``, each per-layer metric's reader in
``sdrbench/metrics/<metric>.py`` and the limits of its check in
``sdrbench/reference/limits/<config>.json``. A configuration file holds
the receiver as upstream's ``multifm`` JSON states it (rate, centre,
decimation, low-pass taps, ``channels`` with each ``chanCenterFreq``),
and beside it each channel's protocol (``protocols``, in the channels'
order), ``dcBlock`` and the pipeline's ``wire``, ``blockSize`` and
``inflightDepth``.

The window drives ``tsl_sdr_tpu_torch``'s ``ReceivePipeline`` as
``pipeline-torch``'s file mode sets it up (production tier, drain inline):
``push`` takes the replayed segment one whole block at a time (the first
push also carries the channelizer's prefix) until ``--seconds`` have
passed, and ``flush`` ends it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import tempfile
import time
from collections import defaultdict, deque
from pathlib import Path

import numpy as np
import torch

from sdrbench import synth
from sdrbench import trace as tracing
from sdrbench.reference import receiver

ROOT = Path(__file__).resolve().parents[1]
REF_DC_OUTPUTS = 16 * 16384   # 16 time constants of the DC blocker


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """(workload, configuration entry) of the cell ``name``."""
    for wl in bench["workloads"]:
        if wl["name"] == name:
            for cfg in bench["configs"]:
                if cfg["name"] == wl["config"]:
                    return wl, cfg
            raise KeyError(f"cell {name!r} names no configuration "
                           f"{wl['config']!r}")
    raise KeyError(f"no cell {name!r} in the benchmark")


def metric_reader(name: str, root: Path = ROOT):
    path = root / "sdrbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sdrbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def channel_table(cfg: dict) -> list[tuple[int, str]]:
    """(offset from the centre in Hz, protocol) of each channel."""
    return [(ch["chanCenterFreq"] - cfg["centerFreqHz"], proto)
            for ch, proto in zip(cfg["channels"], cfg["protocols"],
                                 strict=True)]


def metrics_for(bench: dict, kind: str, cell: str) -> list[dict]:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


class Replay:
    """The segment replayed end to end as one stream: push ``k`` takes
    stream samples ``[c + kB, c + (k+1)B)`` (push 0 from 0), views into
    the segment with its first ``c`` samples appended."""

    def __init__(self, seg: np.ndarray, block: int, carry: int):
        self.n = seg.shape[0]
        self.block, self.carry = block, carry
        self.ext = np.concatenate([seg, seg[:carry]])

    def push(self, k: int) -> np.ndarray:
        if k == 0:
            return self.ext[:self.carry + self.block]
        a = (self.carry + k * self.block) % self.n
        return self.ext[a:a + self.block]

    def pushed(self, k: int) -> int:
        """Stream samples in pushes ``0 .. k-1``."""
        return self.carry + k * self.block if k else 0

    def push_of(self, s: int) -> int:
        """The push that delivers stream sample ``s``."""
        return max(0, (s - self.carry) // self.block)

    def stream(self, a: int, b: int) -> np.ndarray:
        idx = np.arange(a, b) % self.n
        return self.ext[idx]


def message_key(protocol: str, msg) -> tuple:
    if protocol == "pocsag":
        return ("pocsag", int(msg.capcode), int(msg.function),
                bytes(msg.data))
    return ("flex", int(msg.capcode), bytes(msg.data))


def leakage_db(cfg: dict, occupied_hz: float) -> np.ndarray:
    """``[a, b]``: the level in dB at which a carrier on channel ``a``
    reaches channel ``b``'s output, against ``b``'s own carrier: the
    channel filter's gain at the offset between them, the largest over the
    carrier's occupied band (+-``occupied_hz``), over its gain at 0 Hz."""
    taps = np.asarray(cfg["lpfTaps"], np.float64)
    offs = np.asarray([off for off, _ in channel_table(cfg)], np.float64)
    n = np.arange(taps.shape[0])
    at = np.linspace(-occupied_hz, occupied_hz, 49)
    d = offs[:, None, None] - offs[None, :, None] + at
    gain = np.abs(np.exp(-2j * np.pi * d[..., None] / cfg["sampleRateHz"]
                         * n) @ taps).max(-1)
    out = 20 * np.log10(gain / abs(taps.sum()))
    np.fill_diagonal(out, 0.0)
    return out


def reach_db(cfg: dict, mix: dict) -> float:
    """A carrier's level over the band's noise at a channel's output, in
    dB: a neighbour that reaches the channel more than this far down is
    below its noise."""
    taps = np.asarray(cfg["lpfTaps"], np.float64)
    return float(10 * np.log10(mix["carrierAmplitude"] ** 2 * taps.sum() ** 2
                               / (2 * mix["noiseRms"] ** 2
                                  * (taps ** 2).sum())))


def match(msgs, replay: Replay, decoded, calls, depth: int,
          leak_db: np.ndarray, contest_db: float, reach: float) -> dict:
    """Each decoded message against the messages sent: ``decoded``
    (channel, key, call index) in the order they were returned; ``calls``
    (start, return) of each push and of the flush; ``depth`` blocks in
    flight; ``leak_db`` as :func:`leakage_db` gives it; ``reach`` as
    :func:`reach_db` gives it.

    A message's window runs from the push of its first sample to ``depth
    + 2`` calls after the push of its last. Two transmissions that overlap
    in time and reach a channel within ``contest_db`` of each other, the
    stronger above the channel's noise, contest it: FM demodulation then
    follows neither. A message whose own channel another transmission
    contests is ``jammed``: not due. Every other message whose last sample
    was pushed is due, and ``missed`` where its channel did not return it. A page that matches nothing sent on its
    channel is ``leaked`` where it matches a message of another channel
    and came back in that message's window (the channel filter passes
    the neighbour), ``garbled`` where it came back in the window of a
    contest on its channel, and else ``invented``. Jammed, leaked and
    garbled are counted, not judged."""
    total = replay.pushed(len(calls) - 1)
    n = replay.n
    n_ch = leak_db.shape[0]
    jammed, pairs = set(), []
    for i, a in enumerate(msgs):
        for j in range(i + 1, len(msgs)):
            b = msgs[j]
            if b.start >= a.end or a.start >= b.end:
                continue
            la, lb = leak_db[a.channel], leak_db[b.channel]
            pairs.append((i, j, [c for c in range(n_ch)
                                 if abs(la[c] - lb[c]) <= contest_db
                                 and max(la[c], lb[c]) >= -reach]))
            if leak_db[b.channel, a.channel] >= -contest_db:
                jammed.add(i)
            if leak_db[a.channel, b.channel] >= -contest_db:
                jammed.add(j)
    want = defaultdict(deque)
    on_air = defaultdict(lambda: defaultdict(set))   # key -> call -> channels
    contested = defaultdict(set)                     # channel -> calls
    due, jams = [], []
    for p in range(total // n + 2):
        win = []
        for i, m in enumerate(msgs):
            end = p * n + m.end
            lo = replay.push_of(p * n + m.start)
            hi = replay.push_of(end - 1) + depth + 2
            win.append(range(lo, hi + 1))
            want[m.channel, m.key()].append(end)
            for k in win[-1]:
                on_air[m.key()][k].add(m.channel)
            if end <= total:
                (jams if i in jammed else due).append((m.channel, m.key(),
                                                       end))
        for i, j, chans in pairs:
            for c in chans:
                contested[c].update(win[i], win[j])
    got = defaultdict(set)
    invented, leaked, garbled = [], 0, 0
    lat = []
    for ch, key, call in decoded:
        q = want[ch, key]
        if q:
            end = q.popleft()
            got[ch, key].add(end)
            if end <= total:
                lat.append(calls[call][1] - calls[replay.push_of(end - 1)][0])
        elif on_air[key][call] - {ch}:
            leaked += 1
        elif call in contested[ch]:
            garbled += 1
        else:
            invented.append((ch, key, call))
    missed = [(ch, key, end) for ch, key, end in due
              if end not in got.get((ch, key), ())]
    jam_back = sum(end in got.get((ch, key), ()) for ch, key, end in jams)
    return {"attempted": len(due), "missed": len(missed),
            "invented": len(invented), "jammed": len(jams),
            "jammed_decoded": jam_back, "leaked": leaked,
            "garbled": garbled, "latency_s": lat,
            "examples": [f"missed on channel {ch} (ending at sample {end}): "
                         f"{key}" for ch, key, end in missed[:3]]
            + [f"invented on channel {ch} (call {call}): {key}"
               for ch, key, call in invented[:3]]
            + [f"traffic: {len(jams)} messages jammed by a neighbour (not "
               f"due; {jam_back} of them decoded all the same), {leaked} "
               f"pages leaked from other channels, {garbled} garbled in a "
               "contest (counted, not judged)"]}


def reference_state(cfg: dict, replay: Replay, blocks: int, device,
                    precision: str = "f64") -> dict:
    """The plain chain's values of what the program's checkpoint after the
    window holds, under the checkpoint's names: each resampler's history
    (``state.rs.<I>_<D>``: the last channelizer PCM of its rows), each
    row's DC blocker state (``state.dc.<channel>.x_prev``, ``.y_prev``:
    the last resampled sample in and DC-blocked sample out) and each FLEX
    row's carried PCM (``tailpcm_<channel>``). The POCSAG rows carry only
    sign bits, which at a few rows do not tell the control from the
    program (the control flips none on some seeds)."""
    chans = channel_table(cfg)
    fs, dec = cfg["sampleRateHz"], cfg["decimationFactor"]
    ref = receiver.Receiver(cfg["lpfTaps"], fs, dec, chans,
                            precision=precision, device=device)
    k_end = blocks * replay.block // dec
    # enough channel outputs that each resampler's last REF_DC_OUTPUTS
    # outputs have their whole history: the DC blocker's start from zero
    # state has then decayed below 1e-6 LSB
    span = max(math.ceil(REF_DC_OUTPUTS * dp / ip) + ref.lag((ip, dp)) + 2
               for ip, dp in ref.groups)
    k0 = max(0, k_end - span)
    first = max(k0 - 1, 0)
    x = receiver.widen(replay.stream(first * dec, (k_end - 1) * dec
                                     + ref.ntaps), cfg["wire"])
    pcm, amb = ref.pcm(torch.from_numpy(x), k0, k_end)
    out, skip = {}, {}
    for gid, rows in ref.groups.items():
        ip, dp = gid
        lag = ref.lag(gid)
        name = f"state.rs.{ip}_{dp}"
        out[name] = pcm[rows][:, pcm.shape[1] - lag:].cpu().numpy()
        skip[name] = amb[rows][:, amb.shape[1] - lag:].cpu().numpy()
        m_end = k_end * ip // dp
        m0 = 0 if k0 == 0 else m_end - REF_DC_OUTPUTS
        res, bad = ref.resample(gid, pcm[rows], amb[rows], k0, m0, m_end)
        dc = ref.dc_block(res)
        bad = bad.cpu().numpy()
        x_in = receiver.dc_input(res)
        for j, c in enumerate(rows):
            for name, v in ((f"state.dc.{c}.x_prev", x_in[j, -1:]),
                            (f"state.dc.{c}.y_prev", dc[j, -1:])):
                out[name] = v
                skip[name] = bad[j, -1:]
        if chans[rows[0]][1] == "flex":
            for j, c in enumerate(rows):
                out[f"tailpcm_{c}"] = dc[j, -receiver.FLEX_TAIL:]
                skip[f"tailpcm_{c}"] = bad[j, -receiver.FLEX_TAIL:]
    return {"values": out, "skip": skip}


def compare(prog: dict, ref: dict) -> dict:
    """The widest gap of the channelizer PCM, of the DC blockers' state and
    of the FLEX rows' PCM (LSB), where the reference's values are not
    ambiguous. ``prog``: the program's checkpoint, or the ``values`` of
    another :func:`reference_state`."""
    out = {"k1_gap_lsb": 0.0, "dc_state_gap_lsb": 0.0,
           "flex_tail_gap_lsb": 0.0}
    for name, want in ref["values"].items():
        got = np.atleast_1d(prog[name])
        n = got.shape[-1]
        keep = ~ref["skip"][name][..., -n:]
        want = want[..., -n:]
        diff = np.abs(got.astype(np.float64) - want)[keep]
        gap = float(diff.max()) if diff.size else 0.0
        key = ("k1_gap_lsb" if name.startswith("state.rs.") else
               "dc_state_gap_lsb" if name.startswith("state.dc.") else
               "flex_tail_gap_lsb")
        out[key] = max(out[key], gap)
    return out


def checks(match_res: dict, readings: dict, limits: dict) -> dict:
    vals = {"missed": match_res["missed"], "invented": match_res["invented"],
            **readings}
    return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()}


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", bench: dict | None = None, root: Path = ROOT,
        t_start: float | None = None, keep: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's object, the checks
    last. ``keep``, where given, receives the replay, the blocks pushed,
    the configuration and each call's (start, return) times, for a control
    on the same stream."""
    from tsl_sdr_tpu_torch.models.pipeline import ChannelSpec, ReceivePipeline

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(root / "BENCHMARK.json")
    wl, entry = find_cell(bench, cell)
    cfg = load_json(root / entry["file"])
    mix = load_json(root / "sdrbench" / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(root / "sdrbench" / "reference" / "limits"
                       / f"{wl['config']}.json")
    dev = torch.device(device)
    chans = channel_table(cfg)
    fs = cfg["sampleRateHz"]
    specs = [ChannelSpec(cfg["centerFreqHz"] + off, proto,
                         dc_block=cfg["dcBlock"])
             for off, proto in chans]
    pipe = ReceivePipeline(
        cfg["lpfTaps"], cfg["centerFreqHz"], fs, cfg["decimationFactor"],
        specs, exact=False, block_size=cfg["blockSize"],
        inflight_depth=cfg["inflightDepth"], wire_fmt=cfg["wire"],
        device=dev, drain_async=False)
    block, carry = pipe.block_size, pipe.chain.carry_len
    n_blocks = synth.segment_blocks(mix, fs, block)
    seg, msgs = synth.synthesize(chans, mix, seed, fs, n_blocks * block,
                                 cfg["wire"], dev)
    replay = Replay(seg, block, carry)
    del seg
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    pipe.warm_device()
    if cuda:
        torch.cuda.synchronize(dev)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        pipe.timing = {}
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    else:
        from contextlib import nullcontext as record_function

    decoded, calls = [], []

    def take(out, call):
        for ch, part in enumerate(out):
            for m in part:
                decoded.append((ch, message_key(chans[ch][1], m), call))

    setup_s = time.perf_counter() - t_start
    t_first = time.perf_counter()
    k = 0
    while True:
        chunk = replay.push(k)
        t0 = time.perf_counter()
        with record_function("push"):
            out = pipe.push(chunk)
        t1 = time.perf_counter()
        calls.append((t0, t1))
        take(out, k)
        k += 1
        if t1 - t_first >= seconds:
            break
    t0 = time.perf_counter()
    with record_function("flush"):
        out = pipe.flush()
        if cuda:
            torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    calls.append((t0, t_end))
    take(out, k)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t_first
    samples = replay.pushed(k)

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stats = pipe.stream_stats
    timing = pipe.timing
    if stats["blocks"] != k:
        raise RuntimeError(f"{k} blocks pushed, {stats['blocks']} drained")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "state.npz"
        pipe.checkpoint_stream(path)
        with np.load(path) as z:
            ckpt = {n: z[n] for n in z.files if n != "__meta__"}
    for n in ckpt:
        if n.startswith("state.dc.") and n.endswith(".x_prev"):
            ckpt[n] = ckpt[n] / receiver.Q14     # the blocker keeps x in Q.28
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    m = match(msgs, replay, decoded, calls, cfg["inflightDepth"],
              leakage_db(cfg, limits["occupiedHz"]), limits["contestDb"],
              reach_db(cfg, mix))
    if keep is not None:
        keep.update(replay=replay, blocks=k, cfg=cfg, calls=calls)
    readings = compare(ckpt, reference_state(cfg, replay, k, dev))
    chk = checks(m, readings, limits)
    correct = all(v["value"] <= v["limit"] for v in chk.values())

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": correct, "attempted": m["attempted"],
           "failed": m["missed"] + m["invented"], "metrics": {},
           "device": dev_info}
    if not trace:
        vals = {"msps": samples / window_s / 1e6, "setup_s": setup_s}
        for spec in metrics_for(bench, "end_to_end", cell):
            if spec["name"] in vals:
                res["metrics"][spec["name"]] = {"value": vals[spec["name"]],
                                                "unit": spec["unit"]}
    else:
        red = tracing.reduce(tracing.raw_events(prof))
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["window_s"]
        ctx = {"cfg": cfg, "blocks": k, "block": block, "timing": timing,
               "stats": stats, "trace": red, "latency_s": m["latency_s"],
               "gated_rows": len(chans)}
        for spec in metrics_for(bench, "per_layer", cell):
            v = metric_reader(spec["name"], root).read(ctx)
            if v is not None:
                res["metrics"][spec["name"]] = {"value": v,
                                                "unit": spec["unit"]}
        res["breakdown"] = {"device_ops": tracing.top_ops(red),
                            "idle_gaps": red["idle_gaps"]}
    res["checks"] = chk
    res["examples"] = m["examples"]
    return res

