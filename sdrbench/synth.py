"""The one traffic generator: a traffic mix's parameters and a seed -> a
replay segment of wideband samples and the messages it carries.

A mix (``sdrbench/traffic/<name>.json``) sets:

* ``meanIntervalS``: the mean time between messages on a quiet channel;
* ``busyShare`` (default 0): the share of channels, every ``1/busyShare``-th
  from channel 0, that carry messages back to back;
* ``minAirS``: the least air time of the segment, which is whole blocks;
* ``chars``: the range of message lengths in characters;
* ``noiseRms``, ``carrierAmplitude``: the band's noise per I/Q part and
  each carrier's amplitude, in int16 units;
* ``pocsag`` (``baud``, ``pcmAmplitude``), ``flex`` (``pcmAmplitude``):
  each protocol's modulation (deviation = amplitude / 2^14 of half the
  decoder rate);
* ``guardS``, ``gapS``: the quiet air at the segment's ends and between two
  messages of one channel.

The seed draws everything: the quiet channels' arrival times (a Poisson
process given its count, so uniform and independent), each message's
channel among those of its protocol, frame slot, characters, capcode and
function, and the band's noise. The count of messages per protocol and the
set of their lengths (spread evenly over ``chars``) follow from the mix
alone, so every seed carries the same amount of traffic in another order.
Messages on different channels may overlap in time, neighbours included;
one channel never carries two at once. No message crosses the segment's
end, so the segment can be replayed end to end.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from sdrbench import siggen

RATES = {"pocsag": siggen.POCSAG_RATE, "flex": siggen.FLEX_RATE}


@dataclass(frozen=True)
class Message:
    channel: int
    protocol: str
    start: int          # first wideband sample in the segment
    end: int            # one past the last
    capcode: int
    function: int
    text: bytes

    def key(self) -> tuple:
        """What a receiver that decodes it delivers."""
        if self.protocol == "pocsag":
            return ("pocsag", self.capcode, self.function,
                    siggen.pocsag_expected(self.text))
        return ("flex", self.capcode, siggen.flex_expected(self.text))


def baseband(protocol: str, capcode: int, function: int, text: bytes,
             mix: dict) -> np.ndarray:
    if protocol == "pocsag":
        p = mix["pocsag"]
        return siggen.pocsag_pcm(capcode, function, text, baud=p["baud"],
                                 amplitude=p["pcmAmplitude"])
    return siggen.flex_pcm(capcode, text, amplitude=mix["flex"]["pcmAmplitude"])


def wideband_len(n_pcm: int, rate: int, fs: float) -> int:
    return int(n_pcm * fs / rate)


def segment_blocks(mix: dict, fs: float, block: int) -> int:
    return max(1, math.ceil(mix["minAirS"] * fs / block))


def _busy(n_ch: int, mix: dict) -> set:
    share = mix.get("busyShare", 0)
    if not share:
        return set()
    step = max(1, round(1 / share))
    return set(range(0, n_ch, step))


def schedule(channels, mix: dict, seed: int, fs: float,
             n_samples: int) -> list[Message]:
    """The segment's messages, ``channels`` as (offset Hz, protocol)."""
    lo, hi = mix["chars"]
    rng = np.random.default_rng(seed)
    gap = int(mix["gapS"] * fs)
    guard = int(mix["guardS"] * fs)
    busy = _busy(len(channels), mix)
    by_proto: dict = {}
    for c, (_, proto) in enumerate(channels):
        if c not in busy:
            by_proto.setdefault(proto, []).append(c)

    def make(c, proto, start, length, slot):
        text = bytes(rng.integers(0x20, 0x7F, size=length).tolist())
        if proto == "pocsag":
            cap = int(rng.integers(1, 1 << 18)) << 3 | slot
            fn = int(rng.integers(0, 4))
        else:
            cap = int(rng.integers(1, 1_900_000))
            fn = 0
        n = wideband_len(len(baseband(proto, cap, fn, text, mix)),
                         RATES[proto], fs)
        return Message(c, proto, start, start + n, cap, fn, text)

    ends = {c: 0 for v in by_proto.values() for c in v}
    msgs: list[Message] = []
    air = n_samples / fs
    n_quiet = sum(len(v) for v in by_proto.values())
    n_msg = round(n_quiet * air / mix["meanIntervalS"])
    protos = sorted(by_proto)
    share = np.asarray([len(by_proto[p]) for p in protos]) / max(n_quiet, 1)
    counts = np.floor(share * n_msg).astype(int)
    for i in np.argsort(-(share * n_msg - counts))[:n_msg - counts.sum()]:
        counts[i] += 1
    kinds = rng.permutation(np.repeat(np.arange(len(protos)), counts))
    slots = rng.integers(0, 8, size=n_msg)
    longest_of = {p: wideband_len(len(baseband(p, 7, 0, b"~" * hi, mix)),
                                  RATES[p], fs) for p in protos}
    longest = max(longest_of.values(), default=0)
    if n_msg and n_samples - 2 * guard - longest <= 0:
        raise ValueError(f"a segment of {air:.1f} s holds no message")
    times = np.sort(rng.integers(guard, n_samples - guard - longest,
                                 size=n_msg))
    lengths = {k: rng.permutation(np.linspace(lo, hi, max(int(c), 1))
                                  .round().astype(int))
               for k, c in enumerate(counts)}
    used = {k: 0 for k in lengths}
    for t, k, slot in zip(times, kinds, slots):
        proto = protos[k]
        m = make(-1, proto, int(t), int(lengths[k][used[k]]), int(slot))
        used[k] += 1
        cands = [c for c in by_proto[proto] if ends[c] <= m.start]
        if not cands:
            # every channel of the protocol is on air: the message waits
            # for the first to fall quiet
            c = min(by_proto[proto], key=lambda c: ends[c])
            m = dataclasses.replace(m, start=ends[c],
                                    end=ends[c] + m.end - m.start)
            if m.end > n_samples - guard:
                raise ValueError(f"no {proto} channel free for a message "
                                 f"at sample {t}")
        else:
            c = cands[int(rng.integers(len(cands)))]
        m = dataclasses.replace(m, channel=c)
        ends[c] = m.end + gap
        msgs.append(m)
    # busy channels: messages back to back, lengths cycling over the range
    for c in sorted(busy):
        proto = channels[c][1]
        t, j = guard, 0
        while True:
            length = lo + (j * 7919) % (hi - lo + 1)
            m = make(c, proto, t, length, j % 8)
            if m.end > n_samples - guard:
                break
            msgs.append(m)
            t, j = m.end + gap, j + 1
    return sorted(msgs, key=lambda m: (m.end, m.channel))


def fm_mod(pcm: torch.Tensor, rate: int, offset: float, fs: float,
           amp: float) -> torch.Tensor:
    """NBFM of decoder-rate PCM onto a carrier at ``offset`` (zero-order
    hold up to ``fs``): [n, 2] float32 on ``pcm``'s device."""
    dev = pcm.to(torch.float64) / 16384.0 * (rate / 2)
    n_out = int(pcm.shape[0] * fs / rate)
    idx = torch.clamp((torch.arange(n_out, device=pcm.device,
                                    dtype=torch.float64) * rate / fs).long(),
                      max=pcm.shape[0] - 1)
    phase = torch.cumsum(2 * math.pi * (offset + dev[idx]) / fs, 0)
    return (torch.stack([torch.cos(phase), torch.sin(phase)], 1)
            * amp).to(torch.float32)


def synthesize(channels, mix: dict, seed: int, fs: float, n_samples: int,
               wire_fmt: str, device) -> tuple[np.ndarray, list[Message]]:
    """The segment as host wire samples ([n, 2] int16 for ``cs16``, uint8
    for ``rtl_u8``), made on ``device``, and its messages."""
    msgs = schedule(channels, mix, seed, fs, n_samples)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed & (2**63 - 1))
    x = torch.randn((n_samples, 2), generator=gen, device=dev,
                    dtype=torch.float32)
    x *= mix["noiseRms"]
    for m in msgs:
        pcm = torch.from_numpy(baseband(m.protocol, m.capcode, m.function,
                                        m.text, mix)).to(dev)
        sig = fm_mod(pcm, RATES[m.protocol], channels[m.channel][0], fs,
                     mix["carrierAmplitude"])
        x[m.start:m.start + sig.shape[0]] += sig
    if wire_fmt == "cs16":
        out = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
    elif wire_fmt == "rtl_u8":
        out = torch.clamp(torch.round(x / 128) + 127, 0, 255).to(torch.uint8)
    else:
        raise ValueError(f"unknown wire format {wire_fmt!r}")
    del x
    return out.cpu().numpy(), msgs
