"""The plain receive chain, for the check that decides ``correct``.

A straightforward float64 implementation of what a multi-channel pager
receiver computes, written from the upstream programs' definitions
(``multifm/demod.c``, ``filter/direct_fir.c``, ``filter/polyphase_fir.c``,
the decoder's DC blocker) and not from the program under test, whose
modules it neither imports nor calls:

1. wire samples to int16 (``rtl_u8``: ``(u - 127) << 7``);
2. channel ``c``'s taps: the low-pass ``h`` shifted to the channel,
   ``h[i] e^{-j 2 pi f_c i / fs}``, each part truncated to Q.14;
   output ``k`` is ``y[k] = sum_i taps[i] x[k D + i]``, stream sample 0
   being the first sample the receiver was given;
3. the discriminator: ``phi = arg(y[k] conj(y[k-1])) - 2 pi f_c D / fs``
   wrapped into (-pi, pi], PCM ``trunc(phi / pi * 2^14)``; 0 where both
   parts of the product are 0 (so the first output is 0);
4. each protocol's rational resampler ``I/D``: the Kaiser low-pass of
   upstream's designer (gain ``I``, 0.4 of the band, beta 7) in Q.14
   (truncated), split into ``I`` phases of ``P`` taps (``P`` the taps over
   ``I``, rounded up to a multiple of 4); output ``m`` is
   ``sum_p phase[(m D) % I][p] pcm[(m D) // I + p - L] / 2^14`` with
   ``L = P - ceil(D / I)`` samples of zero history at the stream's start;
5. the DC blocker on its output truncated to int16 (:func:`dc_input`):
   ``y[n] = q y[n-1] + x[n] - x[n-1]``, ``q = 1 - trunc(1.6384) / 2^14``
   for the pole 0.9999, rounded to int16;
6. the egress gate's carried tail of a FLEX row: its last 384 int16
   outputs.

A phase difference within ``WRAP_MARGIN`` of +-pi is ambiguous: the
float32 discriminator of a receiver may put it on either side of the wrap,
32,768 LSB apart, so :meth:`Receiver.pcm` marks those outputs, and the
outputs of the resampler that read them, for the comparison to leave out.

``precision="bf16"`` is the control: the channel outputs and the
resampler's sums rounded to bfloat16, the nearest precision below the
float32 that the configuration's discriminator and resampler state.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch

Q14 = 16384
FLEX_TAIL = 384
PROTOCOL_RATES = {"pocsag": 38_400, "flex": 16_000}
DC_POLE = 0.9999
# radians; a float32 discriminator is within 3e-6 of the exact angle
WRAP_MARGIN = 1e-4


def firdes_low_pass(gain: float, sampling_freq: float, cutoff_freq: float,
                    transition_width: float, beta: float = 7.0) -> np.ndarray:
    """Upstream's Kaiser windowed-sinc design (GNU Radio's ``firdes``),
    normalised to a DC gain of ``gain``."""
    atten = beta / 0.1102 + 8.7
    ntaps = int(atten / (22.0 * transition_width / sampling_freq))
    ntaps += ntaps % 2 == 0
    w = np.kaiser(ntaps, beta)
    m = (ntaps - 1) // 2
    wc = 2.0 * np.pi * cutoff_freq / sampling_freq
    n = np.arange(ntaps) - m
    taps = np.where(n != 0, np.sin(n * wc) / (np.where(n, n, 1) * np.pi),
                    wc / np.pi) * w
    return taps * (gain / (taps[m] + 2.0 * taps[m + 1:].sum()))


def resampler_taps(interpolation: int, decimation: int) -> np.ndarray:
    """Upstream's rational resampler filter for ``I/D`` at 0.4 of the band,
    in Q.14 (C truncation)."""
    rate = interpolation / decimation
    if rate >= 1.0:
        trans = 0.5 - 0.4
        mid = 0.5 - trans / 2.0
    else:
        trans = rate * (0.5 - 0.4)
        mid = rate * 0.5 - trans / 2.0
    h = firdes_low_pass(float(interpolation), float(interpolation), mid,
                        trans)
    return np.trunc(h * Q14).astype(np.int64)


def ratio(protocol: str, channel_rate: float) -> tuple[int, int]:
    r = math.gcd(PROTOCOL_RATES[protocol], int(round(channel_rate)))
    return PROTOCOL_RATES[protocol] // r, int(round(channel_rate)) // r


def dc_input(x: torch.Tensor) -> np.ndarray:
    """The DC blocker's input: resampler output cut to int16."""
    return np.clip(torch.trunc(x).cpu().numpy(), -32768, 32767)


def widen(wire: np.ndarray, wire_fmt: str) -> np.ndarray:
    """[n, 2] wire samples -> [n, 2] int16 values."""
    if wire_fmt == "cs16":
        return np.asarray(wire, np.int16)
    if wire_fmt == "rtl_u8":
        return ((np.asarray(wire, np.int16) - 127) << 7).astype(np.int16)
    raise ValueError(f"unknown wire format {wire_fmt!r}")


class Receiver:
    """The chain for one configuration: ``channels`` as (offset Hz,
    protocol) pairs, every channel DC-blocked."""

    def __init__(self, lpf_taps, sample_rate: float, decimation: int,
                 channels, *, precision: str = "f64", device="cpu"):
        if precision not in ("f64", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.fs = float(sample_rate)
        self.dec = int(decimation)
        self.channels = list(channels)
        lpf = np.asarray(lpf_taps, np.float64)
        self.ntaps = lpf.shape[0]
        offs = np.asarray([off for off, _ in self.channels], np.float64)
        i = np.arange(self.ntaps)
        shifted = lpf[:, None] * np.exp(-2j * np.pi * offs[None, :]
                                        * i[:, None] / self.fs)
        self.hr = torch.from_numpy(np.trunc(shifted.real * Q14)).to(
            self.device)
        self.hi = torch.from_numpy(np.trunc(shifted.imag * Q14)).to(
            self.device)
        om = -2.0 * np.pi * offs * self.dec / self.fs
        self.omega = torch.from_numpy(np.angle(np.exp(1j * om))).to(
            self.device)
        rate = self.fs / self.dec
        self.groups: dict = {}
        for c, (_, proto) in enumerate(self.channels):
            self.groups.setdefault(ratio(proto, rate), []).append(c)
        self.phases = {}
        for (ip, dp) in self.groups:
            taps = resampler_taps(ip, dp)
            p = -(-taps.shape[0] // ip)
            p = (p + 3) & ~3
            ph = np.zeros((ip, p), np.float64)
            ph[np.arange(taps.shape[0]) % ip,
               np.arange(taps.shape[0]) // ip] = taps
            self.phases[ip, dp] = torch.from_numpy(ph).to(self.device)

    def lag(self, gid) -> int:
        """``L``: the resampler's zero history at the stream's start."""
        ip, dp = gid
        return self.phases[gid].shape[1] - -(-dp // ip)

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16":
            return t.to(torch.bfloat16).to(torch.float64)
        return t

    def pcm(self, x: torch.Tensor, k0: int, k_end: int):
        """Discriminator PCM [C, k_end - k0] (float64 holding integers) of
        outputs ``k0 .. k_end``, and where it is ambiguous (bool, same
        shape); ``x`` [n, 2] int16 starts at stream sample ``(k0 - 1) D``
        (at 0 when ``k0`` is 0)."""
        d, t = self.dec, self.ntaps
        first = max(k0 - 1, 0)
        n_y = k_end - first
        xf = x.to(self.device, torch.float64)
        need = (n_y - 1) * d + t
        if xf.shape[0] < need:
            raise ValueError(f"{xf.shape[0]} samples, outputs {first}.."
                             f"{k_end} need {need}")
        wr = xf[:need, 0].unfold(0, t, d)
        wi = xf[:need, 1].unfold(0, t, d)
        yr = self._round(wr @ self.hr - wi @ self.hi)
        yi = self._round(wr @ self.hi + wi @ self.hr)
        if k0 == 0:
            pr = torch.cat([torch.zeros_like(yr[:1]), yr[:-1]])
            pi = torch.cat([torch.zeros_like(yi[:1]), yi[:-1]])
        else:
            pr, pi, yr, yi = yr[:-1], yi[:-1], yr[1:], yi[1:]
        sre = yr * pr + yi * pi
        sim = yi * pr - yr * pi
        phi = torch.atan2(sim, sre) + self.omega[None, :]
        phi = torch.where(phi > math.pi, phi - 2 * math.pi, phi)
        phi = torch.where(phi <= -math.pi, phi + 2 * math.pi, phi)
        phi = torch.where((sre == 0) & (sim == 0), torch.zeros_like(phi), phi)
        amb = phi.abs() > math.pi - WRAP_MARGIN
        return (torch.trunc(phi / math.pi * Q14).T.contiguous(),
                amb.T.contiguous())

    def resample(self, gid, pcm: torch.Tensor, amb: torch.Tensor, k0: int,
                 m0: int, m_end: int):
        """Outputs ``m0 .. m_end`` [G, m_end - m0] (float64, before the
        int16 cut) of the group's rows ``pcm`` [G, n] (outputs ``k0..``),
        and which of them read an ambiguous input (``amb``)."""
        ip, dp = gid
        ph = self.phases[gid]
        p = ph.shape[1]
        lag = self.lag(gid)
        g, n = pcm.shape
        pad = max(0, lag - k0)      # zero history before the stream's start
        u = torch.nn.functional.pad(pcm, (pad, p))
        hit = torch.nn.functional.pad(amb.to(torch.float64), (pad, p))
        base = k0 - pad             # stream index of u[:, 0]
        out = torch.empty((g, m_end - m0), dtype=torch.float64,
                          device=pcm.device)
        bad = torch.empty((g, m_end - m0), dtype=torch.bool,
                          device=pcm.device)
        for j in range(ip):
            f_lo = -(-(m0 - j) // ip)
            f_hi = -(-(m_end - j) // ip)
            if f_hi <= f_lo:
                continue
            start = (j * dp) // ip + dp * f_lo - lag - base
            if start < 0:
                raise ValueError(f"output {j + ip * f_lo} reaches before "
                                 f"the computed PCM")
            nf = f_hi - f_lo
            win = u[:, start:start + (nf - 1) * dp + p].unfold(1, p, dp)
            vals = win @ ph[(j * dp) % ip]
            out[:, j + ip * f_lo - m0::ip] = vals[:, :nf]
            touched = hit[:, start:start + (nf - 1) * dp + p].unfold(1, p, dp)
            bad[:, j + ip * f_lo - m0::ip] = touched.sum(-1)[:, :nf] > 0
        return self._round(out / Q14), bad

    @staticmethod
    def dc_block(x: torch.Tensor) -> np.ndarray:
        """int16-cut resampler output [G, n] -> DC-blocked int16 [G, n],
        from zero state at its first sample."""
        q = 1.0 - int(np.trunc((1.0 - DC_POLE) * Q14)) / Q14
        xi = dc_input(x)
        y = scipy.signal.lfilter([1.0, -1.0], [1.0, -q], xi, axis=1)
        return np.clip(np.round(y), -32768, 32767).astype(np.int16)
