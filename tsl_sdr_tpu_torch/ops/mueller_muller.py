"""Mueller & Muller decision-directed clock recovery.

Port of ``tsl_sdr_tpu/ops/mueller_muller.py`` (numpy, on the host).
Reference behaviour (``pager/mueller_muller.c:40-115``): a PI timing loop
over int16 PCM; per recovered symbol at fractional position ``cur``:

    sample  = pcm[int(cur + 0.5)]            (nearest, no interpolation)
    e       = sign(last)*sample - sign(sample)*last
    w       = clamp(w + kw*e, error_min, error_max)
    m      += w + km*sample
    cur    += floor(m);  m -= floor(m)

with the fractional ``next_offset`` carried across buffers. Float32
arithmetic; decisions are the raw picked samples.

The consumption rate is data-dependent (a serial recurrence), so this runs
on the host; at symbol rates (<10 kHz) it is never the bottleneck. It
serves clock-recovery-parity configurations, e.g. after the Costas chain;
the production POCSAG/FLEX/AIS paths use the reference's hard sample-skip
slicing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MuellerMuller:
    kw: float
    km: float
    samples_per_bit: float
    error_min: float
    error_max: float

    def __post_init__(self):
        self.next_offset = np.float32(0.0)
        self.w = np.float32(self.samples_per_bit)
        self.m = np.float32(self.samples_per_bit)
        self.last_sample = np.float32(0.0)

    def process(self, samples) -> np.ndarray:
        """[N] int16 -> int16 symbol-rate decision stream."""
        samples = np.asarray(samples, dtype=np.int16)
        n = np.float32(len(samples))
        cur = self.next_offset
        w = self.w
        m = self.m
        last = self.last_sample
        kw = np.float32(self.kw)
        km = np.float32(self.km)
        emin = np.float32(self.error_min)
        emax = np.float32(self.error_max)
        out = []
        while cur < n:
            sample = np.float32(samples[int(cur + np.float32(0.5))])
            out.append(np.int16(sample))
            sgn_last = np.float32(int(last > 0) - int(last < 0))
            sgn_s = np.float32(int(sample > 0) - int(sample < 0))
            w_error = np.float32(sgn_last * sample - sgn_s * last)
            w = np.float32(w + w_error * kw)
            if emin > w:
                w = emin
            elif emax < w:
                w = emax
            m = np.float32(m + w + km * sample)
            f = np.float32(np.floor(m))
            cur = np.float32(cur + f)
            m = np.float32(m - f)
            last = sample
        self.next_offset = np.float32(cur - n)
        self.w = w
        self.m = m
        self.last_sample = last
        return np.asarray(out, dtype=np.int16)
