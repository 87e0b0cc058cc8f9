"""Push-style streaming adapters around the block-form kernels.

jax-free copy of ``tsl_sdr_tpu/runtime/stream.py:13-149`` (that module
imports the JAX ``ResamplerChain`` and so cannot load without jax), with
:class:`PushResampler` driving the port's
:class:`~tsl_sdr_tpu_torch.models.resampler.ResamplerChain`.
"""

from __future__ import annotations

import signal
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from tsl_sdr_tpu_torch.models.resampler import ResamplerChain


@dataclass
class StreamCounters:
    """Reference-style running counters (``multifm/demod.h:71-81``,
    ``ais/ais_demod_priv.h:154``)."""

    samples_in: int = 0
    samples_out: int = 0
    messages: int = 0
    dropped: int = 0
    crc_rejects: int = 0

    def summary(self) -> str:
        return (
            f"samples_in={self.samples_in} samples_out={self.samples_out} "
            f"messages={self.messages} dropped={self.dropped} "
            f"crc_rejects={self.crc_rejects}"
        )


class StatsTicker:
    """Periodic live-counters line to stderr, printed during the run."""

    def __init__(self, interval: float, counters: StreamCounters, label: str):
        self.interval = float(interval)
        self.counters = counters
        self.label = label
        self._t_last = time.monotonic()
        self._n_last = 0

    def tick(self, extra: str = ""):
        if not self.interval:
            return
        now = time.monotonic()
        dt = now - self._t_last
        if dt < self.interval:
            return
        n = self.counters.samples_in
        rate = (n - self._n_last) / dt / 1e6
        self._t_last, self._n_last = now, n
        print(f"{self.label}: stats {self.counters.summary()} "
              f"[{rate:.2f} Msps]{extra}", file=sys.stderr, flush=True)


def install_sigterm_as_interrupt():
    """Route SIGTERM (service-manager stop) through KeyboardInterrupt so
    the CLI run loops take their drain-and-summarize exit path, like
    Ctrl-C. No-op off the main thread."""
    def _term(_sig, _frm):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass


class PushResampler:
    """Feed arbitrary-sized int16 chunks; emits resampled PCM as available.

    Primes the chain's carry with the first ``carry_len`` samples, then
    steps in fixed ``block_in`` blocks, buffering remainders. The complete
    blocks of one push go to the device in one copy, and their outputs
    come back in one."""

    def __init__(self, chain: ResamplerChain):
        self.chain = chain
        self._pending = np.zeros(0, dtype=np.int16)
        self._state = None

    def push(self, samples) -> np.ndarray:
        self._pending = np.concatenate(
            [self._pending, np.asarray(samples, dtype=np.int16)])
        plan = self.chain.plan
        if self._state is None:
            if len(self._pending) < plan.carry_len:
                return np.zeros(0, dtype=np.int16)
            self._state = self.chain.init_state(
                prefix=self._pending[:plan.carry_len])
            self._pending = self._pending[plan.carry_len:]

        n_blocks = len(self._pending) // plan.block_in
        if not n_blocks:
            return np.zeros(0, dtype=np.int16)
        n = n_blocks * plan.block_in
        blocks = torch.from_numpy(self._pending[:n].copy()).to(
            self.chain.device)
        self._pending = self._pending[n:]
        outs = []
        for lo in range(0, n, plan.block_in):
            self._state, out = self.chain.step(
                self._state, blocks[lo:lo + plan.block_in])
            outs.append(out)
        return torch.cat(outs).cpu().numpy()

    def flush(self) -> np.ndarray:
        """Zero-pad the tail out to full blocks and emit what they yield.

        The zero padding produces filter-settled samples past the true
        stream end; decoders treat them as silence."""
        plan = self.chain.plan
        if self._state is None:
            # stream shorter than the prime; pad through priming too
            need = plan.carry_len + plan.block_in - len(self._pending)
        else:
            need = (-len(self._pending)) % plan.block_in
            need += plan.block_in  # one extra block to drain the carry
        return self.push(np.zeros(need, dtype=np.int16))


def iter_file_blocks(path, block_bytes: int = 1 << 18, dtype=np.int16,
                     unit_items: int = 1):
    """Yield dtype blocks from a file or FIFO until EOF.

    ``unit_items``: carry the byte residue to a multiple of this many
    items (2 for interleaved IQ, so a FIFO short read never splits an I/Q
    pair across chunks)."""
    unit = np.dtype(dtype).itemsize * unit_items
    with open(path, "rb", buffering=0) as f:
        carry = b""
        while True:
            data = f.read(block_bytes)
            if not data:
                break
            data = carry + data
            usable = len(data) - (len(data) % unit)
            carry = data[usable:]
            if usable:
                yield np.frombuffer(data[:usable], dtype=dtype)
