"""Device-side sync-candidate prefilters for egress gating, and packbits.

Port of ``tsl_sdr_tpu/ops/sync_prefilter.py``: per channel per block, is
there any POCSAG (hamming <= 4 of the sync word, a pair of matches spb/4
apart), FLEX (exact BS1) or AIS (NRZI preamble within hamming 2, two
matches within 4) candidate? A block that raises no flag provably holds no
sync start, so its bits never leave the device. See the JAX module for the
superset arguments; the arithmetic here is the same.

The 32-bit slicer registers are built in int64 (the card's support for
uint32 shifts is incomplete); a register is evaluated at every position
from 32 unit-stride shifted slices. Inputs are ``[C, T + K]`` bit planes:
``T`` carried tail bits, then ``K`` new positions.
"""

from __future__ import annotations

import torch

POCSAG_SYNC = 0x7CD215D8
POCSAG_SPBS = (75, 32, 16)   # 38400 Hz / {512, 1200, 2400} baud
POCSAG_MAX_HAM = 4
POCSAG_TAIL = 2560

AIS_PREAMBLE = 0x5555557E
AIS_DECIM = 5
AIS_MAX_HAM = 2
AIS_TAIL = 256

FLEX_BS1 = 0xAAAAAAAA
FLEX_SPB = 10
FLEX_TAIL = 384


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of non-negative int64 values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _matches(bits: torch.Tensor, start: int, span: int, spb: int, word: int,
             max_ham: int) -> torch.Tensor:
    """[C, span] bool: is the 32-tap register ending at positions
    ``start .. start+span`` within ``max_ham`` of ``word``? Register bit k
    at position p = bits[p - k*spb]; ``bits`` is int64."""
    if start < 31 * spb:
        raise ValueError(f"register span {31 * spb} exceeds start {start}")
    w = torch.zeros((bits.shape[0], span), dtype=torch.int64,
                    device=bits.device)
    for k in range(32):
        s0 = start - k * spb
        w |= bits[:, s0:s0 + span] << k
    return _popcount32(w ^ word) <= max_ham


def pocsag_any_candidate(pred: torch.Tensor, k_new: int) -> torch.Tensor:
    """``pred`` [C, T+K] = (pcm < 0) bits -> [C] bool."""
    bits = pred.to(torch.int64)
    t = bits.shape[1] - k_new
    flag = torch.zeros(bits.shape[0], dtype=torch.bool, device=bits.device)
    for spb in POCSAG_SPBS:
        d = max(1, spb // 4)
        m = _matches(bits, t - d - 1, k_new + d + 1, spb, POCSAG_SYNC,
                     POCSAG_MAX_HAM)
        flag |= (m[:, :-d] & m[:, d:]).any(dim=1)
    return flag


def flex_any_candidate(pred: torch.Tensor, k_new: int) -> torch.Tensor:
    """``pred`` [C, T+K] = (pcm >= 0) bits -> [C] bool (exact BS1)."""
    bits = pred.to(torch.int64)
    t = bits.shape[1] - k_new
    return _matches(bits, t, k_new, FLEX_SPB, FLEX_BS1, 0).any(dim=1)


def ais_any_candidate(pred: torch.Tensor, k_new: int) -> torch.Tensor:
    """``pred`` [C, T+K] = (pcm > 0) bits -> [C] bool."""
    p = pred.to(torch.int64)
    nrzi = torch.zeros_like(p)
    nrzi[:, AIS_DECIM:] = 1 - (p[:, AIS_DECIM:] ^ p[:, :-AIS_DECIM])
    t = p.shape[1] - k_new
    margin = AIS_DECIM - 1
    m = _matches(nrzi, t - margin, k_new + margin, AIS_DECIM, AIS_PREAMBLE,
                 AIS_MAX_HAM)
    flag = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for d in range(1, AIS_DECIM):
        flag |= (m[:, :-d] & m[:, d:]).any(dim=1)
    return flag


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """[C, K] 0/1 uint8 -> [C, ceil(K/8)] uint8, big-endian bit order
    within each byte (``np.packbits(bits, axis=1)``); the last byte is
    zero-padded."""
    c, k = bits.shape
    k8 = -(-k // 8) * 8
    if k8 != k:
        bits = torch.nn.functional.pad(bits, (0, k8 - k))
    shifts = torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    b = bits.reshape(c, k8 // 8, 8).to(torch.int32) << shifts
    return b.sum(dim=2).to(torch.uint8)
