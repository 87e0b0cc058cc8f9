"""POCSAG transmission generator (wire format + baseband PCM).

Produces the exact on-air bit order the decoder consumes:

* stored-word convention: on-air bit b == stored word bit b (LSB-first),
  matching the receiver's batch packing (``pager_pocsag.c:477``);
* sync word transmitted MSB-first of 0x7CD215D8 (``:516``);
* address word: flag 0, 18 capcode MSBs at on-air bits 1..18 (LSB-first),
  function at bits 19..20; frame slot z = 2*(capcode & 7) (``:357-364``);
* message words: flag 1, 20 content bits; alpha = 7-bit chars LSB-first,
  numeric = 4-bit BCD LSB-first (``:365-415``);
* BCH(31,21) parity + even-parity bit 31.

Discriminator-domain modulation: bit 1 -> negative PCM (``:476``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tsl_sdr_tpu_torch.models.bch import pocsag_bch

SYNC_WORD = 0x7CD215D8
IDLE_STORED = 0xE983915E  # on-air/LSB-first stored form incl. parity bit
BASE_RATE = 38400

NUMERIC_CHARMAP = "0123456789XU -[]"
_BCH = pocsag_bch(native=False)  # encode only: the numpy tier, no build


def _even_parity_bit(word31: int) -> int:
    return bin(word31).count("1") & 1


def make_address_word(capcode: int, function: int) -> int:
    """Full 32-bit stored word (on-air bit b at bit b)."""
    addr18 = (capcode >> 3) & 0x3FFFF
    payload = (addr18 << 1) | ((function & 3) << 19)  # flag bit 0 == 0
    word31 = int(_BCH.encode_onair_payload(np.asarray([payload]))[0])
    return word31 | (_even_parity_bit(word31) << 31)


def make_data_word(content20: int) -> int:
    payload = 1 | ((content20 & 0xFFFFF) << 1)  # flag bit 0 == 1
    word31 = int(_BCH.encode_onair_payload(np.asarray([payload]))[0])
    return word31 | (_even_parity_bit(word31) << 31)


def pack_alpha(text: bytes) -> list[int]:
    """7-bit chars LSB-first -> 20-bit word contents (zero padded)."""
    bits: list[int] = []
    for c in text:
        bits.extend((c >> i) & 1 for i in range(7))
    while len(bits) % 20:
        bits.append(0)
    return [
        sum(b << i for i, b in enumerate(bits[k : k + 20]))
        for k in range(0, len(bits), 20)
    ]


def expected_alpha_decode(text: bytes) -> bytes:
    """What the reference decoder will deliver for pack_alpha(text): every
    complete 7-bit group is a char, so zero padding may append NULs."""
    nbits = 7 * len(text)
    total = -(-nbits // 20) * 20
    out = list(text) + [0] * ((total // 7) - len(text))
    return bytes(out)


def pack_numeric(digits: str) -> list[int]:
    bits: list[int] = []
    for ch in digits:
        v = NUMERIC_CHARMAP.index(ch)
        bits.extend((v >> i) & 1 for i in range(4))
    while len(bits) % 20:
        bits.append(0)
    return [
        sum(b << i for i, b in enumerate(bits[k : k + 20]))
        for k in range(0, len(bits), 20)
    ]


def expected_numeric_decode(digits: str) -> str:
    nbits = 4 * len(digits)
    total = -(-nbits // 20) * 20
    return digits + "0" * ((total // 4) - len(digits))


@dataclass
class PocsagBurst:
    capcode: int
    function: int
    kind: str       # "alpha" | "numeric"
    content: str | bytes


def build_words(bursts: list[PocsagBurst]) -> list[int]:
    """Assemble sync + batches of 16 words for a sequence of messages."""
    stream: list[int] = []  # stored 32-bit words, batch-aligned (no syncs yet)
    pos = 0  # word index within current batch

    def pad_to(target_pos):
        nonlocal pos
        while pos != target_pos:
            stream.append(IDLE_STORED)
            pos = (pos + 1) % 16

    for b in bursts:
        frame_slot = 2 * (b.capcode & 7)
        if pos > frame_slot:
            pad_to(0)
        pad_to(frame_slot)
        stream.append(make_address_word(b.capcode, b.function))
        pos = (pos + 1) % 16
        contents = (
            pack_alpha(b.content if isinstance(b.content, bytes) else b.content.encode())
            if b.kind == "alpha"
            else pack_numeric(b.content)
        )
        for c in contents:
            stream.append(make_data_word(c))
            pos = (pos + 1) % 16
        # terminate with at least one idle so the decoder delivers
        stream.append(IDLE_STORED)
        pos = (pos + 1) % 16
    pad_to(0)
    return stream


def words_to_bits(words: list[int]) -> np.ndarray:
    """Batches of 16 words -> on-air bit stream with sync before each batch."""
    bits: list[int] = []
    for batch_start in range(0, len(words), 16):
        bits.extend((SYNC_WORD >> (31 - i)) & 1 for i in range(32))  # MSB first
        for w in words[batch_start : batch_start + 16]:
            bits.extend((w >> i) & 1 for i in range(32))  # LSB first
    return np.asarray(bits, dtype=np.uint8)


def modulate(bits: np.ndarray, baud: int, amplitude: int = 8192,
             preamble_bits: int = 576) -> np.ndarray:
    """Bits -> 38400 Hz discriminator-domain PCM (bit 1 == negative)."""
    spb = BASE_RATE // baud
    pre = np.resize(np.asarray([1, 0], dtype=np.uint8), preamble_bits)
    all_bits = np.concatenate([pre, bits])
    levels = np.where(all_bits > 0, -amplitude, amplitude).astype(np.int16)
    return np.repeat(levels, spb)


def generate(bursts: list[PocsagBurst], baud: int = 1200,
             amplitude: int = 8192, tail_bits: int = 64) -> np.ndarray:
    bits = words_to_bits(build_words(bursts))
    pcm = modulate(bits, baud, amplitude)
    spb = BASE_RATE // baud
    tail = np.resize(
        np.asarray([amplitude, -amplitude], dtype=np.int16), tail_bits
    )
    return np.concatenate([pcm, np.repeat(tail, spb)])
