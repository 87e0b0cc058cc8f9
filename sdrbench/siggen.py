"""POCSAG and FLEX transmitters: decoder-rate discriminator PCM of one
message, and what a receiver that follows the protocol must deliver.

Copies of ``tsl_sdr_tpu_torch/testing/pocsag_gen.py`` (alphanumeric
messages) and ``tsl_sdr_tpu_torch/testing/flex_gen.py`` (one 1600 bps
2-FSK frame, one short-address alphanumeric message), with the BCH(31,21)
encoder of ``tsl_sdr_tpu_torch/models/bch.py`` written out for the one
generator polynomial both protocols use. The benchmark keeps its own copy so
that what goes on air does not change with the program under test.
"""

from __future__ import annotations

import numpy as np

# BCH(31,21): g(x) = x^10 + x^9 + x^8 + x^6 + x^5 + x^3 + 1
BCH_G = 0x769

POCSAG_RATE = 38_400
POCSAG_SYNC = 0x7CD215D8
POCSAG_IDLE = 0xE983915E   # stored (on-air LSB-first) form, parity included

FLEX_RATE = 16_000
FLEX_BS1 = 0xAAAAAAAA
FLEX_MAGIC_A = 0x5939
FLEX_MAGIC_B = 0x5555
FLEX_MAGIC_C = 0xED84
FLEX_SEQ_A = 0x78F3        # the 1600 bps 2-FSK coding's A word
FLEX_SYMBOLS = 2816        # a block of 11 x 8 words of 32 bits
FLEX_SYNC2_SAMPLES = 4
FLEX_PHASE_WORDS = 88


def _reverse(v: int, nbits: int) -> int:
    return int(f"{v:0{nbits}b}"[::-1], 2)


def bch_word(payload21: int) -> int:
    """A 21-bit payload in on-air LSB-first order -> the 32-bit stored word:
    systematic BCH(31,21) parity and the even-parity bit 31."""
    data = _reverse(payload21 & 0x1FFFFF, 21)
    rem = data << 10
    for bit in range(30, 9, -1):
        if rem >> bit & 1:
            rem ^= BCH_G << (bit - 10)
    w31 = _reverse((data << 10) | rem, 31)
    return w31 | ((bin(w31).count("1") & 1) << 31)


# -- POCSAG ----------------------------------------------------------------

def _pocsag_words(capcode: int, function: int, text: bytes) -> list[int]:
    """Address word in its frame slot, the 7-bit characters LSB first in
    20-bit data words, one idle word, idles to the batch's end."""
    words: list[int] = []
    slot = 2 * (capcode & 7)
    words += [POCSAG_IDLE] * slot
    addr = (((capcode >> 3) & 0x3FFFF) << 1) | ((function & 3) << 19)
    words.append(bch_word(addr))
    bits = [(c >> i) & 1 for c in text for i in range(7)]
    bits += [0] * (-len(bits) % 20)
    for k in range(0, len(bits), 20):
        content = sum(b << i for i, b in enumerate(bits[k:k + 20]))
        words.append(bch_word(1 | (content << 1)))
    words.append(POCSAG_IDLE)
    words += [POCSAG_IDLE] * (-len(words) % 16)
    return words


def pocsag_pcm(capcode: int, function: int, text: bytes, *, baud: int,
               amplitude: int, preamble_bits: int = 576,
               tail_bits: int = 256) -> np.ndarray:
    """One alphanumeric message as 38,400 Hz PCM (bit 1 negative): the
    preamble, a sync word before each batch of 16 words, an alternating
    tail."""
    bits: list[int] = [(i + 1) & 1 for i in range(preamble_bits)]
    words = _pocsag_words(capcode, function, text)
    for b0 in range(0, len(words), 16):
        bits += [(POCSAG_SYNC >> (31 - i)) & 1 for i in range(32)]
        for w in words[b0:b0 + 16]:
            bits += [(w >> i) & 1 for i in range(32)]
    levels = np.where(np.asarray(bits) > 0, -amplitude, amplitude)
    tail = np.resize([amplitude, -amplitude], tail_bits)
    spb = POCSAG_RATE // baud
    return np.repeat(np.concatenate([levels, tail]), spb).astype(np.int16)


def pocsag_expected(text: bytes) -> bytes:
    """The characters a receiver delivers: every whole 7-bit group of the
    zero-padded data words, so the padding may add NULs."""
    total = -(-7 * len(text) // 20) * 20
    return bytes(text) + bytes(total // 7 - len(text))


# -- FLEX ------------------------------------------------------------------

def _nibble_sum(word: int) -> int:
    word &= 0x1FFFFF
    return sum((word >> (4 * i)) & 0xF for i in range(6)) & 0xF


def _checked(payload: int) -> int:
    """Bits 0..3 set so that the nibble sum over 21 bits is 0xF."""
    payload &= ~0xF
    return payload | ((0xF - _nibble_sum(payload)) & 0xF)


def _flex_words(capcode: int, text: bytes) -> list[int]:
    """Phase A's 88 words: BIW, short address, vector, status and
    characters (three 7-bit characters a word, ETX-padded), fill."""
    chars = list(text)
    chars += [0x03] * (-len(chars) % 3)
    data = [0] + [chars[k] | (chars[k + 1] << 7) | (chars[k + 2] << 14)
                  for k in range(0, len(chars), 3)]
    vsw = 2      # BIW, one address
    start = vsw + 1
    vec = _checked((5 << 4) | (start << 7) | (len(data) << 14))
    biw = _checked(vsw << 10)
    words = [biw, capcode + 32768, vec] + data
    if len(words) > FLEX_PHASE_WORDS:
        raise ValueError(f"{len(text)} characters overflow a FLEX phase")
    words += [0] * (FLEX_PHASE_WORDS - len(words))
    return [bch_word(w) for w in words]


def flex_pcm(capcode: int, text: bytes, *, amplitude: int,
             lead_in_bits: int = 40, tail_bits: int = 300, cycle: int = 3,
             frame: int = 77) -> np.ndarray:
    """One FLEX frame at 1600 bps 2-FSK (symbol 1 positive) as 16 kHz
    PCM, 10 samples a symbol: lead-in, sync 1 (BS1, A, B, inverted A), the
    frame information word, sync 2, the interleaved block, a tail."""
    if not 0x8000 < capcode + 32768 <= 0x1E0000:
        raise ValueError(f"capcode {capcode} has no short address")
    a_word = (FLEX_SEQ_A << 16) | FLEX_MAGIC_A
    fiw = bch_word(_checked(((cycle & 0xF) << 4) | ((frame & 0x7F) << 8)))
    bits: list[int] = [0] * lead_in_bits
    bits += [(FLEX_BS1 >> (31 - i)) & 1 for i in range(32)]
    bits += [(a_word >> (31 - i)) & 1 for i in range(32)]
    bits += [(FLEX_MAGIC_B >> (15 - i)) & 1 for i in range(16)]
    bits += [(~a_word >> (31 - i)) & 1 for i in range(32)]
    bits += [(fiw >> i) & 1 for i in range(32)]
    bits += [i & 1 for i in range(FLEX_SYNC2_SAMPLES)]
    bits += [(FLEX_MAGIC_C >> (15 - i)) & 1 for i in range(16)]
    bits += [1 - (i & 1) for i in range(FLEX_SYNC2_SAMPLES)]
    bits += [1 - ((FLEX_MAGIC_C >> (15 - i)) & 1) for i in range(16)]
    words = _flex_words(capcode, text)
    # 11 blocks of 8 words, bit-interleaved: bit b of each of the 8 words
    bits += [(words[blk * 8 + w] >> b) & 1 for blk in range(11)
             for b in range(32) for w in range(8)]
    bits += [0] * tail_bits
    levels = np.where(np.asarray(bits) > 0, amplitude, -amplitude)
    return np.repeat(levels, 10).astype(np.int16)


def flex_expected(text: bytes) -> bytes:
    return bytes(text)
