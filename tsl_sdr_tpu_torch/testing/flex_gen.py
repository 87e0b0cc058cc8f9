"""FLEX transmission generator (wire format + 16 kHz discriminator PCM).

Emits the exact structure the decoder consumes (reference
``pager/pager_flex.c``):

* SYNC_1 at 1600 bps 2FSK, 10 samples/bit: BS1 0xAAAAAAAA (MSB first),
  A = seq_a | magic 0x5939, B = 0x5555, inverted A, then the FIW
  (LSB-first, BCH(31,21) + 4-bit nibble-sum checksum);
* SYNC_2 at the target coding's rate: comma dots / C 0xED84 / inverted
  comma / inverted C, sized per the coding's consumption counts;
* 11 interleaved blocks per phase: 8-word round-robin bit interleave,
  words LSB-first (``_pager_flex_phase_append_bit``, flex.c:1201-1222);
* BIW / short address / vector / message words with BCH parity and
  nibble-sum checksums.

2FSK symbol 1 == sample >= 0 (NOTE: opposite sign convention to POCSAG).
4FSK levels: strong = +/-amp, weak = +/-amp/4 (slicer threshold trains to
~amp/2 from the 2FSK sync swing).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tsl_sdr_tpu_torch.models.bch import pocsag_bch
from tsl_sdr_tpu_torch.models.flex import CODINGS, Coding  # the protocol coding table

_BCH = pocsag_bch(native=False)  # encode only: the numpy tier, no build

MAGIC_A = 0x5939
MAGIC_B = 0x5555
MAGIC_C = 0xED84
BS1 = 0xAAAAAAAA

PHASE_WORDS = 88




def word_checksum(word: int) -> int:
    word &= 0x1FFFFF
    ck = 0
    for _ in range(6):
        ck += word & 0xF
        word >>= 4
    return ck & 0xF


def _with_checksum(payload_without_ck: int) -> int:
    """Fill bits 0..3 so the nibble sum over 21 bits == 0xF."""
    rest = word_checksum(payload_without_ck & ~0xF)
    ck = (0xF - rest) & 0xF
    return (payload_without_ck & ~0xF) | ck


def encode_word(payload21: int) -> int:
    """BCH-encode + even-parity a 21-bit payload (LSB-first word layout)."""
    w31 = int(_BCH.encode_onair_payload(np.asarray([payload21 & 0x1FFFFF]))[0])
    parity = bin(w31).count("1") & 1
    return w31 | (parity << 31)


def make_fiw(cycle: int, frame: int, roam: bool = False, repeat: bool = False) -> int:
    payload = ((cycle & 0xF) << 4) | ((frame & 0x7F) << 8)
    payload |= (1 << 15) if roam else 0
    payload |= (1 << 16) if repeat else 0
    return encode_word(_with_checksum(payload))


def make_biw(vsw: int, eob: int = 0, prio: int = 0, carry: int = 0, collapse: int = 0) -> int:
    payload = (prio << 4) | ((eob & 3) << 8) | ((vsw & 0x3F) << 10)
    payload |= (carry & 3) << 16 | (collapse & 7) << 18
    return encode_word(_with_checksum(payload))


def make_date_biw(year: int, month: int, day: int) -> int:
    """Extra BIW function 1: date (pager_flex.c:1059-1065)."""
    payload = (1 << 4) | ((day & 0xF) << 7) | (((month - 1) & 0x1F) << 11) \
        | (((year - 1994) & 0x1F) << 16)
    return encode_word(_with_checksum(payload))


def make_time_biw(hour: int, minute: int, second: int) -> int:
    """Extra BIW function 2: time, seconds in units of 8
    (pager_flex.c:1066-1072)."""
    payload = (2 << 4) | (((second >> 3) & 0x7) << 7) | ((minute & 0x3F) << 10) \
        | ((hour & 0x1F) << 16)
    return encode_word(_with_checksum(payload))


def make_short_address(capcode: int) -> int:
    a = capcode + 32768
    assert 0x8000 < a <= 0x1E0000, "capcode out of short-address range"
    return encode_word(a)


def make_long_address(capcode: int) -> tuple[int, int]:
    """Two-word (long) address: the decoder computes
    capcode = 0x1F9001 + (0x1FFFFF - a2)*32768 + a1 - 1 (flex.c:567)."""
    v = capcode - 0x1F9001
    assert v >= 0
    a1 = v % 32768 + 1          # stays below the short-address range
    a2 = 0x1FFFFF - v // 32768
    return encode_word(a1), encode_word(a2)


@dataclass
class FlexBurstMessage:
    capcode: int
    kind: str                 # "alnum" | "numeric" | "tone" | "siv"
    content: str = ""
    seq_num: int = 0
    fragment: bool = False
    maildrop: bool = False
    siv_type: int = 0
    siv_data: int = 0
    long_address: bool = False


NUM_LUT = "0123456789XU -]["


def _pack_alnum_words(text: bytes, seq_num: int, fragment: bool, maildrop: bool):
    status = ((seq_num & 3) << 11) | ((1 << 10) if fragment else 0)
    if seq_num == 3 and maildrop:
        status |= 1 << 20
    words = [status]
    chars = list(text)
    if seq_num == 3:
        # decoder skips the first 7 bits of the first char word (flex.c:652-656)
        chars = [0x00] + chars
    while len(chars) % 3:
        chars.append(0x03)  # ETX terminator(s) inside the final word
    for k in range(0, len(chars), 3):
        w = chars[k] | (chars[k + 1] << 7) | (chars[k + 2] << 14)
        words.append(w)
    return words


def _pack_numeric_words(digits: str):
    """Digits -> 21-bit words; stream = word0 bits 2..20 then 21 bits/word."""
    bits: list[int] = []
    for ch in digits:
        v = NUM_LUT.index(ch)
        bits.extend((v >> i) & 1 for i in range(4))
    # first word holds 19 stream bits (bits 2..20)
    words = []
    first = sum(b << (2 + i) for i, b in enumerate(bits[:19]))
    words.append(first)
    rest = bits[19:]
    for k in range(0, len(rest), 21):
        words.append(sum(b << i for i, b in enumerate(rest[k : k + 21])))
    return words


def expected_numeric_decode(digits: str, nr_words: int) -> str:
    nr_bits = (19 + 21 * (nr_words - 1)) & ~0x3
    out = digits + "0" * (nr_bits // 4 - len(digits))
    return out[: nr_bits // 4]


def build_phase(messages: list[FlexBurstMessage],
                extra_biws: list[int] | None = None) -> tuple[list[int], list[dict]]:
    """Lay out one phase's 88 words; returns (words, expected-decode info).

    Long-address messages occupy two address slots and two vector slots
    (the second vector word is the "long word" = the ALN status word /
    first NUM message word). ``extra_biws`` (already BCH-encoded, e.g. from
    make_date_biw/make_time_biw) follow BIW0 with eob set accordingly.
    """
    extra_biws = extra_biws or []
    eob = len(extra_biws)
    assert eob <= 3
    addr_start = 1 + eob
    addr_units = sum(2 if m.long_address else 1 for m in messages)
    vsw = addr_start + addr_units
    addrs: list[int] = []
    vectors: list[int] = []
    data: list[int] = []
    expected = []
    data_base = vsw + addr_units

    for m in messages:
        if m.long_address:
            a1, a2 = make_long_address(m.capcode)
            addrs.extend([a1, a2])
        else:
            addrs.append(make_short_address(m.capcode))

        if m.kind == "alnum":
            content = m.content.encode() if isinstance(m.content, str) else m.content
            mw = _pack_alnum_words(content, m.seq_num, m.fragment, m.maildrop)
            exp = dict(kind="alnum", capcode=m.capcode, text=content,
                       fragment=m.fragment, seq_num=m.seq_num, maildrop=m.maildrop)
            if m.long_address:
                status, chars = mw[0], mw[1:]
                word_start = data_base
                data.extend(encode_word(w) for w in chars)
                data_base += len(chars)
                vec = _with_checksum(
                    (5 << 4) | (word_start << 7) | ((len(chars) + 1) << 14)
                )
                vectors.extend([encode_word(vec), encode_word(status)])
            else:
                word_start = data_base
                data.extend(encode_word(w) for w in mw)
                data_base += len(mw)
                vec = _with_checksum((5 << 4) | (word_start << 7) | (len(mw) << 14))
                vectors.append(encode_word(vec))
            expected.append(exp)
        elif m.kind == "numeric":
            mw = _pack_numeric_words(m.content)
            if m.long_address:
                first, rest = mw[0], mw[1:]
                word_start = data_base
                data.extend(encode_word(w) for w in rest)
                data_base += len(rest)
                vec = _with_checksum(
                    (3 << 4) | (word_start << 7) | ((len(rest) & 7) << 14)
                )
                vectors.extend([encode_word(vec), encode_word(first)])
                nwords = len(rest) + 1
            else:
                word_start = data_base
                data.extend(encode_word(w) for w in mw)
                data_base += len(mw)
                vec = _with_checksum(
                    (3 << 4) | (word_start << 7) | (((len(mw) - 1) & 7) << 14)
                )
                vectors.append(encode_word(vec))
                nwords = len(mw)
            expected.append(
                dict(kind="numeric", capcode=m.capcode,
                     text=expected_numeric_decode(m.content, nwords).encode())
            )
        elif m.kind == "tone":
            assert not m.long_address
            digits = m.content
            assert len(digits) <= 3
            dv = 0
            for i, ch in enumerate(digits):
                dv |= NUM_LUT.index(ch) << (4 * i)
            vec = _with_checksum((2 << 4) | (0 << 7) | (dv << 9))
            vectors.append(encode_word(vec))
            expected.append(
                dict(kind="numeric", capcode=m.capcode,
                     text=(digits + "0" * (3 - len(digits))).encode())
            )
        elif m.kind == "siv":
            assert not m.long_address
            vec = _with_checksum(
                (1 << 4) | ((m.siv_type & 7) << 7) | ((m.siv_data & 0x7FF) << 10)
            )
            vectors.append(encode_word(vec))
            expected.append(
                dict(kind="siv", capcode=m.capcode, siv_type=m.siv_type,
                     siv_data=m.siv_data)
            )
        else:
            raise ValueError(m.kind)

    words = [make_biw(vsw, eob=eob)] + extra_biws + addrs + vectors + data
    assert len(words) <= PHASE_WORDS, f"phase overflow: {len(words)}"
    fill = encode_word(0)
    words += [fill] * (PHASE_WORDS - len(words))
    return words, expected


def interleave_symbols(coding: Coding, phases: list[list[int]]) -> np.ndarray:
    """Phase word arrays -> symbol stream (values 0..fsk_levels-1)."""
    def phase_bits(words):
        bits = np.zeros(PHASE_WORDS * 32, dtype=np.uint8)
        k = 0
        for blk in range(11):
            for bit in range(32):
                for w in range(8):
                    bits[k] = (words[blk * 8 + w] >> bit) & 1
                    k += 1
        return bits

    pb = [phase_bits(w) for w in phases]
    n_sym = coding.symbols_per_block
    syms = np.zeros(n_sym, dtype=np.int8)
    if coding.nr_phases == 1:
        syms = pb[0][:n_sym]
    elif coding.nr_phases == 2 and coding.fsk_levels == 2:
        syms[0::2] = pb[0]
        syms[1::2] = pb[1]
    elif coding.nr_phases == 2 and coding.fsk_levels == 4:
        syms = (pb[0] << 1) | pb[1]
    else:  # 4 phases, 4FSK
        syms[0::2] = (pb[0] << 1) | pb[1]
        syms[1::2] = (pb[2] << 1) | pb[3]
    return syms


def _sym_levels(syms: np.ndarray, fsk: int, amp: int) -> np.ndarray:
    if fsk == 2:
        # symbol 1 == positive
        return np.where(syms > 0, amp, -amp).astype(np.int16)
    lut = np.asarray([-amp, -amp // 4, amp, amp // 4], dtype=np.int16)
    return lut[syms]


def generate(
    messages: list[FlexBurstMessage],
    baud: int = 1600,
    fsk_levels: int = 2,
    cycle: int = 3,
    frame: int = 77,
    amplitude: int = 8192,
    lead_in_bits: int = 40,
    tail_bits: int = 40,
    extra_biws: list[int] | None = None,
):
    """Build one FLEX frame -> (pcm int16 @16 kHz, expected message dicts).

    Messages are distributed round-robin across the coding's phases
    (A, [B,] C, [D]) in the order given.
    """
    coding = CODINGS[(baud, fsk_levels)]
    amp = amplitude

    per_phase: list[list[FlexBurstMessage]] = [[] for _ in range(coding.nr_phases)]
    for i, m in enumerate(messages):
        per_phase[i % coding.nr_phases].append(m)
    built = [build_phase(ms, extra_biws=extra_biws if pi == 0 else None)
             for pi, ms in enumerate(per_phase)]
    phase_words = [b[0] for b in built]
    # physical phase order: 1 phase -> [A]; 2 phases -> [A, C]; 4 -> [A,B,C,D]
    expected = []
    phase_names = {1: ["A"], 2: ["A", "C"], 4: ["A", "B", "C", "D"]}[
        coding.nr_phases
    ]
    for pi, b in enumerate(built):
        for e in b[1]:
            e["phase"] = phase_names[pi]
            e["cycle"] = cycle
            e["frame"] = frame
            e["baud"] = baud
            expected.append(e)

    pcm: list[np.ndarray] = []

    def emit_bits_1600(bits, first=1):
        lv = np.where(np.asarray(bits) > 0, amp, -amp).astype(np.int16)
        pcm.append(np.repeat(lv, 10))

    # lead-in: constant negative (2FSK symbol 0)
    pcm.append(np.full(lead_in_bits * 10, -amp, dtype=np.int16))
    # BS1 + A + B + INV_A (all MSB-first at 1600)
    emit_bits_1600([(BS1 >> (31 - i)) & 1 for i in range(32)])
    a_word = (coding.seq_a << 16) | MAGIC_A
    emit_bits_1600([(a_word >> (31 - i)) & 1 for i in range(32)])
    emit_bits_1600([(MAGIC_B >> (15 - i)) & 1 for i in range(16)])
    inv_a = (~a_word) & 0xFFFFFFFF
    emit_bits_1600([(inv_a >> (31 - i)) & 1 for i in range(32)])
    # FIW: LSB-first
    fiw = make_fiw(cycle, frame)
    emit_bits_1600([(fiw >> i) & 1 for i in range(32)])

    # SYNC_2 + BLOCK at the target symbol cell size
    cell = coding.sample_skip + 1
    c_syms = 16 // coding.sym_bits

    def emit_syms(syms):
        pcm.append(np.repeat(_sym_levels(np.asarray(syms), fsk_levels, amp), cell))

    # comma dots (alternating), C pattern, inverted comma, inverted C
    dots = [i & 1 for i in range(coding.sync_2_samples)]
    emit_syms([s * (fsk_levels - 1) for s in dots])
    mask = (1 << coding.sym_bits) - 1
    c_pattern = [
        (MAGIC_C >> (16 - coding.sym_bits * (i + 1))) & mask for i in range(c_syms)
    ]
    emit_syms(c_pattern)
    emit_syms([(1 - (i & 1)) * (fsk_levels - 1) for i in range(coding.sync_2_samples)])
    emit_syms([mask ^ s for s in c_pattern])

    # data blocks
    emit_syms(interleave_symbols(coding, phase_words))

    pcm.append(np.full(tail_bits * 10, -amp, dtype=np.int16))
    return np.concatenate(pcm), expected
