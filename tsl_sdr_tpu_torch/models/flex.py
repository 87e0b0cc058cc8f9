"""FLEX pager decoder (1600/3200/6400 bps, 2/4-FSK) — bit-exact FSM.

Replicates the reference three-stage receiver (``pager/pager_flex.c``):

* SYNC_1 (always 1600 bps 2FSK, 16 kHz input = 10 samples/bit): ten
  phase-staggered 32-bit registers hunt BS1 0xAAAAAAAA; the eye width picks
  the sample clock phase; then A word (16-bit coding id + magic), B, inverted
  A (coding matched within hamming < 4 on the id — flex.c:264-287), then the
  FIW (BCH + nibble checksum -> cycle/frame ids). The A/B/INV_A stages also
  accumulate high/low sample averages that train the 4FSK slicer
  (flex.c:347-446).
* SYNC_2 at the target rate: comma / C / inverted comma / inverted C counted
  per the coding's consumption table; values unvalidated (flex.c:461-525).
* BLOCK: slice symbols (2FSK sign, 4FSK trained thresholds), round-robin
  de-interleave into 1/2/4 phases of 88 LSB-first words (8-word interleave
  blocks), then per phase: BIW -> addresses -> vectors -> ALN/NUM/Tone/SIV
  messages, all words BCH(31,21)-corrected and checksummed
  (flex.c:1089-1310).

2FSK symbol 1 == sample >= 0 (opposite of POCSAG's slicing convention).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tsl_sdr_tpu_torch.models.bch import pocsag_bch
from tsl_sdr_tpu_torch.runtime.native import FlexNative

BS1 = 0xAAAAAAAA


@dataclass(frozen=True)
class Coding:
    """One FLEX modulation mode (pager/pager_flex.c:47-96)."""

    seq_a: int              # 16-bit A-word coding id
    baud: int
    fsk_levels: int
    sample_skip: int        # samples consumed per symbol - 1
    sync_2_samples: int     # SYNC_2 pattern consumption count
    sym_bits: int           # bits per symbol (1 for 2FSK, 2 for 4FSK)
    sample_fudge: int       # sample-clock nudge applied entering SYNC_2
    symbols_per_block: int  # 2816 or 5632
    nr_phases: int          # 1, 2 or 4 interleaved phases


CODINGS = {
    (1600, 2): Coding(0x78F3, 1600, 2, 9, 4, 1, 0, 2816, 1),
    (3200, 2): Coding(0x84E7, 3200, 2, 4, 24, 1, 2, 5632, 2),
    (3200, 4): Coding(0x4F97, 3200, 4, 9, 12, 2, 0, 2816, 2),
    (6400, 4): Coding(0x215F, 6400, 4, 4, 32, 2, 2, 5632, 4),
}

_ST_SYNC1, _ST_SYNC2, _ST_BLOCK = 0, 1, 2
_SY_SEARCH_BS1, _SY_BS1, _SY_A, _SY_B, _SY_INV_A, _SY_FIW, _SY_SYNCED = range(7)
_S2_COMMA, _S2_C, _S2_INV_COMMA, _S2_INV_C, _S2_SYNCED = range(5)

PHASE_NAMES = "ABCD"


def _word_checksum(word: int) -> int:
    word &= 0x1FFFFF
    ck = 0
    for _ in range(6):
        ck += word & 0xF
        word >>= 4
    return ck & 0xF


def _cdiv(a: int, b: int) -> int:
    """C-style truncating integer division (the FIW range averages)."""
    if not b:
        return 0
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


_NUM_LUT = "0123456789XU -]["


@dataclass
class FlexMessage:
    kind: str            # "alnum" | "numeric" | "siv"
    baud: int
    phase: str           # "A".."D"
    cycle: int
    frame: int
    capcode: int
    data: bytes = b""
    fragment: bool = False
    maildrop: bool = False
    seq_num: int = 0
    siv_type: int = 0
    siv_data: int = 0
    # frame-level context from extra BIWs (pager_flex.c:1036-1086); None
    # when the frame carried no date/time BIW
    frame_date: tuple | None = None    # (year, month, day)
    frame_time: tuple | None = None    # (hour, minute, second)

    @property
    def text(self) -> str:
        return self.data.decode("latin-1")


class _Phase:
    __slots__ = ("words", "cur_bit", "cur_word", "base_word")

    def __init__(self):
        self.words = [0] * 88
        self.cur_bit = 0
        self.cur_word = 0
        self.base_word = 0

    def reset(self):
        self.words = [0] * 88
        self.cur_bit = 0
        self.cur_word = 0
        self.base_word = 0

    def append_bit(self, bit: int):
        w = self.base_word + self.cur_word
        self.words[w] = (self.words[w] >> 1) | ((bit & 1) << 31)
        self.cur_word = (self.cur_word + 1) % 8
        if self.cur_word == 0:
            self.cur_bit += 1
        if self.cur_bit == 32:
            self.base_word += 8
            self.cur_bit = 0
            self.cur_word = 0


class FlexDecoder:
    """Streaming FLEX decoder; feed 16 kHz int16 PCM via :meth:`on_pcm`."""

    def __init__(self, freq_hz: int = 0, vectorized: bool = True,
                 native: bool = True):
        self.bch = pocsag_bch(native)
        self.freq_hz = freq_hz
        # vectorized BLOCK stage (exact scalar equivalent; False keeps the
        # per-sample reference loop)
        self._vectorized = vectorized
        self._bch_cache: dict = {}
        # native C++ sample FSM (native/tslstream.cc tsl_flex_*), built at
        # first use (a failed build raises). The FSM pauses at each FIW for
        # this side's BCH verdict; BCH + message assembly stay here.
        # native=False keeps the numpy paths.
        self._nat = FlexNative() if native else None
        self.messages: list[FlexMessage] = []
        self._reset_sync()
        # scan() streaming carry (see PocsagDecoder)
        self._scan_tail = np.zeros(0, np.int16)
        self._scan_prefed = 0
        self._scan_want = 0
        self._scan_ever = False
        self._in_scan = False

    # -- resets ---------------------------------------------------------------

    def _reset_sync(self):
        self.state = _ST_SYNC1
        self.skip = 0
        self.skip_count = 0
        self.sample_range = 0
        self.sample_delta = 0
        self.frame_id = 0
        self.cycle_id = 0
        # frame-level extra-BIW context (pager_flex.c:1036-1086)
        self.frame_date: tuple | None = None
        self.frame_time: tuple | None = None
        self.frame_local_id: int | None = None
        # sync 1
        self.sync_state = _SY_BS1
        self.sync_words = [0] * 10
        self.sample_counter = 0
        self.bit_counter = 0
        self.a = 0
        self.b = 0
        self.inv_a = 0
        self.fiw = 0
        self.coding: Coding | None = None
        self.rng_sum_hi = 0
        self.rng_sum_lo = 0
        self.rng_cnt_hi = 0
        self.rng_cnt_lo = 0
        # sync 2
        self.s2_state = _S2_COMMA
        self.s2_dots = 0
        self.s2_c = 0
        self.s2_inv_c = 0
        self.s2_nr_c = 0
        # block
        self.phases = [_Phase() for _ in range(4)]
        self.nr_symbols = 0
        self.phase_ff = False
        self.msg_buf = bytearray()

    def _sync_reset_only(self):
        self.sync_state = _SY_BS1
        self.sync_words = [0] * 10
        self.sample_counter = 0
        self.bit_counter = 0
        self.a = self.b = self.inv_a = self.fiw = 0
        self.coding = None
        self.rng_sum_hi = self.rng_sum_lo = 0
        self.rng_cnt_hi = self.rng_cnt_lo = 0

    # -- slicers ---------------------------------------------------------------

    @staticmethod
    def _slice_2fsk(sample: int) -> int:
        return 1 if sample >= 0 else 0

    def _slice_4fsk(self, sample: int) -> int:
        s = sample - self.sample_delta
        if s < 0:
            return 0 if -s > self.sample_range // 4 else 1
        return 2 if s > self.sample_range // 4 else 3

    def _slice(self, sample: int) -> int:
        if self.coding.fsk_levels == 2:
            return self._slice_2fsk(sample)
        return self._slice_4fsk(sample)

    # -- SYNC 1 ---------------------------------------------------------------

    def _sync_update(self, sample: int):
        self.sample_counter = (self.sample_counter + 1) % 10
        symbol = self._slice_2fsk(sample)
        st = self.sync_state

        if st in (_SY_SEARCH_BS1, _SY_BS1):
            p = self.sample_counter
            self.sync_words[p] = ((self.sync_words[p] << 1) | symbol) & 0xFFFFFFFF
            if st == _SY_SEARCH_BS1:
                if self.sync_words[p] == BS1:
                    self.bit_counter = 1
                    self.sync_state = _SY_BS1
            else:
                if self.sync_words[p] == BS1:
                    self.bit_counter += 1
                else:
                    if self.bit_counter < 3:
                        self.sync_state = _SY_SEARCH_BS1
                    else:
                        self.sync_state = _SY_A
                        self.sample_counter = self.bit_counter // 2
                    self.bit_counter = 0
            return

        if self.sample_counter != 0:
            return
        self._sync_bit(sample)

    def _sync_bit(self, sample: int) -> bool:
        """One A/B/INV_A/FIW stage bit (a sample where sample_counter hit 0).
        Shared by the per-sample cadence loop and the strided fast path so
        the exactness-critical stage logic is single-sourced. Returns True
        when the stage family was left (SYNCED or reset to BS1)."""
        symbol = 1 if sample >= 0 else 0
        st = self.sync_state
        if st == _SY_A:
            self.a = ((self.a << 1) | symbol) & 0xFFFFFFFF
            self._accumulate_range(sample)
            self.bit_counter += 1
            if self.bit_counter == 32:
                self.sync_state = _SY_B
                self.bit_counter = 0
        elif st == _SY_B:
            self.b = ((self.b << 1) | symbol) & 0xFFFF
            self._accumulate_range(sample)
            self.bit_counter += 1
            if self.bit_counter == 16:
                self.sync_state = _SY_INV_A
                self.bit_counter = 0
        elif st == _SY_INV_A:
            self.inv_a = ((self.inv_a << 1) | symbol) & 0xFFFFFFFF
            self._accumulate_range(sample)
            self.bit_counter += 1
            if self.bit_counter == 32:
                if self._check_baud():
                    self.sync_state = _SY_FIW
                else:
                    self._sync_reset_only()
                self.bit_counter = 0
        elif st == _SY_FIW:
            self.fiw = (self.fiw >> 1) | (symbol << 31)
            self._accumulate_range(sample)
            self.bit_counter += 1
            if self.bit_counter == 32:
                hi = _cdiv(self.rng_sum_hi, self.rng_cnt_hi)
                lo = _cdiv(self.rng_sum_lo, self.rng_cnt_lo)
                self.sample_range = hi - lo
                self.sample_delta = hi - self.sample_range // 2
                self.sync_state = _SY_SYNCED
        return self.sync_state in (_SY_SEARCH_BS1, _SY_BS1, _SY_SYNCED)

    def _accumulate_range(self, sample: int):
        if sample > 0:
            self.rng_sum_hi += sample
            self.rng_cnt_hi += 1
        else:
            self.rng_sum_lo += sample
            self.rng_cnt_lo += 1

    def _check_baud(self) -> bool:
        coding_a = (self.a >> 16) & 0xFFFF
        inv_coding_a = (self.inv_a >> 16) & 0xFFFF
        for coding in CODINGS.values():
            # the reference's second (inverted-A) clause can never match:
            # ~seq_a promotes to a 32-bit value whose high bits survive the
            # XOR (flex.c:277-278); we keep the effective behavior
            if bin(coding.seq_a ^ coding_a).count("1") < 4:
                self.coding = coding
                return True
            if bin((~coding.seq_a & 0xFFFFFFFF) ^ inv_coding_a).count("1") < 4:
                self.coding = coding  # unreachable in practice; kept for parity
                return True
        return False

    def _handle_fiw(self) -> bool:
        fiw, fail = self.bch.decode_one(self.fiw & 0x7FFFFFFF)
        if fail:
            return False
        self.cycle_id = (fiw >> 4) & 0xF
        self.frame_id = (fiw >> 8) & 0x7F
        return _word_checksum(fiw) == 0xF

    # -- SYNC 2 ---------------------------------------------------------------

    def _sync2_update(self, sample: int):
        c = self.coding
        if self.s2_state == _S2_COMMA:
            self.s2_dots += 1
            if self.s2_dots == c.sync_2_samples:
                self.s2_state = _S2_C
        elif self.s2_state == _S2_C:
            sym = self._slice(sample)
            self.s2_c = ((self.s2_c << c.sym_bits) | sym) & 0xFFFF
            self.s2_nr_c += c.sym_bits
            if self.s2_nr_c == 16:
                self.s2_state = _S2_INV_COMMA
                self.s2_dots = 0
        elif self.s2_state == _S2_INV_COMMA:
            self.s2_dots += 1
            if self.s2_dots == c.sync_2_samples:
                self.s2_state = _S2_INV_C
                self.s2_nr_c = 0
        elif self.s2_state == _S2_INV_C:
            sym = self._slice(sample)
            self.s2_inv_c = ((self.s2_inv_c << c.sym_bits) | sym) & 0xFFFF
            self.s2_nr_c += c.sym_bits
            if self.s2_nr_c == 16:
                self.s2_state = _S2_SYNCED

    # -- native FSM event pump ------------------------------------------------

    _CODING_LIST = list(CODINGS.values())

    def _on_pcm_native(self, pcm: np.ndarray):
        off = 0
        n = pcm.shape[0]
        while off < n:
            events, consumed = self._nat.on_pcm(pcm[off:])
            off += consumed
            for ev in events:
                if ev[0] == "fiw":
                    _, idx, rng, delta, fiw_raw = ev
                    self.coding = self._CODING_LIST[idx]
                    self.sample_range = rng
                    self.sample_delta = delta
                    self.fiw = fiw_raw
                    self._nat.verdict(self._handle_fiw())
                else:  # completed frame: batched BCH + message assembly
                    _, idx, phases = ev
                    self.coding = self._CODING_LIST[idx]
                    for pid, words in phases:
                        # writable copy (frombuffer views are read-only;
                        # address decode mutates entries in place)
                        self._phase_process(int(pid), words.copy())
                    # end-of-frame context reset (_reset_sync equivalent)
                    self.frame_date = None
                    self.frame_time = None
                    self.frame_local_id = None
            if consumed == 0 and not events:
                break  # defensive: no progress

    # -- BLOCK ---------------------------------------------------------------

    def _sync_tail_vec(self, pcm, i: int, n: int) -> int:
        """Accelerated A/B/INV_A/FIW stages: these consume one bit per 10
        samples (sample_counter == 0), so stride-slice the active samples
        and run the exact per-bit stage logic (shared ``_sync_bit``) over
        <= 112 items instead of a per-sample loop over ~1120 (exact scalar
        equivalent; fuzz-tested). Returns the new sample index."""
        c0 = self.sample_counter
        j0 = (9 - c0) % 10
        first = i + j0
        if first >= n:
            self.sample_counter = (c0 + (n - i)) % 10
            return n
        acts = pcm[first::10]
        k = 0
        left = False
        for sv in acts:
            k += 1
            if self._sync_bit(int(sv)):
                left = True
                break
        if left:
            last = first + (k - 1) * 10
            # the active sample had sample_counter == 0 (scalar semantics);
            # _sync_reset_only already re-zeroed it on the failure path
            if self.sync_state == _SY_SYNCED:
                self.sample_counter = 0
                # replicate on_pcm's post-update FIW handling in place
                if self._handle_fiw():
                    self.state = _ST_SYNC2
                    self.skip = self.coding.sample_skip
                    self.skip_count = self.skip + self.coding.sample_fudge
                else:
                    self._reset_sync()
            return last + 1
        self.sample_counter = (c0 + (n - i)) % 10
        return n

    def _append_bits_vec(self, pid: int, bits: np.ndarray):
        """Vectorized _Phase.append_bit over a bit array.

        The scalar append shifts each word right and inserts at bit 31, so
        after a word's full 32 appends, append t sits at bit t; composing
        with OR at the final positions gives the same full-block words
        (mid-word transients differ, but words are only read at block end,
        when every word has its 32 bits)."""
        ph = self.phases[pid]
        m = bits.shape[0]
        if m == 0:
            return
        t0 = ph.base_word * 32 + ph.cur_bit * 8 + ph.cur_word
        k = t0 + np.arange(m)
        w = (k >> 8) * 8 + (k & 7)        # 8-word round-robin interleave
        bitpos = ((k >> 3) & 31).astype(np.uint32)
        vals = bits.astype(np.uint32) << bitpos
        order = np.argsort(w, kind="stable")
        ws = w[order]
        vs = vals[order]
        starts = np.flatnonzero(np.diff(ws, prepend=ws[0] - 1))
        merged = np.bitwise_or.reduceat(vs, starts)
        words = ph.words
        for wi, mv in zip(ws[starts], merged):
            words[int(wi)] |= int(mv)
        tn = t0 + m
        ph.base_word = (tn >> 8) * 8
        ph.cur_word = tn & 7
        ph.cur_bit = (tn >> 3) & 31

    def _block_vec(self, pcm, i: int, n: int) -> int:
        """Vectorized BLOCK stage: symbols arrive at a fixed cadence (one
        per skip+1 samples), so slicing, 4FSK thresholding and the phase
        de-interleave are plain array ops (exact scalar-loop equivalent;
        fuzz-tested). Returns the new sample index."""
        c = self.coding
        period = self.skip + 1
        k0 = self.skip_count
        first = i + k0
        remaining = c.symbols_per_block - self.nr_symbols
        s = (pcm[first : first + remaining * period : period]
             if first < n else pcm[:0])
        m = s.shape[0]
        if m == 0:
            self.skip_count = (k0 - (n - i)) % period
            return n
        if c.fsk_levels == 2:
            syms = (s >= 0).astype(np.uint8)
        else:
            sd = s.astype(np.int32) - self.sample_delta
            thr = self.sample_range // 4
            syms = np.where(sd < 0, np.where(-sd > thr, 0, 1),
                            np.where(sd > thr, 2, 3)).astype(np.uint8)

        ff0 = self.phase_ff
        if c.nr_phases == 1:
            self._append_bits_vec(0, (syms == 1).astype(np.uint8))
        elif c.nr_phases == 2 and c.fsk_levels == 2:
            b = (syms == 1).astype(np.uint8)
            a0 = 1 if ff0 else 0
            self._append_bits_vec(0, b[a0::2])
            self._append_bits_vec(2, b[1 - a0 :: 2])
            self.phase_ff = bool(ff0 ^ (m & 1))
        elif c.nr_phases == 2:
            self._append_bits_vec(0, (syms >> 1) & 1)
            self._append_bits_vec(2, syms & 1)
        else:
            hi = (syms >> 1) & 1
            lo = syms & 1
            a0 = 1 if ff0 else 0
            self._append_bits_vec(0, hi[a0::2])
            self._append_bits_vec(1, lo[a0::2])
            self._append_bits_vec(2, hi[1 - a0 :: 2])
            self._append_bits_vec(3, lo[1 - a0 :: 2])
            self.phase_ff = bool(ff0 ^ (m & 1))
        self.nr_symbols += m

        if m == remaining:
            if c.nr_phases == 1:
                self._phase_process(0)
            elif c.nr_phases == 2:
                self._phase_process(0)
                self._phase_process(2)
            else:
                for p in range(4):
                    self._phase_process(p)
            self._reset_sync()
            return first + (m - 1) * period + 1
        self.skip_count = (k0 - (n - i)) % period
        return n

    def _block_update(self, sample: int):
        c = self.coding
        symbol = self._slice(sample)
        ph = self.phases
        if c.nr_phases == 1:
            ph[0].append_bit(1 if symbol == 1 else 0)
        elif c.nr_phases == 2 and c.fsk_levels == 2:
            target = ph[0] if not self.phase_ff else ph[2]
            target.append_bit(1 if symbol == 1 else 0)
            self.phase_ff = not self.phase_ff
        elif c.nr_phases == 2:
            ph[0].append_bit((symbol >> 1) & 1)
            ph[2].append_bit(symbol & 1)
        else:
            if not self.phase_ff:
                ph[0].append_bit((symbol >> 1) & 1)
                ph[1].append_bit(symbol & 1)
            else:
                ph[2].append_bit((symbol >> 1) & 1)
                ph[3].append_bit(symbol & 1)
            self.phase_ff = not self.phase_ff

        self.nr_symbols += 1
        if self.nr_symbols == c.symbols_per_block:
            if c.nr_phases == 1:
                self._phase_process(0)
            elif c.nr_phases == 2:
                self._phase_process(0)
                self._phase_process(2)
            else:
                for p in range(4):
                    self._phase_process(p)
            self._reset_sync()

    # -- word-level decode ------------------------------------------------

    def _decode_extra_biw(self, raw: int):
        """Additional BIW: local ids / date / time / system info
        (pager_flex.c:1036-1086; bit layout per __pager_flex_decode_extra_biw).
        """
        word, fail = self._bch_word(raw)
        if fail or _word_checksum(word) != 0xF:
            return
        function = (word >> 4) & 0x7
        if function == 0:        # local SSID word
            self.frame_local_id = (word >> 7) & 0x3FFF
        elif function == 1:      # date
            self.frame_date = (
                ((word >> 16) & 0x1F) + 1994,
                ((word >> 11) & 0x1F) + 1,
                (word >> 7) & 0xF,
            )
        elif function == 2:      # time
            self.frame_time = (
                (word >> 16) & 0x1F,
                (word >> 10) & 0x3F,
                ((word >> 7) & 0x7) << 3,
            )
        # functions 5 (system info) and 7 (country) are log-only in the
        # reference and carry no decoded fields

    def _phase_process(self, phase_id: int, words=None):
        """Decode one phase's 88 words. ``words`` may be a writable uint32
        array (the native frame event path) or None to use the python-tier
        ``self.phases`` list."""
        if words is None:
            words = self.phases[phase_id].words
            raws = np.asarray(words, np.uint64).astype(np.uint32) & np.uint32(
                0x7FFFFFFF)
        else:
            raws = words & np.uint32(0x7FFFFFFF)
        # one batched BCH pass over the phase's 88 words; decode is a
        # pure per-word function, so the value-keyed cache stays correct
        # even though address decode mutates entries in place
        corr_all, fail_all = self.bch.decode(raws)
        self._bch_cache = dict(
            zip(raws.tolist(), zip(corr_all.tolist(), fail_all.tolist()))
        )
        biw, fail = self._bch_word(words[0])
        if fail or _word_checksum(biw) != 0xF:
            return
        biw_vsw = (biw >> 10) & 0x3F
        biw_eob = (biw >> 8) & 0x3
        if biw_eob > biw_vsw:
            return
        addr_start = 1 + biw_eob
        for k in range(1, addr_start):
            self._decode_extra_biw(words[k])

        start_msg = len(self.messages)
        i = addr_start
        while i < biw_vsw:
            vec_offs = i + biw_vsw - addr_start
            ok, capcode, nr_words = self._decode_address(words, i)
            if not ok:
                return
            self._decode_vector(
                phase_id, capcode, words, vec_offs, nr_words + 1
            )
            i += nr_words
            i += 1
        if self.frame_date is not None or self.frame_time is not None:
            for m in self.messages[start_msg:]:
                m.frame_date = self.frame_date
                m.frame_time = self.frame_time

    def _decode_address(self, words: list[int], i: int):
        w0, fail = self._bch_word(words[i])
        if fail:
            return False, 0, 0
        addr_first = w0 & 0x1FFFFF
        words[i] = addr_first
        if (0x8000 < addr_first <= 0x1E0000) or (
            0x1F0000 < addr_first < 0x1F7FFF
        ):
            return True, addr_first - 32768, 0
        w1, fail = self._bch_word(words[i + 1])
        if fail:
            return False, 0, 0
        addr_second = w1 & 0x1FFFFF
        words[i + 1] = addr_second
        capcode = 0x1F9001 + ((0x1FFFFF - addr_second) * 32768 + addr_first - 1)
        return True, capcode, 1

    def _bch_word(self, raw: int):
        raw &= 0x7FFFFFFF
        hit = self._bch_cache.get(raw)
        if hit is not None:
            return hit
        return self.bch.decode_one(raw)

    def _decode_vector(self, phase_id, capcode, base, vec_offs, nr_vec_words):
        vec = []
        for k in range(nr_vec_words):
            w, fail = self._bch_word(base[vec_offs + k])
            if fail:
                return
            vec.append(w)
        self.msg_buf = bytearray()
        vec_word = vec[0]
        if _word_checksum(vec_word) != 0xF:
            return
        vec_type = (vec_word >> 4) & 0x7
        word_start = (vec_word >> 7) & 0x7F
        vec_long_word = vec[1] if nr_vec_words == 2 else 0xFFFFFFFF

        phase = PHASE_NAMES[phase_id]
        if vec_type == 0x2:  # tone / short message
            self._decode_tone(phase, capcode, vec_word, vec_long_word)
        elif vec_type == 0x3:  # standard numeric
            word_length = ((vec_word >> 14) & 0x7) + 1
            if nr_vec_words == 2:
                word_length -= 1
            self._decode_numeric(
                phase, capcode, vec_long_word, base, word_start, word_length
            )
        elif vec_type == 0x5:  # alphanumeric
            word_length = (vec_word >> 14) & 0x7F
            if nr_vec_words == 2:
                word_length -= 1
            self._decode_alphanumeric(
                phase, capcode, vec_long_word, base, word_start, word_length
            )
        elif vec_type == 0x1:  # special instruction vector
            self._decode_siv(phase, capcode, vec_word)
        # SECURE / HEX / SPECIAL_NUMERIC / NUMBERED_NUMERIC: logged-only in
        # the reference (flex.c:1019-1024); no message emitted

    def _decode_alphanumeric(self, phase, capcode, long_word, base, start, nr_words):
        if nr_words == 0:
            return
        if long_word != 0xFFFFFFFF:
            first_char_word = 0
            status_word = long_word
        else:
            first_char_word = 1
            status_word, fail = self._bch_word(base[start])
            if fail:
                return
        fragment = bool(status_word & (1 << 10))
        seq_num = (status_word >> 11) & 0x3
        skip_word = 0
        maildrop = False
        if seq_num == 3:
            skip_word = 1
            maildrop = bool(status_word & (1 << 20))

        for i in range(first_char_word, nr_words):
            codeword, fail = self._bch_word(base[start + i])
            if fail:
                return
            if skip_word:
                codeword >>= 7
            # NOTE: an ETX (0x03) only skips the rest of the CURRENT word in
            # the reference (flex.c:656-668) — later words still decode
            for _ in range(skip_word, 3):
                ch = codeword & 0x7F
                if ch == 0x3:
                    break
                self.msg_buf.append(ch)
                if len(self.msg_buf) == 255:
                    break
                codeword >>= 7
            skip_word = 0
            if len(self.msg_buf) == 255:
                break
        self.messages.append(
            FlexMessage(
                kind="alnum",
                baud=self.coding.baud,
                phase=phase,
                cycle=self.cycle_id,
                frame=self.frame_id,
                capcode=capcode,
                data=bytes(self.msg_buf),
                fragment=fragment,
                maildrop=maildrop,
                seq_num=seq_num,
            )
        )

    def _decode_numeric(self, phase, capcode, long_word, base, start, nr_words):
        nr_bits = nr_words * 21
        if long_word != 0xFFFFFFFF:
            cur_word = (long_word & 0x1FFFFF) >> 2
            nr_bits += 19
            cur_word_bits = 19
            next_word_offs = 0
        else:
            cur_word, fail = self._bch_word(base[start])
            if fail:
                return
            cur_word = (cur_word & 0x1FFFFF) >> 2
            cur_word_bits = 19
            nr_bits -= 2
            next_word_offs = 1

        next_word = 0
        next_word_bits = 21
        if next_word_offs < nr_words:
            next_word, fail = self._bch_word(base[start + next_word_offs])
            if fail:
                return
            next_word &= 0x1FFFFF

        nr_bits &= ~0x3
        while nr_bits != 0:
            rem_bits = cur_word_bits & ~0x3
            for _ in range(0, rem_bits, 4):
                self.msg_buf.append(ord(_NUM_LUT[cur_word & 0xF]))
                if len(self.msg_buf) == 255:
                    break
                cur_word >>= 4
                cur_word_bits -= 4
                nr_bits -= 4
            if len(self.msg_buf) == 255:
                break
            if cur_word_bits != 0 and nr_bits != 0:
                if cur_word_bits == 1:
                    cur_word |= (next_word & 0x7) << 1
                    next_word >>= 3
                    next_word_bits -= 3
                elif cur_word_bits == 2:
                    cur_word |= (next_word & 0x3) << 2
                    next_word >>= 2
                    next_word_bits -= 2
                elif cur_word_bits == 3:
                    cur_word |= (next_word & 0x1) << 3
                    next_word >>= 1
                    next_word_bits -= 1
                cur_word_bits = 4
            elif cur_word_bits == 0 and nr_bits != 0:
                cur_word = next_word
                cur_word_bits = next_word_bits
                next_word_bits = 21
                next_word_offs += 1
                if next_word_offs < nr_words:
                    next_word, fail = self._bch_word(base[start + next_word_offs])
                    if fail:
                        return
                    next_word &= 0x1FFFFF

        self.messages.append(
            FlexMessage(
                kind="numeric",
                baud=self.coding.baud,
                phase=phase,
                cycle=self.cycle_id,
                frame=self.frame_id,
                capcode=capcode,
                data=bytes(self.msg_buf),
            )
        )

    def _decode_tone(self, phase, capcode, first_word, second_word):
        first_word &= 0x1FFFFF
        ttype = (first_word >> 7) & 0x3
        if ttype == 0x0:  # 3 or 8 digits
            fw = first_word >> 9
            for _ in range(3):
                self.msg_buf.append(ord(_NUM_LUT[fw & 0xF]))
                fw >>= 4
            if second_word != 0xFFFFFFFF:
                sw = second_word & 0x1FFFFF
                for _ in range(5):
                    self.msg_buf.append(ord(_NUM_LUT[sw & 0xF]))
                    sw >>= 4
            self.messages.append(
                FlexMessage(
                    kind="numeric",
                    baud=self.coding.baud,
                    phase=phase,
                    cycle=self.cycle_id,
                    frame=self.frame_id,
                    capcode=capcode,
                    data=bytes(self.msg_buf),
                )
            )
        # sourced/sequenced tones are logged-only in the reference

    def _decode_siv(self, phase, capcode, vec_word):
        vec_word &= 0x7FFFFF
        if _word_checksum(vec_word) != 0xF:
            return
        siv_type = (vec_word >> 7) & 0x7
        siv_data = (vec_word >> 10) & 0x7FF
        self.messages.append(
            FlexMessage(
                kind="siv",
                baud=self.coding.baud,
                phase=phase,
                cycle=self.cycle_id,
                frame=self.frame_id,
                capcode=capcode,
                siv_type=siv_type,
                siv_data=siv_data,
            )
        )

    # -- egress-gating hooks (ReceivePipeline device prefilter) ------------

    @property
    def supports_gating(self) -> bool:
        """Egress gating feeds via scan() with explicit gap notifications;
        only the native FSM tier keeps exact stream semantics under that
        protocol (see PocsagDecoder.supports_gating)."""
        return self._nat is not None

    @property
    def in_search(self) -> bool:
        """True while the SYNC_1 hunt has made no progress at all — the
        only state in which a sync-free (unflagged) block may be skipped.
        A mid-BS1 run (bit_counter > 0) returns False: the run may
        complete on the next block's first samples even though that
        block's own span shows no exact BS1 match."""
        if self._nat is not None:
            return self._nat.in_search
        return (self.state == _ST_SYNC1
                and self.sync_state in (_SY_SEARCH_BS1, _SY_BS1)
                and self.bit_counter == 0 and self.skip_count == 0)

    def notify_gap(self):
        """A sync-free span of PCM was skipped upstream (the device
        prefilter raised no flag — ReceivePipeline egress gating): reset
        the SYNC_1 registers so no partial register content straddles the
        gap. Only valid while :attr:`in_search` is True."""
        if self._nat is not None:
            self._nat.sync_reset_only()
            return
        self._sync_reset_only()

    # -- sample pump ----------------------------------------------------------

    def scan(self, pcm) -> list[FlexMessage]:
        """Batch decode with a vectorized BS1 fast-forward.

        Message-exact vs :meth:`on_pcm`: the SYNC_1 hunt looks for an EXACT
        0xAAAAAAAA in one of 10 phase-interleaved slicer registers, i.e. 32
        perfectly alternating sign bits at stride 10 — detected for every
        sample with a 5-pass boolean tree reduction. The unmodified FSM then
        runs only from 34*10 samples before each hit (registers fully
        refill), skipping sync-free noise entirely.

        Streaming-safe: the last ``lookback`` samples are always carried as
        prefilter context with the FSM-fed prefix tracked (see
        PocsagDecoder.scan). Do not interleave scan() and on_pcm() on the
        same instance.
        """
        pcm = np.asarray(pcm, dtype=np.int16)
        if self._nat is not None:
            # one machine owns the protocol: the native FSM's tight BS1
            # hunt (~800 Msps on sync-free input) outruns the numpy
            # prefilter, so scan() is a straight delegate — exactly like
            # PocsagDecoder.scan. The numpy prefilter + vectorized tiers
            # below remain as the native=False fuzz reference.
            start_n = len(self.messages)
            self._on_pcm_native(pcm)
            return self.messages[start_n:]
        start_msg = len(self.messages)
        self._scan_ever = True
        self._in_scan = True
        tail = self._scan_tail
        prefed = self._scan_prefed
        feed_until = prefed + self._scan_want
        if tail.size:
            pcm = np.concatenate([tail, pcm])
        self._scan_tail = np.zeros(0, np.int16)
        self._scan_prefed = 0
        self._scan_want = 0
        n = pcm.shape[0]
        b = pcm >= 0  # _slice_2fsk symbol

        # register == BS1 (1010...10, newest bit 0) <=> symbol[i]==0,
        # symbol[i-10]==1, ... for 32 stride-10 taps: pair-test then AND-tree
        c = np.zeros(n, dtype=bool)
        c[10:] = (~b[10:]) & b[:-10]   # newest pair (k=0 even: 0; k=1: 1)
        for d in (20, 40, 80, 160):
            c[d:] &= c[:-d]            # after loop: AND over 16 pairs
        cand_idx = np.flatnonzero(c)

        lookback = 34 * 10
        chunk = 16_000  # one second of frame structure per FSM slice

        i = prefed
        ci = 0
        fed_end = prefed
        want_end = feed_until
        while i < n:
            searching = (
                self.state == _ST_SYNC1
                and self.sync_state in (_SY_SEARCH_BS1, _SY_BS1)
                and self.bit_counter == 0
            )
            if not searching:
                self.on_pcm(pcm[i : i + chunk])
                i += chunk
                fed_end = min(i, n)
                continue
            if i < feed_until:
                # finish the contiguous margin owed from the previous block
                end = min(n, feed_until)
                self.on_pcm(pcm[i:end])
                i = end
                fed_end = end
                continue
            while ci < len(cand_idx) and cand_idx[ci] < i:
                ci += 1
            if ci >= len(cand_idx):
                break
            cpos = int(cand_idx[ci])
            start = max(i, cpos - lookback)
            if start > i:
                # skipped noise has no exact BS1; zeroed registers can't match
                self._sync_reset_only()
                i = start
            end = min(n, cpos + 64)
            self.on_pcm(pcm[i:end])
            i = end
            fed_end = end
            want_end = max(want_end, cpos + 64)
        if self.state == _ST_SYNC1 and self.sync_state in (
            _SY_SEARCH_BS1, _SY_BS1
        ):
            keep_start = max(0, n - lookback)
            if fed_end < keep_start:
                self._sync_reset_only()
            else:
                self._scan_prefed = fed_end - keep_start
                self._scan_want = max(0, want_end - n)
            self._scan_tail = pcm[keep_start:].copy()
        self._in_scan = False
        return self.messages[start_msg:]

    def on_pcm(self, pcm) -> list[FlexMessage]:
        if self._scan_ever and not self._in_scan:
            raise RuntimeError(
                "do not interleave on_pcm() with scan() on the same "
                "decoder instance (scan carries prefilter state)")
        pcm = np.asarray(pcm, dtype=np.int16)
        start = len(self.messages)
        if self._nat is not None and not self._in_scan:
            # streaming API -> native FSM. scan() keeps the numpy
            # prefilter+vectorized machinery (its BS1 AND-tree outruns even
            # the native FSM on sync-free input) and reaches here with
            # _in_scan set, so its internal feeds stay on the numpy tiers.
            self._on_pcm_native(pcm)
            return self.messages[start:]
        i = 0
        n = pcm.shape[0]
        while i < n:
            if self._vectorized and self.state == _ST_BLOCK:
                i = self._block_vec(pcm, i, n)
                continue
            if (self._vectorized and self.state == _ST_SYNC1
                    and self.sync_state in (_SY_A, _SY_B, _SY_INV_A, _SY_FIW)
                    and self.skip == 0 and self.skip_count == 0):
                i = self._sync_tail_vec(pcm, i, n)
                continue
            s = int(pcm[i])
            i += 1
            if self.skip_count == 0:
                self.skip_count = self.skip
                if self.state == _ST_SYNC1:
                    self._sync_update(s)
                    if self.sync_state == _SY_SYNCED:
                        if self._handle_fiw():
                            self.state = _ST_SYNC2
                            self.skip = self.coding.sample_skip
                            self.skip_count = self.skip + self.coding.sample_fudge
                        else:
                            self._reset_sync()
                elif self.state == _ST_SYNC2:
                    self._sync2_update(s)
                    if self.s2_state == _S2_SYNCED:
                        self.state = _ST_BLOCK
                else:
                    self._block_update(s)
            else:
                self.skip_count -= 1
        return self.messages[start:]
