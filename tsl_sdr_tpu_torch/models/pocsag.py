"""POCSAG pager decoder (512/1200/2400 bps) — bit-exact state machine.

Replicates the reference receiver's behavior (``pager/pager_pocsag.c``):

* SEARCH: three parallel baud detectors (75/32/16 samples per bit at the
  38400 Hz input contract) each keep ``samples_per_bit`` phase-interleaved
  32-bit shift registers hunting the sync word 0x7CD215D8 within hamming
  distance 4 (``:82-117``); sync declares when the matching "eye" spans more
  than half a bit period, and slicing starts mid-eye (``:100-108``).
* BATCH_RECEIVE: one bit per ``samples_per_bit`` samples, sign slicing
  (sample < 0 -> 1), 16 x 32-bit words packed LSB-first (``:471-506``; the
  reference's ``bit << bit_count`` shift lands on bit_count mod 32).
* Per word: mask the parity bit, BCH(31,21)-correct; idle 0x6983915E ends a
  message; LSB 0 = address word (capcode/function); else 20 content bits
  stream into parallel 7-bit-ASCII and 4-bit-BCD registers (``:320-432``).
* Message typing: printable-score heuristic picks alpha vs numeric at
  delivery (``:242-297``).
* SEARCH_SYNCWORD: re-acquire sync at the locked cadence or fall back to
  full search (``:508-537``).

This is the host-tier FSM (sample-sequential, like the wire protocol itself);
the TPU front-end (channelize/resample/demod) feeds it PCM. A vectorized
block decoder rides on top for throughput work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tsl_sdr_tpu_torch.models.bch import pocsag_bch
from tsl_sdr_tpu_torch.runtime.native import PocsagNative

SYNC_CODEWORD = 0x7CD215D8
IDLE_CODEWORD = 0x6983915E
BASE_RATE = 38400
BATCH_WORDS = 16

NUMERIC_CHARMAP = "0123456789XU -[]"

_STATE_SEARCH = 0
_STATE_SYNCHRONIZED = 1
_STATE_BATCH = 2
_STATE_SEARCH_SYNCWORD = 3


def _popcount32(v: int) -> int:
    return bin(v & 0xFFFFFFFF).count("1")


def _check_sync_word(word: int) -> bool:
    return _popcount32(word ^ SYNC_CODEWORD) <= 4


def _is_print(c: int) -> bool:
    return 0x20 <= c <= 0x7E


@dataclass
class PocsagMessage:
    baud: int
    capcode: int
    function: int
    kind: str            # "alpha" | "numeric"
    data: bytes          # message payload as delivered
    early_termination: bool = False

    @property
    def text(self) -> str:
        return self.data.decode("latin-1")


class _BaudDetect:
    def __init__(self, samples_per_bit: int, baud: int):
        self.spb = samples_per_bit
        self.baud = baud
        self.reset()

    def reset(self):
        self.eye = [0] * self.spb
        self.cur_word = 0
        self.nr_eye_matches = 0


class _MessageDecode:
    def __init__(self):
        self.reset()

    def reset(self):
        self.alpha = bytearray()
        self.numeric = bytearray()
        self.word_alpha = 0
        self.word_alpha_bits = 0
        self.word_numeric = 0
        self.word_numeric_bits = 0
        self.seen_nonprint = False
        self.score_alpha = 0
        self.early_termination = False
        self.msg_type = "none"   # none | unknown | alpha | numeric
        self.cap_code = 0
        self.function = 0


class PocsagDecoder:
    """Streaming POCSAG decoder; feed 38400 Hz int16 PCM via :meth:`on_pcm`."""

    def __init__(self, skip_bch: bool = False, vectorized: bool = True,
                 native: bool = True):
        self.bch = pocsag_bch(native)
        # stored-but-unused, matching the reference exactly: pager_pocsag_new
        # takes skip_bch_decode and stores it (pager_pocsag.c:145,185) but no
        # code path ever reads it
        self.skip_bch = skip_bch
        # vectorized BATCH/SEARCH_SYNCWORD paths (exact scalar equivalents;
        # vectorized=False keeps the per-sample reference loops)
        self._vectorized = vectorized
        # native C++ sample FSM (native/tslstream.cc tsl_pocsag_*), built at
        # first use (a failed build raises); BCH + message assembly stay
        # here. native=False keeps the numpy paths.
        self._nat = PocsagNative() if native else None
        self.detectors = [
            _BaudDetect(BASE_RATE // 512, 512),
            _BaudDetect(BASE_RATE // 1200, 1200),
            _BaudDetect(BASE_RATE // 2400, 2400),
        ]
        self.decoder = _MessageDecode()
        self.state = _STATE_SEARCH
        self.sample_skip = 0
        self.baud_rate = 0
        self._batch_reset()
        self._sync_reset()
        self.messages: list[PocsagMessage] = []
        # scan() streaming carry: prefilter-context tail, how many of its
        # leading samples the FSM already consumed, and how many samples past
        # that still owe the FSM a contiguous feed (candidate margin cut off
        # by the previous block edge).
        self._scan_tail = np.zeros(0, np.int16)
        self._scan_prefed = 0
        self._scan_want = 0
        # interleave guard: scan() and on_pcm() must not be mixed on one
        # instance (scan's carry bookkeeping would silently lose messages)
        self._scan_ever = False
        self._in_scan = False

    # -- state resets ---------------------------------------------------------

    def _batch_reset(self):
        self.batch_words = [0] * BATCH_WORDS
        self.batch_word_idx = 0
        self.batch_word_bit = 0
        self.batch_sample_skip = 0
        self.batch_bit_count = 0

    def _sync_reset(self):
        self.sync_sample_skip = 0
        self.sync_bits = 0
        self.sync_word = 0

    # -- message delivery -------------------------------------------------

    def _deliver(self):
        d = self.decoder
        if d.msg_type == "none":
            return
        if len(d.alpha):
            if d.alpha[-1] in (0x04, 0x03, 0x00, 0x17):
                d.score_alpha = 1
        if len(d.numeric) > 40:
            d.score_alpha = 1
        kind = "alpha" if d.score_alpha > 0 else "numeric"
        data = bytes(d.alpha) if kind == "alpha" else bytes(d.numeric)
        self.messages.append(
            PocsagMessage(
                baud=self.baud_rate,
                capcode=d.cap_code,
                function=d.function,
                kind=kind,
                data=data,
                early_termination=d.early_termination,
            )
        )
        d.reset()

    # -- batch word processing ----------------------------------------------

    def _process_batch(self) -> bool:
        """Returns False when a multi-bit error aborts the batch."""
        d = self.decoder
        # one vectorized BCH pass over the whole batch (decode is per-word
        # independent, so pre-decoding words after an abort changes nothing)
        batch = np.asarray(self.batch_words, np.uint64).astype(np.uint32)
        corr_all, fail_all = self.bch.decode(batch & np.uint32(0x7FFFFFFF))
        for z in range(BATCH_WORDS):
            corrected, fail = int(corr_all[z]), bool(fail_all[z])
            if fail:
                if d.msg_type != "none":
                    d.early_termination = True
                    self._deliver()
                return False

            if corrected == IDLE_CODEWORD:
                if d.msg_type != "none":
                    self._deliver()
                continue

            if (corrected & 1) == 0:
                self._deliver()
                d.msg_type = "unknown"
                d.function = (corrected >> 19) & 0x3
                d.cap_code = (((corrected >> 1) & ((1 << 18) - 1)) << 3) + (
                    (z >> 1) & 0x7
                )
            elif d.msg_type == "unknown":
                val = (corrected >> 1) & 0xFFFFF
                d.word_alpha |= val << d.word_alpha_bits
                d.word_alpha_bits += 20
                while d.word_alpha_bits >= 7:
                    c = d.word_alpha & 0x7F
                    if len(d.alpha) < 511:
                        d.alpha.append(c)
                    if _is_print(c) or c in (0x0A, 0x0D):
                        if not d.seen_nonprint:
                            d.score_alpha += 1
                    else:
                        d.seen_nonprint = True
                        if c not in (0x03, 0x04, 0x17, 0x00):
                            d.score_alpha -= 10
                    d.word_alpha >>= 7
                    d.word_alpha_bits -= 7

                if len(d.numeric) < 511:
                    d.word_numeric |= val << d.word_numeric_bits
                    d.word_numeric_bits += 20
                    while d.word_numeric_bits >= 4 and len(d.numeric) < 511:
                        bcd = d.word_numeric & 0xF
                        d.numeric.append(ord(NUMERIC_CHARMAP[bcd]))
                        d.word_numeric >>= 4
                        d.word_numeric_bits -= 4
        return True

    # -- accelerated batch scan ---------------------------------------------

    def scan(self, pcm) -> list[PocsagMessage]:
        """Batch decode with a vectorized SEARCH fast-forward.

        Produces the same messages as :meth:`on_pcm` — the FSM itself is
        unchanged; noise regions are skipped using a numpy prefilter that
        finds every sample whose phase-interleaved 32-bit register *could*
        match the sync word (a strict superset of the FSM's sync triggers,
        since a trigger requires a run of such matches). The FSM is then run
        only from ``34*spb`` samples before each candidate, which fully
        refills all shift registers and eye counters before the candidate,
        so the decode is sample-exact. ~100x faster than the pure FSM on
        sync-free input.

        Streaming-safe: the last ``lookback`` samples are always carried
        into the next scan() call as prefilter context (a sync register
        straddling the call boundary needs them to be found), tracking how
        many were already FSM-fed so nothing is double-fed and detector
        state stays contiguous. Feeding a stream in arbitrary scan()
        blocks produces the same messages as one call. Do not interleave
        scan() and on_pcm() on the same instance.
        """
        pcm = np.asarray(pcm, dtype=np.int16)
        if self._nat is not None:
            # the native FSM outruns the numpy prefilter; scan() is a
            # straight delegate (all samples FSM-fed; no carry needed)
            return self.on_pcm(pcm)
        start_msg = len(self.messages)
        self._scan_ever = True
        self._in_scan = True
        # streaming carry: prepend the previous call's prefilter-context tail
        tail = self._scan_tail
        prefed = self._scan_prefed
        feed_until = prefed + self._scan_want
        if tail.size:
            pcm = np.concatenate([tail, pcm])
        self._scan_tail = np.zeros(0, np.int16)
        self._scan_prefed = 0
        self._scan_want = 0
        n = pcm.shape[0]
        bits = (pcm < 0).astype(np.uint32)

        # Candidate positions: any detector register within hamming 4 of the
        # sync word. A sync trigger needs a run of > spb/2 consecutive
        # matching samples, so probing every spb//4-th GLOBAL grid position
        # still hits every possible trigger (strict superset) at a fraction
        # of the work. Computed LAZILY per window: on dense traffic most
        # samples are consumed by the (vectorized) BATCH path and never need
        # prefiltering — an upfront whole-capture pass would dominate.
        max_spb = max(d.spb for d in self.detectors)
        pad = 31 * max_spb
        bp = np.concatenate([np.zeros(pad, np.uint32), bits])

        def cands_window(lo: int, hi: int) -> np.ndarray:
            cand_list = []
            for det in self.detectors:
                spb = det.spb
                stride = max(1, spb // 4)
                first = -(-lo // stride) * stride  # global grid, >= lo
                pos = np.arange(first, hi, stride)
                if not pos.size:
                    continue
                w = np.zeros(pos.shape[0], dtype=np.uint32)
                for k in range(32):
                    s0 = pad + first - k * spb
                    w |= bp[s0 : s0 + (hi - first) : stride] << np.uint32(k)
                v = w ^ np.uint32(SYNC_CODEWORD)
                v = v - ((v >> 1) & np.uint32(0x55555555))
                v = (v & np.uint32(0x33333333)) + (
                    (v >> 2) & np.uint32(0x33333333))
                v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
                pc = (v * np.uint32(0x01010101)) >> np.uint32(24)
                cand_list.append(pos[pc <= 4])
            if not cand_list:
                return np.zeros(0, np.int64)
            return np.unique(np.concatenate(cand_list))

        cwin = np.zeros(0, np.int64)
        cwin_hi = 0
        win = 1 << 15

        def next_candidate(i: int):
            nonlocal cwin, cwin_hi, win
            while True:
                k = np.searchsorted(cwin, i)
                if k < len(cwin):
                    return int(cwin[k])
                if cwin_hi >= n:
                    return None
                lo = max(cwin_hi, i)
                hi = min(n, lo + win)
                cwin = cands_window(lo, hi)
                cwin_hi = hi
                # grow while dry (noise: amortize), shrink on a hit (dense
                # traffic: the next sync is near)
                win = (1 << 15) if cwin.size else min(win * 4, 1 << 22)

        lookback = 34 * max_spb
        chunk = 32 * 17 * max_spb  # one batch + sync word at the slowest baud

        i = prefed
        fed_end = prefed
        want_end = feed_until
        while i < n:
            if self.state != _STATE_SEARCH:
                # mid-message: run the exact FSM on contiguous samples
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
            # in SEARCH: jump to the next candidate at/after i
            c = next_candidate(i)
            if c is None:
                break
            start = max(i, c - lookback)
            if start > i:
                # skipped region has no candidates -> no sync possible;
                # stale registers are cleared (zeros cannot match sync)
                for det in self.detectors:
                    det.reset()
                i = start
            end = min(n, c + 2 * max_spb)
            self.on_pcm(pcm[i:end])
            i = end
            fed_end = end
            want_end = max(want_end, c + 2 * max_spb)
        if self.state == _STATE_SEARCH:
            keep_start = max(0, n - lookback)
            if fed_end < keep_start:
                # the gap between the last FSM-fed sample and the kept tail
                # was skipped (no candidates there) -> registers are stale
                for det in self.detectors:
                    det.reset()
            else:
                self._scan_prefed = fed_end - keep_start
                self._scan_want = max(0, want_end - n)
            self._scan_tail = pcm[keep_start:].copy()
        self._in_scan = False
        return self.messages[start_msg:]

    # -- egress-gating hooks (ReceivePipeline device prefilter) ------------

    @property
    def supports_gating(self) -> bool:
        """Egress gating feeds via scan() with explicit gap notifications;
        only the native FSM tier keeps exact stream semantics under that
        protocol (the numpy scan carries its own prefilter state)."""
        return self._nat is not None

    @property
    def in_search(self) -> bool:
        """True while hunting for sync (no message in flight)."""
        if self._nat is not None:
            return self._nat.in_search
        return self.state == _STATE_SEARCH

    def notify_gap(self):
        """A sync-free span of PCM was skipped upstream (the device
        prefilter found no candidates — ReceivePipeline egress gating):
        reset the sync detectors so no register run straddles the gap."""
        if self._nat is not None:
            self._nat.detect_reset()
            return
        for det in self.detectors:
            det.reset()

    # -- the sample pump ------------------------------------------------------

    def on_pcm(self, pcm) -> list[PocsagMessage]:
        """Process a PCM block; returns messages completed during this block."""
        if self._scan_ever and not self._in_scan:
            raise RuntimeError(
                "do not interleave on_pcm() with scan() on the same "
                "decoder instance (scan carries prefilter state)")
        pcm = np.asarray(pcm, dtype=np.int16)
        if self._nat is not None:
            start_nat = len(self.messages)
            for ev in self._nat.on_pcm(pcm):
                if ev[0] == "batch":
                    self.baud_rate = ev[1]
                    self.batch_words = [int(v) for v in ev[2]]
                    self._process_batch()
                else:  # sync_lost
                    self._deliver()
            return self.messages[start_nat:]
        bits = (pcm < 0).astype(np.uint8)
        n = pcm.shape[0]
        start_msg = len(self.messages)

        i = 0
        while i < n:
            if self.state == _STATE_SEARCH:
                while i < n:
                    bit = int(bits[i])
                    for det in self.detectors:
                        reg = ((det.eye[det.cur_word] << 1) | bit) & 0xFFFFFFFF
                        det.eye[det.cur_word] = reg
                        if _check_sync_word(reg):
                            det.nr_eye_matches += 1
                        else:
                            if det.nr_eye_matches > det.spb // 2:
                                self.sample_skip = det.spb
                                self.baud_rate = det.baud
                                self._batch_reset()
                                self.batch_sample_skip = det.nr_eye_matches // 2
                                self.state = _STATE_SYNCHRONIZED
                            else:
                                det.nr_eye_matches = 0
                        det.cur_word = (det.cur_word + 1) % det.spb
                    i += 1
                    if self.state == _STATE_SYNCHRONIZED:
                        break
            elif self.state in (_STATE_SYNCHRONIZED, _STATE_BATCH):
                self.state = _STATE_BATCH
                if self._vectorized:
                    i = self._batch_fill_vec(bits, i, n)
                    continue
                while i < n:
                    self.batch_sample_skip += 1
                    if self.batch_sample_skip == self.sample_skip:
                        bit = int(bits[i])
                        self.batch_words[self.batch_word_idx] |= (
                            bit << (self.batch_bit_count & 31)
                        )
                        self.batch_word_bit += 1
                        self.batch_bit_count += 1
                        self.batch_sample_skip = 0
                        if self.batch_word_bit == 32:
                            self.batch_word_bit = 0
                            self.batch_word_idx += 1
                            if self.batch_word_idx == BATCH_WORDS:
                                self._process_batch()
                                self.state = _STATE_SEARCH_SYNCWORD
                                self.batch_word_idx = 0
                                self.batch_word_bit = 0
                                self._sync_reset()
                                i += 1
                                break
                    i += 1
            elif self.state == _STATE_SEARCH_SYNCWORD:
                if self._vectorized:
                    i = self._syncword_vec(bits, i, n)
                    continue
                while i < n:
                    self.sync_sample_skip += 1
                    if self.sync_sample_skip == self.sample_skip:
                        self.sync_sample_skip = 0
                        self.sync_word = (
                            (self.sync_word << 1) | int(bits[i])
                        ) & 0xFFFFFFFF
                        self.sync_bits += 1
                        if self.sync_bits == 32:
                            if not _check_sync_word(self.sync_word):
                                self.state = _STATE_SEARCH
                                self.sample_skip = 0
                                for det in self.detectors:
                                    det.reset()
                                self._deliver()
                            else:
                                self.state = _STATE_BATCH
                                self._batch_reset()
                            i += 1
                            break
                    i += 1

        return self.messages[start_msg:]

    # -- vectorized synced paths (exact equivalents of the scalar loops) ------

    def _batch_fill_vec(self, bits, i: int, n: int) -> int:
        """Vectorized BATCH fill: the bit cadence in BATCH is fixed (one
        sign bit per sample_skip samples), so the remaining bit positions
        are a static slice — no per-sample Python. Exactly equivalent to
        the scalar loop (fuzz-tested); returns the new sample index."""
        spb = self.sample_skip
        b = self.batch_sample_skip
        first = i + (spb - 1 - b)
        bc0 = self.batch_bit_count
        need = BATCH_WORDS * 32 - bc0
        taken = bits[first : first + need * spb : spb] if first < n else \
            np.zeros(0, np.uint8)
        m = taken.shape[0]
        if m:
            j = np.arange(bc0, bc0 + m)
            vals = taken.astype(np.uint32) << (j & 31).astype(np.uint32)
            w = j >> 5
            starts = np.flatnonzero(np.diff(w, prepend=w[0] - 1))
            contrib = np.bitwise_or.reduceat(vals, starts)
            for wi, cv in zip(w[starts], contrib):
                self.batch_words[int(wi)] |= int(cv)
        if m == need:
            # batch complete mid-block
            self.batch_bit_count = bc0 + m
            self._process_batch()
            self.state = _STATE_SEARCH_SYNCWORD
            self.batch_word_idx = 0
            self.batch_word_bit = 0
            self.batch_sample_skip = 0
            self._sync_reset()
            return first + (m - 1) * spb + 1
        # block exhausted: advance carries exactly as the scalar loop would
        bc = bc0 + m
        self.batch_bit_count = bc
        self.batch_word_idx = bc >> 5
        self.batch_word_bit = bc & 31
        self.batch_sample_skip = b + (n - i) - m * spb
        return n

    def _syncword_vec(self, bits, i: int, n: int) -> int:
        """Vectorized SEARCH_SYNCWORD: gather up to the 32 sync bits at the
        locked cadence in one slice (exact scalar-loop equivalent)."""
        spb = self.sample_skip
        s = self.sync_sample_skip
        first = i + (spb - 1 - s)
        need = 32 - self.sync_bits
        taken = bits[first : first + need * spb : spb] if first < n else \
            np.zeros(0, np.uint8)
        m = taken.shape[0]
        if m:
            word = self.sync_word
            packed = 0
            for bit in taken.tolist():
                packed = (packed << 1) | bit
            self.sync_word = ((word << m) | packed) & 0xFFFFFFFF
        if m == need:
            self.sync_bits = 32
            self.sync_sample_skip = 0
            if not _check_sync_word(self.sync_word):
                self.state = _STATE_SEARCH
                self.sample_skip = 0
                for det in self.detectors:
                    det.reset()
                self._deliver()
            else:
                self.state = _STATE_BATCH
                self._batch_reset()
            return first + (m - 1) * spb + 1
        self.sync_bits += m
        self.sync_sample_skip = s + (n - i) - m * spb
        return n
