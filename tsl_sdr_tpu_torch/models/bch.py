"""BCH(n=2^m-1, k, t) codec over GF(2^m) — vectorized over word batches.

Behavior contract (reference ``pager/bch_code.c``, itself adapted from
GNURadio/multimon): narrow-sense binary BCH; decode forms syndromes
s_1..s_{2t} where the received 31-bit word's bit j (MSB-first: bit j =
``(word >> (n-1-j)) & 1``) contributes ``alpha^{i*j}`` to s_i; a single error
is corrected when ``log s_3 == 3 log s_1``; two errors via the closed-form
error-locator + Chien search; more errors -> reject. Reference quirk kept:
if s_1 == 0 and s_2 == 0 but s_3/s_4 != 0, the word passes uncorrected
(``bch_code.c:343-392`` falls through with retval 0).

Our construction is mathematical rather than transcribed: the generator
polynomial is the LCM of the minimal polynomials of alpha^1..alpha^{2t}
(conjugacy-class expansion), and decode is vectorized numpy over arbitrary
batches of words — the all-word syndrome computation is one masked-XOR
matrix reduction, the Chien search one [W, n] table evaluation. This shape
drops straight onto the TPU VPU if bit volume ever warrants it; at pager
bit rates the host does fine (SURVEY §7 phase 4).
"""

from __future__ import annotations

import numpy as np


class BchCode:
    """Generic binary BCH codec.

    Parameters mirror the reference constructor (``bch_code_new``):
    ``p`` — primitive polynomial coefficient list (p[0] + p[1] x + ...),
    ``m`` — field order, ``n`` = 2^m - 1, ``k`` — dimension, ``t`` — errors.
    POCSAG/FLEX instantiate (p=[1,0,1,0,0,1], m=5, n=31, k=21, t=2)
    (``pager/pager_pocsag.c:150,177``; ``pager/pager_flex.c:1353``).
    """

    def __init__(self, p, m: int, n: int, k: int, t: int):
        assert n == (1 << m) - 1
        self.m, self.n, self.k, self.t = m, n, k, t
        self.alpha_to, self.index_of = self._generate_gf(p, m, n)
        self.g = self._gen_poly()
        assert len(self.g) - 1 == n - k, (
            f"generator degree {len(self.g)-1} != n-k={n-k}"
        )
        self._build_decode_tables()

    # -- field construction --------------------------------------------------

    @staticmethod
    def _generate_gf(p, m, n):
        """Log/antilog tables for GF(2^m) with primitive element alpha = x."""
        poly_mask = 0
        for i in range(m):
            if p[i]:
                poly_mask |= 1 << i
        # alpha^m = lower-degree remainder of x^m mod p(x)
        alpha_to = np.zeros(n + 1, dtype=np.int64)
        index_of = np.full(n + 1, -1, dtype=np.int64)
        v = 1
        for i in range(n):
            alpha_to[i] = v
            index_of[v] = i
            v <<= 1
            if v & (1 << m):
                v = (v ^ (1 << m)) ^ poly_mask
        index_of[0] = -1
        return alpha_to, index_of

    def _gf_mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(
            self.alpha_to[(self.index_of[a] + self.index_of[b]) % self.n]
        )

    def _gen_poly(self) -> np.ndarray:
        """g(x) = lcm of minimal polynomials of alpha^1 .. alpha^{2t}.

        Coefficients over GF(2), g[0] = constant term.
        """
        covered: set[int] = set()
        g = [1]  # polynomial "1"
        for i in range(1, 2 * self.t + 1):
            if i in covered:
                continue
            # conjugacy class of alpha^i
            cls = []
            j = i
            while j not in cls:
                cls.append(j)
                j = (j * 2) % self.n
            covered.update(cls)
            # minimal poly = prod (x - alpha^j) over the class, GF(2^m) coeffs
            mp = [1]
            for j in cls:
                root = int(self.alpha_to[j])
                new = [0] * (len(mp) + 1)
                for d, c in enumerate(mp):
                    new[d + 1] ^= c               # x * mp
                    new[d] ^= self._gf_mul(c, root)  # root * mp
                mp = new
            assert all(c in (0, 1) for c in mp), "minimal poly not binary"
            # g *= mp over GF(2)
            new = [0] * (len(g) + len(mp) - 1)
            for d1, c1 in enumerate(g):
                if c1:
                    for d2, c2 in enumerate(mp):
                        new[d1 + d2] ^= c2
            g = new
        return np.asarray(g, dtype=np.int64)

    # -- encode ---------------------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """Systematic encode, vectorized over a batch.

        data: [...] ints holding k data bits where data bit i is the
        coefficient of x^{(n-k)+i}. Returns n-bit codewords in the
        *decoder's* bit convention (coefficient x^j at word bit n-1-j), so
        ``decode(encode(d))`` is clean.
        """
        data = np.asarray(data, dtype=np.uint64)
        nk = self.n - self.k
        g_mask = 0
        for d, c in enumerate(self.g):
            if c:
                g_mask |= 1 << d
        # polynomial long division of data(x)*x^{nk} by g(x), vectorized
        rem = data << np.uint64(nk)
        for bit in range(self.n - 1, nk - 1, -1):
            has = ((rem >> np.uint64(bit)) & np.uint64(1)).astype(bool)
            rem = np.where(has, rem ^ np.uint64(g_mask << (bit - nk)), rem)
        poly = (data << np.uint64(nk)) | rem  # coefficient x^j at bit j
        return self._bit_reverse(poly, self.n)

    @staticmethod
    def _bit_reverse(v: np.ndarray, nbits: int) -> np.ndarray:
        v = np.asarray(v, dtype=np.uint64)
        out = np.zeros_like(v)
        for b in range(nbits):
            out |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(nbits - 1 - b)
        return out

    def encode_onair_payload(self, payload: np.ndarray) -> np.ndarray:
        """Encode a k-bit payload given in *on-air LSB-first word* convention:
        payload bit b = on-air bit b = stored-word bit b (the layout the
        POCSAG batch receiver produces, ``pager_pocsag.c:477``). Returns the
        full n-bit stored word (on-air bit b at word bit b)."""
        payload = np.asarray(payload, dtype=np.uint64)
        data = self._bit_reverse(payload, self.k)  # d_i = on-air bit (k-1-i)
        return self.encode(data)

    # -- decode ---------------------------------------------------------------

    def _build_decode_tables(self):
        n = self.n
        j = np.arange(n)
        # contribution of *word bit* b (MSB-first index) to syndrome s_i:
        # word bit b corresponds to polynomial degree j = n-1-b in the
        # reference's indexing (bch_code.c:329: bit j = word >> (n-1-j))
        self._syn_contrib = np.stack(
            [self.alpha_to[(i * j) % n] for i in range(1, 2 * self.t + 1)]
        )  # [2t, n] indexed by degree j

    def decode(self, words: np.ndarray):
        """Vectorized decode of [W] uint32 n-bit words.

        Returns (corrected_words [W] uint32, failed [W] bool). Matches the
        reference's accept/reject and correction behavior exactly.
        """
        words = np.atleast_1d(np.asarray(words, dtype=np.uint32))
        w = words.shape[0]
        n = self.n
        deg = np.arange(n)
        bits = (words[:, None] >> (n - 1 - deg)[None, :].astype(np.uint32)) & 1

        # syndromes: XOR-reduce contributions of set bits  [W, 4]
        s_poly = np.zeros((w, 4), dtype=np.int64)
        for i in range(4):
            contrib = np.where(bits.astype(bool), self._syn_contrib[i][None, :], 0)
            s_poly[:, i] = np.bitwise_xor.reduce(contrib, axis=1)
        s_log = self.index_of[s_poly]  # [W, 4], -1 for zero

        syn_error = (s_poly != 0).any(axis=1)
        corrected = words.astype(np.int64).copy()
        failed = np.zeros(w, dtype=bool)

        s1_log, s2_log, s3_log = s_log[:, 0], s_log[:, 1], s_log[:, 2]
        s3 = (s1_log * 3) % n

        # case A: single error (s1 != 0 and log s3 == 3 log s1)
        single = syn_error & (s1_log != -1) & (s3_log == s3)
        corrected[single] ^= 1 << (n - 1 - s1_log[single])

        # case B: assume two errors (s1 != 0, s3 mismatch)
        double = syn_error & (s1_log != -1) & (s3_log != s3)
        if double.any():
            idx = np.nonzero(double)[0]
            aux = self.alpha_to[s3[idx]] ^ s_poly[idx, 2]
            log_aux = self.index_of[aux]
            elp1 = (s2_log[idx] - log_aux + n) % n
            elp2 = (s1_log[idx] - log_aux + n) % n
            # Chien search: q(i) = 1 ^ alpha^{elp1+i} ^ alpha^{elp2+2i}
            i_steps = np.arange(1, n + 1)
            q = (
                1
                ^ self.alpha_to[(elp1[:, None] + i_steps[None, :]) % n]
                ^ self.alpha_to[(elp2[:, None] + 2 * i_steps[None, :]) % n]
            )
            roots = q == 0  # [Wd, n]
            two_roots = roots.sum(axis=1) == 2
            loc = i_steps % n  # error location per Chien step
            for row, widx in enumerate(idx):
                if two_roots[row]:
                    for i_loc in loc[roots[row]]:
                        corrected[widx] ^= 1 << (n - 1 - i_loc)
                else:
                    failed[widx] = True

        # case C: s1 == 0 but s2 != 0 -> detect-only failure; the reference
        # lets s1 == s2 == 0 with s3/s4 != 0 pass silently (kept).
        failed |= syn_error & (s1_log == -1) & (s2_log != -1)

        return corrected.astype(np.uint32), failed

    def decode_one(self, word: int):
        c, f = self.decode(np.asarray([word], dtype=np.uint32))
        return int(c[0]), bool(f[0])


class _NativeBch3121(BchCode):
    """BCH(31,21,t=2) with the batch decode routed to the native corrector
    (native/tslstream.cc tsl_bch3121_decode) — same contract, ~50x less
    per-call overhead than the numpy tier at pager word-batch sizes.
    Encode and table construction stay on the numpy base."""

    def __init__(self):
        super().__init__([1, 0, 1, 0, 0, 1], 5, 31, 21, 2)
        from tsl_sdr_tpu_torch.runtime.native import bch3121_decode_native

        self._native = bch3121_decode_native
        self._native(np.zeros(1, np.uint32))  # build + smoke-check

    def decode(self, words):
        return self._native(np.atleast_1d(np.asarray(words, np.uint32)))

    def decode_one(self, word: int):
        c, f = self._native(np.asarray([word], np.uint32))
        return int(c[0]), bool(f[0])


def pocsag_bch(native: bool = True) -> BchCode:
    """The BCH(31,21,t=2) instance both pager protocols use.

    ``native=True`` builds (if stale) and uses the native corrector and
    raises if it cannot build; ``native=False`` is the pure-numpy tier (the
    fuzz oracle)."""
    if native:
        return _NativeBch3121()
    return BchCode([1, 0, 1, 0, 0, 1], 5, 31, 21, 2)
