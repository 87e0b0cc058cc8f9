// K9: the bit-exact tier's derotation and LUT discriminator, after K5.
//
// Replaces the stage that the JAX package runs on the host after its
// exact packed FIR (tsl_sdr_tpu/models/channelizer.py:281-301, with
// ops/fm.py:145 fm_demod_np and ops/atan2.py:83 fast_atan2_np), which the
// port ran as some 60 small integer and float torch ops a block
// (ops/fm.py exact_fm_plain: fm_demod_exact over ops/atan2.py fast_atan2).
// Per output k and channel c, from K5's Q.14 sums a and the host
// rotator's value s before output k:
//   d = (a_re*s_re - a_im*s_im, a_re*s_im + a_im*s_re)   int32, wrapping
//   ch = (d >> 14) + ((d >> 13) & 1)                      narrowed mod 2^16
//   (s_re, s_im) = ch * conj(prev)                        int32, wrapping
//   phi = fast_atan2(float(s_im), float(s_re))            the 257-entry LUT
//   pcm = trunc(float32((phi / pi) * 16384))              the last two f64
// with prev the previous channelized sample (the carried fm_last, full
// int32, at k = 0). It is bit-equal to the plain version: the products
// wrap mod 2^32 as unsigned 32-bit products do; every float32 step is one
// _rn intrinsic in the plain version's order, so nothing contracts into
// an FMA; alpha truncates toward zero and then & 0xFF; the z < TAN_MAP_RES
// test compares in float64; the scale is a float64 true divide by pi
// (__ddiv_rn), a multiply by 2^14, a round to float32, a truncation. A
// zero dividend of either divide is answered without dividing (0 / hi
// and 0 / pi are +0, and both scale to PCM 0), which is the same value.
//
// What bounds it on the H100: bytes. A pager block (130,560 x 8) reads
// 4 B of sums and 4 B of rotator a sample and writes 2 B of PCM and 4 B
// of channelized IQ: 14.6 MB, 4.4 us at 3.35 TB/s; the arithmetic (some
// 40 operations a sample) is below that on the CUDA cores.
//
// How the design responds. A CTA takes a tile of tk outputs for a block
// of cb channels (all of a bank of up to kMaxBlock; 32 a block on wider
// banks), tk * cb <= kTileSamples, tk cut to give the card about four
// CTAs an SM (the wrapper's geometry, ops/fm.py exact_fm_tile: a CTA's
// phases, load, discriminate, store, follow one another, so the SM
// overlaps them across CTAs; on an H100 four beat two and eight):
// - its loads run along the arrays' (k, c) order, eight samples a thread
//   as 16-byte vectors of a_re, a_im and two of seq (scalars where a
//   group is cut by the tile's edge or a base is not 16-byte aligned), so
//   a warp reads whole lines once and no other CTA reads them again (the
//   first design ran a CTA along k for one channel, every load strided by
//   the bank's width);
// - each sample is derotated once, into shared memory and, in the same
//   order and width, to ch; the sample before the tile (one halo row, or
//   the carried fm_last at k = 0) is derotated by the first cb threads,
//   so the discriminator reads its previous sample from shared memory and
//   no CTA talks to another (the first design derotated every sample
//   twice);
// - the PCM tile goes through shared memory transposed ([cb][tk + 2],
//   odd word pitch) and out as rows of [C, K], 16 bytes a thread;
// - the LUT is staged once a tile, up to thousands of samples (the first
//   design staged it, behind a barrier, every 256);
// - neither divide takes its slow path for a zero dividend, which a quiet
//   channel's small samples give often (above).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 257;
constexpr int kTileSamples = 4096;   // tk * cb at most
constexpr int kMaxBlock = 64;        // channels a CTA at most
constexpr int kPcmPad = 2;           // tk + 2 int16: an odd word pitch

// the low and high int16 of a packed (re, im) pair, sign-extended
__device__ __forceinline__ int lo16(unsigned w) {
  return (int)(short)(w & 0xFFFFu);
}
__device__ __forceinline__ int hi16(unsigned w) { return (int)w >> 16; }

// K5's sum times the rotator (seq packed re | im << 16), rounded Q.28 ->
// Q.14 (q14.round_q28_q14), packed re | im << 16 as ch stores it
__device__ __forceinline__ unsigned derotate(int ar, int ai, unsigned s) {
  const unsigned sr = (unsigned)lo16(s), si = (unsigned)hi16(s);
  const unsigned ur = (unsigned)ar, ui = (unsigned)ai;
  const int dr = (int)(ur * sr - ui * si);
  const int di = (int)(ur * si + ui * sr);
  const int cr = (short)((dr >> 14) + ((dr >> 13) & 1));
  const int ci = (short)((di >> 14) + ((di >> 13) & 1));
  return ((unsigned)ci << 16) | ((unsigned)cr & 0xFFFFu);
}

// ops/atan2.py fast_atan2, one rounding a step
__device__ __forceinline__ float lut_atan2(float y, float x,
                                           const float* table) {
  const float pi = __int_as_float(0x40490FDB);   // float32(pi)
  const float hp = __int_as_float(0x3FC90FDB);   // float32(pi / 2)
  const float ya = fabsf(y), xa = fabsf(x);
  const float hi = fmaxf(ya, xa);
  // 0 / hi is +0: the divide gets 1 / 1 there, so that it never takes
  // its slow path for a zero dividend, which a quiet channel's small
  // samples give often
  const float mn = fminf(ya, xa);
  const bool none = mn == 0.0f;
  const float q = __fdiv_rn(none ? 1.0f : mn, none ? 1.0f : hi);
  const float z = none ? 0.0f : q;
  const float alpha = __fmul_rn(z, 255.0f);
  const int index = __float2int_rz(alpha) & 0xFF;
  const float frac = __fsub_rn(alpha, __int2float_rn(index));
  const float t0 = table[index], t1 = table[index + 1];
  const float interp = __fadd_rn(t0, __fmul_rn(__fsub_rn(t1, t0), frac));
  const float base = (double)z < 0.003921569 ? z : interp;
  const float ax = x >= 0.0f ? (y >= 0.0f ? base : -base)
                             : (y >= 0.0f ? __fsub_rn(pi, base)
                                          : __fsub_rn(base, pi));
  const float ay = y >= 0.0f ? (x >= 0.0f ? __fsub_rn(hp, base)
                                          : __fadd_rn(hp, base))
                             : (x >= 0.0f ? __fadd_rn(-hp, base)
                                          : __fsub_rn(-hp, base));
  if (ya == 0.0f && xa == 0.0f) return 0.0f;
  return xa > ya ? ax : ay;
}

// the PCM of channelized sample cur after prev (fm_demod_exact)
__device__ __forceinline__ int16_t discriminate(int cr, int ci, int pr,
                                                int pi, const float* table) {
  const int s_re = (int)((unsigned)cr * (unsigned)pr +
                         (unsigned)ci * (unsigned)pi);
  const int s_im = (int)((unsigned)ci * (unsigned)pr -
                         (unsigned)cr * (unsigned)pi);
  const float phi = lut_atan2(__int2float_rn(s_im), __int2float_rn(s_re),
                              table);
  // phi = +0 (s_im = 0 <= s_re) scales to 0; as above, the float64
  // divide never sees the zero
  const bool still = phi == 0.0f;
  const double scaled = __dmul_rn(
      __ddiv_rn(still ? 1.0 : (double)phi, 3.141592653589793), 16384.0);
  return still ? (int16_t)0
               : (int16_t)__float2int_rz(__double2float_rn(scaled));
}

// Groups of 8 consecutive flat indices, aligned to 8 from the arrays'
// bases, that cover the run [start, start + len): ceil(len / 8) where
// every run starts on the grid, one more where it may not.
__device__ __forceinline__ int groups(int len, bool on_grid) {
  return (len + (on_grid ? 7 : 14)) / 8;
}

__global__ void __launch_bounds__(kThreads)
    exact_fm_kernel(const int16_t* __restrict__ a_re,
                    const int16_t* __restrict__ a_im,
                    const unsigned* __restrict__ seq,
                    const int* __restrict__ last,
                    const float* __restrict__ table_g,
                    int16_t* __restrict__ pcm, unsigned* __restrict__ ch,
                    int* __restrict__ last_out, long long k, int c_n,
                    int tk, int cb, bool vec) {
  __shared__ float table[kTable];
  __shared__ __align__(16) unsigned ch_s[kTileSamples];
  __shared__ __align__(16) int16_t pcm_s[kTileSamples + kPcmPad * kMaxBlock];
  __shared__ int halo[2 * kMaxBlock];
  const int t = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * tk;
  const int tka = (int)min((long long)tk, k - k0);
  const int cb0 = blockIdx.y * cb;
  const int cba = min(cb, c_n - cb0);
  for (int i = t; i < kTable; i += kThreads) table[i] = table_g[i];
  if (t < cba) {
    if (k0 == 0) {
      halo[2 * t] = last[2 * (cb0 + t)];
      halo[2 * t + 1] = last[2 * (cb0 + t) + 1];
    } else {
      const long long e = (k0 - 1) * c_n + cb0 + t;
      const unsigned v = derotate(a_re[e], a_im[e], seq[e]);
      halo[2 * t] = lo16(v);
      halo[2 * t + 1] = hi16(v);
    }
  }

  // derotate the tile: runs of the flat (k, c) order, one for the whole
  // tile where the CTA holds every channel, else one a row of cba
  const bool flat = cba == c_n;
  const int nrun = flat ? 1 : tka;
  const int run = flat ? tka * c_n : cba;
  const int gpr = groups(run, flat || ((c_n | cb) & 7) == 0);
  for (int i = t; i < nrun * gpr; i += kThreads) {
    const int r = i / gpr;
    const long long start = (k0 + r) * c_n + cb0;
    const long long g = (start & ~7LL) + 8LL * (i - r * gpr);
    const long long lo = max(g, start), hi = min(g + 8, start + run);
    if (lo >= hi) continue;
    const int l0 = r * run + (int)(lo - start);   // ch_s index of lo
    if (vec && lo == g && hi == g + 8) {
      const uint4 re = __ldcs(reinterpret_cast<const uint4*>(a_re + g));
      const uint4 im = __ldcs(reinterpret_cast<const uint4*>(a_im + g));
      const uint4 s0 = __ldcs(reinterpret_cast<const uint4*>(seq + g));
      const uint4 s1 = __ldcs(reinterpret_cast<const uint4*>(seq + g + 4));
      const unsigned rw[4] = {re.x, re.y, re.z, re.w};
      const unsigned iw[4] = {im.x, im.y, im.z, im.w};
      const unsigned sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      unsigned out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ar = j & 1 ? hi16(rw[j / 2]) : lo16(rw[j / 2]);
        const int ai = j & 1 ? hi16(iw[j / 2]) : lo16(iw[j / 2]);
        out[j] = derotate(ar, ai, sw[j]);
      }
      const uint4 c0 = make_uint4(out[0], out[1], out[2], out[3]);
      const uint4 c1 = make_uint4(out[4], out[5], out[6], out[7]);
      __stcs(reinterpret_cast<uint4*>(ch + g), c0);
      __stcs(reinterpret_cast<uint4*>(ch + g + 4), c1);
      if ((l0 & 3) == 0) {
        *reinterpret_cast<uint4*>(ch_s + l0) = c0;
        *reinterpret_cast<uint4*>(ch_s + l0 + 4) = c1;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) ch_s[l0 + j] = out[j];
      }
    } else {
      for (long long e = lo; e < hi; ++e) {
        const unsigned v = derotate(a_re[e], a_im[e], seq[e]);
        ch[e] = v;
        ch_s[l0 + (int)(e - lo)] = v;
      }
    }
  }
  __syncthreads();

  // discriminate: sample l = r * cba + cc after its predecessor, the PCM
  // transposed into pcm_s[cc][r]; (r, cc) stepped along with l, not
  // divided out of it
  const int pitch = tk + kPcmPad;
  const int dr = kThreads / cba, dc = kThreads - dr * cba;
  int r = t / cba, cc = t - r * cba;
  for (int l = t; l < tka * cba; l += kThreads, r += dr, cc += dc) {
    if (cc >= cba) {
      cc -= cba;
      ++r;
    }
    const unsigned cur = ch_s[l];
    int pr, pi;
    if (r == 0) {
      pr = halo[2 * cc];
      pi = halo[2 * cc + 1];
    } else {
      const unsigned prev = ch_s[l - cba];
      pr = lo16(prev);
      pi = hi16(prev);
    }
    pcm_s[cc * pitch + r] = discriminate(lo16(cur), hi16(cur), pr, pi, table);
  }
  if (k0 + tka == k && t < cba) {
    const unsigned v = ch_s[(tka - 1) * cba + t];
    last_out[2 * (cb0 + t)] = lo16(v);
    last_out[2 * (cb0 + t) + 1] = hi16(v);
  }
  __syncthreads();

  // the PCM rows [cb0 + cc][k0, k0 + tka), 8 samples (16 bytes) a thread
  const int gpc = groups(tka, (k & 7) == 0);
  for (int i = t; i < cba * gpc; i += kThreads) {
    const int cc = i / gpc;
    const long long start = (cb0 + cc) * k + k0;
    const long long g = (start & ~7LL) + 8LL * (i - cc * gpc);
    const long long lo = max(g, start), hi = min(g + 8, start + tka);
    if (lo >= hi) continue;
    const int16_t* src = pcm_s + cc * pitch;   // sample start + j at src[j]
    if (lo == g && hi == g + 8) {
      src += g - start;
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = ((unsigned)(uint16_t)src[2 * j]) |
               ((unsigned)(uint16_t)src[2 * j + 1] << 16);
      __stcs(reinterpret_cast<uint4*>(pcm + g),
             make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      for (long long e = lo; e < hi; ++e) pcm[e] = src[e - start];
    }
  }
}

}  // namespace

// a_re, a_im [k, c_n] int16 (K5's q14 planes); seq [k, c_n, 2] int16;
// last [c_n, 2] int32; table [257] float32 -> pcm [c_n, k] int16, ch
// [k, c_n, 2] int16, last_out [c_n, 2] int32; a CTA a tile of tk outputs
// (a multiple of 8) for cb channels, tk * cb <= kTileSamples, cb <=
// kMaxBlock. pcm and ch must be 16-byte aligned.
extern "C" int tsl_exact_fm(const void* a_re, const void* a_im,
                            const void* seq, const void* last,
                            const void* table, void* pcm, void* ch,
                            void* last_out, long long k, int c_n, int tk,
                            int cb, void* stream) {
  if (k <= 0 || c_n <= 0 || tk <= 0 || tk % 8 || cb <= 0 || cb > c_n ||
      cb > kMaxBlock || (long long)tk * cb > kTileSamples ||
      (c_n + cb - 1) / cb > 65535 || ((uintptr_t)pcm | (uintptr_t)ch) & 15)
    return (int)cudaErrorInvalidValue;
  const bool vec =
      (((uintptr_t)a_re | (uintptr_t)a_im | (uintptr_t)seq) & 15) == 0;
  const dim3 grid((unsigned)((k + tk - 1) / tk), (c_n + cb - 1) / cb);
  exact_fm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)a_re, (const int16_t*)a_im, (const unsigned*)seq,
      (const int*)last, (const float*)table, (int16_t*)pcm, (unsigned*)ch,
      (int*)last_out, k, c_n, tk, cb, vec);
  return (int)cudaGetLastError();
}
