// K9: the bit-exact tier's derotation and LUT discriminator, after K5.
//
// Replaces the stage that the JAX package runs on the host after its
// exact packed FIR (tsl_sdr_tpu/models/channelizer.py:281-301, with
// ops/fm.py:145 fm_demod_np and ops/atan2.py:83 fast_atan2_np), which the
// port ran as some 60 small integer and float torch ops a block
// (ops/fm.py exact_fm_plain: fm_demod_exact over ops/atan2.py fast_atan2).
// Per output k and channel c, from K5's Q.14 sums a and the host
// rotator's value s before output k:
//   d = (a_re*s_re - a_im*s_im, a_re*s_im + a_im*s_re)   int64, narrowed
//                                                         mod 2^32
//   ch = (d >> 14) + ((d >> 13) & 1)                      narrowed mod 2^16
//   (s_re, s_im) = ch * conj(prev)                        int64 -> int32
//   phi = fast_atan2(float(s_im), float(s_re))            the 257-entry LUT
//   pcm = trunc(float32((phi / pi) * 16384))              the last two f64
// with prev the previous channelized sample (the carried fm_last at k =
// 0). It is bit-equal to the plain version: every float32 step is one
// _rn intrinsic in the plain version's order, so nothing contracts into
// an FMA; alpha truncates toward zero and then & 0xFF; the z < TAN_MAP_RES
// test compares in float64; the scale is a float64 true divide by pi
// (__ddiv_rn), a multiply by 2^14, a round to float32, a truncation.
//
// What bounds it on the H100: bytes. A pager block (130,560 x 8) reads
// 4 B of sums and 4 B of rotator a sample and writes 2 B of PCM and 4 B
// of channelized IQ: 14.6 MB, 4.4 us at 3.35 TB/s; the arithmetic (some
// 40 operations a sample) is below that on the CUDA cores.
//
// How the design responds: one thread a (k, c), threads of a CTA along k
// for one channel, so the PCM [C, K] is written in whole lines; each
// thread derotates the sample before its own again (two rotations, no
// second pass and no exchange between CTAs). The table sits in shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 257;

__device__ __forceinline__ int wrap32(long long v) {
  return (int)(unsigned)(unsigned long long)v;
}

// K5's sums times the rotator, rounded Q.28 -> Q.14 (q14.round_q28_q14)
__device__ __forceinline__ void derotate(const int16_t* a_re,
                                         const int16_t* a_im,
                                         const int16_t* seq, long long i,
                                         int& cr, int& ci) {
  const long long ar = a_re[i], ai = a_im[i];
  const long long sr = seq[2 * i], si = seq[2 * i + 1];
  const int dr = wrap32(ar * sr - ai * si);
  const int di = wrap32(ar * si + ai * sr);
  cr = (int16_t)((dr >> 14) + ((dr >> 13) & 1));
  ci = (int16_t)((di >> 14) + ((di >> 13) & 1));
}

// ops/atan2.py fast_atan2, one rounding a step
__device__ __forceinline__ float lut_atan2(float y, float x,
                                           const float* table) {
  const float pi = __int_as_float(0x40490FDB);   // float32(pi)
  const float hp = __int_as_float(0x3FC90FDB);   // float32(pi / 2)
  const float ya = fabsf(y), xa = fabsf(x);
  const float hi = fmaxf(ya, xa);
  const float z = __fdiv_rn(fminf(ya, xa), hi == 0.0f ? 1.0f : hi);
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

__global__ void __launch_bounds__(kThreads)
    exact_fm_kernel(const int16_t* __restrict__ a_re,
                    const int16_t* __restrict__ a_im,
                    const int16_t* __restrict__ seq,
                    const int* __restrict__ last,
                    const float* __restrict__ table_g,
                    int16_t* __restrict__ pcm, int* __restrict__ ch,
                    int* __restrict__ last_out, long long k, int c_n) {
  __shared__ float table[kTable];
  for (int i = threadIdx.x; i < kTable; i += kThreads) table[i] = table_g[i];
  __syncthreads();
  const int c = blockIdx.y;
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= k) return;
  const long long i = n * c_n + c;
  int cr, ci, pr, pi;
  derotate(a_re, a_im, seq, i, cr, ci);
  if (n == 0) {
    pr = last[2 * c];
    pi = last[2 * c + 1];
  } else {
    derotate(a_re, a_im, seq, i - c_n, pr, pi);
  }
  const int s_re = wrap32((long long)cr * pr + (long long)ci * pi);
  const int s_im = wrap32((long long)ci * pr - (long long)cr * pi);
  const float phi = lut_atan2(__int2float_rn(s_im), __int2float_rn(s_re),
                              table);
  const double scaled =
      __dmul_rn(__ddiv_rn((double)phi, 3.141592653589793), 16384.0);
  pcm[(long long)c * k + n] =
      (int16_t)__float2int_rz(__double2float_rn(scaled));
  ch[i] = (int)(((unsigned)ci << 16) | ((unsigned)cr & 0xFFFFu));
  if (n == k - 1) {
    last_out[2 * c] = cr;
    last_out[2 * c + 1] = ci;
  }
}

}  // namespace

// a_re, a_im [k, c_n] int16 (K5's q14 planes); seq [k, c_n, 2] int16;
// last [c_n, 2] int32; table [257] float32 -> pcm [c_n, k] int16, ch
// [k, c_n, 2] int16, last_out [c_n, 2] int32.
extern "C" int tsl_exact_fm(const void* a_re, const void* a_im,
                            const void* seq, const void* last,
                            const void* table, void* pcm, void* ch,
                            void* last_out, long long k, int c_n,
                            void* stream) {
  if (k <= 0 || c_n <= 0 || c_n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((k + kThreads - 1) / kThreads), c_n);
  exact_fm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)a_re, (const int16_t*)a_im, (const int16_t*)seq,
      (const int*)last, (const float*)table, (int16_t*)pcm, (int*)ch,
      (int*)last_out, k, c_n);
  return (int)cudaGetLastError();
}
