// K4: frame-form polyphase rational resampler, all channels of one call.
//
// Replaces the TPU kernel tsl_sdr_tpu/ops/pallas_resampler.py
// _resample_kernel + _resample_call (reached by resample_capture_pallas),
// and stands in for the XLA transposed-residue product that the JAX
// package runs for every resampler plan without a packed-row form
// (k_row == 0: lcm(I_rep, 128) > 1024, or a spill longer than a row;
// tsl_sdr_tpu/ops/polyphase.py:258-301 _resample_fast_kernel_t).
//
// What it computes: per channel g, over the stream T = carry (n_carry
// samples) ++ block (n samples), zeros past its end, frame m and column
// j < I_rep give output k = m * I_rep + j:
//     acc = sum_{q < P} T[m * D_rep + oj[j] + q] * cols[j, q]
// summed in wrapping int32, where oj[j] = (phase0 + j*D) / I is column j's
// window start inside its frame and cols[j] = phases[(phase0 + j*D) % I] is
// its phase filter. This is the banded form of the dense [S*D_rep, I_rep]
// frame matrix the TPU multiplies by: the same sum (int32 wrap sums are
// order-free) without the zeros. At 147/160 each column holds 36 non-zero
// taps of 320, so the dense form would do 9x the work.
// Two epilogues: f32(acc) / 16384 (the fast tier, equal to the XLA tier
// bit for bit) or int16 round_q28_q14(acc) (the exact tier).
//
// What bounds it on the H100: integer issue and shared-memory loads, P
// multiply-adds per output; at 147/160 over 60 s of 48 kHz PCM that is
// 2.6 M outputs x 36 taps = 95 M int32 multiply-adds over 5.8 MB in and
// 10.6 MB out, so launch latency matters as much at the streaming shapes.
// The tensor cores take no int16 operands. How the design responds: a
// block takes TM frames of one channel for all I_rep columns. It stages
// the frames' samples plus the window overhang ((TM-1)*D_rep + span, read
// through the carry and block pointers one int16 at a time, so no
// alignment is assumed: carry_len 34 or 35 and D_rep 3 or 5 put frame
// starts anywhere), the taps transposed to [P, I_rep] and oj in shared
// memory. A thread takes one column and kKf consecutive frames, so one tap
// load feeds kKf multiply-adds; neighbouring threads take neighbouring
// columns, so tap loads, sample loads (oj grows by about D/I a column)
// and output stores all fall on neighbouring addresses. Work items run over
// (frame group, column) pairs, so I_rep need not fill a block (25 columns
// at 25/16; 64 columns of D_rep = 1 and up to 36 spill frames at 64/1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKf = 4;                  // frames per thread
constexpr int kTmMax = 64;              // frames per block
constexpr int kSmemMax = 160 * 1024;    // dynamic shared memory per block

__host__ __device__ inline size_t taps_bytes(int i_rep, int p) {
  return ((size_t)i_rep * 4 + (size_t)p * i_rep * 2 + 15) & ~(size_t)15;
}

inline size_t smem_bytes(int tm, int i_rep, int p, int d_rep, int span) {
  return taps_bytes(i_rep, p) + ((size_t)(tm - 1) * d_rep + span) * 2;
}

// grid = (ceil(m / tm), G), block = kThreads; tm a multiple of kKf;
// out is float (kQ14 false) or int16_t (kQ14 true), [G, m * i_rep]
template <bool kQ14>
__global__ void __launch_bounds__(kThreads)
frame_resample_kernel(const int16_t* __restrict__ carry,
                      const int16_t* __restrict__ block,
                      const int16_t* __restrict__ cols,
                      const int* __restrict__ oj,
                      void* __restrict__ out,
                      int m, int i_rep, int d_rep, int p, int span, int tm,
                      int n_carry, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* oj_s = (int*)smem;                                   // [i_rep]
  int16_t* wt = (int16_t*)(smem + (size_t)i_rep * 4);       // [p, i_rep]
  int16_t* xs = (int16_t*)(smem + taps_bytes(i_rep, p));    // staged T

  const int g = blockIdx.y;
  const int m0 = blockIdx.x * tm;
  const int16_t* cg = carry + (size_t)g * n_carry;
  const int16_t* bg = block + (size_t)g * n;

  for (int i = threadIdx.x; i < i_rep; i += kThreads) oj_s[i] = oj[i];
  for (int i = threadIdx.x; i < i_rep * p; i += kThreads) {
    const int j = i / p;
    wt[(i - j * p) * i_rep + j] = cols[i];
  }
  const long long t0 = (long long)m0 * d_rep;
  const int n_stage = (tm - 1) * d_rep + span;
  for (int i = threadIdx.x; i < n_stage; i += kThreads) {
    const long long t = t0 + i;
    int16_t v = 0;
    if (t < n_carry) {
      v = cg[t];
    } else if (t - n_carry < n) {
      v = bg[t - n_carry];
    }
    xs[i] = v;
  }
  __syncthreads();

  const int items = i_rep * (tm / kKf);
  const size_t base = (size_t)g * m * i_rep;
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int fg = w / i_rep;
    const int j = w - fg * i_rep;
    const int f0 = fg * kKf;
    const int16_t* xb = xs + f0 * d_rep + oj_s[j];
    unsigned acc[kKf];
#pragma unroll
    for (int r = 0; r < kKf; ++r) acc[r] = 0u;
    for (int q = 0; q < p; ++q) {
      const int wv = wt[q * i_rep + j];
#pragma unroll
      for (int r = 0; r < kKf; ++r) {
        acc[r] += (unsigned)((int)xb[r * d_rep + q] * wv);   // int32 wrap
      }
    }
#pragma unroll
    for (int r = 0; r < kKf; ++r) {
      const int mm = m0 + f0 + r;
      if (mm >= m) break;
      const size_t o = base + (size_t)mm * i_rep + j;
      const int a = (int)acc[r];
      if (kQ14) {
        ((int16_t*)out)[o] = (int16_t)((a >> 14) + ((a >> 13) & 1));
      } else {
        ((float*)out)[o] = __int2float_rn(a) * (1.0f / 16384.0f);
      }
    }
  }
}

template <bool kQ14>
int launch(const void* carry, const void* block, const void* cols,
           const void* oj, void* out, int m, int i_rep, int d_rep, int p,
           int span, int n_carry, long long n, int groups,
           cudaStream_t stream) {
  int tm = kTmMax;
  const int need = (m + kKf - 1) / kKf * kKf;
  if (need < tm) tm = need;
  while (tm > kKf && smem_bytes(tm, i_rep, p, d_rep, span) > kSmemMax) {
    tm = (tm / 2 + kKf - 1) / kKf * kKf;
  }
  const size_t smem = smem_bytes(tm, i_rep, p, d_rep, span);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      frame_resample_kernel<kQ14>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + tm - 1) / tm, groups);
  frame_resample_kernel<kQ14><<<grid, kThreads, smem, stream>>>(
      (const int16_t*)carry, (const int16_t*)block, (const int16_t*)cols,
      (const int*)oj, out, m, i_rep, d_rep, p, span, tm, n_carry, n);
  return (int)cudaGetLastError();
}

}  // namespace

// carry [G, n_carry] int16, block [G, n] int16, cols [i_rep, p] int16,
// oj [i_rep] int32 -> out [G, m * i_rep], f32 for out_mode 0, int16 Q.14
// for out_mode 1; span = max(oj) + p
extern "C" int tsl_frame_resample(const void* carry, const void* block,
                                  const void* cols, const void* oj,
                                  void* out, int m, int i_rep, int d_rep,
                                  int p, int span, int n_carry, long long n,
                                  int groups, int out_mode, void* stream) {
  if (m <= 0 || i_rep <= 0 || d_rep <= 0 || p <= 0 || span < p ||
      n_carry < 0 || n < 0 || groups <= 0 || groups > 65535 ||
      (out_mode != 0 && out_mode != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (out_mode == 1) {
    return launch<true>(carry, block, cols, oj, out, m, i_rep, d_rep, p,
                        span, n_carry, n, groups, (cudaStream_t)stream);
  }
  return launch<false>(carry, block, cols, oj, out, m, i_rep, d_rep, p, span,
                       n_carry, n, groups, (cudaStream_t)stream);
}
