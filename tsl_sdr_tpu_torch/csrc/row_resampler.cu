// K3: packed-row rational resampler, all channels of one ratio group.
//
// Replaces the TPU kernel tsl_sdr_tpu/ops/pallas_resampler.py
// _row_kernel_v2 + _row_call_v2, and stands in for the XLA int16 product
// the JAX pipeline runs for the same function
// (tsl_sdr_tpu/ops/polyphase.py:304-345, vmapped over a ratio group at
// models/pipeline.py:192-202).
//
// What it computes: per channel g the stream T = carry (n_carry samples)
// ++ block (n samples) cut into rows of ROW_IN; output row m holds
//     acc[g, m, j] = sum_{k < ROW_IN} T[m*ROW_IN + k] * w0[k, j]
//                  + sum_{k < sp} T[(m+1)*ROW_IN + k] * w1[k, j]
// summed in wrapping int32 (samples past the stream's end are zero, and so
// are the spill taps past the filter span). Two epilogues: f32(acc) / 16384
// (the fast tier) or int16 round_q28_q14(acc) = (acc >> 14) +
// ((acc >> 13) & 1), wrapped to int16 (the exact tier, bit-identical to
// the reference's filter/utils.c:89-112; a float cannot carry it, as |acc|
// exceeds 2^24).
//
// What bounds it on the H100: integer issue, and launch latency at the
// pipeline's size. At the 8-channel pager width (5/12 ratio: ROW_IN=1536,
// K_ROW=640, sp=128, 85 rows per block, 2 FLEX channels) one block is
// 85 x 1,664 x 640 x 2 = 181 M int32 multiply-adds over 0.5 MB of input,
// far above the card's bytes-per-operation balance; the tensor cores take
// no int16 operands. How the design responds: one launch per ratio group
// covers every row, column and channel (grid = row tiles x column tiles x
// channels) in place of a per-channel loop; each block stages MT rows of
// input, KC samples at a time, in shared memory, and each thread keeps MT
// exact int32 accumulators for its column, so one tap load (coalesced
// across the warp, read through L1) feeds MT multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMt = 8;          // output rows per block
constexpr int kCols = 128;      // output columns per block (one per thread)
constexpr int kKc = 512;        // input samples per row staged at a time

// stage xs[mi][kk] = T[(m0 + mi + roff) * row_in + k0 + kk]
__device__ __forceinline__ void stage(int16_t (*xs)[kKc],
                                      const int16_t* carry,
                                      const int16_t* block, int n_carry,
                                      long long n, int row_in, int m0,
                                      int roff, int k0, int kc) {
  for (int i = threadIdx.x; i < kMt * kc; i += blockDim.x) {
    const int mi = i / kc, kk = i % kc;
    const long long t = (long long)(m0 + mi + roff) * row_in + k0 + kk;
    int16_t v = 0;
    if (t < n_carry) {
      v = carry[t];
    } else if (t - n_carry < n) {
      v = block[t - n_carry];
    }
    xs[mi][kk] = v;
  }
}

__device__ __forceinline__ void accumulate(unsigned (&acc)[kMt],
                                           int16_t (*xs)[kKc],
                                           const int16_t* w, int k_row,
                                           int k0, int kc, int j) {
  for (int kk = 0; kk < kc; ++kk) {
    const int wv = __ldg(w + (size_t)(k0 + kk) * k_row + j);
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi) {
      acc[mi] += (unsigned)((int)xs[mi][kk] * wv);   // int32 wrap
    }
  }
}

// grid = (ceil(m / kMt), ceil(k_row / kCols), G), block = kCols threads;
// out is float (kQ14 false) or int16_t (kQ14 true)
template <bool kQ14>
__global__ void __launch_bounds__(kCols)
row_resample_kernel(const int16_t* __restrict__ carry,
                    const int16_t* __restrict__ block,
                    const int16_t* __restrict__ w0,
                    const int16_t* __restrict__ w1,
                    void* __restrict__ out,
                    int m, int row_in, int k_row, int sp, int n_carry,
                    long long n) {
  __shared__ __align__(16) int16_t xs[kMt][kKc];
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kMt;
  const int j = blockIdx.y * kCols + threadIdx.x;
  const int16_t* cg = carry + (size_t)g * n_carry;
  const int16_t* bg = block + (size_t)g * n;
  const int jc = j < k_row ? j : k_row - 1;   // clamp loads, mask stores

  unsigned acc[kMt];
#pragma unroll
  for (int mi = 0; mi < kMt; ++mi) acc[mi] = 0u;
  for (int k0 = 0; k0 < row_in; k0 += kKc) {
    const int kc = min(kKc, row_in - k0);
    stage(xs, cg, bg, n_carry, n, row_in, m0, 0, k0, kc);
    __syncthreads();
    accumulate(acc, xs, w0, k_row, k0, kc, jc);
    __syncthreads();
  }
  for (int k0 = 0; k0 < sp; k0 += kKc) {
    const int kc = min(kKc, sp - k0);
    stage(xs, cg, bg, n_carry, n, row_in, m0, 1, k0, kc);
    __syncthreads();
    accumulate(acc, xs, w1, k_row, k0, kc, jc);
    __syncthreads();
  }
  if (j >= k_row) return;
  const size_t base = (size_t)g * m * k_row;
#pragma unroll
  for (int mi = 0; mi < kMt; ++mi) {
    if (m0 + mi < m) {
      const size_t o = base + (size_t)(m0 + mi) * k_row + j;
      const int a = (int)acc[mi];
      if (kQ14) {
        ((int16_t*)out)[o] = (int16_t)((a >> 14) + ((a >> 13) & 1));
      } else {
        ((float*)out)[o] = __int2float_rn(a) * (1.0f / 16384.0f);
      }
    }
  }
}

}  // namespace

// carry [G, n_carry] int16, block [G, n] int16, w0 [row_in, k_row] int16,
// w1 [sp, k_row] int16 (unused when sp == 0) -> out [G, m, k_row], f32
// for out_mode 0, int16 Q.14 for out_mode 1
extern "C" int tsl_row_resample(const void* carry, const void* block,
                                const void* w0, const void* w1, void* out,
                                int m, int row_in, int k_row, int sp,
                                int n_carry, long long n, int groups,
                                int out_mode, void* stream) {
  if (m <= 0 || row_in <= 0 || k_row <= 0 || sp < 0 || sp > row_in ||
      n_carry < 0 || n < 0 || groups <= 0 || groups > 65535 ||
      (out_mode != 0 && out_mode != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((m + kMt - 1) / kMt, (k_row + kCols - 1) / kCols, groups);
  if (out_mode == 1) {
    row_resample_kernel<true><<<grid, kCols, 0, (cudaStream_t)stream>>>(
        (const int16_t*)carry, (const int16_t*)block, (const int16_t*)w0,
        (const int16_t*)w1, out, m, row_in, k_row, sp, n_carry, n);
  } else {
    row_resample_kernel<false><<<grid, kCols, 0, (cudaStream_t)stream>>>(
        (const int16_t*)carry, (const int16_t*)block, (const int16_t*)w0,
        (const int16_t*)w1, out, m, row_in, k_row, sp, n_carry, n);
  }
  return (int)cudaGetLastError();
}
