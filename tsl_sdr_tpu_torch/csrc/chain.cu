// K1: fused packed channelizer + FM discriminator, one block of rows.
//
// Replaces the TPU kernels in tsl_sdr_tpu/ops/pallas_chain.py:
// _chain_kernel_v2 + _chain_body + _chain_call_v2 (the zero-copy form) and
// _chain_kernel + _chain_call (the padded form for blocks that are not a
// whole number of tiles). Here one kernel covers both: the last tile is
// masked, and the stream carry and the block are read through two
// pointers, so nothing is concatenated or padded in device memory.
//
// What it computes (tsl_sdr_tpu/ops/packed_fir.py:335-403 and
// ops/fm.py:66-142): the stream S = carry (cr rows) ++ block (rows rows) of
// ROW int16 values per row; output row r has the int32 accumulators
//     acc[r, c] = sum_{u < U} S[r*ROW + u] * W[u, c]      c < 2*HC
// (columns [re | im], flat (k, ch) order inside each half), then per output
// (r, c < HC) the conjugate product with the previous sample of the same
// channel (flat index - C; the state prev[] for the first one), the
// polynomial atan2 of the TPU kernel, + omega, wrap to (-pi, pi], the
// zero-power guard and trunc(phi / pi * 16384).
//
// What bounds it on the H100: integer issue. At the 8-channel pager width
// (ROW=128, U=1218, HC=16) an output row costs 1,218 x 32 int32
// multiply-adds against 256 input bytes and 32 output bytes, two orders of
// magnitude above the card's bytes-per-operation balance, and the tensor
// cores take no int16 operands. How the design responds: the accumulation
// is exact int32 IMAD on the CUDA cores (the XLA tier's arithmetic, no
// float splitting); each tile stages its input rows once in shared memory
// with 16-byte loads; each thread keeps RPT rows of accumulators in
// registers so one tap load feeds RPT multiply-adds; the taps (80 KiB here,
// 224 KiB at 8 channels, 128 taps, decimate-by-40) are read through L1
// rather than staged, so any width fits.
//
// Numerics: every float operation of the FM stage is written with an
// explicit round-to-nearest intrinsic (no FMA contraction) in the order of
// the plain torch version (tsl_sdr_tpu_torch/ops/fm.py), and the divides
// are IEEE divides, so the kernel and the plain version agree bit for bit
// whenever their int32 accumulators do (always: integer sums are exact).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRpt = 8;        // output rows per thread
constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979f;       // == np.float32(np.pi)
constexpr float kHalfPi = 1.57079632679490f;   // == np.float32(np.pi / 2)

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ya = fabsf(y), xa = fabsf(x);
  const float hi = fmaxf(ya, xa);
  const float safe = hi == 0.0f ? 1.0f : hi;
  const float z = __fdiv_rn(fminf(ya, xa), safe);
  const float z2 = __fmul_rn(z, z);
  float p = -0.0117212f;
  p = __fadd_rn(__fmul_rn(p, z2), 0.05265332f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.11643287f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.19354346f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.33262348f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.99997726f);
  const float base = __fmul_rn(z, p);
  const float ax = x >= 0.0f ? (y >= 0.0f ? base : -base)
                             : (y >= 0.0f ? __fsub_rn(kPi, base)
                                          : __fsub_rn(base, kPi));
  const float ay = y >= 0.0f
      ? (x >= 0.0f ? __fsub_rn(kHalfPi, base) : __fadd_rn(kHalfPi, base))
      : (x >= 0.0f ? __fsub_rn(base, kHalfPi) : __fsub_rn(-base, kHalfPi));
  return xa > ya ? ax : ay;
}

__device__ __forceinline__ int16_t fm_pcm(float ar, float ai, float pr,
                                          float pi, float omega) {
  const float sre = __fadd_rn(__fmul_rn(ar, pr), __fmul_rn(ai, pi));
  const float sim = __fsub_rn(__fmul_rn(ai, pr), __fmul_rn(ar, pi));
  float phi = __fadd_rn(atan2_poly(sim, sre), omega);
  phi = phi > kPi ? __fsub_rn(phi, 2.0f * kPi) : phi;
  phi = phi <= -kPi ? __fadd_rn(phi, 2.0f * kPi) : phi;
  if (sre == 0.0f && sim == 0.0f) phi = 0.0f;
  return (int16_t)truncf(__fmul_rn(__fdiv_rn(phi, kPi), 16384.0f));
}

__host__ __device__ size_t x_bytes(int tr, int row, int cr) {
  return (((size_t)(tr + 1 + cr) * row * sizeof(int16_t)) + 15) & ~size_t(15);
}

__host__ __device__ size_t smem_bytes(int tr, int row, int cr, int hc) {
  return x_bytes(tr, row, cr) + 2 * (size_t)(tr + 1) * hc * sizeof(float);
}

// grid.x = ceil(rows / tr); tile t owns output rows [t*tr, t*tr + tr) and
// recomputes the accumulators of row t*tr - 1 (the look-back row) for the
// FM history of its first row.
__global__ void __launch_bounds__(kThreads)
chain_fm_kernel(const int16_t* __restrict__ carry,
                const int16_t* __restrict__ block,
                const int16_t* __restrict__ w,
                const float* __restrict__ omega,
                const float* __restrict__ prev,
                int16_t* __restrict__ out,
                float* __restrict__ prev_out,
                int rows, int row, int cr, int u_len, int hc, int nr_ch,
                int tr) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* xs = reinterpret_cast<int16_t*>(smem);
  float* acc_re = reinterpret_cast<float*>(smem + x_bytes(tr, row, cr));
  float* acc_im = acc_re + (size_t)(tr + 1) * hc;

  const int r0 = blockIdx.x * tr;
  // stage stream rows [r0 - 1, r0 + tr + cr): row -1 and rows past the
  // stream's end read as zeros (they feed only discarded outputs)
  const long long carry_vals = (long long)cr * row;
  const long long total = carry_vals + (long long)rows * row;
  const long long base = (long long)(r0 - 1) * row;
  const int n_vec = (tr + 1 + cr) * row / 8;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const long long s = base + 8LL * i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s >= 0 && s < total) {
      v = s < carry_vals
          ? *reinterpret_cast<const uint4*>(carry + s)
          : *reinterpret_cast<const uint4*>(block + (s - carry_vals));
    }
    reinterpret_cast<uint4*>(xs)[i] = v;
  }
  __syncthreads();

  // accumulators of local rows 0..tr (local row 0 = stream output r0 - 1)
  const int n_groups = (tr + 1) / kRpt;
  const int two_hc = 2 * hc;
  for (int item = threadIdx.x; item < n_groups * hc; item += blockDim.x) {
    const int col = item % hc;
    const int lr0 = (item / hc) * kRpt;
    const int16_t* xr = xs + (size_t)lr0 * row;
    const int16_t* wc = w + col;
    unsigned acc_r[kRpt], acc_i[kRpt];
#pragma unroll
    for (int k = 0; k < kRpt; ++k) acc_r[k] = acc_i[k] = 0u;
    for (int u = 0; u < u_len; ++u) {
      const int wr = __ldg(wc + (size_t)u * two_hc);
      const int wi = __ldg(wc + (size_t)u * two_hc + hc);
#pragma unroll
      for (int k = 0; k < kRpt; ++k) {
        const int xv = xr[k * row + u];
        acc_r[k] += (unsigned)(xv * wr);   // int32 wrap, as the reference
        acc_i[k] += (unsigned)(xv * wi);
      }
    }
#pragma unroll
    for (int k = 0; k < kRpt; ++k) {
      acc_re[(lr0 + k) * hc + col] = __int2float_rn((int)acc_r[k]);
      acc_im[(lr0 + k) * hc + col] = __int2float_rn((int)acc_i[k]);
    }
  }
  __syncthreads();

  const int n_out = min(tr, rows - r0);
  for (int item = threadIdx.x; item < n_out * hc; item += blockDim.x) {
    const int lr = 1 + item / hc;
    const int col = item % hc;
    float pr, pi;
    if (col >= nr_ch) {
      pr = acc_re[lr * hc + col - nr_ch];
      pi = acc_im[lr * hc + col - nr_ch];
    } else if (r0 + lr - 1 > 0) {
      pr = acc_re[(lr - 1) * hc + col + hc - nr_ch];
      pi = acc_im[(lr - 1) * hc + col + hc - nr_ch];
    } else {
      pr = prev[col];
      pi = prev[nr_ch + col];
    }
    out[(size_t)(r0 + lr - 1) * hc + col] =
        fm_pcm(acc_re[lr * hc + col], acc_im[lr * hc + col], pr, pi,
               omega[col]);
  }
  // the last output row's baseband seeds the next block's FM history
  if (r0 + n_out == rows) {
    for (int c = threadIdx.x; c < nr_ch; c += blockDim.x) {
      prev_out[c] = acc_re[n_out * hc + hc - nr_ch + c];
      prev_out[nr_ch + c] = acc_im[n_out * hc + hc - nr_ch + c];
    }
  }
}

}  // namespace

// carry [cr*row] int16, block [rows*row] int16, w [u_len, 2*hc] int16,
// omega [hc] f32, prev [2, nr_ch] f32 -> out [rows, hc] int16,
// prev_out [2, nr_ch] f32. Needs (tr + 1) % 8 == 0, row % 8 == 0,
// u_len <= (cr + 1) * row and 16-byte aligned carry/block pointers.
extern "C" int tsl_chain_fm(const void* carry, const void* block,
                            const void* w, const void* omega,
                            const void* prev, void* out, void* prev_out,
                            int rows, int row, int cr, int u_len, int hc,
                            int nr_ch, int tr, void* stream) {
  if (rows <= 0 || tr <= 0 || (tr + 1) % kRpt || row % 8 ||
      u_len > (cr + 1) * row || nr_ch > hc) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(tr, row, cr, hc);
  cudaError_t err = cudaFuncSetAttribute(
      chain_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (rows + tr - 1) / tr;
  chain_fm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int16_t*)carry, (const int16_t*)block, (const int16_t*)w,
      (const float*)omega, (const float*)prev, (int16_t*)out,
      (float*)prev_out, rows, row, cr, u_len, hc, nr_ch, tr);
  return (int)cudaGetLastError();
}

extern "C" const char* tsl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
