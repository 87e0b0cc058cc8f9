// K1: fused packed channelizer + FM discriminator, one block of rows; and
// K5, the exact packed FIR: the same main loop with integer epilogues.
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
// What bounds it on the H100: operations. At the 8-channel pager width
// (ROW=128, U=1218, HC=16) a 4,177,920-sample block is 65,280 rows x 1,218
// x 32 = 2.54 G int16 multiply-adds against 10.4 MB of input and output:
// 10.3 us at the int8 tensor-core peak with four byte products a
// multiply-add, 3.1 us of memory. On the CUDA cores (int32 IMAD: 132 SMs
// x 64 lanes x ~1.98 GHz) it cannot beat ~150 us.
//
// How the design responds: the FIR runs on the int8 tensor cores by the
// exact split of imma_split.cuh. It is a Toeplitz product: with X the
// tile's staged stream as a plain [rows, ROW] matrix, the A operand at
// output row r and tap u = ROW*q + v is X[r + q, v], so
//     acc[r0:r0+16, :] = sum_q X[r0+q : r0+q+16, :] @ W[ROW*q : ROW*q+ROW, :]
// (the TPU kernel's shifted dots) is a run of 16x32 A tiles read by
// ldmatrix from one staged matrix at row offsets q, never expanded. Each
// tile stages its rows [r0 - 1, r0 + TR + cr) once, split into high/low
// byte planes with 16-byte loads, at a row pitch of ROW + 16 bytes (at a
// multiple of 128 bytes ldmatrix's 8 rows would share 4 banks). The split
// taps (fragment order, U rounded up to 32) are staged in shared memory
// too when they fit (80 KB at the pager width), else read from L2. A warp
// owns two 16-row m-tiles and up to 4 n8 tiles, so each B fragment feeds
// 8 IMMA products. TR + 1 (the tile's rows and its look-back row) is a
// multiple of 16 (32 where shared memory allows: at decimation 50 a row is
// 3,200 values and only 16 rows fit); each tile recomputes its own
// look-back row for the FM history of its first row, so tiles run in any
// order.
//
// K5 (template mode kQ14 / kRaw) replaces the bit-exact tier's device
// stage, tsl_sdr_tpu/ops/packed_fir.py packed_fir_step_exact (an XLA int16 x
// int16 -> int32 jnp.dot; torch's CUDA matmul takes no int16 operands). It
// runs K1's staging and IMMA main loop unchanged, so its int32 sums are
// K1's bit for bit, and writes them from the fragments straight to device
// memory: kQ14 as the reference's Q.28 -> Q.14 rounding (a >> 14) + ((a >>
// 13) & 1), narrowed mod 2^16, into two int16 planes [re | im] of [rows,
// HC]; kRaw as the int32 sums [rows, 2*HC] (the fast tier's debug tap). Its
// bound is K1's (operations); the look-back row each tile recomputes is
// wasted work here, kept so that both kernels share one tiling.
//
// Numerics: every float operation of the FM stage is written with an
// explicit round-to-nearest intrinsic (no FMA contraction) in the order of
// the plain torch version (tsl_sdr_tpu_torch/ops/fm.py), and the divides
// are IEEE divides, so the kernel and the plain version agree bit for bit
// whenever their int32 accumulators do (always: integer sums are exact).

#include <cuda_runtime.h>
#include <stdint.h>

#include "imma_split.cuh"

namespace {

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

constexpr int kPitchPad = 16;   // bytes past ROW per staged row
constexpr int kNtG = 4;         // n8 tiles a warp owns at a time
constexpr int kBatch = 4;       // staging loads a thread keeps in flight
constexpr int kSmemCap = 227 * 1024;

// staged stream rows: high and low byte planes
__host__ __device__ size_t x_bytes(int tr, int row, int cr) {
  return 2 * (size_t)(tr + 1 + cr) * (row + kPitchPad);
}

__host__ __device__ size_t acc_bytes(int tr, int hc) {
  return 2 * (size_t)(tr + 1) * hc * sizeof(float);
}

// both split tap planes: ksteps x n_tiles tiles of 256 bytes each
__host__ __device__ size_t tap_bytes(int u_len, int hc) {
  return 2 * (size_t)((u_len + 31) / 32) * ((2 * hc + 7) / 8) * 256;
}

// epilogues: K1's FM discriminator, K5's rounded planes, K5's raw sums
constexpr int kFm = 0;
constexpr int kQ14 = 1;
constexpr int kRaw = 2;

// grid.x = ceil(rows / tr); tile t owns output rows [t*tr, t*tr + tr) and
// recomputes the accumulators of row t*tr - 1 (the look-back row) for the
// FM history of its first row. stage_taps: copy the tap planes to shared
// memory (else they are read from device memory through L2). out: kFm
// int16 [rows, hc]; kQ14 int16 [2, rows, hc]; kRaw int32 [rows, 2*hc].
template <int kMode>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const int16_t* __restrict__ carry,
             const int16_t* __restrict__ block,
             const uint2* __restrict__ w_hi,
             const uint2* __restrict__ w_lo,
             const float* __restrict__ omega,
             const float* __restrict__ prev,
             void* __restrict__ out,
             float* __restrict__ prev_out,
             int rows, int row, int cr, int u_len, int hc, int nr_ch,
             int tr, int stage_taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = row + kPitchPad;
  const int x_rows = tr + 1 + cr;
  uint8_t* x_hi = smem;
  uint8_t* x_lo = smem + (size_t)x_rows * pitch;
  float* acc_re = reinterpret_cast<float*>(smem + x_bytes(tr, row, cr));
  float* acc_im = acc_re + (size_t)(tr + 1) * hc;
  const int ksteps = (u_len + 31) / 32;
  const int n_tiles = (2 * hc + 7) / 8;
  const uint2* b_hi = w_hi;
  const uint2* b_lo = w_lo;

  const int r0 = blockIdx.x * tr;
  const int n_out = min(tr, rows - r0);
  // stage stream rows [r0 - 1, r0 + tr + cr): row -1 and rows past the
  // stream's end read as zeros (they feed only discarded outputs)
  const long long carry_vals = (long long)cr * row;
  const long long total = carry_vals + (long long)rows * row;
  const long long base = (long long)(r0 - 1) * row;
  // kBatch 16-byte loads a thread in flight before any is stored
  const int per_row = row / 8;
  const int n_x = x_rows * per_row;
  for (int i0 = threadIdx.x; i0 < n_x; i0 += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long s = base + 8LL * (i0 + u * kThreads);
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i0 + u * kThreads < n_x && s >= 0 && s < total) {
        v[u] = s < carry_vals
            ? __ldg(reinterpret_cast<const uint4*>(carry + s))
            : __ldg(reinterpret_cast<const uint4*>(block + (s - carry_vals)));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_x) {
        uint2 hi, lo;
        imma::split8(v[u], hi, lo);
        const size_t o = (size_t)(i / per_row) * pitch + 8 * (i % per_row);
        *reinterpret_cast<uint2*>(x_hi + o) = hi;
        *reinterpret_cast<uint2*>(x_lo + o) = lo;
      }
    }
  }
  if (stage_taps) {
    uint4* t_hi = reinterpret_cast<uint4*>(
        smem + x_bytes(tr, row, cr) + acc_bytes(tr, hc));
    const int n16 = ksteps * n_tiles * 16;   // 16-byte words per plane
    uint4* t_lo = t_hi + n16;
    const uint4* g_hi = reinterpret_cast<const uint4*>(w_hi);
    const uint4* g_lo = reinterpret_cast<const uint4*>(w_lo);
    for (int i0 = threadIdx.x; i0 < n16; i0 += kThreads * kBatch) {
      uint4 h[kBatch], l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = min(i0 + u * kThreads, n16 - 1);
        h[u] = __ldg(g_hi + i);
        l[u] = __ldg(g_lo + i);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n16) {
          t_hi[i] = h[u];
          t_lo[i] = l[u];
        }
      }
    }
    b_hi = reinterpret_cast<const uint2*>(t_hi);
    b_lo = reinterpret_cast<const uint2*>(t_lo);
  }
  __syncthreads();

  // accumulators of local rows 0..tr (local row 0 = stream output r0 - 1):
  // work items are (pair of 16-row m-tiles, group of kNtG n8 tiles); the
  // last pair has one m-tile when (tr + 1) / 16 is odd
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pairs = (tr + 1 + 16) / 32;
  const int n_groups = (n_tiles + kNtG - 1) / kNtG;
  const int ks_per_row = row / 32;
  for (int item = warp; item < n_pairs * n_groups; item += kThreads / 32) {
    const int lr0 = (item / n_groups) * 32;
    const bool two = lr0 + 16 < tr + 1;
    const int lr1 = two ? lr0 + 16 : lr0;   // a repeat of tile 0 if absent
    const int nt0 = (item % n_groups) * kNtG;
    imma::Acc acc[2][kNtG];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kNtG; ++j) imma::zero(acc[h][j]);
    }
    int ks = 0;
    for (int q = 0; q <= cr && ks < ksteps; ++q) {
      for (int kk = 0; kk < ks_per_row && ks < ksteps; ++kk, ++ks) {
        uint32_t ah0[4], al0[4], ah1[4], al1[4];
        imma::load_a(ah0, x_hi, pitch, lr0 + q, 32 * kk);
        imma::load_a(al0, x_lo, pitch, lr0 + q, 32 * kk);
        imma::load_a(ah1, x_hi, pitch, lr1 + q, 32 * kk);
        imma::load_a(al1, x_lo, pitch, lr1 + q, 32 * kk);
#pragma unroll
        for (int j = 0; j < kNtG; ++j) {
          if (nt0 + j < n_tiles) {
            const size_t f = ((size_t)ks * n_tiles + nt0 + j) * 32 + lane;
            const uint2 bh = b_hi[f], bl = b_lo[f];
            imma::mma_split(acc[0][j], ah0, al0, bh, bl);
            imma::mma_split(acc[1][j], ah1, al1, bh, bl);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < kNtG; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = lr0 + 16 * h + (lane >> 2) + (i >> 1) * 8;
          const int c = (nt0 + j) * 8 + (lane & 3) * 2 + (i & 1);
          const int sum = (int)imma::combine(acc[h][j], i);
          if constexpr (kMode == kFm) {
            const float f = __int2float_rn(sum);
            if (c < hc) {
              acc_re[lr * hc + c] = f;
            } else if (c < 2 * hc) {
              acc_im[lr * hc + c - hc] = f;
            }
          } else {
            // K5: output row r0 + lr - 1; the look-back row is dropped
            if (lr >= 1 && lr <= n_out && c < 2 * hc) {
              const size_t r = (size_t)(r0 + lr - 1);
              if constexpr (kMode == kRaw) {
                static_cast<int*>(out)[r * 2 * hc + c] = sum;
              } else {
                const size_t plane = c < hc ? 0 : (size_t)rows * hc;
                static_cast<int16_t*>(out)[plane + r * hc + c % hc] =
                    (int16_t)((sum >> 14) + ((sum >> 13) & 1));
              }
            }
          }
        }
      }
    }
  }
  if constexpr (kMode != kFm) return;
  __syncthreads();

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
    static_cast<int16_t*>(out)[(size_t)(r0 + lr - 1) * hc + col] =
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

// raise the kernel's shared-memory ceiling once per device (the attribute
// applies to the current device only), not on every launch; then launch
template <int kMode>
int launch(const void* carry, const void* block, const void* w_hi,
           const void* w_lo, const void* omega, const void* prev, void* out,
           void* prev_out, int rows, int row, int cr, int u_len, int hc,
           int nr_ch, int tr, cudaStream_t stream) {
  if (rows <= 0 || tr <= 0 || (tr + 1) % 16 || row <= 0 || row % 32 ||
      u_len <= 0 || u_len > (cr + 1) * row || u_len > 32768 || nr_ch > hc ||
      (uintptr_t)carry % 16 || (uintptr_t)block % 16) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = x_bytes(tr, row, cr) + acc_bytes(tr, hc);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  const int stage_taps = smem + tap_bytes(u_len, hc) <= kSmemCap ? 1 : 0;
  if (stage_taps) smem += tap_bytes(u_len, hc);
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || (int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(chain_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = (int)smem;
  }
  const int grid = (rows + tr - 1) / tr;
  chain_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      (const int16_t*)carry, (const int16_t*)block, (const uint2*)w_hi,
      (const uint2*)w_lo, (const float*)omega, (const float*)prev, out,
      (float*)prev_out, rows, row, cr, u_len, hc, nr_ch, tr, stage_taps);
  return (int)cudaGetLastError();
}

}  // namespace

// carry [cr*row] int16, block [rows*row] int16, w_hi/w_lo the split taps
// [ceil(u_len/32), ceil(2*hc/8), 32, 8] bytes (ops/imma_split.py
// fragment_planes of the [u_len, 2*hc] tap matrix), omega [hc] f32, prev
// [2, nr_ch] f32 -> out [rows, hc] int16, prev_out [2, nr_ch] f32. Needs
// (tr + 1) % 16 == 0, row % 32 == 0, u_len <= min((cr + 1) * row, 32768)
// and 16-byte aligned carry/block pointers.
extern "C" int tsl_chain_fm(const void* carry, const void* block,
                            const void* w_hi, const void* w_lo,
                            const void* omega, const void* prev, void* out,
                            void* prev_out, int rows, int row, int cr,
                            int u_len, int hc, int nr_ch, int tr,
                            void* stream) {
  return launch<kFm>(carry, block, w_hi, w_lo, omega, prev, out, prev_out,
                     rows, row, cr, u_len, hc, nr_ch, tr,
                     (cudaStream_t)stream);
}

// K5: the same operands without the FM stage -> out_mode 1: int16 [2, rows,
// hc] (a_re plane, then a_im), the Q.28 -> Q.14 rounded sums; out_mode 2:
// int32 [rows, 2*hc], the sums themselves. Same requirements as
// tsl_chain_fm.
extern "C" int tsl_exact_fir(const void* carry, const void* block,
                             const void* w_hi, const void* w_lo, void* out,
                             int rows, int row, int cr, int u_len, int hc,
                             int tr, int out_mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_mode == kQ14) {
    return launch<kQ14>(carry, block, w_hi, w_lo, nullptr, nullptr, out,
                        nullptr, rows, row, cr, u_len, hc, 0, tr, st);
  }
  if (out_mode == kRaw) {
    return launch<kRaw>(carry, block, w_hi, w_lo, nullptr, nullptr, out,
                        nullptr, rows, row, cr, u_len, hc, 0, tr, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tsl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
