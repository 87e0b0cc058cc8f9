// K3: packed-row rational resampler, all channels of one ratio group.
//
// Replaces the TPU kernel tsl_sdr_tpu/ops/pallas_resampler.py
// _row_kernel_v2 + _row_call_v2, and stands in for the XLA int16 product
// the JAX pipeline runs for the same function
// (tsl_sdr_tpu/ops/polyphase.py:304-345, vmapped over a ratio group at
// models/pipeline.py:192-202).
//
// What it computes: per channel g the stream T = carry (n_carry samples)
// ++ block (n samples); output row m of the channel holds
//     acc[g, m, j] = sum_{k < K} T[m*row_in + k] * W[k, j]
// summed in wrapping int32, where W = [w0; w1] is the row's taps followed by
// the spill's (the next row's first sp samples), zero-padded to K = k_pad, a
// multiple of 32 (samples past the stream's end are zero). Two epilogues:
// f32(acc) / 16384 (the fast tier) or int16 round_q28_q14(acc) = (acc >> 14)
// + ((acc >> 13) & 1), wrapped to int16 (the exact tier, bit-identical to
// the reference's filter/utils.c:89-112; a float cannot carry it, as |acc|
// exceeds 2^24).
//
// What bounds it on the H100: at the 8-channel pager width (5/12 ratio:
// row_in 1536, k_row 640, spill 77 -> K 1632, 85 rows per block, 2 FLEX
// channels) one call is 178 M int16 multiply-adds (0.72 us at the int8
// tensor-core peak with four byte products a multiply-add) over 0.5 MB of
// input, 2.1 MB of split taps and 0.35 MB of output (0.88 us at 3.35
// TB/s): bytes, narrowly. At the decoder's steps (3 rows at 192/125, 8 at
// 16/25) the work is ~0.4 M multiply-adds and launch latency rules.
//
// How the design responds: the products run on the int8 tensor cores by
// the exact split of imma_split.cuh (mma.sync m16n8k32, three accumulator
// sets, uint32 recombination). The channels' rows form one row space
// (row R = g*m + m'); a block of 8 warps owns 16 rows and 32 columns (4 n8
// tiles: 240 blocks at the pager width, 12 and 4 at the decoder's steps);
// its warps split K eight ways, each recombines its partial sums, and the
// partials are added in shared memory (integer addition mod 2^32 is
// associative, so the sum is exact in any order). (Blocks of 32 or 64
// rows, which read each tap tile once for more rows, measured slower at
// every one of these shapes.) Each block stages its rows' input once (K
// up to 2048 in one pass), split into high/low byte planes
// with a row pitch of K + 16 bytes (so ldmatrix's 8 rows hit distinct
// banks). A warp stages a row at a time, its lanes on consecutive 4-sample
// quads (coalesced; 8-, 4- or 2-byte loads as the row's start in the block
// allows: the carry is 77 samples at the pager width, 35 and 50 at the
// decoder's), 4 quads a lane in flight, each stored as one word of high
// bytes and one of low bytes; only the carry and the stream's end go
// sample by sample. Each warp takes a contiguous run of k-steps and loads
// the next step's tap fragments (fragment-ordered planes in device memory,
// one coalesced 256-byte load a tile) while the current step multiplies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "imma_split.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;               // staged loads in flight a lane
constexpr int kNtW = 4;                 // n8 tiles per block (32 columns)
constexpr int kKcMax = 2048;            // K staged at a time
constexpr int kRedBytes = kWarps * kNtW * 4 * 32 * 4;
constexpr int kMaxDevices = 64;         // devices with a cached smem limit

// staged K per pass; pitch kc + 16 bytes: kc % 32 == 0 makes pitch / 4 an
// odd multiple of 4 words, so ldmatrix's 8 rows hit distinct banks
__host__ __device__ int stage_k(int k_pad) { return min(k_pad, kKcMax); }

__host__ __device__ int smem_bytes(int kc) {
  return 2 * 16 * (kc + 16) + kRedBytes;
}

// 4 samples T[n_carry + b .. + 4) of a channel (b in the block's
// coordinates; negative b reads the carry), packed as int16 pairs. align:
// 2 when the row's start allows 8-byte loads of the block, 1 for 4-byte
// loads, 0 for 2-byte loads. The carry and the stream's end (zeros past it
// and for rows past the last) go sample by sample.
__device__ __forceinline__ uint2 fetch4_edge(const int16_t* cg,
                                          const int16_t* bg, int n_carry,
                                          long long n, long long b,
                                          bool valid) {
  unsigned h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long bi = b + i;
    int16_t x = 0;
    if (valid && bi < 0 && bi >= -n_carry) {
      x = __ldg(cg + n_carry + bi);
    } else if (valid && bi >= 0 && bi < n) {
      x = __ldg(bg + bi);
    }
    h[i] = (unsigned short)x;
  }
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

__device__ __forceinline__ uint2 fetch4(const int16_t* cg, const int16_t* bg,
                                        int n_carry, long long n, long long b,
                                        bool valid, int align) {
  if (valid && b >= 0 && b + 4 <= n) {
    if (align == 2) return __ldg(reinterpret_cast<const uint2*>(bg + b));
    if (align == 1) {
      const unsigned* p = reinterpret_cast<const unsigned*>(bg + b);
      return make_uint2(__ldg(p), __ldg(p + 1));
    }
    const unsigned short* p = reinterpret_cast<const unsigned short*>(bg + b);
    return make_uint2(__ldg(p) | ((unsigned)__ldg(p + 1) << 16),
                      __ldg(p + 2) | ((unsigned)__ldg(p + 3) << 16));
  }
  return fetch4_edge(cg, bg, n_carry, n, b, valid);
}

__device__ __forceinline__ void load_b(uint2 (&bh)[kNtW], uint2 (&bl)[kNtW],
                                       const uint2* w_hi, const uint2* w_lo,
                                       size_t kt, int n_tiles, int nt0,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < kNtW; ++j) {
    const size_t f = (kt * n_tiles + nt0 + j) * 32 + lane;
    bh[j] = __ldg(w_hi + f);
    bl[j] = __ldg(w_lo + f);
  }
}

// grid = (ceil(G*m / 16), k_row / (8*kNtW)); block = kThreads
template <bool kQ14>
__global__ void __launch_bounds__(kThreads)
row_resample_kernel(const int16_t* __restrict__ carry,
                    const int16_t* __restrict__ block,
                    const uint2* __restrict__ w_hi,
                    const uint2* __restrict__ w_lo,
                    void* __restrict__ out,
                    int m, int groups, int row_in, int k_row, int k_pad,
                    int n_carry, long long n, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rows_blk = 16;
  const int kc_max = stage_k(k_pad);
  const int pitch = kc_max + 16;
  uint8_t* a_hi = smem;
  uint8_t* a_lo = smem + rows_blk * pitch;
  unsigned* red = reinterpret_cast<unsigned*>(smem + 2 * rows_blk * pitch);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_blk;       // first row of the row space
  const int nt0 = blockIdx.y * kNtW;
  const int n_tiles = k_row / 8;
  const int rows_total = groups * m;

  imma::Acc acc[kNtW];
#pragma unroll
  for (int j = 0; j < kNtW; ++j) imma::zero(acc[j]);

  for (int k0 = 0; k0 < k_pad; k0 += kc_max) {
    const int kc = min(kc_max, k_pad - k0);     // a multiple of 32
    // a warp stages a row at a time: lane l takes samples 4q .. 4q+3 for
    // q = l, l + 32, ..., kBatch of them in flight before it stores any,
    // as one word of high bytes and one of low bytes
    const int quads = kc / 4;
    for (int lr = warp; lr < rows_blk; lr += kWarps) {
      const int r = r0 + lr;
      const bool valid = r < rows_total;
      const int g = valid ? r / m : 0;
      const long long kb =
          (long long)(valid ? r - g * m : 0) * row_in + k0 - n_carry;
      const int align = (kb & 3) == 0 && (vec & 2) ? 2
                        : (kb & 1) == 0 && (vec & 1) ? 1 : 0;
      const int16_t* cg = carry + (size_t)g * n_carry;
      const int16_t* bg = block + (size_t)g * n;
      unsigned* hrow = reinterpret_cast<unsigned*>(a_hi + lr * pitch);
      unsigned* lrow = reinterpret_cast<unsigned*>(a_lo + lr * pitch);
      for (int q0 = lane; q0 < quads; q0 += 32 * kBatch) {
        uint2 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + 32 * u;
          v[u] = q < quads ? fetch4(cg, bg, n_carry, n, kb + 4LL * q, valid,
                                    align)
                           : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + 32 * u;
          if (q < quads) {
            hrow[q] = __byte_perm(v[u].x, v[u].y, 0x7531);
            lrow[q] = __byte_perm(v[u].x, v[u].y, 0x6420);
          }
        }
      }
    }
    __syncthreads();
    // this warp's contiguous share of the pass's k-steps; the next step's
    // tap fragments load while the current one multiplies
    const int nks = kc / 32;
    const int per = (nks + kWarps - 1) / kWarps;
    const int ks_lo = warp * per, ks_hi = min(nks, ks_lo + per);
    uint2 bh[kNtW], bl[kNtW];
    if (ks_lo < ks_hi) {
      load_b(bh, bl, w_hi, w_lo, (size_t)(k0 / 32 + ks_lo), n_tiles, nt0,
             lane);
    }
    for (int ks = ks_lo; ks < ks_hi; ++ks) {
      uint2 nh[kNtW], nl[kNtW];
      if (ks + 1 < ks_hi) {
        load_b(nh, nl, w_hi, w_lo, (size_t)(k0 / 32 + ks + 1), n_tiles,
               nt0, lane);
      }
      uint32_t ah[4], al[4];
      imma::load_a(ah, a_hi, pitch, 0, 32 * ks);
      imma::load_a(al, a_lo, pitch, 0, 32 * ks);
#pragma unroll
      for (int j = 0; j < kNtW; ++j) {
        imma::mma_split(acc[j], ah, al, bh[j], bl[j]);
        bh[j] = nh[j];
        bl[j] = nl[j];
      }
    }
    __syncthreads();
  }

  // each warp's partial, recombined; then the K-split partials summed
#pragma unroll
  for (int j = 0; j < kNtW; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[((warp * kNtW + j) * 4 + i) * 32 + lane] = imma::combine(acc[j], i);
    }
  }
  __syncthreads();
  // every thread sums and writes some of the block's 16 x 32 outputs,
  // indexed as the partials are: (n8 tile, element, lane)
  for (int e = threadIdx.x; e < kNtW * 4 * 32; e += kThreads) {
    const int ln = e & 31, i = (e >> 5) & 3, j = e >> 7;
    unsigned a = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[((w * kNtW + j) * 4 + i) * 32 + ln];
    }
    const int r = r0 + (ln >> 2) + (i >> 1) * 8;
    const int col = (nt0 + j) * 8 + (ln & 3) * 2 + (i & 1);
    if (r < rows_total) {
      const size_t o = (size_t)r * k_row + col;
      const int sum = (int)a;
      if (kQ14) {
        ((int16_t*)out)[o] = (int16_t)((sum >> 14) + ((sum >> 13) & 1));
      } else {
        ((float*)out)[o] = __int2float_rn(sum) * (1.0f / 16384.0f);
      }
    }
  }
}

template <bool kQ14>
int launch(const void* carry, const void* block, const void* w_hi,
           const void* w_lo, void* out, int m, int row_in, int k_row,
           int k_pad, int n_carry, long long n, int groups, cudaStream_t st) {
  const int rows_total = groups * m;
  const int n_chunks = k_row / (8 * kNtW);
  // block loads a row's staging may use: bit 1 8-byte, bit 0 4-byte
  const int vec = ((groups == 1 || n % 4 == 0) && (uintptr_t)block % 8 == 0
                   ? 2 : 0) |
                  ((groups == 1 || n % 2 == 0) && (uintptr_t)block % 4 == 0
                   ? 1 : 0);
  const int smem = smem_bytes(stage_k(k_pad));
  // raise the kernel's shared-memory ceiling once per device (the
  // attribute applies to the current device only), not on every launch
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(row_resample_kernel<kQ14>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  const dim3 grid((rows_total + 15) / 16, n_chunks);
  row_resample_kernel<kQ14><<<grid, kThreads, smem, st>>>(
      (const int16_t*)carry, (const int16_t*)block, (const uint2*)w_hi,
      (const uint2*)w_lo, out, m, groups, row_in, k_row, k_pad, n_carry, n,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// carry [G, n_carry] int16, block [G, n] int16, w_hi/w_lo the split taps
// [k_pad/32, k_row/8, 32, 8] bytes (ops/imma_split.py fragment_planes of
// [w0; w1] padded to k_pad rows) -> out [G, m, k_row], f32 for out_mode 0,
// int16 Q.14 for out_mode 1. Needs k_row % 32 == 0, k_pad % 32 == 0,
// k_pad <= 32768 and m * row_in <= n.
extern "C" int tsl_row_resample(const void* carry, const void* block,
                                const void* w_hi, const void* w_lo, void* out,
                                int m, int row_in, int k_row, int k_pad,
                                int n_carry, long long n, int groups,
                                int out_mode, void* stream) {
  if (m <= 0 || row_in <= 0 || k_row <= 0 || k_row % 32 || k_pad <= 0 ||
      k_pad % 32 || k_pad > 32768 || n_carry < 0 || n < (long long)m * row_in
      || groups <= 0 || (long long)groups * m > (1LL << 30) ||
      (out_mode != 0 && out_mode != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_mode == 1) {
    return launch<true>(carry, block, w_hi, w_lo, out, m, row_in, k_row,
                        k_pad, n_carry, n, groups, st);
  }
  return launch<false>(carry, block, w_hi, w_lo, out, m, row_in, k_row,
                       k_pad, n_carry, n, groups, st);
}
