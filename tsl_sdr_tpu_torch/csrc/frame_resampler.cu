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
// samples) ++ block (n samples), zeros past its end, frame m gives
//     out[m, j] = sum_{k < S*D_rep} T[m*D_rep + k] * W[k, j],   j < I_rep
// summed in wrapping int32, with W the dense [S*D_rep, I_rep] frame matrix
// (each column holds its phase filter at its window offset), the product
// the TPU kernel runs. Two epilogues: f32(acc) / 16384 (the fast tier,
// equal to the XLA tier bit for bit) or int16 round_q28_q14(acc) (the
// exact tier).
//
// What bounds it on the H100: bytes. At 147/160 over 60 s of 48 kHz PCM
// (2.88 M samples, 5.76 MB in, 10.58 MB of f32 out: 4.9 us at 3.35 TB/s)
// the banded product the function needs is 2.6 M outputs x 36 taps; at the
// decimation-50 pipeline's 25/16 step (K 64, N 32) the products take a
// tenth of the bytes' time. At decoder-torch's one-channel step (41
// frames, one block) nothing bounds it but latency: the launch, one round
// trip to memory for the window, the block's dependent instructions with
// one warp to each scheduler, and the stores.
//
// How the design responds: the products run on the int8 tensor cores by
// the exact split of imma_split.cuh (mma.sync m16n8k32, three accumulator
// sets, uint32 recombination). A is a Hankel window, A[m, k] = T[m*D_rep +
// k], K = S*D_rep rounded up to 32 (W's padding rows are zero, so what A
// holds there does not count); B is W split at plan time into B-fragment
// tiles of 32x8 (ops/frame_resampler.py frame_taps), N = I_rep rounded up
// to 8. W is banded, so only the tiles that hold a non-zero tap are kept
// (44 of 190 at 147/160, all 8 at 25/16), with an index of them by
// (k-step, n8 tile); the products of the dropped tiles, all zero, are
// skipped. A block copies the kept tiles and the index into shared memory
// with cp.async while it stages TM frames of one channel, their window of
// (TM-1)*D_rep + K samples, once, as high and low byte planes: each thread
// takes 8-sample chunks, as 16-byte loads on the row's aligned grid
// (carries of 34 or 35 samples put frame starts anywhere) shifted into
// place by the window's uniform lead, so frame m's row starts at byte
// m*D_rep of the planes; only chunks in the carry or past the block's end
// go sample by sample, with predicated loads. When D_rep % 16 == 0 (16,
// 48, 160) those rows are 16-byte aligned and ldmatrix reads the A
// fragments, as in K1 (pitch D_rep); for other D_rep (1, 3, 5) each lane
// builds its 4-byte groups from two aligned 32-bit shared loads and a
// funnel shift (which would serve every D_rep, but takes 3-5 % more device
// time at 16 and 160: bench/torch_k4_lab.py). A warp takes units of one
// m16 tile by four n8 tiles and walks their k-steps in pairs over two
// register sets of tap fragments, each loaded from shared memory a step
// ahead (one set, copied forward a step at a time, made every step wait
// for the next one's loads). The wrapper picks TM and the warps
// (ops/frame_resampler.py launch_shape: TM at most 64, a block's units two
// rounds of its warps). The epilogue converts into a shared tile placed at
// the output's alignment, and the block writes its contiguous output span
// [m0*I_rep, (m0+TM)*I_rep) with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "imma_split.cuh"

namespace {

constexpr int kWarpsMax = 8;
constexpr int kBatch = 4;               // staged chunks a thread in flight
constexpr int kTmMax = 64;              // frames a block
constexpr int kNtW = 4;                 // n8 tiles of a warp's unit
constexpr int kSmemMax = 200 * 1024;
constexpr int kMaxDevices = 64;         // devices with a cached smem limit

// bytes of a staged window plane: TM frames' windows, plus the word the
// funnel path reads past a group, rounded to 16
__host__ __device__ inline int window_bytes(int tm, int d_rep, int k_pad) {
  return ((tm - 1) * d_rep + k_pad + 4 + 15) & ~15;
}

__host__ __device__ inline int index_bytes(int k_steps, int nw) {
  return (k_steps * nw * 8 + 15) & ~15;
}

inline size_t smem_bytes(int tm, int d_rep, int k_pad, int nw, int n_live,
                         int i_rep, int elem) {
  return 2 * (size_t)window_bytes(tm, d_rep, k_pad) + 512 * (size_t)n_live +
         index_bytes(k_pad / 32, nw) +
         (((size_t)tm * i_rep * elem + 16 + 15) & ~(size_t)15);
}

// a 2-byte load where `valid`, else 0, predicated rather than branched
// around: the loads of a chunk then go out together, not each after the
// last has returned
__device__ __forceinline__ unsigned ld16_if(const int16_t* p, bool valid) {
  unsigned short x;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n mov.u16 %0, 0;\n"
      " @q ld.global.nc.u16 %0, [%1];\n}\n"
      : "=h"(x) : "l"(p), "r"((unsigned)valid));
  return x;
}

// the 8 samples at block indexes [b, b + 8) of a channel, sample by
// sample: negative indexes read the carry (zeros before it), indexes at or
// past n read zeros. Only a block's first chunks (the carry) and last ones
// (the stream's end) take this path; past both, a chunk is zeros.
__device__ __forceinline__ uint4 load8_edge(const int16_t* cg,
                                            const int16_t* bg, int n_carry,
                                            long long n, long long b) {
  if (b >= n || b + 8 <= -n_carry) return make_uint4(0u, 0u, 0u, 0u);
  // here -n_carry - 8 < b < n: offsets within the chunk fit 32 bits
  const int r = (int)min(n - b, 8LL);   // samples [0, r) lie before n
  const int bn = b < 0 ? (int)b : 0;    // b, where the chunk starts early
  const int16_t* cb = cg + (n_carry + bn);
  const int16_t* pb = bg + b;
  unsigned h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool carry = bn + i < 0;
    h[i] = ld16_if(carry ? cb + i : pb + i,
                   carry ? bn + i >= -n_carry : i < r);
  }
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                    h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

__device__ __forceinline__ unsigned long long as64(uint2 v) {
  return ((unsigned long long)v.y << 32) | v.x;
}

// 4 bytes of a plane at any byte offset x: two aligned words, one funnel
// shift
__device__ __forceinline__ uint32_t word_at(const uint8_t* plane, int x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(plane) + (x >> 2);
  return __funnelshift_r(w[0], w[1], 8 * (x & 3));
}

// the A fragment of rows row0.. (byte pitch), bytes col0.., at any
// alignment: a0 row lane/4, bytes 4*(lane%4) + 0..3; a1 8 rows on; a2, a3
// the same 16 bytes on (the m16n8k32 .s8/.u8 A layout)
__device__ __forceinline__ void load_a_any(uint32_t (&a)[4],
                                           const uint8_t* plane, int pitch,
                                           int row0, int col0) {
  const int lane = threadIdx.x & 31;
  const int x = (row0 + (lane >> 2)) * pitch + col0 + 4 * (lane & 3);
  a[0] = word_at(plane, x);
  a[1] = word_at(plane, x + 8 * pitch);
  a[2] = word_at(plane, x + 16);
  a[3] = word_at(plane, x + 8 * pitch + 16);
}

// 16 or 8 bytes global -> shared, asynchronously (cp.async)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d), "l"(src));
}

// the tap fragments of k-step kt for n8 tiles nt0 .. nt0 + kNtW - 1 from
// the staged live tiles (zeros for tiles of W that are all zero); returns
// the tiles' live bits. idx holds, per (k-step, word of 32 n8 tiles), the
// word's live bits and the number of live tiles before it.
__device__ __forceinline__ unsigned load_b(uint2 (&bh)[kNtW],
                                          uint2 (&bl)[kNtW],
                                          const uint2* b_hi,
                                          const uint2* b_lo, const int* idx,
                                          int kt, int nw, int nt0,
                                          int lane) {
  const int* e = idx + 2 * (kt * nw + (nt0 >> 5));
  const unsigned word = (unsigned)e[0];
  const int sh = nt0 & 31;
  const unsigned live = word >> sh & ((1u << kNtW) - 1);
  int t = e[1] + __popc(word & ((1u << sh) - 1));
#pragma unroll
  for (int j = 0; j < kNtW; ++j) {
    if (live >> j & 1) {
      bh[j] = b_hi[32 * t + lane];
      bl[j] = b_lo[32 * t + lane];
      ++t;
    } else {
      bh[j] = bl[j] = make_uint2(0u, 0u);
    }
  }
  return live;
}

// grid = (ceil(m / tm), G); block = 32 * warps; out is float (kQ14 false)
// or int16_t (kQ14 true), [G, m * i_rep]; kLdm: d_rep % 16 == 0
template <bool kQ14, bool kLdm>
__global__ void __launch_bounds__(32 * kWarpsMax)
frame_resample_kernel(const int16_t* __restrict__ carry,
                      const int16_t* __restrict__ block,
                      const uint4* __restrict__ w_hi,
                      const uint4* __restrict__ w_lo,
                      const int* __restrict__ w_index,
                      void* __restrict__ out, int m, int i_rep, int d_rep,
                      int k_pad, int n_tiles, int n_live, int tm,
                      int n_carry, long long n) {
  using OutT = typename std::conditional<kQ14, int16_t, float>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const int k_steps = k_pad / 32;
  const int nw = (n_tiles + 31) / 32;   // words of live bits a k-step
  const int wb = window_bytes(tm, d_rep, k_pad);
  uint8_t* a_hi = smem;
  uint8_t* a_lo = a_hi + wb;
  uint2* b_hi = reinterpret_cast<uint2*>(a_lo + wb);
  uint2* b_lo = b_hi + 32 * n_live;
  int* idx = reinterpret_cast<int*>(b_lo + 32 * n_live);
  uint8_t* out_s = reinterpret_cast<uint8_t*>(idx) +
                   index_bytes(k_steps, nw);

  const int g = blockIdx.y;
  const int m0 = blockIdx.x * tm;
  const int rows = min(tm, m - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int16_t* cg = carry + (size_t)g * n_carry;
  const int16_t* bg = block + (size_t)g * n;

  // the live tap tiles and their index go to shared memory asynchronously
  // while the block stages its window (a plain load and store here would
  // hold the staging loads back a round trip)
  for (int i = threadIdx.x; i < 16 * n_live; i += blockDim.x) {
    copy16_async(reinterpret_cast<uint4*>(b_hi) + i, w_hi + i);
    copy16_async(reinterpret_cast<uint4*>(b_lo) + i, w_lo + i);
  }
  for (int i = threadIdx.x; i < k_steps * nw; i += blockDim.x) {
    copy8_async(idx + 2 * i, w_index + 2 * i);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // stage the window T[m0*D_rep, + wb) split into byte planes: chunk j of
  // the planes (window samples 8j .. 8j + 7) is the row's aligned chunks
  // c0 + j and c0 + j + 1 (16-byte loads) shifted down by the window's
  // lead, or, where those leave the block, its 8 samples one by one;
  // kBatch chunks a thread in flight
  const int a = (int)(((uintptr_t)bg >> 1) & 7);
  const long long bw = (long long)m0 * d_rep - n_carry;   // window start
  const long long c0 = (bw + a >= 0 ? bw + a : bw + a - 7) / 8;
  const int lead = (int)(bw + a - 8 * c0);
  const int span = lead ? 16 : 8;   // aligned samples a chunk needs
  const int chunks = wb / 8;
  for (int j0 = threadIdx.x; j0 < chunks; j0 += kBatch * blockDim.x) {
    uint4 v[kBatch], w[kBatch];
    bool fast[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * blockDim.x;
      const long long lo = 8 * (c0 + j) - a;   // block index of chunk c0+j
      fast[b] = lo >= 0 && lo + span <= n;
      if (j >= chunks) continue;
      if (fast[b]) {
        v[b] = __ldg(reinterpret_cast<const uint4*>(bg + lo));
        if (lead) w[b] = __ldg(reinterpret_cast<const uint4*>(bg + lo + 8));
      } else {
        v[b] = load8_edge(cg, bg, n_carry, n, bw + 8 * j);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * blockDim.x;
      if (j >= chunks) break;
      uint2 h, l;
      imma::split8(v[b], h, l);
      unsigned long long hi = as64(h), lo = as64(l);
      if (fast[b] && lead) {
        imma::split8(w[b], h, l);
        hi = (hi >> (8 * lead)) | (as64(h) << (64 - 8 * lead));
        lo = (lo >> (8 * lead)) | (as64(l) << (64 - 8 * lead));
      }
      reinterpret_cast<unsigned long long*>(a_hi)[j] = hi;
      reinterpret_cast<unsigned long long*>(a_lo)[j] = lo;
    }
  }

  // the shared output tile sits at the output span's alignment
  const size_t o0 = ((size_t)g * m + m0) * i_rep;
  const int delta = (int)((uintptr_t)((OutT*)out + o0) & 15);
  OutT* tile = reinterpret_cast<OutT*>(out_s + delta);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // units (m16 tile, group of kNtW n8 tiles) whose tile holds a frame; a
  // warp loads the next k-step's tap fragments while the current one
  // multiplies, and skips the k-steps and tiles where W is zero
  const int n_groups = (n_tiles + kNtW - 1) / kNtW;
  const int units = (rows + 15) / 16 * n_groups;
  for (int u = warp; u < units; u += nwarps) {
    const int mt = u / n_groups;
    const int nt0 = (u - mt * n_groups) * kNtW;
    imma::Acc acc[kNtW];
#pragma unroll
    for (int j = 0; j < kNtW; ++j) imma::zero(acc[j]);
    // one k-step's products with its tap fragments b and live bits
    auto step = [&](int ks, const uint2 (&bh)[kNtW], const uint2 (&bl)[kNtW],
                    unsigned live) {
      if (!live) return;   // W is banded: most (k-step, tile) blocks are 0
      uint32_t ah[4], al[4];
      if constexpr (kLdm) {
        imma::load_a(ah, a_hi, d_rep, 16 * mt, 32 * ks);
        imma::load_a(al, a_lo, d_rep, 16 * mt, 32 * ks);
      } else {
        load_a_any(ah, a_hi, d_rep, 16 * mt, 32 * ks);
        load_a_any(al, a_lo, d_rep, 16 * mt, 32 * ks);
      }
#pragma unroll
      for (int j = 0; j < kNtW; ++j) {
        if (live >> j & 1) imma::mma_split(acc[j], ah, al, bh[j], bl[j]);
      }
    };
    // k-steps in pairs over two register sets, each loaded a step ahead
    uint2 h0[kNtW], l0[kNtW], h1[kNtW], l1[kNtW];
    unsigned v0 = load_b(h0, l0, b_hi, b_lo, idx, 0, nw, nt0, lane), v1;
    for (int ks = 0; ks < k_steps; ks += 2) {
      v1 = ks + 1 < k_steps
               ? load_b(h1, l1, b_hi, b_lo, idx, ks + 1, nw, nt0, lane)
               : 0u;
      step(ks, h0, l0, v0);
      if (ks + 1 == k_steps) break;
      v0 = ks + 2 < k_steps
               ? load_b(h0, l0, b_hi, b_lo, idx, ks + 2, nw, nt0, lane)
               : 0u;
      step(ks + 1, h1, l1, v1);
    }
    // the unit's sums, converted into the tile
#pragma unroll
    for (int j = 0; j < kNtW; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + (lane >> 2) + 8 * (i >> 1);
        const int col = (nt0 + j) * 8 + 2 * (lane & 3) + (i & 1);
        if (r < rows && col < i_rep) {
          const int sum = (int)imma::combine(acc[j], i);
          if constexpr (kQ14) {
            tile[r * i_rep + col] = (OutT)((sum >> 14) + ((sum >> 13) & 1));
          } else {
            tile[r * i_rep + col] = __int2float_rn(sum) * (1.0f / 16384.0f);
          }
        }
      }
    }
  }
  __syncthreads();

  // the block's output span, 16 bytes at a time from the 16-byte boundary
  // below it; the partial first and last 16 bytes go 2 bytes at a time
  uint8_t* dst = reinterpret_cast<uint8_t*>((OutT*)out + o0) - delta;
  const int total = delta + rows * i_rep * (int)sizeof(OutT);
  for (int q = threadIdx.x; q < (total + 15) / 16; q += blockDim.x) {
    const int lo = 16 * q, hi = lo + 16;
    if (lo >= delta && hi <= total) {
      *reinterpret_cast<uint4*>(dst + lo) =
          *reinterpret_cast<const uint4*>(out_s + lo);
    } else {
      for (int b = max(lo, delta); b < min(hi, total); b += 2) {
        *reinterpret_cast<uint16_t*>(dst + b) =
            *reinterpret_cast<const uint16_t*>(out_s + b);
      }
    }
  }
}

template <bool kQ14, bool kLdm>
int launch(const void* carry, const void* block, const void* w_hi,
           const void* w_lo, const void* w_index, void* out, int m,
           int i_rep, int d_rep, int k_pad, int n_tiles, int n_live,
           int n_carry, long long n, int groups, int tm, int warps,
           size_t smem, cudaStream_t stream) {
  // raise the kernel's shared-memory ceiling once per device (the
  // attribute applies to the current device only), not on every launch
  static size_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(frame_resample_kernel<kQ14, kLdm>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  const dim3 grid((m + tm - 1) / tm, groups);
  frame_resample_kernel<kQ14, kLdm><<<grid, 32 * warps, smem, stream>>>(
      (const int16_t*)carry, (const int16_t*)block, (const uint4*)w_hi,
      (const uint4*)w_lo, (const int*)w_index, out, m, i_rep, d_rep, k_pad,
      n_tiles, n_live, tm, n_carry, n);
  return (int)cudaGetLastError();
}

}  // namespace

// carry [G, n_carry] int16, block [G, n] int16; w_hi/w_lo the live tiles
// of the split frame matrix, [n_live, 32, 8] bytes each (ops/imma_split.py
// fragment_planes of W [S*D_rep, I_rep], zero-padded to [k_pad/32,
// n_tiles] tiles, keeping the tiles with a non-zero tap in (k-step, n8
// tile) order); w_index [k_pad/32, ceil(n_tiles/32), 2] int32: per k-step
// and word of 32 n8 tiles, the live bits and the live tiles before the
// word -> out [G, m * i_rep], f32 for out_mode 0, int16 Q.14 for out_mode
// 1. tm frames a block (a multiple of 16, at most 64) on `warps` warps
// with `smem` bytes of dynamic shared memory, as ops/frame_resampler.py
// launch_shape picks them; smem must be this layout's size at tm (so the
// two descriptions of it cannot drift apart unnoticed). Needs k_pad % 32
// == 0, k_pad <= 32768 and 8 * n_tiles >= i_rep.
extern "C" int tsl_frame_resample(const void* carry, const void* block,
                                  const void* w_hi, const void* w_lo,
                                  const void* w_index, void* out, int m,
                                  int i_rep, int d_rep, int k_pad,
                                  int n_tiles, int n_live, int n_carry,
                                  long long n, int groups, int out_mode,
                                  int tm, int warps, int smem,
                                  void* stream) {
  if (m <= 0 || i_rep <= 0 || d_rep <= 0 || k_pad <= 0 || k_pad % 32 ||
      k_pad > 32768 || n_tiles <= 0 || 8 * n_tiles < i_rep ||
      8 * n_tiles >= i_rep + 8 || n_live < 0 ||
      n_live > k_pad / 32 * n_tiles || n_carry < 0 || n < 0 || groups <= 0 ||
      groups > 65535 || (out_mode != 0 && out_mode != 1) || tm < 16 ||
      tm > kTmMax || tm % 16 || warps < 1 || warps > kWarpsMax ||
      (long long)d_rep * tm + k_pad > kSmemMax ||
      smem != (long long)smem_bytes(tm, d_rep, k_pad, (n_tiles + 31) / 32,
                                    n_live, i_rep, out_mode ? 2 : 4) ||
      smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto fn) {
    return fn(carry, block, w_hi, w_lo, w_index, out, m, i_rep, d_rep, k_pad,
              n_tiles, n_live, n_carry, n, groups, tm, warps, (size_t)smem,
              st);
  };
  const bool ldm = d_rep % 16 == 0;
  if (out_mode == 1) {
    return ldm ? go(launch<true, true>) : go(launch<true, false>);
  }
  return ldm ? go(launch<false, true>) : go(launch<false, false>);
}
