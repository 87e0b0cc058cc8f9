// K7, the egress gate: sign slice, sync-candidate prefilter and bit pack of
// one pack group's block, in one launch.
//
// Replaces the gate of tsl_sdr_tpu/models/pipeline.py:219-262, which XLA
// fuses into the block's device program: the sign slice, the prefilters
// of tsl_sdr_tpu/ops/sync_prefilter.py:60-140 (pocsag_any_candidate,
// flex_any_candidate, ais_any_candidate over _matches), jnp.packbits and
// the concatenation into one output buffer a group. The port ran it as
// some 120-360 small torch ops a group (ops/sync_prefilter.py,
// ops/gate.py egress_gate_plain, which this kernel equals byte for byte).
//
// Over the plane F = [carried tail (T bits) | new bits (K)] of each row:
//   POCSAG (bit = pcm < 0): at spb 75, 32 and 16 (d = max(1, spb/4)), the
//     register ending at p has bit k = F[p - k*spb]; m(p) = popcount(reg
//     ^ 0x7CD215D8) <= 4 for p in [t-d-1, t+K); flag if m(q-d) & m(q) for
//     any q (the pair span starts at t-d-1: a run ending at the last old
//     sample triggers on the first new one);
//   AIS (bit = pcm > 0): NRZI N[p] = 1 - (F[p] ^ F[p-5]) (0 for p < 5),
//     registers at spb 5 over N within hamming 2 of 0x5555557E for p in
//     [t-4, t+K), flag if two are 1-4 apart;
//   FLEX (bit = to_int16(pcm) >= 0): spb 10, exactly 0xAAAAAAAA at any p
//     in [t, t+K).
// Float rows are truncated first (-0.4 is bit 0 for < 0). Output a row:
// bits kinds [flag u8 | packbits(new tail) | packbits(bits)], FLEX
// [flag i16 | last min(K, T) pcm | pcm] with pcm = to_int16(row); packbits
// is big-endian in a byte, the last byte zero-padded. The new tail is the
// last T bits of F (part of the old tail when K < T).
//
// What bounds it on the H100: bytes. A pager block's POCSAG group reads
// 6 x 130,560 int16 (1.57 MB) and writes 0.1 MB; the registers, at 32
// shared-memory loads a register and position, are ~0.2 G simple integer
// operations, below the bytes' time on the CUDA cores. A block's launch
// cost (a few microseconds) is what the kernel saves over the torch ops.
//
// How the design responds: a CTA takes (row, tile of kTile new positions):
// it builds its window of F (the tile plus the registers' reach back,
// 2,343 positions for POCSAG) as bytes in shared memory, reading the rows
// through a table of pointers (no stack), evaluates every register it
// needs once a spec into a shared byte array, tests the pairs, packs one
// output byte a thread, and writes FLEX's int16 rows. One more CTA a row
// writes the new tail and its packed bytes. The flag is an OR across the
// row's CTAs without a second launch: each CTA ORs its hit into a scratch
// word, fences, and takes a ticket; the last one exchanges the word for 0,
// writes the flag and resets the ticket, so the scratch (zeroed once by
// the wrapper) is ready for the next launch on the stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_table.cuh"

namespace {

constexpr int kRows = 128;          // rows a launch (the table's size)
constexpr int kTile = 2048;         // new positions a CTA
constexpr int kThreads = kTile / 8; // one packed byte a thread
constexpr int kEarly = 4;           // tile 0 also tests pairs ending at t-4..
constexpr int kLookPocsag = 18 + 31 * 75;   // reach of the spb-75 pair
constexpr int kLookAis = 4 + 31 * 5 + 5;    // pair, register, NRZI
constexpr int kLookFlex = 31 * 10;
constexpr int kWin = kTile + kEarly + kLookPocsag;
constexpr int kMaxD = 18;
constexpr int kM = kTile + kEarly + kMaxD;

enum Mode { kPocsag = 0, kAis = 1, kFlex = 2 };

struct Spec {
  int spb;
  unsigned word;
  int max_ham;
  int mlo;    // first register position, relative to t
  int dmin;   // pair distances tested (0: the register alone)
  int dmax;
};

__constant__ Spec kSpecs[5] = {
    {75, 0x7CD215D8u, 4, -19, 18, 18},
    {32, 0x7CD215D8u, 4, -9, 8, 8},
    {16, 0x7CD215D8u, 4, -5, 4, 4},
    {5, 0x5555557Eu, 2, -4, 1, 4},
    {10, 0xAAAAAAAAu, 0, 0, 0, 0},
};

__device__ __forceinline__ unsigned char sign_bit(float x, int mode) {
  const int v = to_i16(x);
  return mode == kPocsag ? v < 0 : mode == kAis ? v > 0 : v >= 0;
}

// F[q] of row g: the carried tail, then the new bits
__device__ __forceinline__ unsigned char plane(const RowTable<kRows>& rows,
                                               int g, const uint8_t* tail,
                                               int t, long long q, int mode) {
  if (q < t) return tail[(long long)g * t + q];
  return sign_bit(row_value(rows, g, q - t), mode);
}

__global__ void __launch_bounds__(kThreads)
    gate_kernel(const __grid_constant__ RowTable<kRows> rows, long long k,
                const uint8_t* __restrict__ tail, int t,
                void* __restrict__ out, long long out_stride,
                uint8_t* __restrict__ new_tail, int* __restrict__ scratch,
                int n_rows, int mode, int n_tiles) {
  __shared__ uint8_t win[kWin];
  __shared__ uint8_t nrzi[kWin];
  __shared__ uint8_t m[kM];
  const int g = blockIdx.y;
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  uint8_t* out_b = reinterpret_cast<uint8_t*>(out) + g * out_stride;
  int16_t* out_h = reinterpret_cast<int16_t*>(out) + g * out_stride;

  if (j == n_tiles) {
    // the new tail F[k .. k+t), packed after the flag for the bits kinds;
    // FLEX's last min(k, t) pcm samples after its flag
    for (int i = tid; i < t; i += kThreads) {
      new_tail[(long long)g * t + i] = plane(rows, g, tail, t, k + i, mode);
    }
    if (mode == kFlex) {
      const int tp = (int)(k < t ? k : t);
      for (int i = tid; i < tp; i += kThreads) {
        out_h[1 + i] = (int16_t)to_i16(row_value(rows, g, k - tp + i));
      }
    } else {
      for (int b = tid; b < t / 8; b += kThreads) {
        unsigned byte = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          byte |= (unsigned)plane(rows, g, tail, t, k + 8 * b + i, mode)
                  << (7 - i);
        }
        out_b[1 + b] = (uint8_t)byte;
      }
    }
    return;
  }

  const long long n0 = (long long)j * kTile;
  const long long n1 = min(k, n0 + kTile);
  const long long qa = t + n0 - (j == 0 ? kEarly : 0);  // later elements
  const long long qb = t + n1;
  const int look = mode == kPocsag ? kLookPocsag
                   : mode == kAis  ? kLookAis
                                   : kLookFlex;
  const long long w0 = max(0LL, qa - look);
  const int wn = (int)(qb - w0);
  for (int i = tid; i < wn; i += kThreads) {
    win[i] = plane(rows, g, tail, t, w0 + i, mode);
  }
  __syncthreads();
  const uint8_t* src = win;
  if (mode == kAis) {
    // N[p] needs F[p - 5]: the window reaches 5 further back than the
    // registers (its first 5 entries are never read unless w0 == 0, where
    // they are the plane's zeros)
    for (int i = tid; i < wn; i += kThreads) {
      nrzi[i] = (w0 + i < 5 || i < 5) ? 0 : 1 - (win[i] ^ win[i - 5]);
    }
    __syncthreads();
    src = nrzi;
  }

  const int s0 = mode == kPocsag ? 0 : mode == kAis ? 3 : 4;
  const int s1 = mode == kPocsag ? 3 : s0 + 1;
  int hit = 0;
  for (int s = s0; s < s1; ++s) {
    const Spec sp = kSpecs[s];
    const long long mlo = t + sp.mlo;
    const long long p0 = max(mlo, qa - sp.dmax);
    const int np = (int)(qb - p0);
    for (int i = tid; i < np; i += kThreads) {
      const int wi = (int)(p0 + i - w0);
      unsigned reg = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        reg |= (unsigned)src[wi - b * sp.spb] << b;
      }
      m[i] = __popc(reg ^ sp.word) <= sp.max_ham;
    }
    __syncthreads();
    for (long long q = max(qa, mlo + sp.dmin) + tid; q < qb; q += kThreads) {
      const int i = (int)(q - p0);
      if (sp.dmax == 0) {
        hit |= m[i];
      } else {
        for (int d = sp.dmin; d <= sp.dmax; ++d) {
          if (q - d >= mlo) hit |= m[i] & m[i - d];
        }
      }
    }
    __syncthreads();
  }
  const int any = __syncthreads_or(hit);

  if (mode == kFlex) {
    const int tp = (int)(k < t ? k : t);
    for (long long n = n0 + tid; n < n1; n += kThreads) {
      out_h[1 + tp + n] = (int16_t)to_i16(row_value(rows, g, n));
    }
  } else {
    const long long n = n0 + 8 * tid;
    if (n < n1) {
      unsigned byte = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (n + i < k) byte |= (unsigned)win[t + n + i - w0] << (7 - i);
      }
      out_b[1 + t / 8 + n / 8] = (uint8_t)byte;
    }
  }

  if (tid == 0) {
    int* ticket = scratch + g;
    int* acc = scratch + n_rows + g;
    if (any) atomicOr(acc, 1);
    __threadfence();
    if (atomicAdd(ticket, 1) == n_tiles - 1) {
      __threadfence();
      const int flag = atomicExch(acc, 0);
      atomicExch(ticket, 0);
      if (mode == kFlex) {
        out_h[0] = (int16_t)flag;
      } else {
        out_b[0] = (uint8_t)flag;
      }
    }
  }
}

}  // namespace

// rows: n_rows pointers, strides (elements) and float32 flags (host
// arrays); k new samples a row; tail [n_rows, t] uint8; out [n_rows,
// out_stride] uint8 (POCSAG, AIS) or int16 (FLEX); new_tail [n_rows, t]
// uint8; scratch [2 * n_rows] int32, zero on entry and left zero. Launches
// once a kRows rows.
extern "C" int tsl_egress_gate(const long long* ptrs,
                               const long long* strides, const int* f32,
                               int n_rows, long long k, const void* tail,
                               int t, void* out, long long out_stride,
                               void* new_tail, void* scratch, int mode,
                               void* stream) {
  if (n_rows <= 0 || k <= 0 || t < 0 || mode < kPocsag || mode > kFlex ||
      (mode != kFlex && t % 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (int)((k + kTile - 1) / kTile);
  const size_t elem = mode == kFlex ? 2 : 1;
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    const int n = n_rows - r0 < kRows ? n_rows - r0 : kRows;
    RowTable<kRows> table;
    fill_rows(table, ptrs + r0, strides + r0, f32 + r0, n);
    gate_kernel<<<dim3(n_tiles + 1, n), kThreads, 0,
                  (cudaStream_t)stream>>>(
        table, k, (const uint8_t*)tail + (size_t)r0 * t, t,
        (char*)out + (size_t)r0 * out_stride * elem, out_stride,
        (uint8_t*)new_tail + (size_t)r0 * t, (int*)scratch + 2 * r0, n,
        mode, n_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
