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
// 6 x 130,560 int16 (1.57 MB) and writes 0.1 MB (0.5 us at 3.35 TB/s);
// the registers are ~10 integer operations a position and spec, below
// the bytes' time on the CUDA cores. In practice a launch's fixed cost
// and one CTA's chain of dependent steps set its time.
//
// How the design responds: a CTA takes (row, tile of `tile` new
// positions; the wrapper picks the largest tile of 1,024-8,192 that still
// gives every SM two CTAs, ops/gate.py launch_tile: 2,048 at the pager's
// POCSAG group, 384 CTAs). It reads its window of
// F (the tile and the registers' reach back, 2,343 positions for POCSAG)
// once, sign-slicing it straight into 32-bit words with __ballot_sync
// (stride-1 rows with 8- or 16-byte loads, four samples a lane, the
// words assembled by shuffles; other rows one sample a lane), the window
// aligned so that word w holds positions b0 + 32 w .. + 31, LSB first.
// Every register then walks one residue class mod spb as a shift
// register, reg(p + spb) = (reg(p) << 1) | F[p + spb]: a thread takes a
// run of one class (`run` positions, ops/gate.py launch_run: the
// shortest of 16-128 whose runs fit the CTA's threads, 32 for POCSAG at
// 2,048; after a 31-bit warm-up; eight bit reads issued before their
// shifts), so a position costs a bit read, a shift, an xor, a
// popcount and a compare; the runs of all of a mode's specs are one list
// over the CTA's threads. A match sets its bit in a word array m (a
// shared atomicOr; matches are rare). The pair tests are ANDs of m's
// words with m shifted by d (__funnelshift_l). The output bytes come
// from the window's words (__brev, __byte_perm: big-endian within a
// byte); FLEX's int16 pcm is written from the loaded values. One more
// CTA a row writes the new tail and its packed bytes. The flag is an OR
// across the row's CTAs without a second launch: each CTA adds one to
// the low half of a 64-bit scratch word and its hit to the high half in
// one atomic; the CTA that brings the count to the row's tiles writes
// the flag and zeroes the word, so the scratch (zeroed once by the
// wrapper) is ready for the next launch on the stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_table.cuh"

namespace {

constexpr int kRows = 128;          // rows a launch (the table's size)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinTile = 1024;      // new positions a CTA: a power of two
constexpr int kMaxTile = 8192;      // in [kMinTile, kMaxTile]
constexpr int kEarly = 4;           // tile 0 also tests pairs ending at t-4..
constexpr int kLookPocsag = 18 + 31 * 75;   // reach of the spb-75 pair
constexpr int kLookAis = 4 + 31 * 5 + 5;    // pair, register, NRZI
constexpr int kLookFlex = 31 * 10;
// window words: the tile, tile 0's early positions, the look-back, one
// word of alignment, and past the window's end the last group of four
// words the vector loads fill and the reads of a register run's last
// pass of eight (up to 7 * 75 positions on)
constexpr int kWords =
    (kMaxTile + kEarly + kLookPocsag + 31) / 32 + 1 + (7 * 75 + 31) / 32 + 1;

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

__device__ __forceinline__ unsigned sign_bit(float x, int mode) {
  const int v = to_i16(x);
  return mode == kPocsag ? v < 0 : mode == kAis ? v > 0 : v >= 0;
}

// four output bytes of a word of 32 positions (bit i = position i):
// byte e of the result holds positions 8e..8e+7, the first at bit 7
__device__ __forceinline__ unsigned packed_bytes(unsigned word) {
  return __byte_perm(__brev(word), 0, 0x0123);
}

__device__ __forceinline__ long long floor_div32(long long v) {
  return v >= 0 ? v / 32 : -((31 - v) / 32);
}

// the row CTA's look-up of sample n: values of 4 consecutive samples from
// n (a multiple of 4; the row has stride 1 and is aligned for it)
__device__ __forceinline__ void load4(const RowTable<kRows>& rows, int g,
                                      long long n, long long k, float v[4]) {
  if (n + 3 < k) {
    if (rows.f32[g]) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(rows.ptr[g]) + n));
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const int2 h = __ldg(reinterpret_cast<const int2*>(
          reinterpret_cast<const int16_t*>(rows.ptr[g]) + n));
      v[0] = (float)(int16_t)(h.x & 0xFFFF), v[1] = (float)(h.x >> 16);
      v[2] = (float)(int16_t)(h.y & 0xFFFF), v[3] = (float)(h.y >> 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = n + i < k ? row_value(rows, g, n + i) : 0.0f;
    }
  }
}

// the extra CTA of row g: the new tail F[k .. k+t) and its packed bytes
// after the flag (bits kinds), or FLEX's last min(k, t) pcm samples; a
// word a warp and pass, a bit a lane, all of a warp's loads in flight
// before their ballots
__device__ void write_tail(const RowTable<kRows>& rows, int g, long long k,
                           const uint8_t* tail, int t, uint8_t* out_b,
                           int16_t* out_h, uint8_t* new_tail, int mode) {
  constexpr int kU = 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (t + 31) / 32;
  for (int w0 = warp; w0 < nw; w0 += kU * kWarps) {
    unsigned bits[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = 32 * (w0 + u * kWarps) + lane;
      const long long q = k + i;
      bits[u] = i >= t ? 0u
                : q < t ? tail[(long long)g * t + q]
                        : sign_bit(row_value(rows, g, q - t), mode);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int w = w0 + u * kWarps;
      const int i = 32 * w + lane;
      const unsigned word = __ballot_sync(0xFFFFFFFFu, bits[u]);
      if (i < t) new_tail[(long long)g * t + i] = (uint8_t)bits[u];
      if (mode != kFlex && w < nw && lane < 4 && 4 * w + lane < t / 8) {
        out_b[1 + 4 * w + lane] = (uint8_t)(packed_bytes(word) >> (8 * lane));
      }
    }
  }
  if (mode == kFlex) {
    const int tp = (int)(k < t ? k : t);
    for (int i0 = threadIdx.x; i0 < tp; i0 += kU * kThreads) {
      float v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < tp ? row_value(rows, g, k - tp + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        if (i < tp) out_h[1 + i] = (int16_t)to_i16(v[u]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gate_kernel(const __grid_constant__ RowTable<kRows> rows, long long k,
                const uint8_t* __restrict__ tail, int t,
                void* __restrict__ out, long long out_stride,
                uint8_t* __restrict__ new_tail,
                unsigned long long* __restrict__ scratch, int mode,
                int n_tiles, int tile, int run) {
  __shared__ unsigned win[kWords];    // F, a bit a position
  __shared__ unsigned nz[kWords];     // AIS: the NRZI plane N
  __shared__ unsigned m[3][kWords];   // matches, a word array a spec
  const int g = blockIdx.y;
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  uint8_t* out_b = reinterpret_cast<uint8_t*>(out) + g * out_stride;
  int16_t* out_h = reinterpret_cast<int16_t*>(out) + g * out_stride;

  if (j == n_tiles) {
    write_tail(rows, g, k, tail, t, out_b, out_h, new_tail, mode);
    return;
  }

  // the tile's new positions [n0, n1); its pairs end in [qa, qb) of F; its
  // window starts at b0 <= qa - look, b0 = t (mod 32), so a word holds
  // only tail bits or only new ones and the tile starts on a word
  const long long n0 = (long long)j * tile;
  const long long n1 = min(k, n0 + tile);
  const long long qa = t + n0 - (j == 0 ? kEarly : 0);
  const long long qb = t + n1;
  const int look = mode == kPocsag ? kLookPocsag
                   : mode == kAis  ? kLookAis
                                   : kLookFlex;
  const long long wq = floor_div32(qa - look - t);
  const long long b0 = t + 32 * wq;
  const int nw = (int)((qb - b0 + 31) >> 5);
  const int wt = (int)max(0LL, min((long long)nw, -wq));  // tail words
  const int tp = (int)(k < t ? k : t);
  const int s0 = mode == kPocsag ? 0 : mode == kAis ? 3 : 4;
  const int ns = mode == kPocsag ? 3 : 1;

  for (int i = tid; i < ns * kWords; i += kThreads) (&m[0][0])[i] = 0u;
  for (int w = warp; w < wt; w += kWarps) {
    const long long q = b0 + 32 * w + lane;
    const unsigned bit = q >= 0 && tail[(long long)g * t + q];
    const unsigned word = __ballot_sync(0xFFFFFFFFu, bit);
    if (lane == 0) win[w] = word;
  }
  const bool vec =
      rows.stride[g] == 1 &&
      (reinterpret_cast<uintptr_t>(rows.ptr[g]) & (rows.f32[g] ? 15 : 7)) ==
          0;
  if (vec) {
    // four words a warp: lane l slices samples n .. n+3 into a nibble,
    // and the eight lanes of a word OR their nibbles together
    for (int w = wt + 4 * warp; w < nw; w += 4 * kWarps) {
      const long long n = 32 * (wq + w) + 4 * lane;
      float v[4];
      load4(rows, g, n, k, v);
      unsigned nib = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n + i < k) nib |= sign_bit(v[i], mode) << i;
        if (mode == kFlex && n + i >= n0 && n + i < n1) {
          out_h[1 + tp + n + i] = (int16_t)to_i16(v[i]);
        }
      }
      unsigned word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1);
      word |= __shfl_xor_sync(0xFFFFFFFFu, word, 2);
      word |= __shfl_xor_sync(0xFFFFFFFFu, word, 4);
      if ((lane & 7) == 0) win[w + (lane >> 3)] = word;
    }
  } else {
    // a word a warp and pass, a sample a lane; sixteen loads in flight
    constexpr int kU = 16;
    for (int w0 = wt + warp; w0 < nw; w0 += kU * kWarps) {
      float v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long n = 32 * (wq + w0 + u * kWarps) + lane;
        v[u] = n < k && w0 + u * kWarps < nw ? row_value(rows, g, n) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int w = w0 + u * kWarps;
        const long long n = 32 * (wq + w) + lane;
        const unsigned word =
            __ballot_sync(0xFFFFFFFFu, n < k && sign_bit(v[u], mode));
        if (w < nw) {
          if (mode == kFlex && n >= n0 && n < n1) {
            out_h[1 + tp + n] = (int16_t)to_i16(v[u]);
          }
          if (lane == 0) win[w] = word;
        }
      }
    }
  }
  __syncthreads();

  const unsigned* src = win;
  if (mode == kAis) {
    // N = 1 - (F ^ F shifted by 5), and 0 below position 5; word 0's
    // first five bits lack their F[p-5] but no register reads them
    for (int w = tid; w < nw; w += kThreads) {
      const unsigned prev = w ? win[w - 1] : 0u;
      unsigned v = ~(win[w] ^ __funnelshift_l(prev, win[w], 5));
      const long long lo = b0 + 32 * w;
      if (lo < 5) v = lo <= -27 ? 0u : v & (0xFFFFFFFFu << (5 - lo));
      nz[w] = v;
    }
    __syncthreads();
    src = nz;
  }

  // the register runs: each spec's positions [p0, qb) in spb residue
  // classes, each class in runs of `run` positions; one list over the
  // threads
  long long p0s[3];
  int nps[3], cls[3];
  int total = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    p0s[s] = 0;
    nps[s] = cls[s] = 0;
    if (s < ns) {
      const Spec sp = kSpecs[s0 + s];
      p0s[s] = max(t + (long long)sp.mlo, qa - sp.dmax);
      nps[s] = (int)(qb - p0s[s]);
      cls[s] = (nps[s] + sp.spb - 1) / sp.spb;   // positions a class
      total += sp.spb * ((cls[s] + run - 1) / run);
    }
  }
  for (int it = tid; it < total; it += kThreads) {
    int s = 0, li = it;
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int items = s < ns ? kSpecs[s0 + s].spb *
                                     ((cls[s] + run - 1) / run)
                               : 0;
      if (s + 1 < ns && li >= items) {
        li -= items;
        ++s;
      }
    }
    const Spec sp = kSpecs[s0 + s];
    const int spb = sp.spb, r = li % spb, u = li / spb;
    const int np = s == 0 ? nps[0] : s == 1 ? nps[1] : nps[2];
    const long long p0 = s == 0 ? p0s[0] : s == 1 ? p0s[1] : p0s[2];
    const int jr = (np - r + spb - 1) / spb;   // the class's positions
    const int ja = u * run, jb = min(jr, ja + run);
    if (ja >= jb) continue;
    int bi = (int)(p0 - b0) + r + spb * (ja - 31);
    unsigned reg = 0;
#pragma unroll
    for (int b = 0; b < 31; ++b, bi += spb) {
      reg = (reg << 1) | ((src[bi >> 5] >> (bi & 31)) & 1u);
    }
    // eight positions a pass: their bit reads first, then the shifts
    for (int jj = ja; jj < jb; jj += 8, bi += 8 * spb) {
      unsigned w8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int b = bi + e * spb;
        w8[e] = src[b >> 5] >> (b & 31);
      }
      unsigned hits = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        reg = (reg << 1) | (w8[e] & 1u);
        hits |= (unsigned)(__popc(reg ^ sp.word) <= sp.max_ham &&
                           jj + e < jb) << e;
      }
      while (hits) {   // rare: a match sets its bit
        const int b = bi + (__ffs(hits) - 1) * spb;
        hits &= hits - 1;
        atomicOr(&m[s][b >> 5], 1u << (b & 31));
      }
    }
  }
  __syncthreads();

  // pairs ending in the tile's words: m & (m shifted by d); a pair that
  // ends before qa is one the previous tile tests too, and every m bit
  // lies in [max(mlo, qa - dmax), qb)
  int hit = 0;
  const int wa = (int)((qa - b0) >> 5);
  const int nwp = (int)((qb - 1 - b0) >> 5) - wa + 1;
  for (int i = tid; i < ns * nwp; i += kThreads) {
    const int s = i / nwp, w = wa + i % nwp;
    const Spec sp = kSpecs[s0 + s];
    const unsigned cur = m[s][w], prev = m[s][w - 1];
    if (sp.dmax == 0) {
      hit |= cur != 0u;
    } else {
      for (int d = sp.dmin; d <= sp.dmax; ++d) {
        hit |= (cur & __funnelshift_l(prev, cur, d)) != 0u;
      }
    }
  }
  const int any = __syncthreads_or(hit);

  if (mode != kFlex) {
    // the tile's packed bytes, four a window word
    const int wo = (int)((t + n0 - b0) >> 5);
    const long long nbytes = (k + 7) / 8;
    for (int i = tid; 32LL * i < n1 - n0; i += kThreads) {
      const unsigned bytes = packed_bytes(win[wo + i]);
      const long long b = n0 / 8 + 4 * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (b + e < nbytes) out_b[1 + t / 8 + b + e] = (uint8_t)(bytes >> (8 * e));
      }
    }
  }

  if (tid == 0) {
    // one 64-bit word a row: CTAs done (low half) and CTAs that hit
    // (high half), added in one atomic; the last CTA writes the flag and
    // leaves the word zero
    const unsigned long long old = atomicAdd(
        scratch + g, 1ull | ((unsigned long long)(any != 0) << 32));
    if ((unsigned)old == (unsigned)(n_tiles - 1)) {
      const int flag = (old >> 32) != 0 || any;
      atomicExch(scratch + g, 0ull);
      if (mode == kFlex) {
        out_h[0] = (int16_t)flag;
      } else {
        out_b[0] = (uint8_t)flag;
      }
    }
  }
}

}  // namespace

// rows: n_rows (row pointer, stride in elements, float32 flag) triples
// of k new samples (csrc/row_table.cuh, a host array); tail [n_rows, t]
// uint8; out [n_rows, out_stride] uint8 (POCSAG, AIS) or int16 (FLEX);
// new_tail [n_rows, t] uint8; scratch [n_rows] uint64, zero on entry and
// left zero; mode; tile, the new positions a CTA (a power of two in
// [1024, 8192]); run, the positions a register run walks (a multiple of
// 8); the stream. Launches once a kRows rows.
extern "C" int tsl_egress_gate(const long long* rows, int n_rows,
                               long long k, const uint8_t* tail, int t,
                               char* out, long long out_stride,
                               uint8_t* new_tail,
                               unsigned long long* scratch, int mode,
                               int tile, int run, cudaStream_t stream) {
  if (n_rows <= 0 || k <= 0 || t < 0 || mode < kPocsag || mode > kFlex ||
      (mode != kFlex && t % 8) || tile < kMinTile || tile > kMaxTile ||
      (tile & (tile - 1)) || (k + tile - 1) / tile >= (1LL << 31) ||
      run < 8 || run % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (int)((k + tile - 1) / tile);
  const size_t elem = mode == kFlex ? 2 : 1;
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    const int n = n_rows - r0 < kRows ? n_rows - r0 : kRows;
    RowTable<kRows> table;
    fill_rows(table, rows + 3 * r0, n);
    gate_kernel<<<dim3(n_tiles + 1, n), kThreads, 0, stream>>>(
        table, k, tail + (size_t)r0 * t, t,
        out + (size_t)r0 * out_stride * elem, out_stride,
        new_tail + (size_t)r0 * t, scratch + r0, mode, n_tiles, tile, run);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
