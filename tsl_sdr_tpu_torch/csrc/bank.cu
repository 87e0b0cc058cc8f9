// K5, the exact packed FIR, at every shape; and K1 (channelizer + FM) on
// wide banks, where its tile body (chain.cu) cannot keep the taps in
// shared memory. One persistent body with resident taps.
//
// K5 replaces the bit-exact tier's device stage,
// tsl_sdr_tpu/ops/packed_fir.py:406-464 packed_fir_step_exact (an XLA int16
// x int16 -> int32 jnp.dot) and its grouped form :286-318 _grouped_matmul
// (torch's CUDA matmul takes no int16 operands). K1's wide-bank launch
// replaces tsl_sdr_tpu/ops/pallas_chain.py _chain_call_v2 -> _chain_kernel_v2
// -> _chain_body and _chain_call with the grouped FIR body _fir_acc with
// gspec (:167-196), at the widths where chain.cu's launch reads its taps
// from L2 once a tile.
//
// What it computes: the product of chain.cu's note, acc[r, c] = sum_{u < U}
// S[r*ROW + u] * W[u, c] over the stream S = carry (cr rows) ++ block, as
// wrapped int32 sums; K5 writes them (kQ14: (a >> 14) + ((a >> 13) & 1)
// narrowed mod 2^16 into int16 planes [2, rows, HC]; kRaw: int32 [rows,
// 2*HC]), K1 runs the FM discriminator on them (fm.cuh).
//
// What bounds it on the H100: at BENCH_SUITE's 64-channel block (52,224
// rows of 640 values, 1,024 columns of 256 non-zero taps) the work is 13.7
// G int16 multiply-adds, 55 us at the int8 tensor-core peak; K5 raw writes
// 214 MB of sums, 64 us of HBM, so K5 raw is bound by bytes and K1 by
// operations. What held the tile body back was neither: its taps (459 KB
// at 64 channels) do not fit beside a tile, so every 31-row tile re-read
// all of them from L2 (773 MB a launch at 64 channels, 3.5 GB at 256), and
// K5 paid for K1's f32 accumulator plane without using it.
//
// How the design responds:
// - Resident taps, persistent grid. The work is (sub-block of the tap
//   columns, row tile) units; each of about as many blocks as fit on the
//   card at once (one an SM) takes an even run of them, stages its
//   sub-block's tap fragments into shared memory once (twice where its run
//   crosses into the next sub-block) and walks its tiles, so the taps
//   cross L2 about once a block and the rows once a sub-block
//   (ops/chain.py exact_shape and fm_bank_shape size both; where no
//   sub-block's taps fit beside enough rows, K5 reads them from L2 and K1
//   keeps its tile body).
// - Rows by cp.async into a ring of two buffers where two fit (K5 at the
//   pager block and at 64-256 channels; K1's 64-row tiles take one): the
//   next unit's rows load while this one runs its products. The rows are
//   staged as raw int16 (pitch 2*ROW + 16 bytes) and split into high and
//   low bytes in registers (imma::load_a_raw), the taps' k order permuted
//   on the host to match; integer sums do not depend on k order.
// - K5 has no look-back row and no accumulator plane: a warp's item is two
//   16-row m-tiles by a group of 4 n8 tiles over the union of their
//   k-steps (zeros outside a tile's own range add nothing), each B fragment
//   feeding 8 IMMA products, the next step's fragments loading while this
//   step's products issue; the epilogue writes from the fragments. Its
//   block is 8 warps (256 threads; 16 smaller items spilled registers).
// - K1's FM history stays in registers. A sub-block's columns run octet by
//   octet (8 channels), phase by phase, re then im (ops/chain.py
//   octet_columns). An item, one m-tile by one octet, is two warps of the
//   block's 16: each walks half the phases in order with a phase's re and
//   im tiles in its C fragments, so output (r, j, c) finds its history
//   (r, j - 1, c) in the same thread's registers from the previous phase.
//   Only each half's last phase goes to shared memory (the edge phases,
//   2 KB an item, not the plane of [TR + 1, 2 * outputs a row] floats):
//   after one barrier the second half's first phase reads the first half's
//   last (the same row), and phase 0 reads phase opr - 1 one row up (the
//   m-tile above's last row for its first; the look-back row, local row 0,
//   recomputed a tile, has no output; prev[] seeds output row 0). The last
//   output row's phase opr - 1 is the next block's prev. A walk per warp
//   serialised the FM stage behind the products; two warps an item
//   halve the walk and double the warps that hide each other's latency.
// - Tensor cores: mma.sync m16n8k32 by the exact split (imma_split.cuh).
//   Not the limit here:
//   with the products cut out, K5 and K1 kept most of their time (the
//   fragment loads from shared memory, the FM stage, the staging), so
//   wgmma is not taken yet (ROADMAP).
//
// ktab [tiles, 4] int32 as chain.cu's: each n8 tile's first and end k-step,
// its group's base fragment (group of kG tiles side by side a step: K5 4,
// K1 2) and the end of its sub-block's fragments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm.cuh"
#include "imma_split.cuh"

namespace {

constexpr int kThreads = 256;            // K5's block
constexpr int kWarps = kThreads / 32;
constexpr int kFmWarps = 16;             // K1's: two warps an item
constexpr int kPitchPad = 16;   // bytes past 2*ROW per staged row
constexpr int kSmemCap = 227 * 1024;

// epilogues: K1's FM discriminator, K5's rounded planes, K5's raw sums
constexpr int kFm = 0;
constexpr int kQ14 = 1;
constexpr int kRaw = 2;

__host__ __device__ inline int row_pitch(int row) {
  return 2 * row + kPitchPad;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kN));
}

// stream rows [s0, s0 + x_rows) of carry ++ block as raw int16 rows at
// pitch bytes; rows outside the stream read as zeros (they feed only
// outputs that are dropped)
template <int kNT>
__device__ void stage_rows(uint8_t* dst, const int16_t* carry,
                           const int16_t* block, long long carry_vals,
                           long long total, int s0, int x_rows, int row,
                           int pitch) {
  const int per_row = row / 8;   // 16-byte chunks a row
  const int n = x_rows * per_row;
  const long long base = (long long)s0 * row;
  // chunk i = r * per_row + c, advanced without a divide
  const int dr = kNT / per_row, dc = kNT % per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  for (int i = threadIdx.x; i < n; i += kNT) {
    const long long s = base + 8LL * i;
    const bool ok = s >= 0 && s < total;
    const int16_t* src = !ok ? block
        : s < carry_vals ? carry + s : block + (s - carry_vals);
    cp_async16(dst + r * pitch + 16 * c, src, ok ? 16 : 0);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// the union [lo, hi) of the k-steps of tiles tab[0 .. n)
template <int kN>
__device__ __forceinline__ void k_union(const int4* tab, int ksteps,
                                        int& lo, int& hi) {
  lo = ksteps;
  hi = 0;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int4 e = tab[j];
    const int b = min(e.y, ksteps);
    if (e.x < b) {
      lo = min(lo, e.x);
      hi = max(hi, b);
    }
  }
}

// this lane's word of a B fragment: from shared memory (kS, the taps
// staged; an explicit shared load, not a generic one) or through L2
template <bool kS>
__device__ __forceinline__ uint2 load_b(const uint2* p) {
  if constexpr (kS) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v.x), "=r"(v.y)
                 : "r"((uint32_t)__cvta_generic_to_shared(p)));
    return v;
  } else {
    return __ldg(p);
  }
}

// one k-step's operands of an item: A of its kM m-tiles from shared
// address a (the second 16 rows on), B of its group's kN n8 tiles from
// bh/bl (this lane's word of the step's first fragment)
template <int kM, int kN>
struct Frags {
  uint32_t ah[kM][4], al[kM][4];
  uint2 bh[kN], bl[kN];
};

template <bool kS, int kM, int kN>
__device__ __forceinline__ void load_frags(Frags<kM, kN>& f, uint32_t a,
                                           int pitch, const uint2* bh,
                                           const uint2* bl) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    imma::load_a_raw(f.ah[m], f.al[m], a + 16 * m * pitch);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    f.bh[j] = load_b<kS>(bh + 32 * j);
    f.bl[j] = load_b<kS>(bl + 32 * j);
  }
}

template <int kM, int kN, int kMA>
__device__ __forceinline__ void mma_frags(imma::Acc (&acc)[kMA][kN],
                                          const Frags<kM, kN>& f) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      imma::mma_split(acc[m][j], f.ah[m], f.al[m], f.bh[j], f.bl[j]);
    }
  }
}

// an item's products (kM m-tiles from local row lr0 by a group of kN n8
// tiles) over k-steps [lo, hi): step ks reads staged row lr0 + q at value
// 32 * kk (tap u = 32 * ks = ROW * q + 32 * kk); the next step's
// fragments load while this step's products issue
template <bool kS, int kM, int kN, int kMA>
__device__ __forceinline__ void item_sums(imma::Acc (&acc)[kMA][kN],
                                          uint32_t xa, int pitch,
                                          const uint2* bh, const uint2* bl,
                                          int lo, int hi, int ks_per_row,
                                          int lr0) {
  int q = lo / ks_per_row, kk = lo - q * ks_per_row;
  uint32_t a = xa + (lr0 + q) * pitch + 64 * kk;
  // advance a, bh and bl one step
  auto next = [&]() {
    a += 64;
    if (++kk == ks_per_row) {
      kk = 0;
      a += pitch - 64 * ks_per_row;
    }
    bh += kN * 32;
    bl += kN * 32;
  };
  Frags<kM, kN> f0, f1;
  load_frags<kS>(f0, a, pitch, bh, bl);
  for (int ks = lo; ks < hi; ++ks) {
    next();
    if (ks + 1 < hi) load_frags<kS>(f1, a, pitch, bh, bl);
    mma_frags(acc, f0);
    f0 = f1;
  }
}

// the reference's Q.28 -> Q.14 rounding, narrowed mod 2^16
__device__ __forceinline__ int16_t q14(int a) {
  return (int16_t)((a >> 14) + ((a >> 13) & 1));
}

// K5's q14 output of one 16x8 C tile whose columns lie in one plane (hc %
// 8 == 0): lanes t, t ^ 1 swap a pair, so that an even lane writes 4
// values of row g and an odd one 4 of row g + 8, 8 bytes each; every lane
// of the warp runs it. r_g: stream row of the tile's row g; lr_g its
// local row.
__device__ __forceinline__ void q14_quad(int16_t* out, const imma::Acc& c,
                                         size_t r_g, int lr_g, int n_out,
                                         int lc, int lane, int rows, int hc) {
  const uint32_t top = (uint16_t)q14((int)imma::combine(c, 0))
      | (uint32_t)(uint16_t)q14((int)imma::combine(c, 1)) << 16;
  const uint32_t bot = (uint16_t)q14((int)imma::combine(c, 2))
      | (uint32_t)(uint16_t)q14((int)imma::combine(c, 3)) << 16;
  const bool odd = lane & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? top : bot, 1);
  const int col = lc - 2 * odd;   // 4 values from here, a multiple of 4
  const int lr = lr_g + 8 * odd;
  if (lr >= n_out || col >= 2 * hc) return;
  const int ri = col >= hc ? 1 : 0;
  const size_t at = (size_t)ri * rows * hc + (r_g + 8 * odd) * hc + col
      - ri * hc;
  *reinterpret_cast<uint2*>(out + at) =
      odd ? make_uint2(got, bot) : make_uint2(top, got);
}

// K5: one tile's sums, output rows [r0, r0 + n_out), from staged rows at
// shared address xa (plus this lane's raw_lane_offset; local row i = stream
// row r0 + i); tiles of this sub-block from global tile t_base on. Items
// (two m-tiles, or the tile's last one, by a group of 4 n8 tiles) over
// the warps.
template <int kMode, bool kS>
__device__ void exact_tile(uint32_t xa, int pitch, const uint2* b_hi,
                           const uint2* b_lo, int tap0, const int4* tab,
                           int sub_tiles, int ksteps, int ks_per_row, int tr,
                           int r0, int n_out, int t_base, int hc, int rows,
                           void* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pairs = (tr + 16) / 32;
  const int n_groups = sub_tiles / 4;
  for (int item = warp; item < n_pairs * n_groups; item += kWarps) {
    const int lr0 = (item / n_groups) * 32;
    const bool two = lr0 + 16 < tr;
    const int nt0 = (item % n_groups) * 4;
    int lo, hi;
    k_union<4>(tab + nt0, ksteps, lo, hi);
    if (lo >= hi) continue;   // a group of padding columns
    const size_t f0 = (size_t)(tab[nt0].z - tap0 + 4 * lo) * 32 + lane;
    imma::Acc acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) imma::zero(acc[h][j]);
    }
    if (two) {
      item_sums<kS, 2>(acc, xa, pitch, b_hi + f0, b_lo + f0, lo, hi,
                       ks_per_row, lr0);
    } else {
      item_sums<kS, 1>(acc, xa, pitch, b_hi + f0, b_lo + f0, lo, hi,
                       ks_per_row, lr0);
    }
    // the thread's outputs: rows lr0 + 16h + g + 8p, columns lc = the
    // group's first + 8j + 2t, 2t + 1 (lc even)
    const int g = lane >> 2;
    const int lc0 = (t_base + nt0) * 8 + (lane & 3) * 2;
    const size_t row0 = (size_t)(r0 + lr0 + g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = lc0 + 8 * j;
        if (lc - (lane & 3) * 2 >= 2 * hc) break;   // padding tiles
        if constexpr (kMode == kQ14) {
          if (hc % 8 == 0) {
            q14_quad(static_cast<int16_t*>(out), acc[h][j], row0 + 16 * h,
                     lr0 + 16 * h + g, n_out, lc, lane, rows, hc);
            continue;
          }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (lr0 + 16 * h + g + 8 * p >= n_out || lc >= 2 * hc) continue;
          const size_t r = row0 + 16 * h + 8 * p;
          const int v0 = (int)imma::combine(acc[h][j], 2 * p);
          const int v1 = (int)imma::combine(acc[h][j], 2 * p + 1);
          if constexpr (kMode == kRaw) {
            // [rows, 2*hc]: lc is even, so the pair is 8-byte aligned
            *reinterpret_cast<int2*>(static_cast<int*>(out) + r * 2 * hc
                                     + lc) = make_int2(v0, v1);
          } else {
            int16_t* o = static_cast<int16_t*>(out);
            const int ri = lc >= hc ? 1 : 0;
            o[(size_t)ri * rows * hc + r * hc + lc - ri * hc] = q14(v0);
            const int ri1 = lc + 1 >= hc ? 1 : 0;
            o[(size_t)ri1 * rows * hc + r * hc + lc + 1 - ri1 * hc] = q14(v1);
          }
        }
      }
    }
  }
}

// K1's outputs of channels c, c + 1 at out[at], out[at + 1]: one 4-byte
// store where both exist and the pair is aligned
__device__ __forceinline__ void store_pair(int16_t* out, size_t at,
                                           const int16_t (&v)[2], int c,
                                           int nr_ch, bool ok) {
  if (!ok || c >= nr_ch) return;
  if (c + 1 < nr_ch && at % 2 == 0) {
    *reinterpret_cast<short2*>(out + at) = make_short2(v[0], v[1]);
    return;
  }
  out[at] = v[0];
  if (c + 1 < nr_ch) out[at + 1] = v[1];
}

// K1: one phase's re and im sums (floats, C-fragment order) of one m-tile
// (local rows lr0 ..) by one octet, its tiles tab[0] (re) and tab[1] (im);
// the next k-step's fragments load while this step's products issue
__device__ __forceinline__ void phase_sums(float (&ar)[4], float (&ai)[4],
                                           uint32_t xa, int pitch,
                                           const uint2* b_hi,
                                           const uint2* b_lo, int tap0,
                                           const int4* tab, int ksteps,
                                           int ks_per_row, int lr0,
                                           int lane) {
  int lo, hi;
  k_union<2>(tab, ksteps, lo, hi);
  const int base = tab[0].z - tap0;
  imma::Acc acc[1][2];
  imma::zero(acc[0][0]);
  imma::zero(acc[0][1]);
  if (lo < hi) {
    const size_t f0 = (size_t)(base + 2 * lo) * 32 + lane;
    item_sums<true, 1>(acc, xa, pitch, b_hi + f0, b_lo + f0, lo, hi,
                       ks_per_row, lr0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ar[i] = __int2float_rn((int)imma::combine(acc[0][0], i));
    ai[i] = __int2float_rn((int)imma::combine(acc[0][1], i));
  }
}

// K1: one tile's PCM, output rows [r0, r0 + n_out) from staged rows at xa
// (as exact_tile's; local row i = stream row r0 - 1 + i, row 0 the
// look-back row), for channels [c0, c0 + 8 * n_oct) of this sub-block. An
// item (m-tile mt, octet o), m-tile-major, is two warps: half 0 walks
// phases [0, opr / 2), half 1 [opr / 2, opr), each with its history in
// registers from its previous phase. Each writes its last phase to its
// slot of edge [items, 2, 16 rows, 8 channels, re/im]; after the barrier
// half 1's first phase takes its history from half 0's last (the same
// row), and phase 0 from phase opr - 1 one row up (the m-tile above's last
// row for its first row; none for the look-back row; prev[] for output
// row 0). om [opr, 8 * n_oct]: the sub-block's omega. n_items ==
// kFmWarps / 2 (ops/chain.py fm_bank_shape).
__device__ void fm_tile(uint32_t xa, int pitch, const uint2* b_hi,
                        const uint2* b_lo, int tap0, const int4* tab,
                        int ksteps, int ks_per_row, int tr, int r0, int n_out,
                        int c0, int n_oct, int nr_ch, int opr, int rows,
                        const float* om, const float* prev, int16_t* out,
                        float* prev_out, float* edge) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hc = opr * nr_ch;
  const int cpb = 8 * n_oct;
  const int item = warp >> 1, h = warp & 1;
  const int mt = item / n_oct, o = item - mt * n_oct;
  const int lr0 = 16 * mt;
  const int cl = 8 * o + 2 * t;   // the thread's first channel, local
  const int js = opr / 2;
  const int j_begin = h ? js : 0, j_end = h ? opr : js;
  // this item's edge plane of half hh at row r, the thread's channel e
  auto at = [&](int it, int hh, int r, int e) {
    return edge + (((it * 2 + hh) * 16 + r) * 8 + 2 * t + e) * 2;
  };
  float fr[4], fi[4];   // the first phase's sums: its output waits
  float hr[4], hi[4];   // the previous phase: the history
  for (int j = j_begin; j < j_end; ++j) {
    float ar[4], ai[4];
    phase_sums(ar, ai, xa, pitch, b_hi, b_lo, tap0, tab + (o * opr + j) * 2,
               ksteps, ks_per_row, lr0, lane);
    if (j == j_begin) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fr[i] = ar[i];
        fi[i] = ai[i];
      }
    } else {
#pragma unroll
      for (int p = 0; p < 2; ++p) {   // rows g and g + 8
        const int lr = lr0 + g + 8 * p;
        int16_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * p + e;
          v[e] = fm::fm_pcm(ar[i], ai[i], hr[i], hi[i], om[j * cpb + cl + e]);
        }
        store_pair(out, (size_t)(r0 + lr - 1) * hc + j * nr_ch + c0 + cl, v,
                   c0 + cl, nr_ch, lr >= 1 && lr <= n_out);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hr[i] = ar[i];
      hi[i] = ai[i];
    }
  }
  if (j_end > j_begin) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* e = at(item, h, g + 8 * (i >> 1), i & 1);
      e[0] = hr[i];
      e[1] = hi[i];
      const int lr = lr0 + g + 8 * (i >> 1);
      const int c = c0 + cl + (i & 1);
      if (h == 1 && r0 + n_out == rows && lr == n_out && c < nr_ch) {
        prev_out[c] = hr[i];   // the next block's history
        prev_out[nr_ch + c] = hi[i];
      }
    }
  }
  __syncthreads();
  if (j_end == j_begin) return;
  // the first phase's outputs
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = g + 8 * p;   // row in the m-tile
    const int lr = lr0 + r;
    int16_t v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * p + e;
      const int c = min(c0 + cl + e, nr_ch - 1);
      const float* hp = j_begin > 0 ? at(item, 0, r, e)
          : r > 0 ? at(item, 1, r - 1, e)
          : at(max(item - n_oct, 0), 1, 15, e);   // m-tile 0: look-back
      float pr = hp[0], pi = hp[1];
      if (j_begin == 0 && r0 + lr - 1 == 0) {
        pr = prev[c];
        pi = prev[nr_ch + c];
      }
      v[e] = fm::fm_pcm(fr[i], fi[i], pr, pi, om[j_begin * cpb + cl + e]);
    }
    store_pair(out, (size_t)(r0 + lr - 1) * hc + j_begin * nr_ch + c0 + cl,
               v, c0 + cl, nr_ch, lr >= 1 && lr <= n_out);
  }
}

// stage sub-block s (cp.async, not committed): its ktab rows to tab, its
// tap fragments (contiguous, from the end of the previous sub-block's to
// the end of its own) where they are staged, and K1's omega [opr, 8 *
// octets] (plain stores). Returns the index of its first fragment in
// w_hi/w_lo where the taps are staged, else 0.
template <int kMode, int kNT>
__device__ int stage_sub(uint8_t* smem, int tap_bytes, const uint2* w_hi,
                         const uint2* w_lo, const int4* ktab, int sub_tiles,
                         int s, int4* tab, const float* omega, float* om,
                         int nr_ch, int opr) {
  const int4* g_tab = ktab + (size_t)s * sub_tiles;
  for (int i = threadIdx.x; i < sub_tiles; i += kNT) {
    cp_async16(tab + i, g_tab + i, 16);
  }
  if constexpr (kMode == kFm) {
    const int cpb = 8 * (sub_tiles / (2 * opr));
    for (int i = threadIdx.x; i < opr * cpb; i += kNT) {
      const int j = i / cpb;
      const int c = s * cpb + i - j * cpb;
      om[i] = c < nr_ch ? omega[j * nr_ch + c] : 0.0f;
    }
  }
  if (tap_bytes == 0) return 0;
  const int tap0 = s > 0 ? g_tab[-1].w : 0;
  const int n16 = (g_tab[0].w - tap0) * 16;   // 16-byte words a plane
  uint4* t_hi = reinterpret_cast<uint4*>(smem);
  uint4* t_lo = reinterpret_cast<uint4*>(smem + tap_bytes / 2);
  const uint4* s_hi = reinterpret_cast<const uint4*>(w_hi) + 16LL * tap0;
  const uint4* s_lo = reinterpret_cast<const uint4*>(w_lo) + 16LL * tap0;
  for (int i = threadIdx.x; i < n16; i += kNT) {
    cp_async16(t_hi + i, s_hi + i, 16);
    cp_async16(t_lo + i, s_lo + i, 16);
  }
  return tap0;
}

// A work unit is (sub-block s, row tile t), u = s * tiles + t; block b of
// gridDim.x runs units [b * units / gridDim.x, (b + 1) * units /
// gridDim.x): an even share, a run of tiles of one sub-block or two, so it
// stages taps once or twice, and the blocks on the same tiles of
// different sub-blocks run together and find the rows in L2. tap_bytes >
// 0: the widest sub-block's fragments (both planes), staged in shared
// memory; 0: read from device memory through L2. stages: row buffers (2:
// the next unit's rows load while this one runs). K5: sub_tiles n8 tiles
// a sub-block in the tap matrix's own column order, out int16 [2, rows,
// hc] (kQ14) or int32 [rows, 2*hc] (kRaw). K1: sub_tiles = 2 * opr *
// octets, out int16 [rows, hc], prev [2, nr_ch] in, prev_out [2, nr_ch]
// out.
template <int kMode>
__host__ __device__ constexpr int block_threads() {
  return kMode == kFm ? 32 * kFmWarps : kThreads;
}

template <int kMode>
__global__ void __launch_bounds__(block_threads<kMode>())
bank_kernel(const int16_t* __restrict__ carry,
            const int16_t* __restrict__ block,
            const uint2* __restrict__ w_hi, const uint2* __restrict__ w_lo,
            const int4* __restrict__ ktab, const float* __restrict__ omega,
            const float* __restrict__ prev, void* __restrict__ out,
            float* __restrict__ prev_out, int rows, int row, int cr,
            int ksteps, int nr_ch, int opr, int sub_tiles, int n_sub,
            int tr, int stages, int tap_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lb = kMode == kFm ? 1 : 0;   // K1's look-back row
  constexpr int kNT = block_threads<kMode>();
  const int pitch = row_pitch(row);
  const int x_rows = tr + lb + cr;
  const size_t xb = (size_t)x_rows * pitch;
  uint8_t* xs = smem + tap_bytes;
  // the sub-block's ktab rows; K1's edge phases and omega
  int4* tab = reinterpret_cast<int4*>(xs + stages * xb);
  float* edge = reinterpret_cast<float*>(tab + sub_tiles);
  const int n_oct = sub_tiles / (2 * opr);
  float* om = edge + kFmWarps / 2 * 2 * 16 * 8 * 2;
  const bool staged = tap_bytes > 0;
  const uint2* b_hi = staged ? reinterpret_cast<const uint2*>(smem) : w_hi;
  const uint2* b_lo = staged
      ? reinterpret_cast<const uint2*>(smem + tap_bytes / 2) : w_lo;
  const long long carry_vals = (long long)cr * row;
  const long long total = carry_vals + (long long)rows * row;
  const int tiles = (rows + tr - 1) / tr;
  const int ks_per_row = row / 32;
  const long long units = (long long)n_sub * tiles;
  const int u0 = (int)(units * blockIdx.x / gridDim.x);
  const int u1 = (int)(units * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;

  int s = u0 / tiles;
  int tap0 = stage_sub<kMode, kNT>(smem, tap_bytes, w_hi, w_lo, ktab,
                                   sub_tiles, s, tab, omega, om, nr_ch, opr);
  stage_rows<kNT>(xs, carry, block, carry_vals, total,
                  (u0 - s * tiles) * tr - lb, x_rows, row, pitch);
  cp_async_commit();
  for (int u = u0, k = 0; u < u1; ++u, ++k) {
    const int t = u - s * tiles;
    const bool more = u + 1 < u1;
    const int sn = (u + 1) / tiles;
    const int tn = u + 1 - sn * tiles;
    const uint32_t xa = (uint32_t)__cvta_generic_to_shared(
        xs + (stages == 2 ? (size_t)(k & 1) * xb : 0))
        + imma::raw_lane_offset(pitch);
    if (stages == 2 && more) {
      stage_rows<kNT>(xs + (size_t)((k + 1) & 1) * xb, carry, block,
                      carry_vals, total, tn * tr - lb, x_rows, row, pitch);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = t * tr;
    const int n_out = min(tr, rows - r0);
    if constexpr (kMode == kFm) {
      fm_tile(xa, pitch, b_hi, b_lo, tap0, tab, ksteps, ks_per_row, tr, r0,
              n_out, s * n_oct * 8, n_oct, nr_ch, opr, rows, om, prev,
              static_cast<int16_t*>(out), prev_out, edge);
    } else if (staged) {
      exact_tile<kMode, true>(xa, pitch, b_hi, b_lo, tap0, tab, sub_tiles,
                              ksteps, ks_per_row, tr, r0, n_out,
                              s * sub_tiles, opr * nr_ch, rows, out);
    } else {
      exact_tile<kMode, false>(xa, pitch, b_hi, b_lo, tap0, tab, sub_tiles,
                               ksteps, ks_per_row, tr, r0, n_out,
                               s * sub_tiles, opr * nr_ch, rows, out);
    }
    __syncthreads();   // every warp is done with this buffer and the taps
    if (more && sn != s) {   // the next unit is in the next sub-block
      s = sn;
      tap0 = stage_sub<kMode, kNT>(smem, tap_bytes, w_hi, w_lo, ktab,
                                   sub_tiles, s, tab, omega, om, nr_ch, opr);
      cp_async_commit();
    }
    if (stages == 1 && more) {
      stage_rows<kNT>(xs, carry, block, carry_vals, total, tn * tr - lb,
                      x_rows, row, pitch);
      cp_async_commit();
    }
  }
}

// check the launch, raise the kernel's shared-memory ceiling once per
// device, and launch about as many blocks as fit on the card at once
template <int kMode>
int launch_bank(const void* carry, const void* block, const void* w_hi,
                const void* w_lo, const void* ktab, const void* omega,
                const void* prev, void* out, void* prev_out, int rows,
                int row, int cr, int u_len, int nr_ch, int opr,
                int sub_tiles, int tr, int stages, int tap_bytes,
                cudaStream_t stream) {
  constexpr int lb = kMode == kFm ? 1 : 0;
  const int group = kMode == kFm ? 2 : 4;
  if (rows <= 0 || tr <= 0 || (tr + lb) % 16 || row <= 0 || row % 32 ||
      u_len <= 0 || u_len > (cr + 1) * row || u_len > 32768 || nr_ch <= 0 ||
      opr <= 0 || sub_tiles <= 0 || sub_tiles % group || stages < 1 ||
      stages > 2 || tap_bytes < 0 || tap_bytes % 512 ||
      (uintptr_t)carry % 16 || (uintptr_t)block % 16 ||
      (uintptr_t)ktab % 16) {
    return (int)cudaErrorInvalidValue;
  }
  // beside taps and rows: the ktab rows, K1's edge phases and omega
  int n_sub, extra = sub_tiles * (int)sizeof(int4);
  if constexpr (kMode == kFm) {
    // taps staged; one item (m-tile, octet) a pair of warps
    if (sub_tiles % (2 * opr) || tap_bytes == 0 ||
        (tr + 1) / 16 * (sub_tiles / (2 * opr)) != kFmWarps / 2) {
      return (int)cudaErrorInvalidValue;
    }
    const int cpb = 8 * (sub_tiles / (2 * opr));
    n_sub = (nr_ch + cpb - 1) / cpb;
    extra += (kFmWarps / 2 * 2 * 16 * 8 * 2 + opr * cpb)
             * (int)sizeof(float);
  } else {
    n_sub = ((2 * opr * nr_ch + 7) / 8 + sub_tiles - 1) / sub_tiles;
  }
  const size_t smem = (size_t)tap_bytes
      + (size_t)stages * (tr + lb + cr) * row_pitch(row) + extra;
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  static int occ_smem[kMaxDevices] = {};
  static int occ[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(bank_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = (int)smem;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (occ_smem[dev] != (int)smem || occ[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[dev], bank_kernel<kMode>, block_threads<kMode>(), smem);
    if (err != cudaSuccess) return (int)err;
    if (occ[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem[dev] = (int)smem;
  }
  const long long units = (long long)n_sub * ((rows + tr - 1) / tr);
  const long long slots = (long long)sms[dev] * occ[dev];
  const int grid = (int)(units < slots ? units : slots);
  bank_kernel<kMode><<<grid, block_threads<kMode>(), smem, stream>>>(
      (const int16_t*)carry, (const int16_t*)block, (const uint2*)w_hi,
      (const uint2*)w_lo, (const int4*)ktab, (const float*)omega,
      (const float*)prev, out, (float*)prev_out, rows, row, cr,
      (u_len + 31) / 32, nr_ch, opr, sub_tiles, n_sub, tr, stages,
      tap_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: carry [cr*row] int16, block [rows*row] int16; w_hi/w_lo, ktab the
// split taps in the tap matrix's column order, k-permuted for load_a_raw,
// in groups of 4 n8 tiles and sub-blocks of sub_tiles tiles (ops/chain.py
// ExactTaps) -> out_mode 1: int16 [2, rows, opr*nr_ch] (the Q.28 -> Q.14
// rounded sums, a_re plane then a_im); out_mode 2: int32 [rows,
// 2*opr*nr_ch], the sums. tr % 16 == 0, row % 32 == 0, u_len <= min((cr +
// 1) * row, 32768), 16-byte aligned carry/block/ktab.
extern "C" int tsl_exact_fir(const void* carry, const void* block,
                             const void* w_hi, const void* w_lo,
                             const void* ktab, void* out, int rows, int row,
                             int cr, int u_len, int nr_ch, int opr,
                             int sub_tiles, int tr, int stages, int tap_bytes,
                             int out_mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_mode == kQ14) {
    return launch_bank<kQ14>(carry, block, w_hi, w_lo, ktab, nullptr,
                             nullptr, out, nullptr, rows, row, cr, u_len,
                             nr_ch, opr, sub_tiles, tr, stages, tap_bytes,
                             st);
  }
  if (out_mode == kRaw) {
    return launch_bank<kRaw>(carry, block, w_hi, w_lo, ktab, nullptr,
                             nullptr, out, nullptr, rows, row, cr, u_len,
                             nr_ch, opr, sub_tiles, tr, stages, tap_bytes,
                             st);
  }
  return (int)cudaErrorInvalidValue;
}

// K1 on wide banks: the same stream; taps in octet order (ops/chain.py
// octet_columns), groups of 2 n8 tiles (re, im of one phase of an octet),
// sub-blocks of sub_tiles = 2 * opr * octets tiles; omega [opr*nr_ch] f32,
// prev [2, nr_ch] f32 -> out [rows, opr*nr_ch] int16, prev_out [2, nr_ch]
// f32. (tr + 1) % 16 == 0; otherwise as tsl_exact_fir.
extern "C" int tsl_chain_fm_bank(const void* carry, const void* block,
                                 const void* w_hi, const void* w_lo,
                                 const void* ktab, const void* omega,
                                 const void* prev, void* out, void* prev_out,
                                 int rows, int row, int cr, int u_len,
                                 int nr_ch, int opr, int sub_tiles, int tr,
                                 int stages, int tap_bytes, void* stream) {
  return launch_bank<kFm>(carry, block, w_hi, w_lo, ktab, omega, prev, out,
                          prev_out, rows, row, cr, u_len, nr_ch, opr,
                          sub_tiles, tr, stages, tap_bytes,
                          (cudaStream_t)stream);
}
