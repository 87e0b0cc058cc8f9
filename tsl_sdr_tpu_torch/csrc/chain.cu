// K1: fused packed channelizer + FM discriminator, one block of rows: the
// tile body, for the launches whose taps fit in shared memory beside a
// tile (the pager block, multifm_rtlsdr_8ch) and those where not even the
// bank body (bank.cu, which K1 takes at BENCH_SUITE's 16-256 channels and
// K5 at every shape) keeps them resident (decimation 50, the Airspy band's
// 232 channels).
//
// Replaces the TPU kernels in tsl_sdr_tpu/ops/pallas_chain.py:
// _chain_kernel_v2 + _chain_body + _chain_call_v2 (the zero-copy form) and
// _chain_kernel + _chain_call (the padded form for blocks that are not a
// whole number of tiles), in both forms of their FIR body _fir_acc: the
// chunked one and the phase-grouped windowed one that wide banks take
// (_fir_acc with gspec, :167-196; its XLA twin is packed_fir.py
// _grouped_matmul). Here one kernel covers all of them: the last tile is
// masked, the stream carry and the block are read through two pointers,
// so nothing is concatenated or padded in device memory, and the grouped
// form is a table of k-ranges, not a second body.
//
// What it computes (tsl_sdr_tpu/ops/packed_fir.py:335-403 and
// ops/fm.py:66-142): the stream S = carry (cr rows) ++ block (rows rows) of
// ROW int16 values per row; output row r has the int32 accumulators
//     acc[r, c] = sum_{u < U} S[r*ROW + u] * W[u, c]      c < 2*HC
// (columns [re | im], flat (k, ch) order inside each half), then per output
// (r, c < HC) the conjugate product with the previous sample of the same
// channel (flat index - C; the state prev[] for the first one), the
// polynomial atan2 of the TPU kernel, + omega, wrap to (-pi, pi], the
// zero-power guard and trunc(phi / pi * 16384). Column (re/im, j, ch) of W
// is zero outside the 2T values from 2*D*j on (phase j's window).
//
// What bounds it on the H100: operations, counting each column's 2T
// non-zero taps only. At the 8-channel pager width (ROW=128, U=1218, HC=32,
// 577 taps) a 4,177,920-sample block is 65,280 rows x 64 columns x 1,154 =
// 4.82 G int16 multiply-adds: 9.7 us at the int8 tensor-core peak with four
// byte products a multiply-add, against 16.7 MB in and 4.2 MB out (6.2 us
// of memory). At 64 channels of 1 Msps / 40 / 128 taps a 16,711,680-sample
// block is 52,224 rows x 1,024 x 256 = 13.7 G: 55 us (120 MB, 36 us).
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
// multiple of 128 bytes ldmatrix's 8 rows would share 4 banks).
//   Structural zeros: each 8-column tile of W runs only the 32-value
// k-steps of its table entry (ktab: first, end). Grouped, that is the steps
// that hold the tile's non-zero taps, a phase's window rounded out to 32 (9
// of 26 steps at 64 channels of 128 taps): the grouped branch at the
// card's own granularity, an n8 tile, where the TPU needed g*2C >= 128
// lanes a group. Chunked, every tile runs all of them. A warp owns two
// 16-row m-tiles and a group of 4 n8 tiles, loops over the union of their
// ranges and issues a tile's products only inside its own, so each B
// fragment feeds up to 8 IMMA products; where the 4 tiles share one range
// (every chunked tile; grouped, 4 tiles of one phase) the loop tests
// nothing a step. The split taps keep each group's steps only, its 4
// tiles side by side a step, so a warp reads a step's 4 fragments from one
// address (with 4 per-tile addresses the pager block ran slower); they are
// staged in shared memory when they fit (80 KB at the pager width), else
// read from L2. Integer sums do not depend on order, so both forms give
// the same bits.
//   Wide banks: the FM epilogue keeps the block's f32 accumulators in
// shared memory, [TR + 1, 2 x outputs a row], which at 256 channels does
// not fit beside even 16 rows. So grid.x runs over channel blocks: block b
// owns channels [b*cpb, (b+1)*cpb) of every phase, its columns contiguous
// in W (the host permutes them: [re | im] x phase x channel, whole n8
// tiles), and writes its outputs by computed index into the usual layout.
// An output's FM history is the flat index minus C, the same channel one
// phase back or phase opr-1 of the look-back row, so a block needs nothing
// from another. grid.x is the fastest axis: the blocks that stage the same
// rows run together and find them in L2. One block of all channels where
// it fits (every shape before wide banks keeps its launch); else the widest
// block beside 32 rows, since then the taps come from L2 once a tile and a
// channel block, so their traffic a row falls with TR. TR + 1 (the
// tile's rows and its look-back row) is a multiple of 16 (32 or more where
// shared memory allows: at decimation 50 a row is 3,200 values and only 16
// rows fit); each tile recomputes its own look-back row for the FM
// history of its first row, so tiles run in any order.
//
// Numerics: the FM stage is fm.cuh's, bit for bit the plain torch version
// whenever the int32 accumulators agree (always: integer sums are exact).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fm.cuh"
#include "imma_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPitchPad = 16;   // bytes past ROW per staged row
constexpr int kNtG = 4;         // n8 tiles a warp owns at a time
constexpr int kBatch = 4;       // staging loads a thread keeps in flight
constexpr int kSmemCap = 227 * 1024;
constexpr int kMaxGridY = 65535;

// staged stream rows: high and low byte planes
__host__ __device__ size_t x_bytes(int tr, int row, int cr) {
  return 2 * (size_t)(tr + 1 + cr) * (row + kPitchPad);
}

// the FM accumulators of a channel block: hcb = opr * cpb columns a half
__host__ __device__ size_t acc_bytes(int tr, int hcb) {
  return 2 * (size_t)(tr + 1) * hcb * sizeof(float);
}

// local column rem = j * cpb + cl of a half of channel block c0 -> the
// output column j * nr_ch + c0 + cl, or -1 for a padding channel; one block
// of all channels is already in that order (no divide)
__device__ __forceinline__ int global_col(int rem, int c0, int cpb,
                                          int nr_ch) {
  if (cpb == nr_ch) return rem;
  const int j = rem / cpb;
  const int c = c0 + rem - j * cpb;
  return c < nr_ch ? j * nr_ch + c : -1;
}

// one work item's n8 tiles: each tile's k-steps [lo, hi); the fragment of
// step ks of tile j is base + kNtG * ks + j (a group's tiles side by side a
// step, one address for all four); the tiles below n_valid exist; the item
// runs the union [ks_lo, ks_hi) of the ranges
struct KRange {
  int lo[kNtG], hi[kNtG];
  int base, n_valid, ks_lo, ks_hi, ks_per_row, lane;
};

// the item's products: kTwo, two 16-row m-tiles from local row lr0 (else
// one); kOwn, each tile's products only inside its own range (else every
// tile below n_valid runs every step: the branch-free loop)
template <bool kTwo, bool kOwn>
__device__ __forceinline__ void k_loop(imma::Acc (&acc)[2][kNtG],
                                       const uint8_t* x_hi,
                                       const uint8_t* x_lo, int pitch,
                                       int lr0, const uint2* b_hi,
                                       const uint2* b_lo, const KRange& kr) {
  // tap u = 32 * ks = ROW * q + 32 * kk; the inner loop runs along one
  // staged row
  int ks = kr.ks_lo;
  for (int q = ks / kr.ks_per_row; ks < kr.ks_hi; ++q) {
    for (int kk = ks - q * kr.ks_per_row;
         kk < kr.ks_per_row && ks < kr.ks_hi; ++kk, ++ks) {
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      imma::load_a(ah0, x_hi, pitch, lr0 + q, 32 * kk);
      imma::load_a(al0, x_lo, pitch, lr0 + q, 32 * kk);
      if constexpr (kTwo) {
        imma::load_a(ah1, x_hi, pitch, lr0 + 16 + q, 32 * kk);
        imma::load_a(al1, x_lo, pitch, lr0 + 16 + q, 32 * kk);
      }
#pragma unroll
      for (int j = 0; j < kNtG; ++j) {
        const bool on = kOwn ? ks >= kr.lo[j] && ks < kr.hi[j]
                             : j < kr.n_valid;
        if (on) {
          const size_t f = ((size_t)(kr.base + kNtG * ks) + j) * 32 + kr.lane;
          const uint2 bh = b_hi[f], bl = b_lo[f];
          imma::mma_split(acc[0][j], ah0, al0, bh, bl);
          if constexpr (kTwo) imma::mma_split(acc[1][j], ah1, al1, bh, bl);
        }
      }
    }
  }
}

// grid = (channel blocks, row tiles from tile0); tile t owns output rows
// [t*tr, t*tr + tr) of channels [c0, c0 + cpb) and recomputes the
// accumulators of row t*tr - 1 (the look-back row) for the FM history of
// its first row. Channel block b's tap columns are its ntb n8 tiles from
// b*ntb on (local column (re/im, j, cl) at (re/im * opr + j) * cpb + cl);
// ktab[tile] = (first k-step, end k-step, its group's base in w_hi/w_lo,
// end of its block's fragments): the tiles come in groups of kNtG, a
// group's fragments step after step, its tiles side by side, and a
// block's groups one after another (ops/chain.py ChainTaps). stage_taps:
// copy the block's tap fragments to shared memory (else they are read from
// device memory through L2). out: int16 [rows, hc].
__global__ void __launch_bounds__(kThreads)
chain_kernel(const int16_t* __restrict__ carry,
             const int16_t* __restrict__ block,
             const uint2* __restrict__ w_hi,
             const uint2* __restrict__ w_lo,
             const int4* __restrict__ ktab,
             const float* __restrict__ omega,
             const float* __restrict__ prev,
             int16_t* __restrict__ out,
             float* __restrict__ prev_out,
             int rows, int row, int cr, int ksteps, int nr_ch, int opr,
             int cpb, int tr, int tile0, int stage_taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = row + kPitchPad;
  const int x_rows = tr + 1 + cr;
  const int hc = opr * nr_ch;          // output columns a half
  const int hcb = opr * cpb;           // ... of this channel block
  const int ntb = (2 * hcb + 7) / 8;   // its n8 tiles
  const int c0 = blockIdx.x * cpb;
  const int4* tab = ktab + (size_t)blockIdx.x * ntb;
  uint8_t* x_hi = smem;
  uint8_t* x_lo = smem + (size_t)x_rows * pitch;
  float* acc_re = reinterpret_cast<float*>(smem + x_bytes(tr, row, cr));
  float* acc_im = acc_re + (size_t)(tr + 1) * hcb;
  const uint2* b_hi = w_hi;
  const uint2* b_lo = w_lo;

  const int r0 = (tile0 + blockIdx.y) * tr;
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
  // the block's tap fragments are contiguous, from the end of the previous
  // block's to the end of its own
  int tap0 = 0;
  if (stage_taps) {
    tap0 = blockIdx.x > 0 ? tab[-1].w : 0;
    const int n16 = (tab[0].w - tap0) * 16;   // 16-byte words per plane
    uint4* t_hi = reinterpret_cast<uint4*>(
        smem + x_bytes(tr, row, cr) + acc_bytes(tr, hcb));
    uint4* t_lo = t_hi + n16;
    const uint4* g_hi = reinterpret_cast<const uint4*>(w_hi) + 16LL * tap0;
    const uint4* g_lo = reinterpret_cast<const uint4*>(w_lo) + 16LL * tap0;
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
  const int n_groups = (ntb + kNtG - 1) / kNtG;
  const int ks_per_row = row / 32;
  for (int item = warp; item < n_pairs * n_groups; item += kThreads / 32) {
    const int lr0 = (item / n_groups) * 32;
    const bool two = lr0 + 16 < tr + 1;
    const int nt0 = (item % n_groups) * kNtG;
    KRange kr;
    kr.n_valid = min(kNtG, ntb - nt0);
    kr.base = tab[nt0].z - tap0;
    kr.ks_lo = ksteps;
    kr.ks_hi = 0;
    kr.ks_per_row = ks_per_row;
    kr.lane = lane;
#pragma unroll
    for (int j = 0; j < kNtG; ++j) {
      kr.lo[j] = kr.hi[j] = 0;
      if (j < kr.n_valid) {
        const int4 e = tab[nt0 + j];
        kr.lo[j] = e.x;
        kr.hi[j] = min(e.y, ksteps);
        if (kr.lo[j] < kr.hi[j]) {
          kr.ks_lo = min(kr.ks_lo, kr.lo[j]);
          kr.ks_hi = max(kr.ks_hi, kr.hi[j]);
        }
      }
    }
    // the item's tiles share one range (every chunked tile, and a grouped
    // group of tiles inside one phase): no test a tile and k-step
    bool same = true;
#pragma unroll
    for (int j = 0; j < kNtG; ++j) {
      if (j < kr.n_valid && (kr.lo[j] != kr.ks_lo || kr.hi[j] != kr.ks_hi)) {
        same = false;
      }
    }
    imma::Acc acc[2][kNtG];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kNtG; ++j) imma::zero(acc[h][j]);
    }
    if (two) {
      if (same) {
        k_loop<true, false>(acc, x_hi, x_lo, pitch, lr0, b_hi, b_lo, kr);
      } else {
        k_loop<true, true>(acc, x_hi, x_lo, pitch, lr0, b_hi, b_lo, kr);
      }
    } else if (same) {
      k_loop<false, false>(acc, x_hi, x_lo, pitch, lr0, b_hi, b_lo, kr);
    } else {
      k_loop<false, true>(acc, x_hi, x_lo, pitch, lr0, b_hi, b_lo, kr);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < kNtG; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = lr0 + 16 * h + (lane >> 2) + (i >> 1) * 8;
          const int lc = (nt0 + j) * 8 + (lane & 3) * 2 + (i & 1);
          if (lc >= 2 * hcb) continue;   // padding of the last n8 tile
          const int ri = lc >= hcb ? 1 : 0;
          const int rem = lc - ri * hcb;   // (j, cl) in the block's half
          const int sum = (int)imma::combine(acc[h][j], i);
          (ri ? acc_im : acc_re)[lr * hcb + rem] = __int2float_rn(sum);
        }
      }
    }
  }
  __syncthreads();

  // output (lr, j, c): its history is (lr, j - 1, c), or (lr - 1, opr - 1,
  // c) for phase 0, both in this block's accumulators
  for (int item = threadIdx.x; item < n_out * hcb; item += blockDim.x) {
    const int lr = 1 + item / hcb;
    const int rem = item - (lr - 1) * hcb;
    const int col = global_col(rem, c0, cpb, nr_ch);
    if (col < 0) continue;
    float pr, pi;
    if (rem >= cpb) {
      pr = acc_re[lr * hcb + rem - cpb];
      pi = acc_im[lr * hcb + rem - cpb];
    } else if (r0 + lr - 1 > 0) {
      pr = acc_re[(lr - 1) * hcb + rem + hcb - cpb];
      pi = acc_im[(lr - 1) * hcb + rem + hcb - cpb];
    } else {
      pr = prev[c0 + rem];
      pi = prev[nr_ch + c0 + rem];
    }
    out[(size_t)(r0 + lr - 1) * hc + col] =
        fm::fm_pcm(acc_re[lr * hcb + rem], acc_im[lr * hcb + rem], pr, pi,
               omega[col]);
  }
  // the last output row's baseband seeds the next block's FM history
  if (r0 + n_out == rows) {
    for (int cl = threadIdx.x; cl < cpb && c0 + cl < nr_ch;
         cl += blockDim.x) {
      prev_out[c0 + cl] = acc_re[n_out * hcb + hcb - cpb + cl];
      prev_out[nr_ch + c0 + cl] = acc_im[n_out * hcb + hcb - cpb + cl];
    }
  }
}

// raise the kernel's shared-memory ceiling once per device (the attribute
// applies to the current device only), not on every launch; then launch,
// in runs of at most kMaxGridY row tiles
int launch(const void* carry, const void* block, const void* w_hi,
           const void* w_lo, const void* ktab, const void* omega,
           const void* prev, void* out, void* prev_out, int rows, int row,
           int cr, int u_len, int nr_ch, int opr, int cpb, int tr,
           int tap_bytes, cudaStream_t stream) {
  if (rows <= 0 || tr <= 0 || (tr + 1) % 16 || row <= 0 || row % 32 ||
      u_len <= 0 || u_len > (cr + 1) * row || u_len > 32768 || nr_ch <= 0 ||
      opr <= 0 || cpb <= 0 || cpb > nr_ch || tap_bytes < 0 ||
      tap_bytes % 512 || (uintptr_t)carry % 16 || (uintptr_t)block % 16 ||
      (uintptr_t)ktab % 16) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = x_bytes(tr, row, cr) + acc_bytes(tr, opr * cpb);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  const int stage_taps = smem + tap_bytes <= kSmemCap ? 1 : 0;
  if (stage_taps) smem += tap_bytes;
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || (int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = (int)smem;
  }
  const int n_blocks = (nr_ch + cpb - 1) / cpb;
  const int tiles = (rows + tr - 1) / tr;
  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
    const int run = tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY;
    const dim3 grid(n_blocks, run);
    chain_kernel<<<grid, kThreads, smem, stream>>>(
        (const int16_t*)carry, (const int16_t*)block, (const uint2*)w_hi,
        (const uint2*)w_lo, (const int4*)ktab, (const float*)omega,
        (const float*)prev, (int16_t*)out, (float*)prev_out, rows, row, cr,
        (u_len + 31) / 32, nr_ch, opr, cpb, tr, t0, stage_taps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// carry [cr*row] int16, block [rows*row] int16; w_hi/w_lo the split taps in
// channel blocks of cpb channels, each n8 tile's k-steps only ([L, 32, 8]
// bytes) and ktab [tiles, 4] int32 (ops/chain.py ChainTaps); tap_bytes what
// the widest block's fragments take in shared memory (staged when they fit
// beside the tile); omega [opr*nr_ch] f32, prev [2, nr_ch] f32 -> out
// [rows, opr*nr_ch] int16, prev_out [2, nr_ch] f32. Needs (tr + 1) % 16 ==
// 0, row % 32 == 0, u_len <= min((cr + 1) * row, 32768) and 16-byte
// aligned carry/block/ktab pointers.
extern "C" int tsl_chain_fm(const void* carry, const void* block,
                            const void* w_hi, const void* w_lo,
                            const void* ktab, const void* omega,
                            const void* prev, void* out, void* prev_out,
                            int rows, int row, int cr, int u_len, int nr_ch,
                            int opr, int cpb, int tr, int tap_bytes,
                            void* stream) {
  return launch(carry, block, w_hi, w_lo, ktab, omega, prev, out, prev_out,
                rows, row, cr, u_len, nr_ch, opr, cpb, tr, tap_bytes,
                (cudaStream_t)stream);
}

extern "C" const char* tsl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
