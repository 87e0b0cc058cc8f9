// K8, the fast DC blocker: the float form of the reference's DC blocker
// over a block's DC-blocked channels of one length, in one launch.
//
// Replaces tsl_sdr_tpu/ops/dc_blocker.py:66-93 dc_blocker_step_fast, a
// lax.associative_scan (not Pallas) of the first-order IIR
//     y[n] = q*y[n-1] + (x[n] - x[n-1]),   q = 1 - p/2^14,
// with x = to_int16(row) (truncate, saturate), x[-1] the state's x_prev /
// 2^14 and y[-1] its y_prev; out = clamp(round(y)) to int16 (round half to
// even, as torch.round), new x_prev = x[K-1] * 2^14, new y_prev =
// round(y[K-1]). The port's plain version (ops/dc_blocker.py
// dc_block_fast_plain) is a chunked float64 scan from matrix products,
// some 57 torch ops a row. float64 throughout: in float32 the recurrence
// at pole 0.9999 drifts by whole LSB over a 54,400-sample block.
//
// What bounds it on the H100: bytes, 4 B in and 2 B out a sample (0.3 MB
// at the pager's one FLEX channel, 0.1 us), far below a launch's fixed
// cost. The recurrence is a chain of dependent float64 FMAs; a scan cuts
// it to a few short chains and a log-depth composition of affine maps.
//
// How the design responds: a row is spread over many CTAs, a chunk of
// kChunk = 2,048 samples each, with a single-pass chained scan
// (decoupled look-back). A CTA takes its (row, chunk) from a ticket, so
// it waits only on CTAs that have started (no deadlock whatever order
// the hardware runs CTAs in). Each thread owns kPer = 8 consecutive
// samples, loaded straight into registers (16 or 32 bytes a thread, the
// threads side by side, so a warp's loads are coalesced; the sample
// before them comes from the thread before through shared memory):
// (1) every thread runs its samples from y = 0, keeping the map
// y -> a*y + e; (2) the CTA scans the maps (warp shuffles, then across
// warps); the chunk's map is (q^2048, E), and q^2048 is the same for
// every full chunk, so a chunk publishes only E (with a tag); (3) warp 0
// finds the y entering the chunk: chunk c = 32 m + o composes the E of
// chunks 32 m .. c-1 (one a lane, waiting on each tag; a fixed-order
// shuffle scan) and applies them to the y entering chunk 32 m, which
// chunk 32 m publishes (the row's y_prev for m = 0); chunk 32 m itself
// composes the 32 chunks before it from the y entering chunk 32 (m - 1).
// So a chunk's y never depends on which predecessors happened to be
// done, and the output is the same on every run; (4) every thread reruns
// its samples from its carry and stores its rounded outputs from
// registers (16 bytes a thread). x[n-1] at a chunk's start is the previous input sample,
// read from the row, so y is the only carried dependency. The chunk that
// holds the row's last sample writes the new state.
//
// The look-back scratch (a 64-bit word, the launch's epoch above a
// 24-bit ticket, then a tagged (E) slot a chunk and a tagged (y) slot a
// group of 32 chunks; its size from tsl_dc_block_fast_scratch) lives for
// each (device, stream). One atomic add gives a CTA its ticket and the
// epoch; the CTA that takes the last ticket adds what carries the ticket
// back to 0 and the epoch on by one. A launch tags its slots with its
// epoch + 1, so slots left by an earlier launch never match (until the
// 40-bit epoch wraps, after 2^40 launches on one stream). The epoch
// lives on the device, so a launch replayed from a CUDA graph gets a new
// one too. No memset launch: the wrapper zeroes the scratch once, when
// it makes it. Only the sums' order differs from the plain version's, so
// the two agree within 1 LSB (a sample differs only where y lies within
// ~1e-11 of a half).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_table.cuh"

namespace {

constexpr int kRows = 64;          // rows a launch (the table's size)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // samples a thread (8 k)
constexpr int kChunk = kThreads * kPer;    // samples a CTA
constexpr int kGroup = 32;                 // chunks a look-back window
constexpr int kTicketBits = 24;            // a launch's CTAs < 2^24

struct DcStates {
  const int* x_prev[kRows];   // [] int32, Q.28
  const int* y_prev[kRows];   // [] int32
  double q[kRows];
  double q_chunk[kRows];      // q^kChunk, a full chunk's decay
};

struct Slot {
  unsigned long long tag;   // the launch's epoch + 1 once v is written
  double v;
};

// (a1, e1) then (a2, e2): y -> a2*(a1*y + e1) + e2
__device__ __forceinline__ void compose(double& a, double& e, double a2,
                                        double e2) {
  e = fma(a2, e, e2);
  a = a2 * a;
}

// inclusive scan of the lanes' maps, lane 0's applied first
__device__ __forceinline__ void scan_lanes(double& a, double& e, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double pa = __shfl_up_sync(0xFFFFFFFFu, a, off);
    const double pe = __shfl_up_sync(0xFFFFFFFFu, e, off);
    if (lane >= off) {
      double ca = pa, ce = pe;
      compose(ca, ce, a, e);
      a = ca;
      e = ce;
    }
  }
}

__device__ __forceinline__ void publish(Slot* s, double v,
                                        unsigned long long tag) {
  s->v = v;
  __threadfence();
  atomicExch(&s->tag, tag);
}

__device__ __forceinline__ double await(const Slot* s,
                                        unsigned long long tag) {
  while (*reinterpret_cast<const volatile unsigned long long*>(&s->tag) !=
         tag) {
    __nanosleep(32);
  }
  __threadfence();
  return *reinterpret_cast<const volatile double*>(&s->v);
}

// samples n .. n+kPer-1 of row g, cast to int16 values (the row has
// stride 1 and n is a multiple of 8 from a 16-byte aligned start when
// vec), eight at a time
__device__ __forceinline__ void load_run(const RowTable<kRows>& rows, int g,
                                         long long n, int cnt, bool vec,
                                         int x[kPer]) {
  if (vec && cnt == kPer) {
#pragma unroll
    for (int j = 0; j < kPer; j += 8) {
      if (rows.f32[g]) {
        const float4* p = reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(rows.ptr[g]) + n + j);
        const float4 f0 = __ldg(p), f1 = __ldg(p + 1);
        const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) x[j + i] = to_i16(f[i]);
      } else {
        const int4 w = __ldg(reinterpret_cast<const int4*>(
            reinterpret_cast<const int16_t*>(rows.ptr[g]) + n + j));
        const int h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[j + 2 * i] = (int16_t)(h[i] & 0xFFFF);
          x[j + 2 * i + 1] = h[i] >> 16;
        }
      }
    }
  } else {
    float f[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      f[i] = i < cnt ? row_value(rows, g, n + i) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[i] = to_i16(f[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
    dc_fast_kernel(const __grid_constant__ RowTable<kRows> rows,
                   const __grid_constant__ DcStates st, long long k, int nch,
                   int16_t* __restrict__ out, int* __restrict__ st_out,
                   unsigned long long* __restrict__ ticket,
                   Slot* __restrict__ agg, Slot* __restrict__ base) {
  __shared__ int xl[kThreads];   // each thread's last sample
  __shared__ double wa[kWarps], we[kWarps];
  __shared__ double s_x, s_y;    // x before the chunk, y entering it
  __shared__ int s_id;
  __shared__ unsigned long long s_tag;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const unsigned long long w = atomicAdd(ticket, 1ull);
    const unsigned id = (unsigned)(w & ((1ull << kTicketBits) - 1));
    if (id == gridDim.x - 1) {   // every CTA has its ticket and epoch
      atomicAdd(ticket, (1ull << kTicketBits) - gridDim.x);
    }
    s_id = (int)id;
    s_tag = (w >> kTicketBits) + 1;
  }
  __syncthreads();
  const unsigned long long tag = s_tag;
  const int g = s_id / nch, c = s_id % nch;
  const int ngroups = (nch + kGroup - 1) / kGroup;
  const long long c0 = (long long)c * kChunk;
  const int cn = (int)min((long long)kChunk, k - c0);
  const double q = st.q[g];

  // the thread's kPer samples, straight into registers (coalesced: the
  // threads' runs of 16 or 32 bytes lie side by side)
  const int lo = tid * kPer;
  const int cnt = max(0, min(kPer, cn - lo));
  const bool vec =
      rows.stride[g] == 1 &&
      (reinterpret_cast<uintptr_t>(rows.ptr[g]) & 15) == 0;
  int xr[kPer];
  load_run(rows, g, c0 + lo, cnt, vec, xr);
  xl[tid] = xr[kPer - 1];
  if (tid == 0) {
    s_x = c == 0 ? (double)*st.x_prev[g] * (1.0 / 16384.0)
                 : (double)to_i16(row_value(rows, g, c0 - 1));
  }
  __syncthreads();
  // sample lo - 1 is the last of the thread before (a whole run of kPer
  // wherever this thread has samples)
  const double x_in = tid == 0 ? s_x : (double)xl[tid - 1];

  // (1) the thread's samples from y = 0: its map y -> a*y + e
  double a = 1.0, e = 0.0, xp = x_in;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i < cnt) {
      const double x = (double)xr[i];
      e = fma(q, e, x - xp);
      a *= q;
      xp = x;
    }
  }

  // (2) inclusive scan of the maps over the threads, in order
  scan_lanes(a, e, lane);
  if (lane == 31) {
    wa[warp] = a;
    we[warp] = e;
  }
  __syncthreads();

  // (3) warp 0: the scan over the warps, the chunk's E published, then
  // the y entering the chunk
  if (warp == 0) {
    double ba = lane < kWarps ? wa[lane] : 1.0;
    double be = lane < kWarps ? we[lane] : 0.0;
    scan_lanes(ba, be, lane);
    if (lane < kWarps) {
      wa[lane] = ba;
      we[lane] = be;
    }
    const double chunk_e = __shfl_sync(0xFFFFFFFFu, be, kWarps - 1);
    if (lane == 0 && c + 1 < nch) {
      publish(&agg[(long long)g * nch + c], chunk_e, tag);
    }
    double y_in;
    if (c == 0) {
      y_in = (double)*st.y_prev[g];
    } else {
      const int o = c % kGroup;
      const int gb = o ? c - o : c - kGroup;   // the window's first chunk
      const int n = o ? o : kGroup;
      double la = 1.0, le = 0.0;
      if (lane < n) {
        la = st.q_chunk[g];
        le = await(&agg[(long long)g * nch + gb + lane], tag);
      }
      scan_lanes(la, le, lane);
      double yb = 0.0;
      if (lane == 0) {
        yb = gb == 0 ? (double)*st.y_prev[g]
                     : await(&base[(long long)g * ngroups + gb / kGroup], tag);
      }
      yb = __shfl_sync(0xFFFFFFFFu, yb, 0);
      la = __shfl_sync(0xFFFFFFFFu, la, n - 1);
      le = __shfl_sync(0xFFFFFFFFu, le, n - 1);
      y_in = fma(la, yb, le);
      if (o == 0 && lane == 0) {
        publish(&base[(long long)g * ngroups + c / kGroup], y_in, tag);
      }
    }
    if (lane == 0) s_y = y_in;
  }
  __syncthreads();

  // the maps before this thread's samples: the warps before, then the
  // lanes before within the warp
  double ea = 1.0, ee = 0.0;
  if (warp > 0) {
    ea = wa[warp - 1];
    ee = we[warp - 1];
  }
  const double la = __shfl_up_sync(0xFFFFFFFFu, a, 1);
  const double le = __shfl_up_sync(0xFFFFFFFFu, e, 1);
  if (lane > 0) compose(ea, ee, la, le);
  double y = fma(ea, s_y, ee);

  // (4) the samples again from their carry, the rounded outputs stored
  // from registers (16 bytes a thread where the row's start allows)
  int res[kPer];
  xp = x_in;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    res[i] = 0;
    if (i < cnt) {
      const double x = (double)xr[i];
      y = fma(q, y, x - xp);
      xp = x;
      // round half to even (saturating at the int32 range), then clamp
      res[i] = min(max(__double2int_rn(y), -32768), 32767);
    }
  }
  int16_t* o = out + (long long)g * k + c0 + lo;
  if (cnt == kPer && (k & 7) == 0) {
#pragma unroll
    for (int j = 0; j < kPer; j += 8) {
      int4 w;
      w.x = (res[j] & 0xFFFF) | (res[j + 1] << 16);
      w.y = (res[j + 2] & 0xFFFF) | (res[j + 3] << 16);
      w.z = (res[j + 4] & 0xFFFF) | (res[j + 5] << 16);
      w.w = (res[j + 6] & 0xFFFF) | (res[j + 7] << 16);
      *reinterpret_cast<int4*>(o + j) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) o[i] = (int16_t)res[i];
    }
  }
  if (c == nch - 1 && cnt > 0 && lo + cnt == cn) {
    st_out[2 * g] = (int)xp * 16384;
    st_out[2 * g + 1] = __double2int_rn(y);
  }
}

// the scratch's bytes: the ticket word (16 with its padding), then a slot
// a chunk and a slot a look-back window of kRows rows
long long scratch_bytes(long long k) {
  const long long nch = (k + kChunk - 1) / kChunk;
  return 16 + (long long)sizeof(Slot) * kRows * (nch + (nch + kGroup - 1) /
                                                          kGroup);
}

}  // namespace

// The bytes of look-back scratch tsl_dc_block_fast needs at k samples a
// row (zeroed once by the caller, then kept for the stream).
extern "C" long long tsl_dc_block_fast_scratch(long long k) {
  return k > 0 ? scratch_bytes(k) : 0;
}

// rows: n_rows (row pointer, stride in elements, float32 flag) triples of
// [k] samples (csrc/row_table.cuh); states: n_rows (x_prev, y_prev)
// device pointers to int32 scalars; q: n_rows poles (host arrays); out
// [n_rows, k] int16 (16-byte aligned); st_out [n_rows, 2] int32 (x_prev,
// y_prev); scratch: scratch_bytes of look-back scratch, zero when first
// used (cudaErrorInvalidValue if fewer); the stream. Launches once a
// kRows rows.
extern "C" int tsl_dc_block_fast(const long long* rows,
                                 const long long* states, const double* q,
                                 int n_rows, long long k, int16_t* out,
                                 int* st_out, char* scratch,
                                 long long scratch_len,
                                 cudaStream_t stream) {
  if (n_rows <= 0 || k <= 0 ||
      kRows * ((k + kChunk - 1) / kChunk) >= (1LL << kTicketBits) ||
      scratch_len < scratch_bytes(k)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nch = (int)((k + kChunk - 1) / kChunk);
  unsigned long long* ticket = (unsigned long long*)scratch;
  Slot* agg = (Slot*)(scratch + 16);
  Slot* base = agg + (size_t)kRows * nch;
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    const int n = n_rows - r0 < kRows ? n_rows - r0 : kRows;
    RowTable<kRows> table;
    fill_rows(table, rows + 3 * r0, n);
    DcStates st;
    for (int i = 0; i < n; ++i) {
      st.x_prev[i] = (const int*)states[2 * (r0 + i)];
      st.y_prev[i] = (const int*)states[2 * (r0 + i) + 1];
      st.q[i] = q[r0 + i];
      st.q_chunk[i] = pow(q[r0 + i], (double)kChunk);
    }
    dc_fast_kernel<<<n * nch, kThreads, 0, stream>>>(
        table, st, k, nch, out + (size_t)r0 * k, st_out + 2 * r0, ticket,
        agg, base);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
