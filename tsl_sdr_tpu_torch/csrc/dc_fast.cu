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
// What bounds it on the H100: latency. The bytes (4 B in, 2 B out a
// sample: 0.3 MB at the pager's one FLEX channel) take 0.1 us; the
// recurrence is a chain of dependent float64 FMAs, which a chunked scan
// cuts to two chunks' worth a thread plus a log-depth scan.
//
// How the design responds: a CTA a row, kThreads threads. The row goes
// through in segments of kSeg samples, each loaded whole (coalesced, cast
// to int16) into shared memory, where every thread owns kPer consecutive
// samples (kept in registers after their first read; the shared layout
// pads a word every 16 samples, so the threads' strided reads fall in
// distinct banks): (1) every thread runs its chunk serially from y = 0,
// keeping its end value e and q^len; (2) the CTA scans the affine maps
// y -> q^len*y + e (warp shuffles, then across warps in shared memory)
// for the value entering each chunk from the segment's carry; (3) every
// thread reruns its chunk from that value and writes the rounded outputs
// over its samples, and the CTA stores the segment (coalesced). The last
// sample's x and y carry to the next segment. A first version that read
// the row from device memory in each thread's chunk (54 samples a thread,
// strided) took 0.068 ms a pager row on an H100, as long as the plain
// version's matrix products; staging the segments took it to 0.032 (one
// SM's float64 pipe, conversions included, now bounds it: a row runs on
// one CTA). Only the sums' order differs from the plain
// version's, so the two agree within 1 LSB (a sample differs only where y
// lies within ~1e-11 of a half).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_table.cuh"

namespace {

constexpr int kRows = 64;         // rows a launch (the table's size)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                  // samples a thread a segment
constexpr int kSeg = kThreads * kPer;     // samples a segment

struct DcStates {
  const int* x_prev[kRows];   // [] int32, Q.28
  const int* y_prev[kRows];   // [] int32
  double q[kRows];
};

// sample n's place in the staged segment: a word of padding every 16
// samples, so thread t's n = 16 t + i sits in bank (9 t + i / 2) % 32
__device__ __forceinline__ int slot(int n) { return n + 2 * (n >> 4); }

// (a1, e1) then (a2, e2): y -> a2*(a1*y + e1) + e2
__device__ __forceinline__ void compose(double& a, double& e, double a2,
                                        double e2) {
  e = fma(a2, e, e2);
  a = a2 * a;
}

__global__ void __launch_bounds__(kThreads)
    dc_fast_kernel(const __grid_constant__ RowTable<kRows> rows,
                   const __grid_constant__ DcStates st, long long k,
                   int16_t* __restrict__ out, int* __restrict__ st_out) {
  __shared__ int16_t xs[kSeg + kSeg / 8];
  __shared__ double wa[kWarps], we[kWarps];
  __shared__ double cx, cy;   // x and y before the segment
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const double q = st.q[g];
  int16_t* o = out + (long long)g * k;
  if (tid == 0) {
    cx = (double)*st.x_prev[g] * (1.0 / 16384.0);
    cy = (double)*st.y_prev[g];
  }
  for (long long s0 = 0; s0 < k; s0 += kSeg) {
    const int sn = (int)min((long long)kSeg, k - s0);
    // all of a thread's loads in flight at once, then their casts
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      v[j] = i < sn ? row_value(rows, g, s0 + i) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < sn) xs[slot(i)] = (int16_t)to_i16(v[j]);
    }
    __syncthreads();
    const int lo = min(sn, tid * kPer);
    const int cnt = min(sn - lo, kPer);
    const double x_in = lo == 0 ? cx : (double)xs[slot(lo - 1)];

    // (1) the chunk from y = 0: its map y -> a*y + e
    int xr[kPer];
    double a = 1.0, e = 0.0, xp = x_in;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        xr[i] = xs[slot(lo + i)];
        const double x = (double)xr[i];
        e = fma(q, e, x - xp);
        a *= q;
        xp = x;
      }
    }

    // (2) inclusive scan of the maps over the threads, in order
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
    if (lane == 31) {
      wa[warp] = a;
      we[warp] = e;
    }
    __syncthreads();
    if (warp == 0) {
      double ba = wa[lane], be = we[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double pa = __shfl_up_sync(0xFFFFFFFFu, ba, off);
        const double pe = __shfl_up_sync(0xFFFFFFFFu, be, off);
        if (lane >= off) {
          double ca = pa, ce = pe;
          compose(ca, ce, ba, be);
          ba = ca;
          be = ce;
        }
      }
      wa[lane] = ba;
      we[lane] = be;
    }
    __syncthreads();
    // the maps before this thread's chunk: the warps before, then the
    // lanes before within the warp
    double ea = 1.0, ee = 0.0;
    if (warp > 0) {
      ea = wa[warp - 1];
      ee = we[warp - 1];
    }
    const double la = __shfl_up_sync(0xFFFFFFFFu, a, 1);
    const double le = __shfl_up_sync(0xFFFFFFFFu, e, 1);
    if (lane > 0) compose(ea, ee, la, le);
    double y = fma(ea, cy, ee);
    __syncthreads();   // every thread has read cx, cy and its x_in

    // (3) the chunk again from its carry, the outputs over its samples
    xp = x_in;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        const double x = (double)xr[i];
        y = fma(q, y, x - xp);
        xp = x;
        // round half to even (saturating at the int32 range), then clamp
        xs[slot(lo + i)] = (int16_t)min(max(__double2int_rn(y), -32768),
                                        32767);
      }
    }
    if (cnt > 0 && lo + cnt == sn) {
      cx = xp;
      cy = y;
      if (s0 + sn == k) {
        st_out[2 * g] = (int)xp * 16384;
        st_out[2 * g + 1] = __double2int_rn(y);
      }
    }
    __syncthreads();
    for (int i = tid; i < sn; i += kThreads) o[s0 + i] = xs[slot(i)];
    __syncthreads();
  }
}

}  // namespace

// rows: n_rows pointers, strides (elements) and float32 flags (host
// arrays) of [k] samples; x_prev, y_prev: n_rows device pointers to int32
// scalars (host arrays); q: n_rows poles (host array); out [n_rows, k]
// int16; st_out [n_rows, 2] int32 (x_prev, y_prev). Launches once a kRows
// rows.
extern "C" int tsl_dc_block_fast(const long long* ptrs,
                                 const long long* strides, const int* f32,
                                 const long long* x_prev,
                                 const long long* y_prev, const double* q,
                                 int n_rows, long long k, void* out,
                                 void* st_out, void* stream) {
  if (n_rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    const int n = n_rows - r0 < kRows ? n_rows - r0 : kRows;
    RowTable<kRows> table;
    fill_rows(table, ptrs + r0, strides + r0, f32 + r0, n);
    DcStates st;
    for (int i = 0; i < n; ++i) {
      st.x_prev[i] = (const int*)x_prev[r0 + i];
      st.y_prev[i] = (const int*)y_prev[r0 + i];
      st.q[i] = q[r0 + i];
    }
    dc_fast_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        table, st, k, (int16_t*)out + (size_t)r0 * k,
        (int*)st_out + 2 * r0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
