// The exact DC blocker: the reference's integer recurrence, one warp per
// stream, only its dependent chain run serially.
//
// Not a TPU kernel: the JAX package runs this as a lax.scan
// (tsl_sdr_tpu/ops/dc_blocker.py:49-63 dc_blocker_step_exact, the default
// DC tier of decoder-tpu -b and resampler-tpu -b). Torch has no op for it:
// the recurrence (reference filter/dc_blocker.h:72-93), all int32,
//     acc -= x_prev; x_prev = s << 14; acc += x_prev - p * y_prev;
//     y_prev = acc >> 14; out = (int16) y_prev
// is serial, and the >> 14 makes it non-associative, so no scan can split
// it. Reordered (addition mod 2^32 is order-free) it is
//     d_n = (x_n << 14) - (x_{n-1} << 14);  acc = (acc + d_n) - p * y;
//     y = acc >> 14
// where d_n does not depend on the chain (for n = 0 the state's x_prev,
// already Q.28, stands for x_{-1} << 14), and y starts from the state's
// y_prev, not from acc >> 14: the state is an input, and the two need not
// agree. The wrap is done in unsigned arithmetic (signed overflow is
// undefined in C++), the shift right on the signed value (arithmetic, as
// XLA's). The state [G, 3] int32 (x_prev, y_prev, acc) is read at the
// start and written back at the end, so blocks chain.
//
// What bounds it on the H100: latency. Each turn is two dependent integer
// instructions, SHF (y = acc >> 14) then IMAD (acc = t - p * y, with t =
// acc + d_n issued beside the SHF), so n samples take at least n times
// their summed latency; chip_smoke.py measures one turn's cycles with
// bench/dc_chain_probe.cu (the same chain, dc_chain.cuh, on registers
// alone) and reads the SHF/IMAD pair from its compiled SASS. The bytes
// (2n in, 2n out) take a thousandth of that.
//
// How the design responds: a warp takes a stream and walks it in chunks
// of kChunk samples on the row's 16-byte grid. Its lanes load a chunk
// with 16-byte loads into shared memory, compute every d_n of the chunk in
// parallel (8 a lane), and issue the next chunk's loads; then lane 0 runs
// the chain alone, in runs of kRun samples whose d it reads from shared
// memory one run ahead (16-byte loads), writing y back over the chunk's
// samples; the warp then stores the chunk with 16-byte stores. Nothing in
// the serial loop waits on device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dc_chain.cuh"

namespace {

constexpr int kChunk = 2048;            // samples a warp stages at a time
constexpr int kPer = kChunk / 8 / 32;   // 16-byte groups a lane loads
constexpr int kRun = 16;                // samples of one unrolled chain run

// 8 samples of a stream from sample s on (zeros outside [0, n)); xg + s
// is 16-byte aligned, and a chunk's ragged edges go sample by sample
__device__ __forceinline__ uint4 load8(const int16_t* xg, long long n,
                                       long long s) {
  if (s >= 0 && s + 8 <= n) {
    return __ldg(reinterpret_cast<const uint4*>(xg + s));
  }
  unsigned h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long si = s + i;
    h[i] = si >= 0 && si < n ? (unsigned short)__ldg(xg + si) : 0u;
  }
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                    h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

__device__ __forceinline__ void load_run(unsigned (&d)[kRun],
                                         const unsigned* ds) {
#pragma unroll
  for (int j = 0; j < kRun / 4; ++j) {
    const uint4 t = reinterpret_cast<const uint4*>(ds)[j];
    d[4 * j] = t.x;
    d[4 * j + 1] = t.y;
    d[4 * j + 2] = t.z;
    d[4 * j + 3] = t.w;
  }
}

// one run of kRun turns on d, its y written to ys as two 16-byte stores
__device__ __forceinline__ void run(const unsigned (&d)[kRun], int16_t* ys,
                                    unsigned& acc, int& y, unsigned neg_p) {
  unsigned pk[kRun / 2];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    turn(acc, y, d[k], neg_p);
    if (k & 1) {
      pk[k >> 1] |= (unsigned)y << 16;
    } else {
      pk[k >> 1] = (unsigned)y & 0xFFFFu;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(ys);
  dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
}

// lane 0's part: the chain over samples [lo, hi) of the staged chunk,
// reading ds, writing (int16) y into ys. Runs alternate between two
// register sets, each loaded a run ahead (ds holds kRun samples of padding
// for the load past the last run).
__device__ __forceinline__ void chain(const unsigned* ds, int16_t* ys,
                                      int lo, int hi, unsigned& acc, int& y,
                                      unsigned neg_p) {
  int i = lo;
  const int head = min(hi, (lo + kRun - 1) / kRun * kRun);
  for (; i < head; ++i) {
    turn(acc, y, ds[i], neg_p);
    ys[i] = (int16_t)y;
  }
  const int end = i + (hi - i) / kRun * kRun;
  if (i < end) {
    unsigned d0[kRun], d1[kRun];
    load_run(d0, ds + i);
    for (; i + 2 * kRun <= end; i += 2 * kRun) {
      load_run(d1, ds + i + kRun);
      run(d0, ys + i, acc, y, neg_p);
      load_run(d0, ds + i + 2 * kRun);
      run(d1, ys + i + kRun, acc, y, neg_p);
    }
    if (i < end) {
      run(d0, ys + i, acc, y, neg_p);
      i += kRun;
    }
  }
  for (; i < hi; ++i) {
    turn(acc, y, ds[i], neg_p);
    ys[i] = (int16_t)y;
  }
}

// grid = G, block = one warp
__global__ void __launch_bounds__(32)
dc_block_exact_kernel(const int16_t* __restrict__ x,
                      int16_t* __restrict__ out, int* __restrict__ state,
                      long long n, int p) {
  __shared__ __align__(16) int16_t xs[kChunk];           // x, then y
  __shared__ __align__(16) unsigned ds[kChunk + kRun];   // d_n
  const int g = blockIdx.x, lane = threadIdx.x;
  const int16_t* xg = x + (size_t)g * n;
  int16_t* og = out + (size_t)g * n;
  // chunk c holds samples [c*kChunk - ax, (c+1)*kChunk - ax), so its
  // 8-sample groups are 16-byte aligned in x (and in out when out's row
  // has x's alignment)
  const int ax = (int)(((uintptr_t)xg >> 1) & 7);
  const bool vec_out = (int)(((uintptr_t)og >> 1) & 7) == ax;
  unsigned x_prev = (unsigned)state[3 * g];
  int y = state[3 * g + 1];
  unsigned acc = (unsigned)state[3 * g + 2];
  const unsigned neg_p = 0u - (unsigned)p;
  const long long chunks = n > 0 ? (n + ax + kChunk - 1) / kChunk : 0;

  uint4 v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    v[u] = load8(xg, n, 8LL * (lane + 32 * u) - ax);
  }
  for (long long c = 0; c < chunks; ++c) {
    const long long base = c * kChunk - ax;
    const int lo = base < 0 ? (int)-base : 0;
    const int hi = (int)min((long long)kChunk, n - base);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      reinterpret_cast<uint4*>(xs)[lane + 32 * u] = v[u];
    }
    __syncwarp();
    // d of the chunk's samples, 8 a lane at a time (one 16-byte load, two
    // 16-byte stores for a group inside [lo, hi))
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i0 = 8 * (lane + 32 * u);
      if (i0 + 8 <= lo || i0 >= hi) continue;
      const uint4 xv = reinterpret_cast<const uint4*>(xs)[lane + 32 * u];
      const unsigned w[4] = {xv.x, xv.y, xv.z, xv.w};
      unsigned prev = i0 > lo ? (unsigned)(int)xs[i0 - 1] << 14 : 0u;
      unsigned d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int16_t xk = (int16_t)(w[k >> 1] >> (16 * (k & 1)));
        const unsigned cur = (unsigned)(int)xk << 14;
        d[k] = cur - (i0 + k == lo ? x_prev : prev);
        prev = cur;
      }
      if (i0 >= lo && i0 + 8 <= hi) {
        uint4* dst = reinterpret_cast<uint4*>(ds + i0);
        dst[0] = make_uint4(d[0], d[1], d[2], d[3]);
        dst[1] = make_uint4(d[4], d[5], d[6], d[7]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (i0 + k >= lo && i0 + k < hi) ds[i0 + k] = d[k];
        }
      }
    }
    x_prev = (unsigned)(int)xs[hi - 1] << 14;
    // the next chunk's loads go in flight while lane 0 runs the chain
    if (c + 1 < chunks) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        v[u] = load8(xg, n, base + kChunk + 8LL * (lane + 32 * u));
      }
    }
    __syncwarp();
    if (lane == 0) chain(ds, xs, lo, hi, acc, y, neg_p);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = lane + 32 * u;
      const long long s = base + 8LL * q;
      if (vec_out && s >= 0 && s + 8 <= n) {
        *reinterpret_cast<uint4*>(og + s) =
            reinterpret_cast<const uint4*>(xs)[q];
      } else {
        for (int i = 0; i < 8; ++i) {
          if (s + i >= 0 && s + i < n) og[s + i] = xs[8 * q + i];
        }
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    state[3 * g] = (int)x_prev;
    state[3 * g + 1] = y;
    state[3 * g + 2] = (int)acc;
  }
}

}  // namespace

// x [G, n] int16 -> out [G, n] int16; state [G, 3] int32 updated in place
extern "C" int tsl_dc_block_exact(const void* x, void* out, void* state,
                                  long long n, int groups, int p,
                                  void* stream) {
  if (n < 0 || groups <= 0) return (int)cudaErrorInvalidValue;
  dc_block_exact_kernel<<<groups, 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)x, (int16_t*)out, (int*)state, n, p);
  return (int)cudaGetLastError();
}
