// The exact DC blocker: the reference's integer recurrence, one thread per
// stream.
//
// Not a TPU kernel: the JAX package runs this as a lax.scan
// (tsl_sdr_tpu/ops/dc_blocker.py:49-63 dc_blocker_step_exact, the default
// DC tier of decoder-tpu -b and resampler-tpu -b). Torch has no op for it:
// the recurrence (reference filter/dc_blocker.h:72-93), all int32,
//     acc -= x_prev; x_prev = s << 14; acc += x_prev - p * y_prev;
//     y_prev = acc >> 14; out = (int16) y_prev
// is serial, and the >> 14 makes it non-associative, so no scan can split
// it. What bounds it: the latency of that dependent chain, a few integer
// operations per sample on one thread; the loads of s do not depend on it
// and run ahead. The wrap is done in unsigned arithmetic (signed overflow
// is undefined in C++), the shift right on the signed value (arithmetic,
// as XLA's). The state [G, 3] int32 (x_prev, y_prev, acc) is read at the
// start and written back at the end, so blocks chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
dc_block_exact_kernel(const int16_t* __restrict__ x,
                      int16_t* __restrict__ out, int* __restrict__ state,
                      long long n, int groups, int p) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const int16_t* xg = x + (size_t)g * n;
  int16_t* og = out + (size_t)g * n;
  unsigned x_prev = (unsigned)state[3 * g];
  int y_prev = state[3 * g + 1];
  unsigned acc = (unsigned)state[3 * g + 2];
  const unsigned pu = (unsigned)p;
  for (long long i = 0; i < n; ++i) {
    acc -= x_prev;
    x_prev = (unsigned)(int)xg[i] << 14;
    acc += x_prev - pu * (unsigned)y_prev;
    y_prev = (int)acc >> 14;
    og[i] = (int16_t)y_prev;
  }
  state[3 * g] = (int)x_prev;
  state[3 * g + 1] = y_prev;
  state[3 * g + 2] = (int)acc;
}

}  // namespace

// x [G, n] int16 -> out [G, n] int16; state [G, 3] int32 updated in place
extern "C" int tsl_dc_block_exact(const void* x, void* out, void* state,
                                  long long n, int groups, int p,
                                  void* stream) {
  if (n < 0 || groups <= 0) return (int)cudaErrorInvalidValue;
  dc_block_exact_kernel<<<(groups + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int16_t*)x, (int16_t*)out, (int*)state, n, groups, p);
  return (int)cudaGetLastError();
}
