// K6's dependent chain (tsl_sdr_tpu_torch/csrc/costas_turn.cuh) alone,
// on registers, on one warp: one chunk turn of the Costas loop (phase ramp,
// sinf/cosf, rotation, clip, the butterfly sums, the update and the
// floor-mod), the least time a chunk of the kernel can take, its bound.
// Not part of the kernel library; chip_smoke.py builds it beside the
// library (kernels/build.py compile_shared) and reads its SASS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "costas_turn.cuh"

namespace {

// out[0] the cycles (clock64), out[1] the nanoseconds (globaltimer),
// out[2] the turns, out[3] the final state's bits (kept live)
__global__ void costas_chain_probe_kernel(unsigned long long* out, int turns,
                                          int n) {
  const int lane = threadIdx.x;
  // a fixed full-scale sample a lane, off the chain; gains as the
  // slice's (alpha 0.05, beta 0.002, e_max 0.5)
  const float xr[1] = {0.45f - 0.01f * lane};
  const float xi[1] = {0.1f + 0.007f * lane};
  const CostasGains g{0.05f, 0.002f, 0.5f, -0.3f, 0.3f};
  float phase = 0.25f, f_dev = 0.01f, keep = 0.0f;
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  for (int i = 0; i < turns; ++i) {
    float o_r[1], o_i[1];
    costas_turn<1>(xr, xi, o_r, o_i, lane, n, phase, f_dev, g);
    keep = __fadd_rn(keep, o_r[0] + o_i[0]);   // off the chain
  }
  asm volatile("" : "+f"(phase), "+f"(f_dev), "+f"(keep));
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (lane == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = t1 - t0;
    out[2] = (unsigned long long)turns;
    out[3] = ((unsigned long long)__float_as_uint(phase) << 32) ^
             __float_as_uint(f_dev) ^ __float_as_uint(keep);
  }
}

}  // namespace

// out: 4 uint64 on the device (see costas_chain_probe_kernel); turns > 0;
// n the chunk's samples, in [1, 32]
extern "C" int tsl_costas_chain_probe(void* out, int turns, int n,
                                      void* stream) {
  if (turns <= 0 || n < 1 || n > 32) return (int)cudaErrorInvalidValue;
  costas_chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out, turns, n);
  return (int)cudaGetLastError();
}
