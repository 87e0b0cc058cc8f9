// The exact DC blocker's dependent chain (tsl_sdr_tpu_torch/csrc/
// dc_chain.cuh) alone, on registers, on one thread: the least time a
// sample of the kernel can take, its bound. Not part of the kernel
// library; chip_smoke.py builds it beside the library
// (kernels/build.py compile_shared) and reads its SASS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dc_chain.cuh"

namespace {

constexpr int kUnroll = 16;   // turns of the probe's loop body

// out[0] the cycles (clock64), out[1] the nanoseconds (globaltimer),
// out[2] the turns, out[3] the final acc (kept live)
__global__ void dc_chain_probe_kernel(unsigned long long* out, int turns) {
  unsigned acc = threadIdx.x;
  int y = 0;
  const unsigned neg_p = 0u - 1638u;
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  for (int i = 0; i < turns; i += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      turn(acc, y, (unsigned)(i + k) << 14, neg_p);
    }
  }
  asm volatile("" : "+r"(acc));
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  out[0] = (unsigned long long)(c1 - c0);
  out[1] = t1 - t0;
  out[2] = (unsigned long long)turns;
  out[3] = acc;
}

}  // namespace

// out: 4 uint64 on the device (see dc_chain_probe_kernel); turns a
// positive multiple of 16
extern "C" int tsl_dc_chain_probe(void* out, int turns, void* stream) {
  if (turns <= 0 || turns % kUnroll) return (int)cudaErrorInvalidValue;
  dc_chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out, turns);
  return (int)cudaGetLastError();
}
