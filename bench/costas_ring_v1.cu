// K6's first form, kept as the yardstick of bench/torch_k6_lab.py: the
// same chunked Costas loop (tsl_sdr_tpu_torch/csrc/costas_turn.cuh), one
// warp a channel, but each chunk loaded from device memory into a ring of
// D register sets a few turns ahead and its outputs stored to device
// memory every turn. Not part of the kernel library; the lab builds it
// beside the library (kernels/build.py compile_shared) and holds it equal
// to the plain version too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "costas_turn.cuh"

namespace {

template <int J>
__device__ __forceinline__ void load_chunk(const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           float (&br)[J], float (&bi)[J],
                                           long long t0, int n, int c,
                                           int nr_ch, int lane) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    if (k < n) {
      const long long at = (t0 + k) * nr_ch + c;
      br[j] = __ldg(xr + at);
      bi[j] = __ldg(xi + at);
    } else {
      br[j] = 0.0f;
      bi[j] = 0.0f;
    }
  }
}

// grid = C channels, block = one warp
template <int J>
__global__ void __launch_bounds__(32)
costas_ring_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ ore, float* __restrict__ oim,
                   const float* __restrict__ phase_in,
                   const float* __restrict__ fdev_in,
                   float* __restrict__ phase_out,
                   float* __restrict__ fdev_out, long long k_tot, int nr_ch,
                   int chunk, CostasGains g) {
  // register sets of the load ring (chunks in flight: D - 1)
  constexpr int D = J <= 2 ? 4 : 2;
  const int c = blockIdx.x, lane = threadIdx.x;
  float phase = phase_in[c];
  float f_dev = fdev_in[c];
  const long long n_full = k_tot / chunk;
  const int rem = (int)(k_tot - n_full * chunk);
  const long long n_chunks = n_full + (rem > 0);
  auto len = [&](long long i) { return i < n_full ? chunk : rem; };

  float br[D][J], bi[D][J];
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (u < n_chunks) {
      load_chunk<J>(xr, xi, br[u], bi[u], u * (long long)chunk, len(u), c,
                    nr_ch, lane);
    }
  }
  for (long long base = 0; base < n_chunks; base += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const long long i = base + u;
      if (i < n_chunks) {
        const int n = len(i);
        const long long t0 = i * chunk;
        float o_r[J], o_i[J];
        costas_turn<J>(br[u], bi[u], o_r, o_i, lane, n, phase, f_dev, g);
        if (i + D < n_chunks) {
          load_chunk<J>(xr, xi, br[u], bi[u], (i + D) * chunk, len(i + D),
                        c, nr_ch, lane);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < n) {
            const long long at = (t0 + k) * nr_ch + c;
            ore[at] = o_r[j];
            oim[at] = o_i[j];
          }
        }
      }
    }
  }
  if (lane == 0) {
    phase_out[c] = phase;
    fdev_out[c] = f_dev;
  }
}

}  // namespace

// tsl_costas_chunks's interface (ops/costas.py), for chunks of at most 32
// samples (one a lane)
extern "C" int tsl_costas_ring_v1(const void* xr, const void* xi, void* ore,
                                  void* oim, const void* phase_in,
                                  const void* fdev_in, void* phase_out,
                                  void* fdev_out, long long k_tot, int nr_ch,
                                  int chunk, float alpha, float beta,
                                  float e_max, float dev_min, float dev_max,
                                  void* stream) {
  if (k_tot <= 0 || nr_ch <= 0 || chunk < 1 || chunk > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const CostasGains g{alpha, beta, e_max, dev_min, dev_max};
  costas_ring_kernel<1><<<nr_ch, 32, 0, (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)ore, (float*)oim,
      (const float*)phase_in, (const float*)fdev_in, (float*)phase_out,
      (float*)fdev_out, k_tot, nr_ch, chunk, g);
  return (int)cudaGetLastError();
}
