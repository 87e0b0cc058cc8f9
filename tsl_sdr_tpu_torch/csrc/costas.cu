// K6: the chunked 2nd-order Costas loop (coherent PLL), one warp a
// channel.
//
// Replaces tsl_sdr_tpu/ops/costas.py:94-139 _costas_chunks, a lax.scan
// over chunks (not Pallas), which costas_block_planes (:167-214) runs over
// [K, C] float32 planes: per chunk of L samples from phase0, f_dev
//     ph_k = phase0 + f_dev*k;  o = x * e^{-j ph_k}
//     err_k = clip(o_im*o_re, -e_max, e_max)
//     S = sum err_k;  R = sum (L-k)*err_k
//     f_dev' = clip(f_dev + beta*S, dev_min, dev_max)
//     phase' = mod(phase0 + L*f_dev + beta*R + alpha*S, 2*pi)
// over K // L chunks of L, then one chunk of the remainder. Torch has no
// scan, so it is this kernel (ops/costas.py costas_block_planes).
//
// What bounds it on the H100: latency. The chunks of a channel are
// serial: each turn is a dependent chain of FMUL/FADD (the phase ramp),
// sinf and cosf, the rotation, the clip, five butterfly levels of two
// shuffles and adds, the update and fmodf; a block is ceil(K/L) turns a
// channel, the channels side by side. chip_smoke.py measures one turn
// with bench/costas_chain_probe.cu (the same chain, costas_turn.cuh, on
// registers alone) and reads its SASS. The bytes (16 a sample: xr, xi in,
// o_re, o_im out) take a small fraction of that.
//
// How the design responds: a warp takes a channel, its lanes a chunk's
// samples (J = tree width / 32 a lane, sample k = lane + 32*j), so a turn
// does its sincos and rotation for all samples at once and its sums by a
// butterfly that leaves them on every lane (no broadcast). The inputs do
// not depend on the chain: the warp stages tiles of kTile samples into
// shared memory by cp.async, the next tile in flight while the current
// one runs, and collects the outputs in shared memory, written out once a
// tile. So the turns read and write shared memory only: a version that
// loaded each chunk into registers a few turns ahead and stored its
// outputs every turn took twice as long (7.0 against 3.4 ms at the
// slice's block on an H100), most of the difference in those loads and
// stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "costas_turn.cuh"

namespace {

constexpr int kTile = 1024;   // samples of a channel a warp stages at a time

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// grid = C channels, block = one warp
template <int J>
__global__ void __launch_bounds__(32)
costas_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ ore, float* __restrict__ oim,
              const float* __restrict__ phase_in,
              const float* __restrict__ fdev_in, float* __restrict__ phase_out,
              float* __restrict__ fdev_out, long long k_tot, int nr_ch,
              int chunk, CostasGains g) {
  __shared__ float xs[2][2][kTile];   // [buffer][re, im][sample]
  __shared__ float os[2][kTile];      // [re, im][sample]
  const int c = blockIdx.x, lane = threadIdx.x;
  float phase = phase_in[c];
  float f_dev = fdev_in[c];
  const long long n_full = k_tot / chunk;
  const int rem = (int)(k_tot - n_full * chunk);
  const long long n_chunks = n_full + (rem > 0);
  const int tile_chunks = kTile / chunk;
  const long long tile_len = (long long)tile_chunks * chunk;
  const long long n_tiles = (n_chunks + tile_chunks - 1) / tile_chunks;
  // tile t's samples [t*tile_len, +n) into buffer b, one commit group
  auto stage = [&](long long t, int b) {
    const long long s0 = t * tile_len;
    const int n = (int)min(tile_len, k_tot - s0);
    for (int i = lane; i < n; i += 32) {
      const long long at = (s0 + i) * nr_ch + c;
      cp_async4(&xs[b][0][i], xr + at);
      cp_async4(&xs[b][1][i], xi + at);
    }
    cp_async_commit();
  };
  stage(0, 0);
  for (long long t = 0; t < n_tiles; ++t) {
    const int b = (int)(t & 1);
    if (t + 1 < n_tiles) {
      stage(t + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const long long c0 = t * tile_chunks;
    const int n_q = (int)min((long long)tile_chunks, n_chunks - c0);
    for (int q = 0; q < n_q; ++q) {
      const int n = c0 + q < n_full ? chunk : rem;
      const int off = q * chunk;
      float vr[J], vi[J], o_r[J], o_i[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        vr[j] = k < n ? xs[b][0][off + k] : 0.0f;
        vi[j] = k < n ? xs[b][1][off + k] : 0.0f;
      }
      costas_turn<J>(vr, vi, o_r, o_i, lane, n, phase, f_dev, g);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < n) {
          os[0][off + k] = o_r[j];
          os[1][off + k] = o_i[j];
        }
      }
    }
    __syncwarp();
    const long long s0 = t * tile_len;
    const int n = (int)min(tile_len, k_tot - s0);
    for (int i = lane; i < n; i += 32) {
      const long long at = (s0 + i) * nr_ch + c;
      ore[at] = os[0][i];
      oim[at] = os[1][i];
    }
    __syncwarp();
  }
  if (lane == 0) {
    phase_out[c] = phase;
    fdev_out[c] = f_dev;
  }
}

template <int J>
cudaError_t launch(const float* xr, const float* xi, float* ore, float* oim,
                   const float* ph_in, const float* fd_in, float* ph_out,
                   float* fd_out, long long k_tot, int nr_ch, int chunk,
                   CostasGains g, cudaStream_t stream) {
  costas_kernel<J><<<nr_ch, 32, 0, stream>>>(xr, xi, ore, oim, ph_in, fd_in,
                                             ph_out, fd_out, k_tot, nr_ch,
                                             chunk, g);
  return cudaGetLastError();
}

}  // namespace

// xr, xi [K, C] float32 (time-major) -> ore, oim [K, C]; the state
// (phase, f_dev) [C] read from *_in and written to *_out; chunk in
// [1, 512], its sums over max(32, next_pow2(chunk)) values
extern "C" int tsl_costas_chunks(const void* xr, const void* xi, void* ore,
                                 void* oim, const void* phase_in,
                                 const void* fdev_in, void* phase_out,
                                 void* fdev_out, long long k_tot, int nr_ch,
                                 int chunk, float alpha, float beta,
                                 float e_max, float dev_min, float dev_max,
                                 void* stream) {
  if (k_tot <= 0 || nr_ch <= 0 || chunk < 1 || chunk > 512) {
    return (int)cudaErrorInvalidValue;
  }
  int width = 32;
  while (width < chunk) width *= 2;
  const CostasGains g{alpha, beta, e_max, dev_min, dev_max};
  const float* x_r = (const float*)xr;
  const float* x_i = (const float*)xi;
  float* o_r = (float*)ore;
  float* o_i = (float*)oim;
  const float* p_in = (const float*)phase_in;
  const float* f_in = (const float*)fdev_in;
  float* p_out = (float*)phase_out;
  float* f_out = (float*)fdev_out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (width / 32) {
    case 1:
      err = launch<1>(x_r, x_i, o_r, o_i, p_in, f_in, p_out, f_out, k_tot,
                      nr_ch, chunk, g, s);
      break;
    case 2:
      err = launch<2>(x_r, x_i, o_r, o_i, p_in, f_in, p_out, f_out, k_tot,
                      nr_ch, chunk, g, s);
      break;
    case 4:
      err = launch<4>(x_r, x_i, o_r, o_i, p_in, f_in, p_out, f_out, k_tot,
                      nr_ch, chunk, g, s);
      break;
    case 8:
      err = launch<8>(x_r, x_i, o_r, o_i, p_in, f_in, p_out, f_out, k_tot,
                      nr_ch, chunk, g, s);
      break;
    default:
      err = launch<16>(x_r, x_i, o_r, o_i, p_in, f_in, p_out, f_out, k_tot,
                       nr_ch, chunk, g, s);
      break;
  }
  return (int)err;
}
