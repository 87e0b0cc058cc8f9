// One chunk of the chunked Costas loop on one warp: the dependent chain
// of kernel K6 (costas.cu), shared with the probe that measures its
// latency (bench/costas_chain_probe.cu).
//
// Every float operation is written out with a _rn intrinsic in the order
// the plain version (ops/costas.py costas_block_planes_plain) computes it,
// so nvcc contracts nothing into an FMA and the two agree bit for bit; the
// sums are one pairwise tree over the chunk padded with zeros to 32*J
// values: a halving tree over a lane's J samples (sample k = lane + 32*j
// pairs with j + J/2), then an xor butterfly across the lanes, which leaves
// the same sums on every lane (float addition commutes), so every lane
// updates the state itself.

#pragma once

struct CostasGains {
  float alpha, beta, e_max, dev_min, dev_max;
};

constexpr float kTwoPi = 6.283185307179586f;   // float32(2*pi)

// xr/xi: the chunk's samples k = lane + 32*j (any value where k >= n);
// ore/oim: the rotated samples; phase/f_dev: the loop state, advanced by
// the chunk's n samples
template <int J>
__device__ __forceinline__ void costas_turn(const float (&xr)[J],
                                            const float (&xi)[J],
                                            float (&ore)[J], float (&oim)[J],
                                            int lane, int n, float& phase,
                                            float& f_dev,
                                            const CostasGains& g) {
  const float fn = (float)n;
  float e[J], w[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    const float ph = __fadd_rn(phase, __fmul_rn(f_dev, (float)k));
    const float c = cosf(ph);
    const float s = sinf(ph);
    // x * e^{-j ph}
    ore[j] = __fadd_rn(__fmul_rn(xr[j], c), __fmul_rn(xi[j], s));
    oim[j] = __fsub_rn(__fmul_rn(xi[j], c), __fmul_rn(xr[j], s));
    const float err =
        fminf(fmaxf(__fmul_rn(oim[j], ore[j]), -g.e_max), g.e_max);
    const bool live = k < n;
    e[j] = live ? err : 0.0f;
    w[j] = live ? __fmul_rn(__fsub_rn(fn, (float)k), err) : 0.0f;
  }
#pragma unroll
  for (int h = J / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      e[j] = __fadd_rn(e[j], e[j + h]);
      w[j] = __fadd_rn(w[j], w[j + h]);
    }
  }
  float s_tot = e[0], ramp = w[0];
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) {
    s_tot = __fadd_rn(s_tot, __shfl_xor_sync(0xffffffffu, s_tot, m));
    ramp = __fadd_rn(ramp, __shfl_xor_sync(0xffffffffu, ramp, m));
  }
  const float f_dev2 = fminf(
      fmaxf(__fadd_rn(f_dev, __fmul_rn(g.beta, s_tot)), g.dev_min),
      g.dev_max);
  const float x = __fadd_rn(
      __fadd_rn(__fadd_rn(phase, __fmul_rn(fn, f_dev)),
                __fmul_rn(g.beta, ramp)),
      __fmul_rn(g.alpha, s_tot));
  // jnp.mod's floor-mod: fmodf truncates toward zero (exactly), so a
  // negative remainder takes one 2*pi
  float r = fmodf(x, kTwoPi);
  if (r < 0.0f) r = __fadd_rn(r, kTwoPi);
  phase = r;
  f_dev = f_dev2;
}
