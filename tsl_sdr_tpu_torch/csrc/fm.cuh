// The FM discriminator's per-output arithmetic, shared by K1's two bodies
// (chain.cu, bank.cu): the conjugate product with the previous sample, the
// polynomial atan2 of the TPU kernel, + omega, wrap to (-pi, pi], the
// zero-power guard and trunc(phi / pi * 16384).
//
// Every float operation is written with an explicit round-to-nearest
// intrinsic (no FMA contraction) in the order of the plain torch version
// (tsl_sdr_tpu_torch/ops/fm.py), and the divides are IEEE divides, so a
// kernel and the plain version agree bit for bit whenever their int32
// accumulators do (always: integer sums are exact).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fm {

constexpr float kPi = 3.14159265358979f;       // == np.float32(np.pi)
constexpr float kHalfPi = 1.57079632679490f;   // == np.float32(np.pi / 2)

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ya = fabsf(y), xa = fabsf(x);
  const float hi = fmaxf(ya, xa);
  const float safe = hi == 0.0f ? 1.0f : hi;
  const float z = __fdiv_rn(fminf(ya, xa), safe);
  const float z2 = __fmul_rn(z, z);
  float p = -0.0117212f;
  p = __fadd_rn(__fmul_rn(p, z2), 0.05265332f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.11643287f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.19354346f);
  p = __fadd_rn(__fmul_rn(p, z2), -0.33262348f);
  p = __fadd_rn(__fmul_rn(p, z2), 0.99997726f);
  const float base = __fmul_rn(z, p);
  const float ax = x >= 0.0f ? (y >= 0.0f ? base : -base)
                             : (y >= 0.0f ? __fsub_rn(kPi, base)
                                          : __fsub_rn(base, kPi));
  const float ay = y >= 0.0f
      ? (x >= 0.0f ? __fsub_rn(kHalfPi, base) : __fadd_rn(kHalfPi, base))
      : (x >= 0.0f ? __fsub_rn(base, kHalfPi) : __fsub_rn(-base, kHalfPi));
  return xa > ya ? ax : ay;
}

__device__ __forceinline__ int16_t fm_pcm(float ar, float ai, float pr,
                                          float pi, float omega) {
  const float sre = __fadd_rn(__fmul_rn(ar, pr), __fmul_rn(ai, pi));
  const float sim = __fsub_rn(__fmul_rn(ai, pr), __fmul_rn(ar, pi));
  float phi = __fadd_rn(atan2_poly(sim, sre), omega);
  phi = phi > kPi ? __fsub_rn(phi, 2.0f * kPi) : phi;
  phi = phi <= -kPi ? __fadd_rn(phi, 2.0f * kPi) : phi;
  if (sre == 0.0f && sim == 0.0f) phi = 0.0f;
  return (int16_t)truncf(__fmul_rn(__fdiv_rn(phi, kPi), 16384.0f));
}

}  // namespace fm
