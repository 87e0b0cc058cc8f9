// K10: the integer NCO and its scalings, after K5's raw sums.
//
// Replaces tsl_sdr_tpu/ops/packed_fir.py:474-488 nco_rotate with the two
// 1/16384 scalings XLA fuses around it in the jitted Costas runner
// (tsl_sdr_tpu/models/costas_channel.py:123-140, :176-196) and in the
// production tier's debug tap (tsl_sdr_tpu/models/channelizer.py:
// 410-424), which the port ran as some 25-30 small torch ops a block
// (ops/packed_fir.py nco_derotate_plain). For every (k, c) of K5's raw
// int32 sums p [rows, 2 * half] (half = opr * C; the flat order of
// p[:, :half] and p[:, half:] is (k, c)), output index k0 + k:
//   ar, ai = float32(p_re), float32(p_im)
//   ph = int32((k0 + k) * omega[c] mod 2^32)      wrapping, as JAX's int32
//   th = float32(ph) * float32(2 pi / 2^32)
//   yr = ar cos th - ai sin th;  yi = ar sin th + ai cos th
// then, by mode, the planes (yr, yi) [K, C] float32 each times 1/16384
// twice (K6's input), or trunc(y * 1/16384) clamped to int16, interleaved
// [K, C, 2] (the native Costas path's and the debug tap's IQ). Every
// float32 step is one _rn intrinsic in the plain version's order; cosf and
// sinf are the CUDA math library's (no fast-math build), as torch's cos
// and sin on the card call them, so the result is bit-equal.
//
// What bounds it on the H100: bytes, 8 B of sums in and 8 B (planes) or
// 4 B (int16) out a (k, c): 32 MB a Costas block (250,000 x 8), 0.0096 ms
// at 3.35 TB/s; the math (sincos, about 40 float32 operations) is below.
//
// How the design responds: one pass, four consecutive (k, c) a thread,
// each operand read and each output written as one 16-byte vector where
// a row holds a multiple of four (scalars otherwise), the phase wrapped in
// 32-bit integers with no table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr float kQ14 = 0x1p-14f;   // 1 / 16384

enum Mode { kPlanes = 0, kInt16 = 1 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    nco_kernel(const int* __restrict__ p, const int* __restrict__ omega,
               void* __restrict__ out, int half, int c_n, int n,
               long long k0, float dtheta, bool vec) {
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (j0 >= n) return;
  const int m = min(kVec, n - j0);
  int row = j0 / half, col = j0 - row * half;
  float ar[kVec], ai[kVec];
  if (vec && m == kVec) {   // half % 4 == 0: the four share a row
    const int* re = p + (long long)row * 2 * half + col;
    const int4 r4 = __ldcs(reinterpret_cast<const int4*>(re));
    const int4 i4 = __ldcs(reinterpret_cast<const int4*>(re + half));
    const int rv[kVec] = {r4.x, r4.y, r4.z, r4.w};
    const int iv[kVec] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      ar[j] = __int2float_rn(rv[j]);
      ai[j] = __int2float_rn(iv[j]);
    }
  } else {
    for (int j = 0; j < m; ++j) {
      const int* re = p + (long long)row * 2 * half + col;
      ar[j] = __int2float_rn(re[0]);
      ai[j] = __int2float_rn(re[half]);
      if (++col == half) {
        col = 0;
        ++row;
      }
    }
  }
  int kk = j0 / c_n, c = j0 - kk * c_n;
  float yr[kVec] = {}, yi[kVec] = {};
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (j < m) {
      const unsigned ph =
          (unsigned)(unsigned long long)(k0 + kk) * (unsigned)omega[c];
      const float th = __fmul_rn(__int2float_rn((int)ph), dtheta);
      const float cs = cosf(th), sn = sinf(th);
      yr[j] = __fsub_rn(__fmul_rn(ar[j], cs), __fmul_rn(ai[j], sn));
      yi[j] = __fadd_rn(__fmul_rn(ar[j], sn), __fmul_rn(ai[j], cs));
      if (++c == c_n) {
        c = 0;
        ++kk;
      }
    }
  }
  if (kMode == kPlanes) {
    float* o_re = static_cast<float*>(out) + j0;
    float* o_im = o_re + n;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      yr[j] = __fmul_rn(__fmul_rn(yr[j], kQ14), kQ14);
      yi[j] = __fmul_rn(__fmul_rn(yi[j], kQ14), kQ14);
    }
    if (vec && m == kVec) {
      __stcs(reinterpret_cast<float4*>(o_re),
             make_float4(yr[0], yr[1], yr[2], yr[3]));
      __stcs(reinterpret_cast<float4*>(o_im),
             make_float4(yi[0], yi[1], yi[2], yi[3]));
    } else {
      for (int j = 0; j < m; ++j) {
        o_re[j] = yr[j];
        o_im[j] = yi[j];
      }
    }
  } else {
    unsigned w[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // trunc toward zero, then q14.to_int16's clamp
      const int r = min(max(__float2int_rz(__fmul_rn(yr[j], kQ14)), -32768),
                        32767);
      const int i = min(max(__float2int_rz(__fmul_rn(yi[j], kQ14)), -32768),
                        32767);
      w[j] = ((unsigned)i << 16) | ((unsigned)r & 0xFFFFu);
    }
    unsigned* o = static_cast<unsigned*>(out) + j0;
    if (vec && m == kVec) {
      __stcs(reinterpret_cast<uint4*>(o), make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      for (int j = 0; j < m; ++j) o[j] = w[j];
    }
  }
}

}  // namespace

// p [rows, 2 * half] int32 (K5's raw sums, half a multiple of c_n);
// omega [c_n] int32 turns; k0 the absolute index of output 0; dtheta
// float32(2 pi / 2^32) -> mode 0: out [2, rows * half] float32 (yr, yi
// planes [K, C] scaled twice by 1/16384); mode 1: out [rows * half, 2]
// int16.
extern "C" int tsl_nco_derotate(const void* p, const void* omega, void* out,
                                int rows, int half, int c_n, long long k0,
                                int mode, float dtheta, void* stream) {
  const long long n = (long long)rows * half;
  if (rows <= 0 || c_n <= 0 || half <= 0 || half % c_n || n >= (1LL << 31) ||
      (mode != kPlanes && mode != kInt16))
    return (int)cudaErrorInvalidValue;
  const bool vec =
      half % kVec == 0 && (((uintptr_t)p | (uintptr_t)out) & 15) == 0;
  const unsigned grid =
      (unsigned)((n + (long long)kThreads * kVec - 1) / (kThreads * kVec));
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kPlanes)
    nco_kernel<kPlanes><<<grid, kThreads, 0, s>>>(
        (const int*)p, (const int*)omega, out, half, c_n, (int)n, k0,
        dtheta, vec);
  else
    nco_kernel<kInt16><<<grid, kThreads, 0, s>>>(
        (const int*)p, (const int*)omega, out, half, c_n, (int)n, k0,
        dtheta, vec);
  return (int)cudaGetLastError();
}
