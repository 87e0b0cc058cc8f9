// A table of a launch's input rows, passed by value as a kernel parameter:
// the rows of one pack group or of one length of DC-blocked channels, each
// a [K] tensor of its own (a view into K1's output, a resampler's output
// or the DC blocker's), int16 or float32, at any element stride. Reading
// them through the table spares the torch.stack that would gather them
// into one tensor first. The host side fills it from one host array of
// (data pointer, stride in elements, float32 flag) triples, a row each.
#pragma once

#include <math.h>
#include <stdint.h>

template <int kRows>
struct RowTable {
  const void* ptr[kRows];
  long long stride[kRows];   // elements between consecutive samples
  unsigned char f32[kRows];  // 1: float32, 0: int16
};

template <int kRows>
__host__ void fill_rows(RowTable<kRows>& t, const long long* rows, int n) {
  for (int i = 0; i < n; ++i) {
    t.ptr[i] = (const void*)rows[3 * i];
    t.stride[i] = rows[3 * i + 1];
    t.f32[i] = (unsigned char)(rows[3 * i + 2] != 0);
  }
}

// sample n of row g as a float: int16 values exactly, float32 as stored
template <int kRows>
__device__ __forceinline__ float row_value(const RowTable<kRows>& t, int g,
                                           long long n) {
  const long long off = n * t.stride[g];
  if (t.f32[g]) {
    return __ldg(reinterpret_cast<const float*>(t.ptr[g]) + off);
  }
  return (float)__ldg(reinterpret_cast<const int16_t*>(t.ptr[g]) + off);
}

// the port's q14.to_int16 (the JAX package's astype(int16)): truncate
// toward zero, saturate at the int16 range; identity on int16 values
__device__ __forceinline__ int to_i16(float x) {
  return __float2int_rz(fminf(fmaxf(x, -32768.0f), 32767.0f));
}
