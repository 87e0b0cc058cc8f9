// Exact int16 x int16 -> wrapped int32 products on Hopper's int8 tensor
// cores (IMMA), shared by K1 (chain.cu), K3 (row_resampler.cu) and K4
// (frame_resampler.cu).
//
// The tensor cores take 8-bit operands, not 16-bit ones. An int16 is
// 256 * hi + lo with hi = x >> 8 (signed byte) and lo = x & 0xFF (unsigned
// byte), so
//     sum x*w = 65536*HH + 256*(HL + LH) + LL      (mod 2^32)
// where HH, HL, LH and LL are the four cross sums of byte products. Each is
// one mma.sync.m16n8k32 with s32 accumulation: s8.s8 (HH), s8.u8 and u8.s8
// into one accumulator (HL + LH), u8.u8 (LL). Recombined in uint32 the sum
// is the wrapped int32 sum of the int16 products bit for bit; because
// recombination is linear mod 2^32, partial sums over parts of K (other
// warps, other blocks) may be recombined first and added in any order.
// No partial leaves s32 for K <= 32768 (the wrappers check it).
//
// Operands: A (the input samples) is split while it is staged into two
// row-major byte planes in shared memory and read with ldmatrix (K1, K3)
// or, where rows sit at any byte, with aligned word loads (K4); B (the
// taps) is split once at plan time (ops/imma_split.py fragment_planes) into
// planes whose 32x8 tiles are stored in B-fragment lane order, so a warp
// reads a tile as one coalesced 256-byte load of a uint2 per lane.
// The plain arithmetic is ops/imma_split.py split_matmul_plain.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace imma {

// 8 int16 values (a uint4) -> their 8 high bytes and 8 low bytes, in order
__device__ __forceinline__ void split8(const uint4 v, uint2& hi, uint2& lo) {
  hi.x = __byte_perm(v.x, v.y, 0x7531);
  hi.y = __byte_perm(v.z, v.w, 0x7531);
  lo.x = __byte_perm(v.x, v.y, 0x6420);
  lo.y = __byte_perm(v.z, v.w, 0x6420);
}

// A fragment (16 rows x 32 bytes, m16n8k32 row layout) from a row-major
// byte plane in shared memory; rows row0.., bytes col0.. (16-byte aligned
// rows: pitch % 16 == 0, col0 % 16 == 0). Lanes 0-7, 8-15, 16-23, 24-31
// address the four 8x16-byte matrices (rows 0-7 | 8-15) x (bytes 0-15 |
// 16-31), which are the fragment's registers a0..a3 in that order.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* plane,
                                       int pitch, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  const uint8_t* p = plane + (size_t)(row0 + (lane & 7) + (lane & 8)) * pitch
                     + col0 + ((lane >> 4) << 4);
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// The same fragments, high and low, from raw int16 rows in shared memory
// (no split planes): one ldmatrix.x4 of b16 gives lane (g, t) the values
// at columns 2t, 2t+1, 8+2t, 9+2t of rows g and g+8 (the four 8x8 b16
// matrices (rows 0-7 | 8-15) x (values 0-7 | 8-15)), a second one the same
// 16 values on, and __byte_perm splits each pair of registers into four
// high and four low bytes. So fragment position p = 16h + 4t + i of a
// 32-value step holds value 16h + 2t + (i & 1) + 8(i >> 1) of the row: the
// B operand's k order is permuted to match on the host
// (ops/imma_split.py RAW_K_ORDER). Rows at a pitch of 16 bytes times an odd
// number keep ldmatrix's 8 rows on distinct banks; col0 % 16 == 0 (values).
// the byte offset of the row and value this lane addresses for
// load_a_raw, within a 16-row by 16-value block of the rows
__device__ __forceinline__ int raw_lane_offset(int pitch) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 4) << 3)) * pitch + (((lane >> 3) & 1) << 4);
}

// addr: the shared-memory address of row row0, value col0 of the rows
// plus raw_lane_offset
__device__ __forceinline__ void load_a_raw(uint32_t (&hi)[4],
                                           uint32_t (&lo)[4],
                                           uint32_t addr) {
  uint32_t r[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[4 * h]), "=r"(r[4 * h + 1]), "=r"(r[4 * h + 2]),
          "=r"(r[4 * h + 3])
        : "r"(addr + 32 * h));
  }
  // a0: row g, a1: row g + 8, a2, a3: the same 16 values on
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const uint32_t x = r[(f >> 1) * 4 + (f & 1) * 2];
    const uint32_t y = r[(f >> 1) * 4 + (f & 1) * 2 + 1];
    hi[f] = __byte_perm(x, y, 0x7531);
    lo[f] = __byte_perm(x, y, 0x6420);
  }
}

// the three accumulator sets of one 16x8 output tile (C-fragment layout:
// c[0], c[1] at row lane/4, columns 2*(lane%4) + 0, 1; c[2], c[3] 8 rows on)
struct Acc {
  int hh[4];
  int mid[4];
  int ll[4];
};

__device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c.hh[i] = c.mid[i] = c.ll[i] = 0;
}

#define TSL_IMMA(ATYPE, BTYPE, C, A, B)                                      \
  asm volatile(                                                              \
      "mma.sync.aligned.m16n8k32.row.col.s32." ATYPE "." BTYPE ".s32 "      \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"    \
      : "+r"(C[0]), "+r"(C[1]), "+r"(C[2]), "+r"(C[3])                       \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(B.x), "r"(B.y))

// C += A * B for one 16x32 A tile (planes ah, al) and one 32x8 B tile
// (fragments bh, bl): four IMMA products into the three sets
__device__ __forceinline__ void mma_split(Acc& c, const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint2 bh, const uint2 bl) {
  TSL_IMMA("s8", "s8", c.hh, ah, bh);
  TSL_IMMA("s8", "u8", c.mid, ah, bl);
  TSL_IMMA("u8", "s8", c.mid, al, bh);
  TSL_IMMA("u8", "u8", c.ll, al, bl);
}

#undef TSL_IMMA

// the wrapped int32 sum of element i of the tile
__device__ __forceinline__ unsigned combine(const Acc& c, int i) {
  return ((unsigned)c.hh[i] << 16) + ((unsigned)c.mid[i] << 8) +
         (unsigned)c.ll[i];
}

}  // namespace imma
