// Probe kernels of bench/torch_k1_lab.py: the row-load ceilings that K1's
// staging (tsl_sdr_tpu_torch/csrc/chain.cu, bank.cu) is measured against on
// the H100. Built beside the patched copies of K1 with the kernel library's
// flags (kernels/build.compile_shared); plain C entry points, launched on
// the stream they are given, returning cudaGetLastError().
//
// k1probe_copy: the Hopper counterpart of bench/pallas_parts_lab3.py's
// stream copy. Rows of row_bytes bytes, a CTA a tile of tile_rows rows,
// each thread copying vec-byte chunks (4, 8 or 16) addressed as K1's
// staging addresses its rows (row = chunk / chunks a row). Its bound is
// the bytes read and written at 3.35 TB/s.
//
// k1probe_depth: the counterpart of bench/pallas_parts_lab5.py's manual DMA
// ring. A persistent grid (one CTA an SM: every launch takes shared memory
// for 8 chunks, so only the depth changes) walks an even run of chunks of
// chunk_rows rows; cp.async keeps `depth` chunks in flight
// (cp.async.wait_group depth - 1) and each arrived chunk's rows give their
// first 128 values to the output, as lab 5's kernel writes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 8;
constexpr int kOutValues = 128;   // values a row the depth probe writes

template <int kVec>
struct Chunk;
template <>
struct Chunk<4> {
  using T = uint32_t;
};
template <>
struct Chunk<8> {
  using T = uint2;
};
template <>
struct Chunk<16> {
  using T = uint4;
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            long long rows, int row_bytes, int tile_rows) {
  using T = typename Chunk<kVec>::T;
  const int per_row = row_bytes / kVec;
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const long long n_rows = rows - r0 < tile_rows ? rows - r0 : tile_rows;
  const long long n = n_rows * per_row;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const long long r = r0 + i / per_row;
    const int c = (int)(i % per_row);
    const size_t at = (size_t)r * row_bytes + (size_t)c * kVec;
    *reinterpret_cast<T*>(out + at) =
        __ldg(reinterpret_cast<const T*>(in + at));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kN));
}

template <int kDepth>
__global__ void __launch_bounds__(kThreads)
depth_kernel(const int16_t* __restrict__ in, int16_t* __restrict__ out,
             int rows, int row, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (rows + chunk_rows - 1) / chunk_rows;
  const int c0 = (int)((long long)n_chunks * blockIdx.x / gridDim.x);
  const int c1 = (int)((long long)n_chunks * (blockIdx.x + 1) / gridDim.x);
  const size_t chunk_bytes = (size_t)chunk_rows * row * 2;
  // chunk c into ring slot (c - c0) % kDepth; one commit group a call,
  // empty past the run's end, so that wait_group counts chunks
  auto issue = [&](int c) {
    if (c < c1) {
      const int r0 = c * chunk_rows;
      const int nr = min(chunk_rows, rows - r0);
      uint8_t* dst = smem + (size_t)((c - c0) % kDepth) * chunk_bytes;
      const int16_t* src = in + (size_t)r0 * row;
      for (int i = threadIdx.x; i < nr * row / 8; i += kThreads) {
        cp_async16(dst + 16 * (size_t)i, src + 8 * (size_t)i);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < kDepth; ++k) issue(c0 + k);
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<kDepth - 1>();   // chunk c has arrived
    __syncthreads();
    const int r0 = c * chunk_rows;
    const int nr = min(chunk_rows, rows - r0);
    const int16_t* buf = reinterpret_cast<const int16_t*>(
        smem + (size_t)((c - c0) % kDepth) * chunk_bytes);
    for (int i = threadIdx.x; i < nr * (kOutValues / 8); i += kThreads) {
      const int r = i / (kOutValues / 8), q = i % (kOutValues / 8);
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * kOutValues + 8 * q) =
          *reinterpret_cast<const uint4*>(buf + (size_t)r * row + 8 * q);
    }
    __syncthreads();   // the slot is free again
    issue(c + kDepth);
  }
}

template <int kDepth>
int launch_depth(const void* in, void* out, int rows, int row,
                 int chunk_rows, cudaStream_t stream) {
  const int smem = kMaxDepth * chunk_rows * row * 2;
  cudaError_t err = cudaFuncSetAttribute(
      depth_kernel<kDepth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (rows + chunk_rows - 1) / chunk_rows;
  depth_kernel<kDepth><<<n_chunks < sms ? n_chunks : sms, kThreads, smem,
                         stream>>>((const int16_t*)in, (int16_t*)out, rows,
                                   row, chunk_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: rows x row_bytes bytes (16-byte aligned; row_bytes % vec == 0);
// vec 4, 8 or 16; a CTA copies tile_rows rows
extern "C" int k1probe_copy(const void* in, void* out, long long rows,
                            int row_bytes, int vec, int tile_rows,
                            void* stream) {
  if (rows <= 0 || tile_rows <= 0 || row_bytes <= 0 || row_bytes % vec ||
      (uintptr_t)in % 16 || (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ctas = (rows + tile_rows - 1) / tile_rows;
  if (ctas > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* i = (const uint8_t*)in;
  uint8_t* o = (uint8_t*)out;
  switch (vec) {
    case 4:
      copy_kernel<4><<<(int)ctas, kThreads, 0, st>>>(i, o, rows, row_bytes,
                                                      tile_rows);
      break;
    case 8:
      copy_kernel<8><<<(int)ctas, kThreads, 0, st>>>(i, o, rows, row_bytes,
                                                      tile_rows);
      break;
    case 16:
      copy_kernel<16><<<(int)ctas, kThreads, 0, st>>>(i, o, rows, row_bytes,
                                                       tile_rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// in [rows, row] int16 (row % 8 == 0, 16-byte aligned) -> out [rows, 128]
// int16, each row's first 128 values; depth 1, 2, 4 or 8 chunks in flight;
// 8 chunks of chunk_rows rows must fit in a block's shared memory
extern "C" int k1probe_depth(const void* in, void* out, int rows, int row,
                             int chunk_rows, int depth, void* stream) {
  if (rows <= 0 || row < kOutValues || row % 8 || chunk_rows <= 0 ||
      (size_t)kMaxDepth * chunk_rows * row * 2 > 227 * 1024 ||
      (uintptr_t)in % 16 || (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (depth) {
    case 1:
      return launch_depth<1>(in, out, rows, row, chunk_rows, st);
    case 2:
      return launch_depth<2>(in, out, rows, row, chunk_rows, st);
    case 4:
      return launch_depth<4>(in, out, rows, row, chunk_rows, st);
    case 8:
      return launch_depth<8>(in, out, rows, row, chunk_rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
