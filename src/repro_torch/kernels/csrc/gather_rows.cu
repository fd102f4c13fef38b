// Row gather out[b] = table[idx[b]] for Hopper: the port of the JAX
// package's kernels/sgns.py::gather_rows, which the two-tier retrieval scan
// uses to fetch the survivors of its int8 pass (embed_serve/quant.py,
// rescore_exact).
//
// One warp copies one output row: with rows of a multiple of 16 bytes and
// 16-byte aligned pointers each lane moves 16 bytes at a time, so a warp
// reads 512 contiguous bytes per step; otherwise it copies bytes. Like the
// TPU kernel it checks no bounds: the caller maps sentinel ids to row 0.
//
// Bound on an H100: bytes only (each gathered row read once and written
// once, plus the indices) at 3.35 TB/s; it does no arithmetic. At the
// serving shape (256 queries x 40 survivors x 128 bf16) that is 5.3 MB,
// about 1.6 us, so the launch itself dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename V>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                  int B, long long units, V* __restrict__ out) {
  const int b = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const V* src = table + static_cast<long long>(idx[b]) * units;
  V* dst = out + static_cast<long long>(b) * units;
  for (long long u = lane; u < units; u += 32) dst[u] = src[u];
}

}  // namespace

// table: (N, row_bytes / itemsize) row-major; idx: (B,) int32; out: (B, ...).
extern "C" int gather_rows(const void* table, const void* idx, int B,
                           long long row_bytes, void* out, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_kernel<uint4><<<blocks, THREADS, 0, st>>>(
        static_cast<const uint4*>(table), static_cast<const int*>(idx), B,
        row_bytes / 16, static_cast<uint4*>(out));
  } else {
    gather_kernel<unsigned char><<<blocks, THREADS, 0, st>>>(
        static_cast<const unsigned char*>(table),
        static_cast<const int*>(idx), B, row_bytes,
        static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
