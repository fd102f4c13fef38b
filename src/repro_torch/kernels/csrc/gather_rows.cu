// Row gather out[b] = table[idx[b]] for Hopper: the port of the JAX
// package's kernels/sgns.py::gather_rows, which the two-tier retrieval scan
// uses to fetch the survivors of its int8 pass (embed_serve/quant.py,
// rescore_exact) and the trainer's "pallas" route its minibatch rows; and
// of gather_rows_rowwise, the one-row-per-grid-step reference it is held
// against.
//
// gather_kernel: one warp copies one output row: with rows of a multiple
// of 16 bytes and 16-byte aligned pointers each lane moves 16 bytes at a
// time, so a warp reads 512 contiguous bytes per step; otherwise it copies
// bytes. gather_rowwise_kernel: one block of one warp per output row, the
// straightforward counterpart of the TPU's one-row grid step (the same
// function; one row in flight per block). Like the TPU kernels they check
// no bounds: the caller maps sentinel ids to row 0.
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

template <typename V>
__global__ void __launch_bounds__(32)
    gather_rowwise_kernel(const V* __restrict__ table,
                          const int* __restrict__ idx, long long units,
                          V* __restrict__ out) {
  const V* src = table + static_cast<long long>(idx[blockIdx.x]) * units;
  V* dst = out + static_cast<long long>(blockIdx.x) * units;
  for (long long u = threadIdx.x; u < units; u += 32) dst[u] = src[u];
}

bool vector_rows(const void* table, long long row_bytes, const void* out) {
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

// table: (N, row_bytes / itemsize) row-major; idx: (B,) int32; out: (B, ...).
extern "C" int gather_rows(const void* table, const void* idx, int B,
                           long long row_bytes, void* out, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (vector_rows(table, row_bytes, out)) {
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

// The same function, one block per output row.
extern "C" int gather_rows_rowwise(const void* table, const void* idx, int B,
                                   long long row_bytes, void* out,
                                   void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector_rows(table, row_bytes, out)) {
    gather_rowwise_kernel<uint4><<<B, 32, 0, st>>>(
        static_cast<const uint4*>(table), static_cast<const int*>(idx),
        row_bytes / 16, static_cast<uint4*>(out));
  } else {
    gather_rowwise_kernel<unsigned char><<<B, 32, 0, st>>>(
        static_cast<const unsigned char*>(table),
        static_cast<const int*>(idx), row_bytes,
        static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
