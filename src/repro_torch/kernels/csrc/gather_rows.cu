// Row gather out[b] = table[idx[b]] for Hopper: the port of the JAX
// package's kernels/sgns.py::gather_rows, which the two-tier retrieval scan
// uses to fetch the survivors of its int8 pass (embed_serve/quant.py,
// rescore_exact) and the trainer's "pallas" route its minibatch rows; and
// of gather_rows_rowwise, the one-row-per-grid-step reference it is held
// against.
//
// Bound on an H100: bytes only (each gathered row read once and written
// once, plus the indices) at 3.35 TB/s; it does no arithmetic. At the
// serving shape (256 queries x 40 survivors x 128 bf16) that is 5.3 MB,
// about 1.6 us; at the trainer's minibatch (256 x 128 f32) 0.07 us, far
// under a launch. What sets the time is latency: the id must arrive before
// its row can be asked for, so a gather is a launch plus two dependent
// round trips to memory, and enough loads must be in flight for the bytes.
//
// gather_kernel (the planner is sgns.py::plan_gather):
//   * a lane group per row: the widest vector (16, 8, 4, 2 or 1 bytes) that
//     divides the row's bytes and both base addresses, and L = min(32, the
//     row's vectors rounded up to a power of two) lanes a row, so a warp
//     copies 32 / L rows a step (two bf16 rows of d = 128, one f32 row); a
//     row wider than 32 vectors loops within its group;
//   * each lane loads its row's id (one coalesced load a warp) and then its
//     vectors (read-only path);
//   * one wave: the planner sizes the grid so that no block waits for
//     another to finish (8 blocks of 256 threads an SM, which
//     __launch_bounds__ guarantees: 32 registers, no spill); past that the
//     grid strides.
// Plain stores: the next kernel reads the output (sgns_grads from L2 on the
// trainer's route, the rescore on the serving path).
//
// gather_rowwise_kernel: one block of one warp per output row, the
// straightforward counterpart of the TPU's one-row grid step (the same
// function; one row in flight per block), 16-byte vectors when the rows and
// bases allow, else bytes. Like the TPU kernels neither checks bounds: the
// caller maps sentinel ids to row 0. Row offsets are 64-bit: a 26.25 M-row
// table is past 2^31 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;      // sgns.GATHER_BLOCKS_PER_SM

template <typename V>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                  long long B, long long units, int lanes_log2,
                  V* __restrict__ out) {
  const long long L = 1 << lanes_log2;
  const long long j = threadIdx.x & (L - 1);      // this lane's first vector
  const long long per_grid =
      (static_cast<long long>(gridDim.x) * THREADS) >> lanes_log2;
  for (long long b =
           (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >>
           lanes_log2;
       b < B; b += per_grid) {
    const V* src = table + static_cast<long long>(__ldg(idx + b)) * units;
    V* dst = out + b * units;
    for (long long u = j; u < units; u += L) dst[u] = __ldg(src + u);
  }
}

template <typename V>
int launch_gather(const void* table, const void* idx, long long B,
                  long long row_bytes, int lanes_log2, int blocks, void* out,
                  cudaStream_t st) {
  gather_kernel<V><<<blocks, THREADS, 0, st>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx), B,
      row_bytes / static_cast<long long>(sizeof(V)), lanes_log2,
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
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
// vec_bytes (16, 8, 4, 2 or 1) divides row_bytes and both bases; a row takes
// 2^lanes_log2 lanes, over `blocks` blocks of 256 threads
// (sgns.py::plan_gather).
extern "C" int gather_rows(const void* table, const void* idx, int B,
                           long long row_bytes, int vec_bytes,
                           int lanes_log2, int blocks, void* out,
                           void* stream) {
  if (B == 0) return 0;
  if (blocks < 1 || lanes_log2 < 0 || lanes_log2 > 5 || vec_bytes < 1 ||
      vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) != 0 ||
      row_bytes % vec_bytes != 0 ||
      (reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) %
              vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16:
      return launch_gather<uint4>(table, idx, B, row_bytes, lanes_log2,
                                  blocks, out, st);
    case 8:
      return launch_gather<uint2>(table, idx, B, row_bytes, lanes_log2,
                                  blocks, out, st);
    case 4:
      return launch_gather<unsigned>(table, idx, B, row_bytes, lanes_log2,
                                     blocks, out, st);
    case 2:
      return launch_gather<unsigned short>(table, idx, B, row_bytes,
                                           lanes_log2, blocks, out, st);
    case 1:
      return launch_gather<unsigned char>(table, idx, B, row_bytes,
                                          lanes_log2, blocks, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
