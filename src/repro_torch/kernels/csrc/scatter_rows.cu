// Row scatter-add table[idx[p]] += upd[p], in place and in position order,
// for Hopper: the port of the JAX package's kernels/sgns.py::scatter_add_rows
// and of its one-row-per-grid-step reference scatter_add_rows_rowwise. The
// trainer's unfused routes (ops.sgns_step, impl "pallas" and "pallas_fused")
// apply -lr * grad to the vertex table over idx_v and to the context table
// over idx_c ++ idx_n with it.
//
// What it computes: for p = 0 .. B-1 in order,
//   table[idx[p]] = T(f32(table[idx[p]]) + f32(T(upd[p])))
// with T the table's dtype: each position's update rounded to T and each
// add rounded to T. That is what the TPU kernel's sequential grid gives
// (duplicates across blocks are serialized by the grid, duplicates within
// a block take its serialized path, sgns.py:738-806). It is not the fused
// update's semantics, which sums a run in f32 and rounds once.
//
// Hopper blocks run in no order, so the order comes from elsewhere:
//
//   scatter_runs      the host sorts idx stably (torch.sort), which keeps
//                     position order within each run of equal ids. One
//                     warp per sorted position; the warp at the start of a
//                     run owns it, reads the row once into registers, adds
//                     the run's updates in sorted (= position) order and
//                     writes the row once. Each row has one owner: no
//                     atomics, and the result is that of the plain version
//                     bit for bit.
//   scatter_rowwise   no sort: each block owns 32 columns, one thread per
//                     column, and walks all B positions in order. No two
//                     threads touch one element, so position order is exact
//                     with no synchronisation. Slow by design (B dependent
//                     steps per thread): it is the reference scatter_runs is
//                     held against.
//
// Bound on an H100: bytes. The update rows are read once and each unique
// row read and written once, plus the ids (B = 2 * 256 + 5 context rows of
// 128 f32: about 0.4 MB, 0.13 us at 3.35 TB/s); one add per element. At the
// trainer's sizes the launch and the longest run (a Zipf hub row's tens of
// positions, walked serially by its warp) set the time.
//
// Row offsets are 64-bit: a 26.25 M x 128 f32 table is 13.4 GB. No index
// bounds are checked (as on the TPU). __fadd_rn keeps the compiler from
// contracting the add with anything around it, so every position rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 32;  // columns per block of scatter_rowwise

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one position's add: the update rounded to T, then the sum rounded to T
template <typename T, typename U>
__device__ __forceinline__ T add_rounded(T row, U upd) {
  return from_f32<T>(
      __fadd_rn(to_f32(row), to_f32(from_f32<T>(to_f32(upd)))));
}

template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
    scatter_runs(T* __restrict__ table, const int* __restrict__ sidx,
                 const long long* __restrict__ perm,
                 const U* __restrict__ upd, int B, int d) {
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= B) return;
  const int row = sidx[j];
  if (j > 0 && sidx[j - 1] == row) return;       // not the start of its run
  int e = j + 1;
  while (e < B && sidx[e] == row) ++e;
  const long long dd = d;
  T* dst = table + static_cast<long long>(row) * dd;
  for (int k = lane; k < d; k += 32) {
    T acc = dst[k];
    for (int p = j; p < e; ++p) acc = add_rounded(acc, upd[perm[p] * dd + k]);
    dst[k] = acc;
  }
}

// table is not __restrict__: a thread reads back rows it wrote itself
template <typename T, typename U>
__global__ void __launch_bounds__(COLS)
    scatter_rowwise(T* table, const int* __restrict__ idx,
                    const U* __restrict__ upd, int B, int d) {
  const int k = blockIdx.x * COLS + threadIdx.x;
  if (k >= d) return;
  const long long dd = d;
  for (int p = 0; p < B; ++p) {
    T* dst = table + static_cast<long long>(idx[p]) * dd + k;
    *dst = add_rounded(*dst, upd[static_cast<long long>(p) * dd + k]);
  }
}

template <typename T, typename U>
int launch_runs(void* table, const void* sidx, const void* perm,
                const void* upd, int B, int d, cudaStream_t st) {
  scatter_runs<T, U><<<(B + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      static_cast<T*>(table), static_cast<const int*>(sidx),
      static_cast<const long long*>(perm), static_cast<const U*>(upd), B, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U>
int launch_rowwise(void* table, const void* idx, const void* upd, int B,
                   int d, cudaStream_t st) {
  scatter_rowwise<T, U><<<(d + COLS - 1) / COLS, COLS, 0, st>>>(
      static_cast<T*>(table), static_cast<const int*>(idx),
      static_cast<const U*>(upd), B, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32 table, 1 = bf16. upd_f32: upd (B, d) is f32 (else in the
// table's dtype; an f32 table takes f32 only). The trainer's routes pass
// f32; upd in the table's dtype is taken as the JAX scatter_add_rows takes
// it, so the two are held against each other on the same inputs. sidx: idx
// sorted stably (int32), perm: its int64 sort permutation.
extern "C" int scatter_add_rows(int dtype, int upd_f32, void* table,
                                const void* sidx, const void* perm,
                                const void* upd, int B, int d, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && upd_f32)
    return launch_runs<float, float>(table, sidx, perm, upd, B, d, st);
  if (dtype == 1 && upd_f32)
    return launch_runs<__nv_bfloat16, float>(table, sidx, perm, upd, B, d,
                                             st);
  if (dtype == 1)
    return launch_runs<__nv_bfloat16, __nv_bfloat16>(table, sidx, perm, upd,
                                                     B, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same function in the reference's order; idx (B,) int32 unsorted.
extern "C" int scatter_add_rows_rowwise(int dtype, int upd_f32, void* table,
                                        const void* idx, const void* upd,
                                        int B, int d, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && upd_f32)
    return launch_rowwise<float, float>(table, idx, upd, B, d, st);
  if (dtype == 1 && upd_f32)
    return launch_rowwise<__nv_bfloat16, float>(table, idx, upd, B, d, st);
  if (dtype == 1)
    return launch_rowwise<__nv_bfloat16, __nv_bfloat16>(table, idx, upd, B, d,
                                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
