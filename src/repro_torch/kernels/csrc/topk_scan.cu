// Exact MIPS top-k scan for Hopper: the port of the JAX package's
// embed_serve/topk.py::topk_mips (f32 and bf16 tables) and
// topk_mips_quant (int8 tables with per-row scales), both launched there
// by _launch_topk_scan.
//
// What it computes: for every query q and every table row r < valid, the
// f32 score s = q . row (an int8 row: s = (q . row) * scale[r], the scale
// applied after the dot), and the k best (s, r) under the total order
// "score descending, then row ascending". Unfilled slots are
// (-inf, INT32_MAX).
//
// The TPU kernel walks row tiles as a sequential grid axis into a revisited
// output block. Hopper blocks run in no order, so this is two kernels:
//
//   1. topk_scan_partials: grid (query blocks x row splits). A block stages
//      BQ queries in shared memory as f32 (never rounded to bf16), walks its
//      own row range in tiles of TN rows (one row per thread, f32 FMA over
//      the row, bf16 widened with __bfloat162float), and folds each tile
//      into a running top-k per query held in shared memory. One warp folds
//      one query at a time: a ballot finds the tile rows that beat the k-th
//      entry, and each is inserted in order. Output: (Q, splits, k).
//   2. topk_scan_merge: one warp per query takes the top-k of the splits*k
//      partial candidates under the same order. Each partial list is
//      sorted, so a list is abandoned at its first candidate that loses.
//
// Bound on an H100 at the serving shape (26.25 M x 128 bf16 rows, 256
// queries): 2*Q*N*d = 1.7 TFLOP of f32 FMA on the CUDA cores (67 TFLOP/s,
// 25.7 ms) against 6.7 GB of table (3.35 TB/s, 2.0 ms), so it is
// operation-bound. The design keeps the FMA loop fed from registers (the
// row) and broadcast shared-memory reads (the queries), and makes BQ as
// large as shared memory allows so the table is read Q/BQ times. Tensor
// cores, TMA and wgmma are not used yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TN = 256;              // rows per tile == threads per block
constexpr int WARPS = TN / 32;
constexpr int MERGE_WARPS = 4;       // queries per merge block
constexpr int IDX_SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Eight consecutive row elements as f32.
template <typename T>
struct Row8;

template <>
struct Row8<float> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

template <>
struct Row8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat16_raw lo, hi;
      lo.x = static_cast<unsigned short>(w[i] & 0xffffu);
      hi.x = static_cast<unsigned short>(w[i] >> 16);
      x[2 * i] = __bfloat162float(__nv_bfloat16(lo));
      x[2 * i + 1] = __bfloat162float(__nv_bfloat16(hi));
    }
  }
};

template <>
struct Row8<int8_t> {
  static __device__ __forceinline__ void load(const int8_t* p, float* x) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const unsigned w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = static_cast<float>(
          static_cast<signed char>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
    }
  }
};

// Insert (cv, ci) into the sorted list (Lv, Li) of length k; the caller has
// checked that it beats the last entry. All 32 lanes call this together.
__device__ void warp_insert(float* Lv, int* Li, int k, float cv, int ci,
                            int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const bool b = i < k && better(Lv[i], Li[i], cv, ci);
    pos += __popc(__ballot_sync(FULL, b));
  }
  // shift [pos, k - 1) up by one slot, top chunk first
  for (int base = ((k - 1) / 32) * 32; base >= 0 && base + 31 > pos;
       base -= 32) {
    const int i = base + lane;
    const bool mv = i > pos && i < k;
    float v = 0.f;
    int x = 0;
    if (mv) {
      v = Lv[i - 1];
      x = Li[i - 1];
    }
    __syncwarp();
    if (mv) {
      Lv[i] = v;
      Li[i] = x;
    }
    __syncwarp();
  }
  if (lane == 0) {
    Lv[pos] = cv;
    Li[pos] = ci;
  }
  __syncwarp();
}

// Offer one candidate per lane (live lanes only) to the list, lowest lane
// first. Returns the ballot of lanes that beat the list's last entry on
// entry.
__device__ unsigned warp_offer(float* Lv, int* Li, int k, float v, int gi,
                               bool live, int lane) {
  const bool pass = live && better(v, gi, Lv[k - 1], Li[k - 1]);
  const unsigned first = __ballot_sync(FULL, pass);
  unsigned m = first;
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, v, j);
    const int ci = __shfl_sync(FULL, gi, j);
    if (better(cv, ci, Lv[k - 1], Li[k - 1])) {
      warp_insert(Lv, Li, k, cv, ci, lane);
    }
  }
  return first;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(TN)
    scan_kernel(const T* __restrict__ table, const float* __restrict__ scales,
                const float* __restrict__ queries, int Q, int d, int valid,
                int k, int rows_per_split, float* __restrict__ part_v,
                int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // (BQ, d) queries
  float* sc = qs + BQ * d;                       // (BQ, TN) tile scores
  float* Lv = sc + BQ * TN;                      // (BQ, k) running scores
  int* Li = reinterpret_cast<int*>(Lv + BQ * k); // (BQ, k) running rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, splits = gridDim.y;

  for (int e = tid; e < BQ * d; e += TN) {
    const int q = e / d;
    qs[e] = q0 + q < Q ? queries[static_cast<size_t>(q0 + q) * d + e % d]
                       : 0.f;
  }
  for (int e = tid; e < BQ * k; e += TN) {
    Lv[e] = -INFINITY;
    Li[e] = IDX_SENTINEL;
  }
  __syncthreads();

  const long long begin = static_cast<long long>(split) * rows_per_split;
  const long long end =
      min(begin + rows_per_split, static_cast<long long>(valid));
  for (long long t0 = begin; t0 < end; t0 += TN) {
    const long long row = t0 + tid;
    float acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = 0.f;
    if (row < end) {
      const T* p = table + row * d;
      for (int j = 0; j < d; j += 8) {
        float x[8];
        Row8<T>::load(p + j, x);
#pragma unroll
        for (int q = 0; q < BQ; ++q) {
          const float4* qq = reinterpret_cast<const float4*>(qs + q * d + j);
          const float4 a = qq[0], b = qq[1];
          float s = acc[q];
          s = fmaf(a.x, x[0], s);
          s = fmaf(a.y, x[1], s);
          s = fmaf(a.z, x[2], s);
          s = fmaf(a.w, x[3], s);
          s = fmaf(b.x, x[4], s);
          s = fmaf(b.y, x[5], s);
          s = fmaf(b.z, x[6], s);
          s = fmaf(b.w, x[7], s);
          acc[q] = s;
        }
      }
      if (scales != nullptr) {
        const float s = scales[row];
#pragma unroll
        for (int q = 0; q < BQ; ++q) acc[q] = acc[q] * s;
      }
    }
#pragma unroll
    for (int q = 0; q < BQ; ++q) sc[q * TN + tid] = acc[q];
    __syncthreads();
    const int n = static_cast<int>(min(static_cast<long long>(TN), end - t0));
    for (int q = warp; q < BQ; q += WARPS) {
      if (q0 + q >= Q) continue;
      for (int c = 0; c < n; c += 32) {
        const int r = c + lane;
        const bool live = r < n;
        warp_offer(Lv + q * k, Li + q * k, k, live ? sc[q * TN + r] : 0.f,
                   static_cast<int>(t0) + r, live, lane);
      }
    }
    __syncthreads();
  }

  for (int q = warp; q < BQ; q += WARPS) {
    if (q0 + q >= Q) continue;
    const size_t base = (static_cast<size_t>(q0 + q) * splits + split) * k;
    for (int i = lane; i < k; i += 32) {
      part_v[base + i] = Lv[q * k + i];
      part_i[base + i] = Li[q * k + i];
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
    merge_kernel(const float* __restrict__ part_v,
                 const int* __restrict__ part_i, int Q, int splits, int k,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= Q) return;  // whole warp; no block-wide barrier follows
  float* Lv = reinterpret_cast<float*>(smem4) + warp * k;
  int* Li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem4) +
                                   MERGE_WARPS * k) + warp * k;
  for (int i = lane; i < k; i += 32) {
    Lv[i] = -INFINITY;
    Li[i] = IDX_SENTINEL;
  }
  __syncwarp();
  for (int s = 0; s < splits; ++s) {
    const size_t base = (static_cast<size_t>(q) * splits + s) * k;
    for (int c = 0; c < k; c += 32) {
      const int r = c + lane;
      const bool live = r < k;
      const float v = live ? part_v[base + r] : -INFINITY;
      const int gi = live ? part_i[base + r] : IDX_SENTINEL;
      const unsigned took = warp_offer(Lv, Li, k, v, gi, live, lane);
      // each partial list is sorted: once one candidate loses, the rest of
      // the list loses too (the k-th entry only gets better)
      if (took != __ballot_sync(FULL, live)) break;
    }
  }
  for (int i = lane; i < k; i += 32) {
    out_v[static_cast<size_t>(q) * k + i] = Lv[i];
    out_i[static_cast<size_t>(q) * k + i] = Li[i];
  }
}

template <typename T, int BQ>
int launch_scan(const void* table, const void* scales, const void* queries,
                int Q, int d, int valid, int k, int rows_per_split,
                int splits, void* part_v, void* part_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ) * d +
                                       static_cast<size_t>(BQ) * TN) +
                      static_cast<size_t>(BQ) * k * (sizeof(float) +
                                                     sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<T, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Q + BQ - 1) / BQ, splits);
  scan_kernel<T, BQ><<<grid, TN, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const float*>(scales),
      static_cast<const float*>(queries), Q, d, valid, k, rows_per_split,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bq(int bq, const void* table, const void* scales,
                const void* queries, int Q, int d, int valid, int k,
                int rows_per_split, int splits, void* part_v, void* part_i,
                cudaStream_t stream) {
  switch (bq) {
    case 64:
      return launch_scan<T, 64>(table, scales, queries, Q, d, valid, k,
                                rows_per_split, splits, part_v, part_i,
                                stream);
    case 32:
      return launch_scan<T, 32>(table, scales, queries, Q, d, valid, k,
                                rows_per_split, splits, part_v, part_i,
                                stream);
    case 16:
      return launch_scan<T, 16>(table, scales, queries, Q, d, valid, k,
                                rows_per_split, splits, part_v, part_i,
                                stream);
    case 8:
      return launch_scan<T, 8>(table, scales, queries, Q, d, valid, k,
                               rows_per_split, splits, part_v, part_i,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8 (scales required); bq in {8,16,32,64}.
// The table is (rows, d) row-major with d % 8 == 0 and 16-byte rows
// aligned; rows >= valid are never read. part_v/part_i: (Q, splits, k).
extern "C" int topk_scan_partials(int dtype, int bq, const void* table,
                                  const void* scales, const void* queries,
                                  int Q, int d, int valid, int k,
                                  int rows_per_split, int splits,
                                  void* part_v, void* part_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_bq<float>(bq, table, nullptr, queries, Q, d, valid, k,
                                rows_per_split, splits, part_v, part_i, st);
    case 1:
      return dispatch_bq<__nv_bfloat16>(bq, table, nullptr, queries, Q, d,
                                        valid, k, rows_per_split, splits,
                                        part_v, part_i, st);
    case 2:
      if (scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_bq<int8_t>(bq, table, scales, queries, Q, d, valid, k,
                                 rows_per_split, splits, part_v, part_i, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// (Q, splits, k) partial lists -> (Q, k) under the same order.
extern "C" int topk_scan_merge(const void* part_v, const void* part_i, int Q,
                               int splits, int k, void* out_v, void* out_i,
                               void* stream) {
  const size_t smem =
      static_cast<size_t>(MERGE_WARPS) * k * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (Q + MERGE_WARPS - 1) / MERGE_WARPS;
  merge_kernel<<<blocks, MERGE_WARPS * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), Q,
      splits, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
