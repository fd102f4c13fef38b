// Row-sequential exact MIPS top-k for Hopper: the port of the JAX package's
// embed_serve/topk.py::topk_mips_rowwise, the TPU kernel that walks the
// table one row per grid step with the queries resident and the (Q, k)
// output block revisited at every step.
//
// What it computes: for every query q and every table row r < valid, in
// ascending r, the f32 score s = q . row (a bf16 row widened with
// __bfloat162float, the query kept in f32), inserted into a sorted k-list
// when (s, r) beats its last entry under "score descending, then row
// ascending". Unfilled slots are (-inf, INT32_MAX). The same function as
// topk_scan.cu's scan.
//
// Design: one thread owns one query and walks every row in order; a block
// is one warp of BQ = 32 queries. Rows come in tiles of RT rows: the raw
// bytes of tile t + 1 are copied into shared memory with cp.async while
// tile t is scored, then widened to f32 once per block and read by every
// thread as a broadcast. Each thread scores the RT rows of a tile as RT
// independent fmaf chains over d in index order from 0.f, which is the
// order of topk_scan.cu's per-thread loop, so the two kernels agree bit
// for bit on any input. Then it offers the RT scores to its own k-list (in
// shared memory, slot-major) in row order. No row range is split and
// nothing is merged: that is what makes it an independent reference for
// topk_scan.cu, whose split-and-merge is the thing it checks.
//
// Bound on an H100: the same work as the scan (2*Q*N*d f32 FMA, 67 TFLOP/s
// on the CUDA cores), but the kernel is latency-bound by design: its
// parallelism is Q threads (Q / 32 SMs busy), each walking all N rows.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;               // queries per block == threads
constexpr int RT = 16;               // rows per staged tile
constexpr int IDX_SENTINEL = 0x7fffffff;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Insert (v, i) into the thread's sorted list (slot s at L[s * BQ + tid]);
// the caller has checked that it beats the last entry.
__device__ __noinline__ void insert(float* Lv, int* Li, int k, float v, int i,
                                    int tid) {
  int p = k - 1;
  while (p > 0) {
    const float pv = Lv[(p - 1) * BQ + tid];
    const int pi = Li[(p - 1) * BQ + tid];
    if (!better(v, i, pv, pi)) break;
    Lv[p * BQ + tid] = pv;
    Li[p * BQ + tid] = pi;
    --p;
  }
  Lv[p * BQ + tid] = v;
  Li[p * BQ + tid] = i;
}

// Start the asynchronous copy of tile t's raw rows into the staging slot.
template <typename T>
__device__ __forceinline__ void stage(const T* table, int d, int valid, int t,
                                      unsigned char* raw, int tid) {
  const long long r0 = static_cast<long long>(t) * RT;
  const int n = static_cast<int>(min(static_cast<long long>(RT), valid - r0));
  const int chunks = n * d * static_cast<int>(sizeof(T)) / 16;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(table + r0 * d);
  for (int c = tid; c < chunks; c += BQ) {
    __pipeline_memcpy_async(raw + 16 * c, src + 16 * c, 16);
  }
  __pipeline_commit();
}

template <typename T>
__global__ void __launch_bounds__(BQ)
    rowwise_kernel(const T* __restrict__ table,
                   const float* __restrict__ queries, int Q, int d, int valid,
                   int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float4* qs4 = smem4;                             // (d/4, BQ) queries
  float* rf = reinterpret_cast<float*>(qs4 + (d / 4) * BQ);   // (RT, d) f32
  float* Lv = rf + RT * d;                         // (k, BQ) running scores
  int* Li = reinterpret_cast<int*>(Lv + k * BQ);   // (k, BQ) running rows
  unsigned char* raw = reinterpret_cast<unsigned char*>(Li + k * BQ);
  const int tid = threadIdx.x;
  const int q = blockIdx.x * BQ + tid;
  const bool live = q < Q;
  const int d4 = d / 4;

  const float4* qrow =
      reinterpret_cast<const float4*>(queries + static_cast<size_t>(q) * d);
  for (int j = 0; j < d4; ++j) {
    qs4[j * BQ + tid] = live ? qrow[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s = 0; s < k; ++s) {
    Lv[s * BQ + tid] = -INFINITY;
    Li[s * BQ + tid] = IDX_SENTINEL;
  }
  float last_v = -INFINITY;
  int last_i = IDX_SENTINEL;

  const int tiles = (valid + RT - 1) / RT;
  stage(table, d, valid, 0, raw, tid);
  for (int t = 0; t < tiles; ++t) {
    __pipeline_wait_prior(0);
    __syncthreads();  // tile t landed; every thread is done with rf
    const int n = min(RT, valid - t * RT);
    const T* src = reinterpret_cast<const T*>(raw);
    for (int e = tid; e < n * d; e += BQ) rf[e] = widen(src[e]);
    __syncthreads();  // the staging slot is free: tile t + 1 flies into it
    if (t + 1 < tiles) stage(table, d, valid, t + 1, raw, tid);

    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    const float4* rf4 = reinterpret_cast<const float4*>(rf);
    for (int j = 0; j < d4; ++j) {
      const float4 a = qs4[j * BQ + tid];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 b = rf4[r * d4 + j];
        float s = acc[r];
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
        acc[r] = s;
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int row = t * RT + r;
        if (r < n && better(acc[r], row, last_v, last_i)) {
          insert(Lv, Li, k, acc[r], row, tid);
          last_v = Lv[(k - 1) * BQ + tid];
          last_i = Li[(k - 1) * BQ + tid];
        }
      }
    }
  }

  if (live) {
    for (int s = 0; s < k; ++s) {
      out_v[static_cast<size_t>(q) * k + s] = Lv[s * BQ + tid];
      out_i[static_cast<size_t>(q) * k + s] = Li[s * BQ + tid];
    }
  }
}

template <typename T>
int launch(const void* table, const void* queries, int Q, int d, int valid,
           int k, void* out_v, void* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ) * d +
                                       static_cast<size_t>(RT) * d) +
                      static_cast<size_t>(BQ) * k * (sizeof(float) +
                                                     sizeof(int)) +
                      sizeof(T) * static_cast<size_t>(RT) * d;
  cudaError_t e = cudaFuncSetAttribute(
      rowwise_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rowwise_kernel<T><<<(Q + BQ - 1) / BQ, BQ, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const float*>(queries), Q, d,
      valid, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. table: (rows, d) row-major, 16-byte aligned,
// d % 8 == 0; rows >= valid are never read (valid >= 1). queries: (Q, d)
// f32, 16-byte aligned. out_v/out_i: (Q, k).
extern "C" int topk_rowwise(int dtype, const void* table, const void* queries,
                            int Q, int d, int valid, int k, void* out_v,
                            void* out_i, void* stream) {
  if (Q == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(table, queries, Q, d, valid, k, out_v, out_i, st);
    case 1:
      return launch<__nv_bfloat16>(table, queries, Q, d, valid, k, out_v,
                                   out_i, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
