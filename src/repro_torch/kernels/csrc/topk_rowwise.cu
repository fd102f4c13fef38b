// Exact MIPS top-k by full scoring and radix selection, for Hopper: the
// port of the JAX package's embed_serve/topk.py::topk_mips_rowwise, the
// TPU kernel that walks the table one row per grid step with the queries
// resident and the (Q, k) output block revisited at every step. It is the
// reference that topk_scan.cu's split-and-merge scan is held against.
//
// What it computes: for every query q and every table row r < valid, the
// f32 score s = q . row (a bf16 row widened with __bfloat162float, the
// query kept in f32) as one fmaf chain over d in index order from 0.f;
// then the k best (score, row) under "score descending, then row
// ascending". Unfilled slots are (-inf, INT32_MAX). The same function as
// topk_scan.cu's scan, and bit for bit the same scores, since both take
// the same fmaf chain; nothing else is shared with it.
//
// Bound on an H100: operations. 2*Q*N*d f32 FMA-operations on the CUDA
// cores (67 TFLOP/s) against N*d*itemsize table bytes: at the serving
// main path (1,048,576 x 128 bf16, Q = 256) 1.03 ms of FMAs against
// 0.08 ms of table bytes.
//
// What held the earlier design back (measured by chip_smoke.py on an H100
// 80GB HBM3 at 700 W: 390.3 device ms at that shape, against 5.0 ms for
// torch.topk(q @ T.float().T)): one thread per query walked every row in
// order, so Q = 256 queries made 8 blocks of one warp each on 8 of 132
// SMs, each thread inserting into its own sorted list: about 6 us per
// 16-row tile, the card almost idle.
//
// Design: the valid rows are walked in chunks of C rows (the wrapper's
// plan: the (Q, C) f32 score scratch stays under a fixed cap), two
// launches per chunk, in order on the stream:
//
//   score_kernel    a GEMM-shaped pass over (query tile x row tile): 64
//                   queries x 128 rows per block of 256 threads, each
//                   thread 4 queries x 8 rows of independent accumulators.
//                   d is staged through shared memory 32 at a time (rows
//                   widened to f32 once, both tiles transposed so a thread
//                   reads its 4 queries and 8 rows as float4), the next
//                   step's loads in flight during this step's FMAs. Each
//                   accumulator is its own fmaf chain over d in index order:
//                   no split over d, no tree sum, no tensor cores.
//   select_kernel   one block per query: an exact radix select of the k
//                   smallest 64-bit keys over the chunk's scores and the k
//                   best carried from the previous chunks. The key is
//                   (~order-preserving bits of the score) << 32 | row, so
//                   ascending key = score descending, then row ascending;
//                   -0.0 is taken as +0.0 (the two compare equal) and rows
//                   are unique, so the k smallest keys are the answer with
//                   its ties resolved. Entries whose key is above the
//                   carried k-th key cannot enter and are skipped. 11-bit
//                   digits, most significant first, are counted in a
//                   shared-memory histogram (lanes with the same digit
//                   combined by __match_any_sync) until the entries that
//                   can still be among the k best number at most CAP (past
//                   k = CAP / 2: a power of two >= 2k, in device memory); one
//                   more pass copies those into shared memory (the first
//                   pass copies them as it counts, and that pass is the
//                   only one when they fit), a bitonic sort orders them,
//                   and the first k are the new carried list. At the main
//                   path the first chunk takes two passes over its
//                   scores, and the later ones one pass that skips all
//                   but a few entries.
//
// No per-split running lists and no merge (the scan's design), no library
// top-k, sort or CUB primitive: that independence is what makes it a
// reference for topk_scan.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TR = 128;              // rows per score block
constexpr int TQ = 64;               // queries per score block
constexpr int KT = 32;               // depth per staged step
constexpr int SCORE_THREADS = 256;   // 16 x 16 threads, 8 rows x 4 queries
constexpr int SEL_THREADS = 512;     // threads per selection block
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int DIGIT = 11;            // radix bits per histogram pass
constexpr int BINS = 1 << DIGIT;
constexpr int CAP = 2048;            // candidates sorted in shared memory
constexpr int IDX_SENTINEL = 0x7fffffff;

// 16 bytes of T, widened to f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
  }
};

// scores[q * ld + r] = queries[q] . table[base + r] for r < n, q < Q.
// Two blocks per SM (at most 128 registers a thread), so one block's
// first loads hide under the other's FMAs.
template <typename T>
__global__ void __launch_bounds__(SCORE_THREADS, 2)
    score_kernel(const T* __restrict__ table,
                 const float* __restrict__ queries, int Q, int d,
                 long long base, int n, int ld, int qtiles,
                 float* __restrict__ scores) {
  constexpr int V = Vec<T>::N;
  constexpr int RLOADS = TR * (KT / V) / SCORE_THREADS;
  constexpr int QLOADS = TQ * (KT / 4) / SCORE_THREADS;
  __shared__ __align__(16) float Rs[KT][TR];
  __shared__ __align__(16) float Qs[KT][TQ];
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x % qtiles) * TQ;
  const int r0 = (blockIdx.x / qtiles) * TR;
  const int tx = tid & 15;             // rows tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid >> 4;             // queries ty*4 .. +3
  const long long dd = d;

  float rv[RLOADS][V];
  float4 qv[QLOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RLOADS; ++i) {
      const int c = i * SCORE_THREADS + tid;
      const int r = c % TR, kk = k0 + (c / TR) * V;
      if (r0 + r < n && kk < d) {
        Vec<T>::load(table + (base + r0 + r) * dd + kk, rv[i]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) rv[i][v] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < QLOADS; ++i) {
      const int c = i * SCORE_THREADS + tid;
      const int qq = c % TQ, kk = k0 + (c / TQ) * 4;
      qv[i] = (q0 + qq < Q && kk < d)
                  ? *reinterpret_cast<const float4*>(
                        queries + (q0 + qq) * dd + kk)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < RLOADS; ++i) {
      const int c = i * SCORE_THREADS + tid;
#pragma unroll
      for (int v = 0; v < V; ++v) Rs[(c / TR) * V + v][c % TR] = rv[i][v];
    }
#pragma unroll
    for (int i = 0; i < QLOADS; ++i) {
      const int c = i * SCORE_THREADS + tid;
      const int s = (c / TQ) * 4, qq = c % TQ;
      Qs[s][qq] = qv[i].x;
      Qs[s + 1][qq] = qv[i].y;
      Qs[s + 2][qq] = qv[i].z;
      Qs[s + 3][qq] = qv[i].w;
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += KT) {
    const int kt = min(KT, d - k0);    // a multiple of 8: d % 8 == 0
    if (k0 + KT < d) fetch(k0 + KT);
    for (int k8 = 0; k8 < kt; k8 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 a = *reinterpret_cast<const float4*>(&Qs[k8 + u][ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Rs[k8 + u][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Rs[k8 + u][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();                   // every thread is done with the tiles
    if (k0 + KT < d) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= Q) continue;
    float* out = scores + static_cast<long long>(q) * ld + r0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h * 64 + tx * 4;
      if (r0 + r + 3 < n) {
        *reinterpret_cast<float4*>(out + r) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r0 + r + j < n) out[r + j] = acc[i][h * 4 + j];
      }
    }
  }
}

// Ascending key = score descending, then row ascending. -0.0 is taken as
// +0.0, since the two compare equal and tie on the row.
__device__ __forceinline__ unsigned long long sort_key(float s, int row) {
  unsigned b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  const unsigned asc = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(~asc) << 32) |
         static_cast<unsigned>(row);
}

// Exclusive prefix sum of x over the block; *total gets the block's sum.
__device__ unsigned block_exclusive_sum(unsigned x, unsigned* warp_sums,
                                        unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < SEL_WARPS ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < SEL_WARPS) warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const unsigned before = (warp > 0 ? warp_sums[warp - 1] : 0u) + inc - x;
  *total = warp_sums[SEL_WARPS - 1];
  __syncthreads();                     // warp_sums may be reused
  return before;
}

// One query's k best over rows base .. base + n - 1 (scores[q * ld + i])
// and the k best carried in best_v / best_i (ignored when first), written
// back to best_v / best_i sorted. The candidates are sorted in shared memory
// (CAP of them), or (GLOBAL: k past CAP / 2) in the query's `cap` slots of
// gkey / gval in device memory, through the same code.
template <bool GLOBAL>
__global__ void __launch_bounds__(SEL_THREADS)
    select_kernel(const float* __restrict__ scores, int ld, int n, int base,
                  int k, int first, float* best_v, int* best_i,
                  unsigned long long* gkey, float* gval, int gcap) {
  __shared__ unsigned hist[BINS];
  __shared__ unsigned long long skey[GLOBAL ? 1 : CAP];
  __shared__ float sval[GLOBAL ? 1 : CAP];
  unsigned long long* ckey = skey;
  float* cval = sval;
  int cap = CAP;
  if constexpr (GLOBAL) {
    ckey = gkey + static_cast<size_t>(blockIdx.x) * gcap;
    cval = gval + static_cast<size_t>(blockIdx.x) * gcap;
    cap = gcap;
  }
  __shared__ unsigned warp_sums[SEL_WARPS];
  __shared__ unsigned s_count, s_digit, s_before, s_matched;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* s = scores + static_cast<long long>(blockIdx.x) * ld;
  float* bv = best_v + static_cast<long long>(blockIdx.x) * k;
  int* bi = best_i + static_cast<long long>(blockIdx.x) * k;
  // nothing worse than the carried k-th entry can be among the k best
  const unsigned long long sentinel = sort_key(-INFINITY, IDX_SENTINEL);
  const unsigned long long limit =
      first ? sentinel : sort_key(bv[k - 1], bi[k - 1]);

  // visit(ok, key, value) for every entry: the chunk's scores, then the
  // carried list. Every lane of a warp calls it the same number of times.
  auto for_each = [&](auto&& visit) {
    const int n4 = (n + 3) / 4;
    for (int i0 = 0; i0 < n4; i0 += SEL_THREADS) {
      const int i = i0 + tid;
      float v[4];
      if (4 * i + 3 < n) {
        const float4 x = reinterpret_cast<const float4*>(s)[i];
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = 4 * i + j < n ? s[4 * i + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = 4 * i + j < n;
        visit(ok, ok ? sort_key(v[j], base + 4 * i + j) : 0ull, v[j]);
      }
    }
    for (int i0 = 0; i0 < k; i0 += SEL_THREADS) {
      const int i = i0 + tid;
      const bool ok = i < k;
      const float v = ok && !first ? bv[i] : -INFINITY;
      visit(ok, ok ? (first ? sentinel : sort_key(v, bi[i])) : 0ull, v);
    }
  };

  // radix select, most significant digit first, until at most cap entries
  // can still be among the k best: (key & mask) < prefix are in (below of
  // them), (key & mask) == prefix compete for the rest
  // them), (key & mask) == prefix compete for the rest. The first pass
  // also copies the entries that can enter into shared memory while they
  // fit: when all of them do, no second pass is needed.
  unsigned long long prefix = 0ull, mask = 0ull;
  unsigned below = 0u;
  if (tid == 0) s_count = 0u;
  for (int shift = 64 - DIGIT;; shift = max(shift - DIGIT, 0)) {
    const bool first_pass = mask == 0ull;
    for (int b = tid; b < BINS; b += SEL_THREADS) hist[b] = 0u;
    __syncthreads();
    for_each([&](bool ok, unsigned long long key, float v) {
      const int bin = ok && key <= limit && (key & mask) == prefix
                          ? static_cast<int>((key >> shift) & (BINS - 1))
                          : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
      if (!first_pass) return;
      const unsigned in = __ballot_sync(0xffffffffu, bin >= 0);
      if (in == 0u) return;
      unsigned slot = 0u;
      if (lane == __ffs(in) - 1) slot = atomicAdd(&s_count, __popc(in));
      slot = __shfl_sync(0xffffffffu, slot, __ffs(in) - 1) +
             __popc(in & ((1u << lane) - 1u));
      if (bin >= 0 && slot < static_cast<unsigned>(cap)) {
        ckey[slot] = key;
        cval[slot] = v;
      }
    });
    __syncthreads();
    // BINS / SEL_THREADS consecutive bins per thread
    constexpr int PER = BINS / SEL_THREADS;
    unsigned mine = 0u;
#pragma unroll
    for (int j = 0; j < PER; ++j) mine += hist[tid * PER + j];
    unsigned total;
    const unsigned ex = block_exclusive_sum(mine, warp_sums, &total);
    if (first_pass && total <= static_cast<unsigned>(cap)) break;  // all copied
    const unsigned need = k - below;   // >= 1, and total >= need
    if (ex < need && need <= ex + mine) {
      unsigned c = ex;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const unsigned h = hist[tid * PER + j];
        if (c + h >= need) {
          s_digit = tid * PER + j;
          s_before = c;
          s_matched = h;
          break;
        }
        c += h;
      }
    }
    __syncthreads();
    below += s_before;
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    mask |= static_cast<unsigned long long>(BINS - 1) << shift;
    const unsigned matched = s_matched;
    __syncthreads();                   // s_* are rewritten next pass
    if (below + matched <= static_cast<unsigned>(cap) || shift == 0) break;
  }

  // the candidates into shared memory (unless the first pass holds them
  // all), then a bitonic sort of their keys
  if (mask != 0ull) {
    if (tid == 0) s_count = 0u;
    __syncthreads();
    for_each([&](bool ok, unsigned long long key, float v) {
      if (ok && key <= limit && (key & mask) <= prefix) {
        const unsigned slot = atomicAdd(&s_count, 1u);
        ckey[slot] = key;
        cval[slot] = v;
      }
    });
    __syncthreads();
  }
  const int count = static_cast<int>(s_count);
  int n2 = 1;
  while (n2 < count) n2 <<= 1;
  for (int i = count + tid; i < n2; i += SEL_THREADS) ckey[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (n2 >> 1); i += SEL_THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = ckey[lo], b = ckey[hi];
        if ((a > b) == ((lo & size) == 0)) {
          ckey[lo] = b;
          ckey[hi] = a;
          const float t = cval[lo];
          cval[lo] = cval[hi];
          cval[hi] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += SEL_THREADS) {
    bv[i] = cval[i];
    bi[i] = static_cast<int>(ckey[i] & 0xffffffffu);
  }
}

template <typename T>
int launch(const void* table, const void* queries, int Q, int d, int valid,
           int k, int chunk_rows, void* scratch, void* out_v, void* out_i,
           void* cand, int cap, cudaStream_t stream) {
  const int qtiles = (Q + TQ - 1) / TQ;
  for (int base = 0; base < valid; base += chunk_rows) {
    const int n = min(chunk_rows, valid - base);
    const int blocks = qtiles * ((n + TR - 1) / TR);
    score_kernel<T><<<blocks, SCORE_THREADS, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const float*>(queries), Q,
        d, base, n, chunk_rows, qtiles, static_cast<float*>(scratch));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    unsigned long long* gkey = static_cast<unsigned long long*>(cand);
    float* gval = reinterpret_cast<float*>(gkey + static_cast<size_t>(Q) * cap);
    if (cand == nullptr)
      select_kernel<false><<<Q, SEL_THREADS, 0, stream>>>(
          static_cast<const float*>(scratch), chunk_rows, n, base, k,
          base == 0, static_cast<float*>(out_v), static_cast<int*>(out_i),
          nullptr, nullptr, CAP);
    else
      select_kernel<true><<<Q, SEL_THREADS, 0, stream>>>(
          static_cast<const float*>(scratch), chunk_rows, n, base, k,
          base == 0, static_cast<float*>(out_v), static_cast<int*>(out_i),
          gkey, gval, cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. table: (rows, d) row-major, 16-byte aligned,
// d % 8 == 0; rows >= valid are never read (valid >= 1). queries: (Q, d)
// f32, 16-byte aligned. k >= 1: up to CAP / 2 the candidates are sorted in
// shared memory (cand null); past it in cand, (Q, cap) 64-bit keys then
// (Q, cap) f32, cap a power of two >= 2k. chunk_rows: a multiple of 4;
// scratch: (Q, chunk_rows) f32. out_v/out_i: (Q, k), written in full.
extern "C" int topk_rowwise(int dtype, const void* table, const void* queries,
                            int Q, int d, int valid, int k, int chunk_rows,
                            void* scratch, void* out_v, void* out_i,
                            void* cand, int cap, void* stream) {
  if (Q == 0) return 0;
  const bool global = 2 * k > CAP;
  if (k < 1 || chunk_rows < 4 || chunk_rows % 4 || global != (cand != nullptr) ||
      (global && (cap < 2 * k || (cap & (cap - 1)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(table, queries, Q, d, valid, k, chunk_rows,
                           scratch, out_v, out_i, cand, cap, st);
    case 1:
      return launch<__nv_bfloat16>(table, queries, Q, d, valid, k,
                                   chunk_rows, scratch, out_v, out_i, cand,
                                   cap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
