// Fused SGNS minibatch for Hopper: the port of the JAX package's
// kernels/sgns.py::sgns_fused_update (combine="segsum"), of its
// gather-and-grads sibling sgns_fused_grads and of sgns_grads, the
// gradients of rows gathered beforehand.
//
// What it computes, for one minibatch of B (vertex, context) pairs sharing
// S negative context rows:
//   v = vert[idx_v], c = ctx[idx_c], n = ctx[idx_n]     (widened to f32)
//   pos = <v_b, c_b>, neg = v n^T, g_pos = (sigmoid(pos) - 1) m,
//   g_neg = sigmoid(neg) m, dv = g_pos c + g_neg n, dc = g_pos v,
//   dn = g_neg^T v, loss = sum m softplus(-pos) + sum m softplus(neg)
// and then, for the update, every unique row r of each table gets
//   table[r] = table[r] + cast(-lr * sum of the gradients aimed at r)
// once, with the sum over its positions in f32 (vertex side over idx_v;
// context side over idx_c ++ idx_n, where position p >= B is negative
// p - B), the update cast to the table's dtype and the add rounded to it.
//
// The TPU kernel is one sequential grid over a VMEM scratch: dn and the loss
// accumulate from tile to tile and the apply runs at the last step. Hopper
// blocks run in no order, so the work is two kernels on one stream:
//
//   sgns_tile_grads      one block per bb minibatch rows: gathers its v and
//                        c rows and all S negative rows into shared memory
//                        as f32, computes the tile's scores and gradients,
//                        writes dv and dc for its rows and its own (S, d) dn
//                        partial and loss partial (no float atomics).
//   sgns_combine_apply   one warp per run of equal indices in the sorted
//                        index vectors (the host sorts them, stably, as the
//                        JAX wrapper argsorts them outside the kernel). The
//                        warp sums its run's gradients in sorted-position
//                        order, reducing the dn partials of a negative
//                        position in block order, reads the row (nothing has
//                        written it yet: the pre-update value) and writes
//                        the new value once. Each unique row has exactly one
//                        owner, so there are no races and no atomics and a
//                        run repeats bitwise.
//
// sgns_fused_grads is sgns_tile_grads (gradients in the table's dtype) plus
// sgns_reduce_partials, the fixed-order sum of the dn and loss partials.
// sgns_grads is the same pair with the gather taken out: its index
// pointers are null, so row r of a tile is row row0 + r of v and c, and
// negative s is row s of n. dn is summed in f32 and cast once, as the TPU
// kernel accumulates it in an f32 output (sgns.py:105, 127).
//
// Bound on an H100: bytes. A minibatch reads (2B + S) rows and writes the
// unique ones (B = 256, S = 5, d = 128 f32: about 0.5 MB, 0.15 us at
// 3.35 TB/s) and does about 6BSd + 4Bd operations (1.1 MFLOP, 0.02 us at the
// 67 TFLOP/s f32 rate); sgns_grads reads and writes (2B + S) rows. Launch
// and the host's sort dominate at that size; this design keeps every row
// read once from device memory and the gradients in f32 scratch, and
// leaves batching several minibatches into one launch to later work.
//
// Row offsets are 64-bit: a 26.25 M x 128 f32 table is 13.4 GB, past 2^31
// bytes. The kernels check no index bounds (as on the TPU).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// jax.nn.sigmoid and jax.nn.softplus (= logaddexp(x, 0)) in f32
__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float softplus_f32(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Row i of a table addressed through idx, or row i itself when idx is null
// (rows gathered beforehand).
__device__ __forceinline__ long long row_of(const int* idx, int i) {
  return idx != nullptr ? static_cast<long long>(idx[i])
                        : static_cast<long long>(i);
}

__device__ __forceinline__ float load_mask(const void* mask, int mask_bf16,
                                           int b) {
  return mask_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(mask)[b])
             : static_cast<const float*>(mask)[b];
}

// Shared memory (floats): v (bb, d), c (bb, d), n (S, d), g and l
// (bb, S + 1) each (column 0 the positive pair, 1 + s negative s), m (bb).
// v, c and n rows come from vsrc, csrc and nsrc through idx_v, idx_c and
// idx_n, each null when its rows were gathered beforehand.
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
    sgns_tile_grads(const T* __restrict__ vsrc, const T* __restrict__ csrc,
                    const T* __restrict__ nsrc,
                    const int* __restrict__ idx_v,
                    const int* __restrict__ idx_c,
                    const int* __restrict__ idx_n,
                    const void* __restrict__ mask, int mask_bf16, int B,
                    int S, int d, int bb, OutT* __restrict__ dv,
                    OutT* __restrict__ dc, float* __restrict__ dn_part,
                    float* __restrict__ loss_part) {
  extern __shared__ float smem[];
  const int T1 = S + 1;
  float* v_s = smem;
  float* c_s = v_s + bb * d;
  float* n_s = c_s + bb * d;
  float* g_s = n_s + S * d;
  float* l_s = g_s + bb * T1;
  float* m_s = l_s + bb * T1;
  const int row0 = blockIdx.x * bb;
  const int rows = min(bb, B - row0);
  const long long dd = d;

  // gather: neighbouring threads read neighbouring columns of a row
  for (int i = threadIdx.x; i < bb * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    float v = 0.0f, c = 0.0f;
    if (r < rows) {
      v = to_f32(vsrc[row_of(idx_v, row0 + r) * dd + k]);
      c = to_f32(csrc[row_of(idx_c, row0 + r) * dd + k]);
    }
    v_s[i] = v;
    c_s[i] = c;
  }
  for (int i = threadIdx.x; i < S * d; i += THREADS) {
    const int s = i / d, k = i - s * d;
    n_s[i] = to_f32(nsrc[row_of(idx_n, s) * dd + k]);
  }
  for (int r = threadIdx.x; r < bb; r += THREADS)
    m_s[r] = r < rows ? load_mask(mask, mask_bf16, row0 + r) : 0.0f;
  __syncthreads();

  // scores: one warp per dot product, a fixed shuffle tree per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < rows * T1; q += WARPS) {
    const int r = q / T1, t = q - r * T1;
    const float* a = v_s + r * d;
    const float* b = t == 0 ? c_s + r * d : n_s + (t - 1) * d;
    float acc = 0.0f;
    for (int k = lane; k < d; k += 32) acc += a[k] * b[k];
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const float m = m_s[r];
      if (t == 0) {
        g_s[q] = (sigmoid_f32(acc) - 1.0f) * m;
        l_s[q] = m * softplus_f32(-acc);
      } else {
        g_s[q] = sigmoid_f32(acc) * m;
        l_s[q] = m * softplus_f32(acc);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    const float* g = g_s + r * T1;
    float acc = g[0] * c_s[i];
    for (int s = 0; s < S; ++s) acc += g[1 + s] * n_s[s * d + k];
    const long long o = static_cast<long long>(row0 + r) * dd + k;
    dv[o] = from_f32<OutT>(acc);
    dc[o] = from_f32<OutT>(g[0] * v_s[i]);
  }
  float* dn = dn_part + static_cast<long long>(blockIdx.x) * S * dd;
  for (int i = threadIdx.x; i < S * d; i += THREADS) {
    const int s = i / d, k = i - s * d;
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += g_s[r * T1 + 1 + s] * v_s[r * d + k];
    dn[i] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int q = 0; q < rows * T1; ++q) acc += l_s[q];
    loss_part[blockIdx.x] = acc;
  }
}

__device__ __forceinline__ float sum_loss(const float* loss_part, int nblk) {
  float acc = loss_part[0];
  for (int b = 1; b < nblk; ++b) acc += loss_part[b];
  return acc;
}

// dn[s, k] = sum over blocks, in block order, of the partials; and the loss.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    sgns_reduce_partials(const float* __restrict__ dn_part,
                         const float* __restrict__ loss_part, int nblk, int S,
                         int d, OutT* __restrict__ dn,
                         float* __restrict__ loss) {
  const long long n = static_cast<long long>(S) * d;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i < n) {
    float acc = dn_part[i];
    for (int b = 1; b < nblk; ++b) acc += dn_part[b * n + i];
    dn[i] = from_f32<OutT>(acc);
  }
  if (i == 0) *loss = sum_loss(loss_part, nblk);
}

// One warp per sorted position; the warp at the first position of a run
// owns the run. Warps [0, B) cover the vertex side, [B, 2B + S) the
// context side (idx_c ++ idx_n).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    sgns_combine_apply(T* __restrict__ vert, T* __restrict__ ctx,
                       const int* __restrict__ ivs,
                       const long long* __restrict__ perm_v,
                       const int* __restrict__ icns,
                       const long long* __restrict__ perm_c,
                       const float* __restrict__ dv,
                       const float* __restrict__ dc,
                       const float* __restrict__ dn_part,
                       const float* __restrict__ loss_part, int nblk, int B,
                       int S, int d, float neg_lr, float* __restrict__ loss) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *loss = sum_loss(loss_part, nblk);
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int L = B + S;
  if (w >= B + L) return;
  const bool vside = w < B;
  const int n = vside ? B : L;
  const int j = vside ? w : w - B;
  const int* sidx = vside ? ivs : icns;
  const long long* perm = vside ? perm_v : perm_c;
  const int row = sidx[j];
  if (j > 0 && sidx[j - 1] == row) return;       // not the start of its run
  int e = j + 1;
  while (e < n && sidx[e] == row) ++e;
  const long long dd = d;
  const long long sd = static_cast<long long>(S) * d;
  T* dst = (vside ? vert : ctx) + static_cast<long long>(row) * dd;
  for (int k = lane; k < d; k += 32) {
    float acc = 0.0f;
    for (int p = j; p < e; ++p) {
      const long long q = perm[p];
      float g;
      if (vside) {
        g = dv[q * dd + k];
      } else if (q < B) {
        g = dc[q * dd + k];
      } else {
        const float* src = dn_part + (q - B) * dd + k;
        g = src[0];
        for (int b = 1; b < nblk; ++b) g += src[b * sd];
      }
      acc = p == j ? g : acc + g;
    }
    // the update rounded to the table's dtype, then one add rounded to it;
    // the _rn intrinsics keep the compiler from fusing them into an FMA
    const float upd = to_f32(from_f32<T>(__fmul_rn(neg_lr, acc)));
    dst[k] = from_f32<T>(__fadd_rn(to_f32(dst[k]), upd));
  }
}

template <typename T, typename OutT>
int launch_tile_grads(const void* vsrc, const void* csrc, const void* nsrc,
                      const void* idx_v, const void* idx_c,
                      const void* idx_n, const void* mask,
                      int mask_bf16, int B, int S, int d, int bb, int smem,
                      void* dv, void* dc, void* dn_part, void* loss_part,
                      cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgns_tile_grads<T, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nblk = (B + bb - 1) / bb;
  sgns_tile_grads<T, OutT><<<nblk, THREADS, smem, st>>>(
      static_cast<const T*>(vsrc), static_cast<const T*>(csrc),
      static_cast<const T*>(nsrc), static_cast<const int*>(idx_v),
      static_cast<const int*>(idx_c), static_cast<const int*>(idx_n), mask,
      mask_bf16, B, S, d, bb,
      static_cast<OutT*>(dv), static_cast<OutT*>(dc),
      static_cast<float*>(dn_part), static_cast<float*>(loss_part));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update(void* vert, void* ctx, const void* idx_v, const void* idx_c,
                  const void* idx_n, const void* mask, int mask_bf16, int B,
                  int S, int d, float lr, int bb, int smem, const void* ivs,
                  const void* perm_v, const void* icns, const void* perm_c,
                  void* dv, void* dc, void* dn_part, void* loss_part,
                  void* loss, cudaStream_t st) {
  int rc = launch_tile_grads<T, float>(vert, ctx, ctx, idx_v, idx_c, idx_n,
                                       mask, mask_bf16, B, S, d, bb, smem, dv,
                                       dc, dn_part, loss_part, st);
  if (rc != 0) return rc;
  const int nblk = (B + bb - 1) / bb;
  const int warps = 2 * B + S;
  sgns_combine_apply<T><<<(warps + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      static_cast<T*>(vert), static_cast<T*>(ctx),
      static_cast<const int*>(ivs), static_cast<const long long*>(perm_v),
      static_cast<const int*>(icns), static_cast<const long long*>(perm_c),
      static_cast<const float*>(dv), static_cast<const float*>(dc),
      static_cast<const float*>(dn_part),
      static_cast<const float*>(loss_part), nblk, B, S, d, -lr,
      static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grads(const void* vsrc, const void* csrc, const void* nsrc,
                 const void* idx_v, const void* idx_c, const void* idx_n,
                 const void* mask, int mask_bf16, int B, int S, int d, int bb,
                 int smem, void* dv, void* dc, void* dn_part, void* loss_part,
                 void* dn, void* loss, cudaStream_t st) {
  int rc = launch_tile_grads<T, T>(vsrc, csrc, nsrc, idx_v, idx_c, idx_n,
                                   mask, mask_bf16, B, S, d, bb, smem, dv, dc,
                                   dn_part, loss_part, st);
  if (rc != 0) return rc;
  const int nblk = (B + bb - 1) / bb;
  const long long n = static_cast<long long>(S) * d;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  sgns_reduce_partials<T><<<blocks > 0 ? blocks : 1, THREADS, 0, st>>>(
      static_cast<const float*>(dn_part), static_cast<const float*>(loss_part),
      nblk, S, d, static_cast<T*>(dn), static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32 tables, 1 = bf16. mask: (B,) f32, or bf16 when mask_bf16.
// Tables are updated in place; ivs/icns are the stably sorted idx_v and
// idx_c ++ idx_n (int32), perm_v/perm_c their int64 sort permutations;
// dv, dc: (B, d) f32, dn_part: (ceil(B / bb), S, d) f32 and loss_part:
// (ceil(B / bb),) f32 are scratch; loss: (1,) f32 out.
extern "C" int sgns_fused_update(int dtype, int mask_bf16, void* vert,
                                 void* ctx, const void* idx_v,
                                 const void* idx_c, const void* idx_n,
                                 const void* mask, int B, int S, int d,
                                 float lr, int bb, int smem, const void* ivs,
                                 const void* perm_v, const void* icns,
                                 const void* perm_c, void* dv, void* dc,
                                 void* dn_part, void* loss_part, void* loss,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_update<float>(vert, ctx, idx_v, idx_c, idx_n, mask,
                                mask_bf16, B, S, d, lr, bb, smem, ivs, perm_v,
                                icns, perm_c, dv, dc, dn_part, loss_part,
                                loss, st);
  if (dtype == 1)
    return launch_update<__nv_bfloat16>(vert, ctx, idx_v, idx_c, idx_n, mask,
                                        mask_bf16, B, S, d, lr, bb, smem, ivs,
                                        perm_v, icns, perm_c, dv, dc, dn_part,
                                        loss_part, loss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same gather and gradients without the update: dv, dc (B, d) and
// dn (S, d) in the table's dtype, loss (1,) f32; dn_part and loss_part are
// scratch as above.
extern "C" int sgns_fused_grads(int dtype, int mask_bf16, const void* vert,
                                const void* ctx, const void* idx_v,
                                const void* idx_c, const void* idx_n,
                                const void* mask, int B, int S, int d, int bb,
                                int smem, void* dv, void* dc, void* dn_part,
                                void* loss_part, void* dn, void* loss,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_grads<float>(vert, ctx, ctx, idx_v, idx_c, idx_n, mask,
                               mask_bf16, B, S, d, bb, smem, dv, dc, dn_part,
                               loss_part, dn, loss, st);
  if (dtype == 1)
    return launch_grads<__nv_bfloat16>(vert, ctx, ctx, idx_v, idx_c, idx_n,
                                       mask, mask_bf16, B, S, d, bb, smem, dv,
                                       dc, dn_part, loss_part, dn, loss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradients of rows gathered beforehand: v, c (B, d) and n (S, d) in
// one dtype; outputs and scratch as sgns_fused_grads.
extern "C" int sgns_grads(int dtype, int mask_bf16, const void* v,
                          const void* c, const void* n, const void* mask,
                          int B, int S, int d, int bb, int smem, void* dv,
                          void* dc, void* dn_part, void* loss_part, void* dn,
                          void* loss, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_grads<float>(v, c, n, nullptr, nullptr, nullptr, mask,
                               mask_bf16, B, S, d, bb, smem, dv, dc, dn_part,
                               loss_part, dn, loss, st);
  if (dtype == 1)
    return launch_grads<__nv_bfloat16>(v, c, n, nullptr, nullptr, nullptr,
                                       mask, mask_bf16, B, S, d, bb, smem, dv,
                                       dc, dn_part, loss_part, dn, loss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
