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
// blocks run in no order. The update is one cooperative launch,
// sgns_update_fused, of nblk + 2 blocks or more (one warp per position for
// the combine, as far as the SMs allow):
//
//   blocks [0, nblk)  the tile gradients (fused_tile_grads): one block per
//                     bb minibatch rows gathers its v and c rows and all S
//                     negative rows into shared memory as f32, computes the
//                     tile's scores and gradients, writes dv and dc for its
//                     rows and its own (S, d) dn partial and loss partial
//                     (no float atomics). bb is half the unfused kernels'
//                     (more blocks, less time each). The dot products'
//                     reductions and sigmoid/softplus tails, and the
//                     gather's loads, are issued several at a time.
//   blocks nblk and   meanwhile sort the ids on chip, one side each (the
//   nblk + 1          blocks past them wait): the B vertex positions; the
//                     B + S context positions (idx_c ++ idx_n); each side
//                     as keys id << 32 | position, bitonic-sorted in shared
//                     memory, so equal ids keep their position order
//                     (stable, as the JAX wrapper's argsort); a block scan
//                     of the run heads gives each run of equal ids its
//                     (start, end, id, first position).
//   grid.sync()       one grid-wide barrier, which is why the launch is
//                     cooperative: every block must be resident at once
//                     (checked before the launch; the error is returned).
//                     A "last block to arrive" counter would need a zeroed
//                     word kept between calls and shared by every stream.
//   all blocks        the combine: every warp of the grid takes runs in
//                     turn. For each column a run's gradients are summed in
//                     sorted-position order, a negative position's dn
//                     partials in block order; 32 positions are fetched at
//                     once and AHEAD positions' gradients are in flight at
//                     once, so a hub row's run costs a round trip per AHEAD
//                     positions, not per position; a negative's partials
//                     are loaded PARTS at a time. The warp reads the row
//                     (nothing has written it yet: the pre-update value)
//                     and writes the new value once. Each unique row has
//                     exactly one owner, so there are no races and no
//                     atomics and a run repeats bitwise. Scratch written
//                     before the barrier is read with __ldcg (at L2).
//
// sgns_fused_grads is sgns_tile_grads (gradients in the table's dtype) plus
// sgns_reduce_partials, the fixed-order sum of the dn and loss partials.
// (sgns_tile_grads also takes null index pointers, rows gathered
// beforehand; nothing passes them since sgns_grads has its own kernel.)
//
// sgns_grads, the gradients of rows gathered beforehand, is one
// cooperative launch, sgns_grads_coop, of nblk = ceil(B / bb) blocks (bb =
// 8 at the trainer's minibatches, so 32 blocks at B = 256): each block
// loads its v and c rows (contiguous) and all S negatives with 16-byte
// loads all in flight at once, reduces DOTS dot products a warp together
// with their tails on DOTS lanes, writes dv and dc a vector a thread and its
// dn and loss partials (the loss summed by one warp in a fixed order); one
// grid.sync(); then the grid sums each dn element's partials in block
// order (__ldcg, PARTS in flight) and casts once, as the TPU kernel
// accumulates dn in an f32 output (sgns.py:105, 127). Its floor is one
// launch and three dependent round trips (rows in; partials out, across
// the barrier, and in again): a few us.
//
// Bound on an H100: bytes. A minibatch reads (2B + S) rows and writes the
// unique ones (B = 256, S = 5, d = 128 f32: about 0.5 MB, 0.15 us at
// 3.35 TB/s) and does about 6BSd + 4Bd operations (1.1 MFLOP, 0.02 us at the
// 67 TFLOP/s f32 rate); sgns_grads reads and writes (2B + S) rows. At that
// size latency sets the time: a launch and the dependent round trips of the
// update (ids, then rows, before the barrier; sorted positions, then
// gradient rows, then table rows after it) put a floor of a few us under
// it, far above the bytes bound.
//
// Row offsets are 64-bit: a 26.25 M x 128 f32 table is 13.4 GB, past 2^31
// bytes. The kernels check no index bounds (as on the TPU).
#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// sgns_fused_update: one cooperative launch
// ---------------------------------------------------------------------------
constexpr int AHEAD = 16;          // positions of a run loaded at once
constexpr int PARTS = 16;          // dn partials of a negative loaded at once
constexpr int COLS = 4;            // columns per lane per 128-column step
constexpr int GATHER = 8;          // elements a thread gathers at once
constexpr int DOTS = 8;            // dot products a warp reduces at once

struct UpdateArgs {
  void* vert;
  void* ctx;
  const int* idx_v;
  const int* idx_c;
  const int* idx_n;
  const void* mask;
  int mask_bf16, B, S, d, bb, nblk;
  float neg_lr;
  // scratch: f32 dv, dc (B, d), dn partials (nblk, S, d), loss partials
  // (nblk,), the loss; int32 (start, end, id, first position) of each run,
  // the sorted positions (2B + S), and the two sides' run counts
  float* dv;
  float* dc;
  float* dn_part;
  float* loss_part;
  float* loss;
  int4* info;
  int* pos;
  int* runs;
};

// sgns_tile_grads for block blk of the fused launch, gradients in f32: a
// copy of that kernel's body (kept apart, so sgns_grads and
// sgns_fused_grads keep their code), the same arithmetic in the same order.
template <typename T>
__device__ void fused_tile_grads(const UpdateArgs& a, int blk, float* smem) {
  const T* vsrc = static_cast<const T*>(a.vert);
  const T* csrc = static_cast<const T*>(a.ctx);
  const int S = a.S, d = a.d, bb = a.bb, B = a.B;
  const int T1 = S + 1;
  float* v_s = smem;
  float* c_s = v_s + bb * d;
  float* n_s = c_s + bb * d;
  float* g_s = n_s + S * d;
  float* l_s = g_s + bb * T1;
  float* m_s = l_s + bb * T1;
  const int row0 = blk * bb;
  const int rows = min(bb, B - row0);
  const long long dd = d;

  // the gather: GATHER elements of v, c and n a thread at a time, every
  // load of a step in flight at once (two round trips: ids, then rows)
  for (int i0 = 0; i0 < bb * d || i0 < S * d; i0 += GATHER * THREADS) {
    float v[GATHER], c[GATHER], n[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      const int r = i / d, k = i - r * d;
      v[u] = c[u] = n[u] = 0.0f;
      if (i < bb * d && r < rows) {
        v[u] = to_f32(
            vsrc[static_cast<long long>(a.idx_v[row0 + r]) * dd + k]);
        c[u] = to_f32(
            csrc[static_cast<long long>(a.idx_c[row0 + r]) * dd + k]);
      }
      if (i < S * d)
        n[u] = to_f32(csrc[static_cast<long long>(a.idx_n[r]) * dd + k]);
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < bb * d) {
        v_s[i] = v[u];
        c_s[i] = c[u];
      }
      if (i < S * d) n_s[i] = n[u];
    }
  }
  for (int r = threadIdx.x; r < bb; r += THREADS)
    m_s[r] = r < rows ? load_mask(a.mask, a.mask_bf16, row0 + r) : 0.0f;
  __syncthreads();

  // scores: one warp per dot product, a fixed shuffle tree per dot (as in
  // sgns_tile_grads), DOTS of a warp's dots reduced together; every lane
  // then holds each total, and lane i computes dot i's sigmoid and softplus
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q0 = warp; q0 < rows * T1; q0 += WARPS * DOTS) {
    float acc[DOTS];
#pragma unroll
    for (int i = 0; i < DOTS; ++i) {
      const int q = q0 + i * WARPS;
      acc[i] = 0.0f;
      if (q < rows * T1) {
        const int r = q / T1, t = q - r * T1;
        const float* x = v_s + r * d;
        const float* y = t == 0 ? c_s + r * d : n_s + (t - 1) * d;
        for (int k = lane; k < d; k += 32) acc[i] += x[k] * y[k];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < DOTS; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    float mine = acc[0];
#pragma unroll
    for (int i = 1; i < DOTS; ++i) mine = lane == i ? acc[i] : mine;
    const int q = q0 + lane * WARPS;
    if (lane < DOTS && q < rows * T1) {
      const int r = q / T1, t = q - r * T1;
      const float m = m_s[r];
      if (t == 0) {
        g_s[q] = (sigmoid_f32(mine) - 1.0f) * m;
        l_s[q] = m * softplus_f32(-mine);
      } else {
        g_s[q] = sigmoid_f32(mine) * m;
        l_s[q] = m * softplus_f32(mine);
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
    a.dv[o] = acc;
    a.dc[o] = g[0] * v_s[i];
  }
  float* dn = a.dn_part + static_cast<long long>(blk) * S * dd;
  for (int i = threadIdx.x; i < S * d; i += THREADS) {
    const int s = i / d, k = i - s * d;
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += g_s[r * T1 + 1 + s] * v_s[r * d + k];
    dn[i] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int q = 0; q < rows * T1; ++q) acc += l_s[q];
    a.loss_part[blk] = acc;
  }
}

// A sorting block, one per side: side 0 sorts the B vertex positions,
// side 1 the B + S context positions (idx_c ++ idx_n), as keys id << 32 |
// position, bitonic-sorted ascending in shared memory: by id, equal ids by
// position (stable). Writes the side's sorted positions at pos[base + i]
// (base 0 for the vertex side, B for the context side) and, for each run
// of equal ids, (base + start, base + end, id, first position) at
// info[base + r], and its run count at runs[side].
__device__ void sort_runs(const UpdateArgs& a, int side,
                          unsigned long long* keys) {
  __shared__ int wtotal[WARPS];
  __shared__ int nruns;
  const int B = a.B;
  const int n = side ? B + a.S : B, base = side ? B : 0;
  const int n2 = n > 1 ? 1 << (32 - __clz(n - 1)) : 1;
  int* starts = reinterpret_cast<int*>(keys + n2);      // (n + 1,)
  const int tid = threadIdx.x;
  for (int i = tid; i < n2; i += THREADS) {
    unsigned long long key = ~0ull;
    if (i < n) {
      const unsigned id = static_cast<unsigned>(
          side == 0 ? a.idx_v[i] : i < B ? a.idx_c[i] : a.idx_n[i - B]);
      key = static_cast<unsigned long long>(id) << 32 |
            static_cast<unsigned>(i);
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2 / 2; i += THREADS) {
        // (i / stride) * 2 * stride + i % stride, stride a power of two
        const int lo = 2 * i - (i & (stride - 1));
        const unsigned long long x = keys[lo], y = keys[lo + stride];
        if ((x > y) == ((lo & size) == 0)) {
          keys[lo] = y;
          keys[lo + stride] = x;
        }
      }
      __syncthreads();
    }
  }
  // run starts: thread t takes positions [t * pt, (t + 1) * pt); a block
  // scan of the head counts places each thread's starts
  const int pt = (n + THREADS - 1) / THREADS;
  const int i0 = min(tid * pt, n);
  const int i1 = min(i0 + pt, n);
  int heads = 0;
  for (int i = i0; i < i1; ++i) {
    const unsigned long long k = keys[i];
    heads += i == 0 || (keys[i - 1] >> 32) != (k >> 32);
    a.pos[base + i] = static_cast<int>(k & 0xffffffffu);
  }
  const int warp = tid >> 5, lane = tid & 31;
  int incl = heads;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wtotal[warp] = incl;
  __syncthreads();
  int before = incl - heads;
  for (int w = 0; w < warp; ++w) before += wtotal[w];
  for (int i = i0; i < i1; ++i) {
    if (i == 0 || (keys[i - 1] >> 32) != (keys[i] >> 32))
      starts[before++] = i;
  }
  if (tid == THREADS - 1) {
    starts[before] = n;        // the last thread's count is the total
    nruns = before;
    a.runs[side] = before;
  }
  __syncthreads();
  for (int r = tid; r < nruns; r += THREADS) {
    const int j = starts[r];
    const unsigned long long k = keys[j];
    a.info[base + r] = make_int4(base + j, base + starts[r + 1],
                                 static_cast<int>(k >> 32),
                                 static_cast<int>(k & 0xffffffffu));
  }
}

// Blocks [0, nblk) compute the tile gradients while blocks nblk and nblk +
// 1 sort (the blocks past them, there to give the combine a warp per run,
// wait); one
// grid-wide barrier; then every warp of the grid takes runs of the sorted
// positions in turn and applies each run's summed update to its row once.
template <typename T>
__global__ void __launch_bounds__(THREADS) sgns_update_fused(
    const UpdateArgs a) {
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int nblk = a.nblk;
  if (blockIdx.x < nblk)
    fused_tile_grads<T>(a, blockIdx.x, reinterpret_cast<float*>(fsmem));
  else if (blockIdx.x < nblk + 2)
    sort_runs(a, blockIdx.x - nblk,
              reinterpret_cast<unsigned long long*>(fsmem));
  cooperative_groups::this_grid().sync();

  // scratch written before the barrier is read at L2 (__ldcg), never
  // through a possibly stale L1 line
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float acc = __ldcg(a.loss_part);
    for (int b = 1; b < nblk; ++b) acc += __ldcg(a.loss_part + b);
    *a.loss = acc;
  }
  const int B = a.B, S = a.S, d = a.d;
  const long long dd = d;
  const long long sd = static_cast<long long>(S) * d;
  const int runs_v = __ldcg(a.runs), runs = runs_v + __ldcg(a.runs + 1);
  const int lane = threadIdx.x & 31;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < runs;
       r += gridDim.x * WARPS) {
    // the vertex side's runs, then the context side's (from info[B] on)
    const int4 run = __ldcg(a.info + (r < runs_v ? r : B + r - runs_v));
    const int j = run.x, e = run.y;
    const bool vside = j < B;
    T* dst = static_cast<T*>(vside ? a.vert : a.ctx) +
             static_cast<long long>(run.z) * dd;
    for (int k0 = 0; k0 < d; k0 += 32 * COLS) {
      // the row's old value, loaded while the gradients are summed
      float old[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int k = k0 + 32 * c + lane;
        old[c] = k < d ? to_f32(dst[k]) : 0.0f;
      }
      float acc[COLS];
      for (int p32 = j; p32 < e; p32 += 32) {
        // 32 sorted positions at once, one a lane, then AHEAD positions'
        // gradients in flight at a time, added in order
        const int mine = e - j == 1 ? run.w
                         : p32 + lane < e ? __ldcg(a.pos + p32 + lane) : 0;
        const int e32 = min(e, p32 + 32);
        for (int p0 = p32; p0 < e32; p0 += AHEAD) {
          int q[AHEAD];
#pragma unroll
          for (int i = 0; i < AHEAD; ++i)
            q[i] = __shfl_sync(0xffffffffu, mine, (p0 - p32 + i) & 31);
          float g[AHEAD][COLS];
#pragma unroll
          for (int i = 0; i < AHEAD; ++i) {
            const long long qi = q[i];
            const bool neg = p0 + i < e32 && !vside && qi >= B;
            const float* src =
                vside ? a.dv + qi * dd
                      : qi < B ? a.dc + qi * dd : a.dn_part + (qi - B) * dd;
#pragma unroll
            for (int c = 0; c < COLS; ++c) {
              const int k = k0 + 32 * c + lane;
              g[i][c] = p0 + i < e32 && k < d ? __ldcg(src + k) : 0.0f;
            }
            if (neg) {
              // a negative's partials of the other blocks, summed in block
              // order, PARTS blocks' partials of every column loaded at once
              for (int b0 = 1; b0 < nblk; b0 += PARTS) {
                float part[PARTS][COLS];
#pragma unroll
                for (int u = 0; u < PARTS; ++u) {
#pragma unroll
                  for (int c = 0; c < COLS; ++c) {
                    const int k = k0 + 32 * c + lane;
                    part[u][c] = b0 + u < nblk && k < d
                                     ? __ldcg(src + (b0 + u) * sd + k)
                                     : 0.0f;
                  }
                }
#pragma unroll
                for (int u = 0; u < PARTS; ++u) {
                  if (b0 + u < nblk) {
#pragma unroll
                    for (int c = 0; c < COLS; ++c) g[i][c] += part[u][c];
                  }
                }
              }
            }
          }
#pragma unroll
          for (int i = 0; i < AHEAD; ++i) {
            if (p0 + i < e32) {
#pragma unroll
              for (int c = 0; c < COLS; ++c)
                acc[c] = p0 + i == j ? g[i][c] : acc[c] + g[i][c];
            }
          }
        }
      }
      // the update rounded to the table's dtype, then one add rounded to
      // it; the _rn intrinsics keep the compiler from fusing them into an
      // FMA
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int k = k0 + 32 * c + lane;
        if (k < d) {
          const float upd = to_f32(from_f32<T>(__fmul_rn(a.neg_lr, acc[c])));
          dst[k] = from_f32<T>(__fadd_rn(old[c], upd));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// sgns_grads: one cooperative launch
// ---------------------------------------------------------------------------
struct GradsArgs {
  const void* v;
  const void* c;
  const void* n;
  const void* mask;
  int mask_bf16, B, S, d, bb, nblk;
  void* dv;          // (B, d), the rows' dtype
  void* dc;
  void* dn;          // (S, d), the rows' dtype
  float* dn_part;    // (nblk, S, d) f32 scratch
  float* loss_part;  // (nblk,) f32 scratch
  float* loss;       // the loss
};

// VEC consecutive elements at p as f32 (16 bytes: 4 f32 or 8 bf16).
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* x) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// VEC f32 values to p in T, rounded once each (16 or 8 bytes).
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* x) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// Block blk takes rows [blk bb, blk bb + rows) of v and c (contiguous: the
// rows were gathered beforehand) and all S negatives: every load in flight
// at once (16-byte vectors when the rows allow), DOTS dot products a warp
// reduced together with their tails on DOTS lanes, dv and dc written a
// vector a thread, its (S, d) dn partial and its loss (summed by one warp
// in a fixed order) to scratch. One grid-wide barrier, then the grid sums
// each dn element's partials in block order and casts once; block 0 sums
// the loss partials. No float atomics: a call repeats bitwise.
template <typename T>
__global__ void __launch_bounds__(THREADS) sgns_grads_coop(const GradsArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float gsmem[];
  const int S = a.S, d = a.d, bb = a.bb, T1 = S + 1;
  float* v_s = gsmem;
  float* c_s = v_s + bb * d;
  float* n_s = c_s + bb * d;
  float* g_s = n_s + S * d;
  float* l_s = g_s + bb * T1;
  float* m_s = l_s + bb * T1;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * bb;
  const int rows = min(bb, a.B - row0);
  const long long off = static_cast<long long>(row0) * d;
  const T* vsrc = static_cast<const T*>(a.v) + off;
  const T* csrc = static_cast<const T*>(a.c) + off;
  const T* nsrc = static_cast<const T*>(a.n);
  const int nr = rows * d, nn = S * d;
  // one test for the whole grid: every row slab starts at a multiple of
  // bb d elements from a 16-byte aligned base
  const bool vec = d % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.v) |
                     reinterpret_cast<uintptr_t>(a.c) |
                     reinterpret_cast<uintptr_t>(a.n) |
                     reinterpret_cast<uintptr_t>(a.dv) |
                     reinterpret_cast<uintptr_t>(a.dc)) & 15) == 0;

  // the rows, gathered beforehand: v, c and n, a vector of each per thread
  // per step, every load of a step (and the mask, bb <= THREADS) issued
  // before any store
  const float m = tid < rows ? load_mask(a.mask, a.mask_bf16, row0 + tid)
                             : 0.0f;
  if (vec) {
    for (int i0 = 0; i0 < max(nr, nn); i0 += THREADS * VEC) {
      const int i = i0 + tid * VEC;
      float x[VEC], y[VEC], z[VEC];
      if (i < nr) {
        load_vec(vsrc + i, x);
        load_vec(csrc + i, y);
      }
      if (i < nn) load_vec(nsrc + i, z);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        if (i < nr) {
          v_s[i + u] = x[u];
          c_s[i + u] = y[u];
        }
        if (i < nn) n_s[i + u] = z[u];
      }
    }
  } else {
    for (int i = tid; i < max(nr, nn); i += THREADS) {
      if (i < nr) {
        v_s[i] = to_f32(vsrc[i]);
        c_s[i] = to_f32(csrc[i]);
      }
      if (i < nn) n_s[i] = to_f32(nsrc[i]);
    }
  }
  if (tid < bb) m_s[tid] = m;
  __syncthreads();

  // scores: one warp per dot product, DOTS of a warp's dots reduced
  // together by one fixed shuffle tree each; lane i takes dot i's sigmoid
  // and softplus
  const int warp = tid >> 5, lane = tid & 31;
  const int ndots = rows * T1;
  for (int q0 = warp; q0 < ndots; q0 += WARPS * DOTS) {
    float acc[DOTS];
#pragma unroll
    for (int i = 0; i < DOTS; ++i) {
      const int q = q0 + i * WARPS;
      acc[i] = 0.0f;
      if (q < ndots) {
        const int r = q / T1, t = q - r * T1;
        const float* x = v_s + r * d;
        const float* y = t == 0 ? c_s + r * d : n_s + (t - 1) * d;
        for (int k = lane; k < d; k += 32) acc[i] = fmaf(x[k], y[k], acc[i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < DOTS; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    float mine = acc[0];
#pragma unroll
    for (int i = 1; i < DOTS; ++i) mine = lane == i ? acc[i] : mine;
    const int q = q0 + lane * WARPS;
    if (lane < DOTS && q < ndots) {
      const int r = q / T1, t = q - r * T1;
      const float mr = m_s[r];
      if (t == 0) {
        g_s[q] = (sigmoid_f32(mine) - 1.0f) * mr;
        l_s[q] = mr * softplus_f32(-mine);
      } else {
        g_s[q] = sigmoid_f32(mine) * mr;
        l_s[q] = mr * softplus_f32(mine);
      }
    }
  }
  __syncthreads();

  // dv = g_pos c + sum_s g_neg n_s and dc = g_pos v, VEC columns a thread
  T* dv = static_cast<T*>(a.dv) + off;
  T* dc = static_cast<T*>(a.dc) + off;
  if (vec) {
    for (int i = tid * VEC; i < nr; i += THREADS * VEC) {
      const int r = i / d, k = i - r * d;
      const float* g = g_s + r * T1;
      float x[VEC], y[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        x[u] = g[0] * c_s[i + u];
        y[u] = g[0] * v_s[i + u];
      }
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) x[u] += g[1 + s] * n_s[s * d + k + u];
      }
      store_vec(dv + i, x);
      store_vec(dc + i, y);
    }
  } else {
    for (int i = tid; i < nr; i += THREADS) {
      const int r = i / d, k = i - r * d;
      const float* g = g_s + r * T1;
      float acc = g[0] * c_s[i];
      for (int s = 0; s < S; ++s) acc += g[1 + s] * n_s[s * d + k];
      dv[i] = from_f32<T>(acc);
      dc[i] = from_f32<T>(g[0] * v_s[i]);
    }
  }
  // the block's dn partial, its rows in order
  float* part = a.dn_part + static_cast<long long>(blockIdx.x) * nn;
  for (int i = tid; i < nn; i += THREADS) {
    const int s = i / d, k = i - s * d;
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += g_s[r * T1 + 1 + s] * v_s[r * d + k];
    part[i] = acc;
  }
  // the block's loss: warp 0, lane j the terms j, j + 32, ... in order,
  // then one shuffle tree
  if (warp == 0) {
    float acc = 0.0f;
    for (int q = lane; q < ndots; q += 32) acc += l_s[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) a.loss_part[blockIdx.x] = acc;
  }
  cooperative_groups::this_grid().sync();

  // dn[i] = the partials of blocks 0, 1, ... added in order (read at L2:
  // other blocks wrote them), PARTS loads in flight at a time; then cast
  const int nblk = a.nblk;
  T* dn = static_cast<T*>(a.dn);
  for (int i = blockIdx.x * THREADS + tid; i < nn; i += gridDim.x * THREADS) {
    float acc = 0.0f;
    for (int b0 = 0; b0 < nblk; b0 += PARTS) {
      float p[PARTS];
#pragma unroll
      for (int u = 0; u < PARTS; ++u)
        p[u] = b0 + u < nblk
                   ? __ldcg(a.dn_part + static_cast<long long>(b0 + u) * nn + i)
                   : 0.0f;
#pragma unroll
      for (int u = 0; u < PARTS; ++u) {
        if (b0 + u < nblk) acc = b0 + u == 0 ? p[u] : acc + p[u];
      }
    }
    dn[i] = from_f32<T>(acc);
  }
  // the loss partials in block order, by the last thread of block 0 (the
  // dn elements go to the lowest threads first)
  if (blockIdx.x == 0 && tid == THREADS - 1) {
    float acc = 0.0f;
    for (int b0 = 0; b0 < nblk; b0 += PARTS) {
      float p[PARTS];
#pragma unroll
      for (int u = 0; u < PARTS; ++u)
        p[u] = b0 + u < nblk ? __ldcg(a.loss_part + b0 + u) : 0.0f;
#pragma unroll
      for (int u = 0; u < PARTS; ++u) {
        if (b0 + u < nblk) acc = b0 + u == 0 ? p[u] : acc + p[u];
      }
    }
    *a.loss = acc;
  }
}

// One cooperative launch of nblk blocks (at most one per SM: the planner's
// rows per block keep nblk within the SMs, so every block is resident at
// once; cudaLaunchCooperativeKernel refuses a grid that is not).
template <typename T>
int launch_grads_coop(const GradsArgs& a, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgns_grads_coop<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  GradsArgs args = a;
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sgns_grads_coop<T>), dim3(a.nblk),
      dim3(THREADS), params, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

// One cooperative launch of nblk + 1 blocks, refused (with the error
// returned) unless every block can be resident at once: the grid-wide
// barrier needs them all.
template <typename T>
int launch_fused(const UpdateArgs& a, int grid, int smem, cudaStream_t st) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(sgns_update_fused<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sgns_update_fused<T>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  UpdateArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sgns_update_fused<T>), dim3(grid),
      dim3(THREADS), params, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
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
// Tables are updated in place. bb rows per gradient block (nblk = ceil(B /
// bb) of them), then the two sorting blocks, then more up to `blocks` for
// the combine; smem: the dynamic shared memory of a block, the larger of a
// gradient tile's and a sort's 12 n2 + 4 bytes, n2 being B + S rounded up
// to a power of two. fscratch: f32 dv, dc (B, d), dn partials (nblk, S,
// d), loss partials (nblk,), then the loss (its last element, the output);
// iscratch: 5 (2B + S) + 2 int32, 16-byte aligned.
extern "C" int sgns_fused_update(int dtype, int mask_bf16, void* vert,
                                 void* ctx, const void* idx_v,
                                 const void* idx_c, const void* idx_n,
                                 const void* mask, int B, int S, int d,
                                 float lr, int bb, int blocks, int smem,
                                 void* fscratch, void* iscratch,
                                 void* stream) {
  const int nblk = (B + bb - 1) / bb, n = 2 * B + S;
  const long long bd = static_cast<long long>(B) * d;
  float* f = static_cast<float*>(fscratch);
  int* i = static_cast<int*>(iscratch);
  float* dn_part = f + 2 * bd;
  float* loss_part = dn_part + static_cast<long long>(nblk) * S * d;
  const UpdateArgs a{vert, ctx,
                     static_cast<const int*>(idx_v),
                     static_cast<const int*>(idx_c),
                     static_cast<const int*>(idx_n),
                     mask, mask_bf16, B, S, d, bb, nblk, -lr,
                     f, f + bd, dn_part, loss_part, loss_part + nblk,
                     reinterpret_cast<int4*>(i), i + 4 * n, i + 5 * n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < nblk + 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_fused<float>(a, blocks, smem, st);
  if (dtype == 1) return launch_fused<__nv_bfloat16>(a, blocks, smem, st);
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
// one dtype; dv, dc (B, d), dn (S, d) in that dtype, loss (1,) f32;
// dn_part (nblk, S, d) and loss_part (nblk,) f32 scratch, nblk = ceil(B /
// bb) <= the SMs and bb <= 256 (plan_sgns_grads). One cooperative launch.
extern "C" int sgns_grads(int dtype, int mask_bf16, const void* v,
                          const void* c, const void* n, const void* mask,
                          int B, int S, int d, int bb, int smem, void* dv,
                          void* dc, void* dn_part, void* loss_part, void* dn,
                          void* loss, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bb < 1 || bb > THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const GradsArgs a{v, c, n, mask, mask_bf16, B, S, d, bb, (B + bb - 1) / bb,
                    dv, dc, dn, static_cast<float*>(dn_part),
                    static_cast<float*>(loss_part), static_cast<float*>(loss)};
  if (dtype == 0) return launch_grads_coop<float>(a, smem, st);
  if (dtype == 1) return launch_grads_coop<__nv_bfloat16>(a, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
