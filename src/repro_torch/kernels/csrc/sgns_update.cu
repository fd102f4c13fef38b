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
//                     (no float atomics), bb = 8 rows. The dot products'
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
// Any B and S: past one tile a block beside the two sorting blocks (B >
// 1,040 at 8-row tiles) or past a sorting block's shared memory (B + S >
// 16,384), the update is sgns_update_sorted, one cooperative launch of one
// block an SM: the blocks take tiles blockIdx.x, + gridDim.x, ... (each
// block's dn and loss partials summed over its tiles in order); then all
// 2B + S positions, as 64-bit keys side << 63 | id << 32 | position (the
// vertex side first, so the layout is sort_runs'), are bitonic-sorted in
// device memory: each 8,192-key chunk in one block's shared memory, the
// strides of a merge that cross chunks as grid-wide steps with a barrier
// each, the rest chunk by chunk again (about a dozen barriers at B =
// 8,192); a warp finds the runs that start among 32 sorted positions (a
// key whose side and id differ from the one before it) and combines each
// exactly as above. Below both limits the launch is the one above, its
// geometry unchanged, so every minibatch the trainer issues computes what
// it did bit for bit.
//
// Any S and d: when one tile row and all S negatives do not fit a block's
// 227 KB, tile_grads_chunked keeps the v and c rows and a dv accumulator
// beside nc negatives at a time (the largest nc that fits), dv summing the
// negatives' terms chunk after chunk in order of s and each chunk's dn
// rows written as they come; past d of about 14,500 (not one row and one
// negative in 227 KB) the same code runs on a workspace in device memory.
// sgns_grads and sgns_fused_grads take the same routine (CHUNK), so #6
// stays bitwise #5 on its gathered rows.
//
// sgns_grads, the gradients of rows gathered beforehand, and sgns_fused_grads,
// the same with the gather inside, are one kernel, sgns_grads_coop,
// instantiated with and without ids: one cooperative launch over tiles of bb =
// 8 rows (fewer when the S negatives leave no room), one block a tile up to
// one block an SM (32 blocks at the trainer's B = 256), each block taking
// every blocks-th tile past that, so any B runs. For a tile a fused-grads
// block first loads the ids of its bb vertex and context rows and of the S
// negatives (one round trip); then it loads the v and c rows and all S
// negatives, 16-byte loads all in flight at once (contiguous slabs, or rows of
// the tables through the ids), reduces DOTS dot products a warp together with
// their tails on DOTS lanes, writes dv and dc a vector a thread and adds the
// tile's dn and loss (summed by one warp in a fixed order) to the block's
// partials in tile order; one grid.sync(); then the grid sums each dn
// element's block partials in block order (__ldcg, PARTS in flight) and casts
// once, as the TPU kernels accumulate dn in an f32 output (sgns.py:105, 127,
// 172). The same rows give the same bits either way, so sgns_fused_grads(vert,
// ctx, iv, ic, in) == sgns_grads(vert[iv], ctx[ic], ctx[in]) bitwise. Its
// floor is one launch and three dependent round trips (rows in; partials out,
// across the barrier, and in again), four with the ids: a few us.
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

__device__ __forceinline__ float load_mask(const void* mask, int mask_bf16,
                                           int b) {
  return mask_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(mask)[b])
             : static_cast<const float*>(mask)[b];
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
  // nc > 0: the negatives are staged nc rows at a time (tile_grads_chunked),
  // in a workspace of work_floats per block at `work` (null: shared memory)
  int nc, work_floats;
  // sort_chunk > 0: the grid-wide sort of sort_keys keys (sgns_update_sorted)
  int sort_chunk, sort_keys;
  // scratch: f32 dv, dc (B, d), dn partials (nblk, S, d), the workspaces,
  // loss partials (nblk,), the loss; int32 (start, end, id, first position)
  // of each run, the sorted positions (2B + S), and the two sides' run
  // counts (the grid-wide sort: its 64-bit keys, then the positions)
  float* dv;
  float* dc;
  float* dn_part;
  float* work;
  float* loss_part;
  float* loss;
  int4* info;
  int* pos;
  int* runs;
  unsigned long long* keys;
};

// The gradients of tile `tile` of the fused launch, in f32: bb rows
// gathered through the ids into shared memory as f32, with all S
// negatives, the scores and gradients of the tile, dv and dc for its rows,
// and its (S, d) dn partial and loss partial, which are block blk's (the
// block's first tile writes them, a later one adds to them).
template <typename T>
__device__ void fused_tile_grads(const UpdateArgs& a, int tile, int blk,
                                 bool first, float* smem) {
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
  const int row0 = tile * bb;
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

  // scores: one warp per dot product, a fixed shuffle tree per dot, DOTS
  // of a warp's dots reduced together; every lane
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
    dn[i] = first ? acc : dn[i] + acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int q = 0; q < rows * T1; ++q) acc += l_s[q];
    a.loss_part[blk] = first ? acc : a.loss_part[blk] + acc;
  }
}

// ---------------------------------------------------------------------------
// tiles whose S negatives do not fit beside them in shared memory
// ---------------------------------------------------------------------------
// The gradients of rows [row0, row0 + rows) with the S negatives staged nc
// rows at a time, for any S and d. The workspace w holds the (bb, d) v and c
// rows and dv accumulator, the (bb, S + 1) gradients and loss terms, the
// (bb,) mask and nc negative rows, all f32 (chunk_work_floats): the block's
// shared memory when that fits, else the block's own slice of a device
// scratch, which the same code reaches through generic pointers
// (__syncthreads orders a block's device-memory accesses as it does its
// shared ones). Rows come from slabs (row r at src + r d) or, with GATHER,
// from table rows through the ids. Each dot product is one warp's fmaf
// chain over lanes and a fixed shuffle tree; dv = g_pos c + the negatives'
// terms in order of s, carried from chunk to chunk in the workspace; the
// chunk's dn rows go to `part` (written by the block's first tile, added to
// by its later ones, each element by the same thread). Writes dv and dc
// (OutT) at rows row0.. and returns the tile's loss in warp 0 (its lanes'
// terms in order, then a shuffle tree).
template <typename T, bool GATHER, typename OutT>
__device__ float tile_grads_chunked(const T* vsrc, const T* csrc,
                                   const T* nsrc, const int* idx_v,
                                   const int* idx_c, const int* idx_n,
                                   const void* mask, int mask_bf16, int row0,
                                   int rows, int bb, int S, int d, int nc,
                                   float* w, OutT* dv, OutT* dc, float* part,
                                   bool first) {
  const int T1 = S + 1;
  const long long dd = d;
  float* v_s = w;
  float* c_s = v_s + static_cast<long long>(bb) * d;
  float* a_s = c_s + static_cast<long long>(bb) * d;
  float* g_s = a_s + static_cast<long long>(bb) * d;
  float* l_s = g_s + static_cast<long long>(bb) * T1;
  float* m_s = l_s + static_cast<long long>(bb) * T1;
  float* n_s = m_s + bb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nr = rows * d;
  for (int i = tid; i < nr; i += THREADS) {
    const int r = i / d, k = i - r * d;
    const long long rv = GATHER ? idx_v[row0 + r] : row0 + r;
    const long long rc = GATHER ? idx_c[row0 + r] : row0 + r;
    v_s[i] = to_f32(vsrc[rv * dd + k]);
    c_s[i] = to_f32(csrc[rc * dd + k]);
  }
  for (int r = tid; r < bb; r += THREADS)
    m_s[r] = r < rows ? load_mask(mask, mask_bf16, row0 + r) : 0.0f;
  for (int s0 = 0; s0 < S; s0 += nc) {
    const int ns = min(nc, S - s0), nn = ns * d;
    for (int i = tid; i < nn; i += THREADS) {
      const int s = i / d, k = i - s * d;
      const long long rn = GATHER ? idx_n[s0 + s] : s0 + s;
      n_s[i] = to_f32(nsrc[rn * dd + k]);
    }
    __syncthreads();
    // the chunk's scores, after the positives' with the first chunk
    const int np = s0 == 0 ? rows : 0;
    for (int q = warp; q < np + rows * ns; q += WARPS) {
      int r, t;
      const float* y;
      if (q < np) {
        r = q;
        t = 0;
        y = c_s + static_cast<long long>(r) * d;
      } else {
        r = (q - np) / ns;
        const int s = q - np - r * ns;
        t = 1 + s0 + s;
        y = n_s + static_cast<long long>(s) * d;
      }
      const float* x = v_s + static_cast<long long>(r) * d;
      float acc = 0.0f;
      for (int k = lane; k < d; k += 32) acc = fmaf(x[k], y[k], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const float m = m_s[r];
        const int o = r * T1 + t;
        g_s[o] = t == 0 ? (sigmoid_f32(acc) - 1.0f) * m : sigmoid_f32(acc) * m;
        l_s[o] = m * softplus_f32(t == 0 ? -acc : acc);
      }
    }
    __syncthreads();
    for (int i = tid; i < nr; i += THREADS) {
      const int r = i / d, k = i - r * d;
      const float* g = g_s + r * T1;
      float acc = s0 == 0 ? g[0] * c_s[i] : a_s[i];
      for (int s = 0; s < ns; ++s)
        acc = fmaf(g[1 + s0 + s], n_s[static_cast<long long>(s) * d + k], acc);
      a_s[i] = acc;
    }
    float* pc = part + static_cast<long long>(s0) * d;
    for (int i = tid; i < nn; i += THREADS) {
      const int s = i / d, k = i - s * d;
      float acc = 0.0f;
      for (int r = 0; r < rows; ++r)
        acc = fmaf(g_s[r * T1 + 1 + s0 + s], v_s[static_cast<long long>(r) * d + k],
                   acc);
      pc[i] = first ? acc : pc[i] + acc;
    }
    __syncthreads();                  // the next chunk reuses n_s
  }
  for (int i = tid; i < nr; i += THREADS) {
    const long long o = static_cast<long long>(row0) * d + i;
    dv[o] = from_f32<OutT>(a_s[i]);
    dc[o] = from_f32<OutT>(g_s[(i / d) * T1] * v_s[i]);
  }
  float loss = 0.0f;
  if (warp == 0) {
    for (int q = lane; q < rows * T1; q += 32) loss += l_s[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      loss += __shfl_xor_sync(0xffffffffu, loss, o);
  }
  __syncthreads();                    // the next tile reuses the workspace
  return loss;
}

// Tile `tile` of the fused update, its partials block blk's: all S
// negatives beside the tile in shared memory (fused_tile_grads), or (CHUNK)
// staged in chunks.
template <typename T, bool CHUNK>
__device__ void update_tile(const UpdateArgs& a, int tile, int blk, bool first,
                            unsigned char* smem) {
  if constexpr (CHUNK) {
    const int row0 = tile * a.bb;
    float* w = a.work ? a.work + static_cast<long long>(blk) * a.work_floats
                      : reinterpret_cast<float*>(smem);
    const float l = tile_grads_chunked<T, true, float>(
        static_cast<const T*>(a.vert), static_cast<const T*>(a.ctx),
        static_cast<const T*>(a.ctx), a.idx_v, a.idx_c, a.idx_n, a.mask,
        a.mask_bf16, row0, min(a.bb, a.B - row0), a.bb, a.S, a.d, a.nc, w,
        a.dv, a.dc, a.dn_part + static_cast<long long>(blk) * a.S * a.d,
        first);
    if (threadIdx.x == 0)
      a.loss_part[blk] = first ? l : a.loss_part[blk] + l;
  } else {
    fused_tile_grads<T>(a, tile, blk, first, reinterpret_cast<float*>(smem));
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

// Run [j, e) of the sorted positions (row `id`; its first position fp),
// applied by one warp: for each column the run's gradients summed in
// sorted-position order, a negative position's dn partials in block order,
// then the row's one update. j < B is the vertex side.
template <typename T>
__device__ __forceinline__ void combine_run(const UpdateArgs& a, int j, int e,
                                            int id, int fp, int lane) {
  const int B = a.B, d = a.d, nblk = a.nblk;
  const long long dd = d;
  const long long sd = static_cast<long long>(a.S) * d;
  const bool vside = j < B;
  T* dst = static_cast<T*>(vside ? a.vert : a.ctx) +
           static_cast<long long>(id) * dd;
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
      const int mine = e - j == 1 ? fp
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

// Block 0's first thread: the loss, the nblk loss partials in block order.
__device__ __forceinline__ void sum_loss(const UpdateArgs& a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float acc = __ldcg(a.loss_part);
    for (int b = 1; b < a.nblk; ++b) acc += __ldcg(a.loss_part + b);
    *a.loss = acc;
  }
}

// Blocks [0, nblk) compute the tile gradients while blocks nblk and nblk +
// 1 sort (the blocks past them, there to give the combine a warp per run,
// wait); one
// grid-wide barrier; then every warp of the grid takes runs of the sorted
// positions in turn and applies each run's summed update to its row once.
template <typename T, bool CHUNK>
__global__ void __launch_bounds__(THREADS) sgns_update_fused(
    const UpdateArgs a) {
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int nblk = a.nblk;
  if (blockIdx.x < nblk)
    update_tile<T, CHUNK>(a, blockIdx.x, blockIdx.x, true, fsmem);
  else if (blockIdx.x < nblk + 2)
    sort_runs(a, blockIdx.x - nblk,
              reinterpret_cast<unsigned long long*>(fsmem));
  cooperative_groups::this_grid().sync();

  // scratch written before the barrier is read at L2 (__ldcg), never
  // through a possibly stale L1 line
  sum_loss(a);
  const int B = a.B;
  const int runs_v = __ldcg(a.runs), runs = runs_v + __ldcg(a.runs + 1);
  const int lane = threadIdx.x & 31;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < runs;
       r += gridDim.x * WARPS) {
    // the vertex side's runs, then the context side's (from info[B] on)
    const int4 run = __ldcg(a.info + (r < runs_v ? r : B + r - runs_v));
    combine_run<T>(a, run.x, run.y, run.z, run.w, lane);
  }
}

// ---------------------------------------------------------------------------
// the fused update past one block an SM or a sorting block's shared memory
// ---------------------------------------------------------------------------
// The sort key of position p in [0, 2B + S): the vertex positions p < B
// (side 0) before the context ones (side 1: idx_c ++ idx_n), each side by
// id, equal ids by position. Sorted, the first B keys are the vertex side,
// as in sort_runs' layout.
__device__ __forceinline__ unsigned long long position_key(const UpdateArgs& a,
                                                           int p) {
  const int B = a.B;
  const unsigned id = static_cast<unsigned>(
      p < B ? a.idx_v[p] : p < 2 * B ? a.idx_c[p - B] : a.idx_n[p - 2 * B]);
  return (p < B ? 0ull : 1ull << 63) |
         static_cast<unsigned long long>(id) << 32 | static_cast<unsigned>(p);
}

// Bitonic steps of sizes size_from..size_to (powers of two) on the C keys
// of chunk [c0, c0 + C) staged in shared memory: every stride below C (and
// below the size), the direction of a pair from its index in the whole
// array, as one bitonic sort of all the keys would take it.
__device__ void bitonic_chunk(unsigned long long* sk, int C, int c0,
                              int size_from, int size_to) {
  for (int size = size_from; size <= size_to; size <<= 1) {
    for (int stride = min(size, C) >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < C / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const unsigned long long x = sk[lo], y = sk[lo + stride];
        if ((x > y) == (((c0 + lo) & size) == 0)) {
          sk[lo] = y;
          sk[lo + stride] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The fused update for any B and S, one cooperative launch of one block an
// SM: every block takes tiles blockIdx.x, + gridDim.x, ... (its dn and loss
// partials summed over them in order); the 2B + S position keys
// (position_key) are bitonic-sorted in device memory, chunks of sort_chunk
// keys in shared memory and the strides of a merge that cross chunks as
// grid-wide steps, a grid barrier after each; then each run of equal keys'
// ids (its head found by comparing a key with the one before it, its end by
// scanning on) is combined by one warp exactly as in sgns_update_fused. The
// same gradients, the same per-run sums in sorted-position order, the same
// one owner per row.
template <typename T, bool CHUNK>
__global__ void __launch_bounds__(THREADS) sgns_update_sorted(
    const UpdateArgs a) {
  extern __shared__ __align__(16) unsigned char fsmem[];
  auto grid = cooperative_groups::this_grid();
  const int B = a.B, n = 2 * B + a.S, n2 = a.sort_keys, C = a.sort_chunk;
  const int tiles = (B + a.bb - 1) / a.bb;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    update_tile<T, CHUNK>(a, t, blockIdx.x, t == static_cast<int>(blockIdx.x),
                          fsmem);
    __syncthreads();                  // the next tile reuses shared memory
  }
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(fsmem);
  unsigned long long* keys = a.keys;
  const int stride_all = gridDim.x * C;
  for (int c0 = blockIdx.x * C; c0 < n2; c0 += stride_all) {
    for (int i = threadIdx.x; i < C; i += THREADS)
      sk[i] = c0 + i < n ? position_key(a, c0 + i) : ~0ull;
    __syncthreads();
    bitonic_chunk(sk, C, c0, 2, C);
    for (int i = threadIdx.x; i < C; i += THREADS) keys[c0 + i] = sk[i];
    __syncthreads();
  }
  grid.sync();
  for (int size = 2 * C; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride >= C; stride >>= 1) {
      for (int i = blockIdx.x * THREADS + threadIdx.x; i < n2 / 2;
           i += gridDim.x * THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const unsigned long long x = __ldcg(keys + lo),
                                 y = __ldcg(keys + lo + stride);
        if ((x > y) == ((lo & size) == 0)) {
          keys[lo] = y;
          keys[lo + stride] = x;
        }
      }
      grid.sync();
    }
    for (int c0 = blockIdx.x * C; c0 < n2; c0 += stride_all) {
      for (int i = threadIdx.x; i < C; i += THREADS)
        sk[i] = __ldcg(keys + c0 + i);
      __syncthreads();
      bitonic_chunk(sk, C, c0, size, size);
      for (int i = threadIdx.x; i < C; i += THREADS) keys[c0 + i] = sk[i];
      __syncthreads();
    }
    grid.sync();
  }
  // the sorted positions as sort_runs writes them: a vertex position, or
  // one of idx_c ++ idx_n
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const int p = static_cast<int>(__ldcg(keys + i) & 0xffffffffu);
    a.pos[i] = p < B ? p : p - B;
  }
  sum_loss(a);
  grid.sync();

  // the runs: a warp takes 32 sorted positions at a time and combines each
  // run that starts among them
  const int lane = threadIdx.x & 31;
  for (int w0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32; w0 < n;
       w0 += gridDim.x * WARPS * 32) {
    const int i = w0 + lane;
    const unsigned long long key = i < n ? __ldcg(keys + i) : ~0ull;
    const bool head =
        i < n && (i == 0 || (__ldcg(keys + i - 1) >> 32) != (key >> 32));
    unsigned heads = __ballot_sync(0xffffffffu, head);
    while (heads) {
      const int h = __ffs(heads) - 1;
      heads &= heads - 1;
      const int j = w0 + h;
      const unsigned long long kj = __shfl_sync(0xffffffffu, key, h);
      int e = n;
      for (int base = j + 1; base < n; base += 32) {
        const int x = base + lane;
        const bool end = x >= n || (__ldcg(keys + x) >> 32) != (kj >> 32);
        const unsigned m = __ballot_sync(0xffffffffu, end);
        if (m) {
          e = base + __ffs(m) - 1;
          break;
        }
      }
      const int p = static_cast<int>(kj & 0xffffffffu);
      combine_run<T>(a, j, e, static_cast<int>((kj >> 32) & 0x7fffffffu),
                     p < B ? p : p - B, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// sgns_grads and sgns_fused_grads: one cooperative launch
// ---------------------------------------------------------------------------
struct GradsArgs {
  const void* v;     // (B, d) rows gathered beforehand, or the vertex table
  const void* c;     // (B, d), or the context table
  const void* n;     // (S, d), or the context table
  const int* idx_v;  // the ids of v, c and n rows in their tables (fused
  const int* idx_c;  // grads), null when the rows were gathered beforehand
  const int* idx_n;
  const void* mask;
  int mask_bf16, B, S, d, bb;
  int nc;            // > 0: negatives staged nc at a time (CHUNK)
  int work_floats;   // floats of a block's workspace at `work` (CHUNK)
  float* work;       // (blocks, work_floats) f32, or null: shared memory
  void* dv;          // (B, d), the rows' dtype
  void* dc;
  void* dn;          // (S, d), the rows' dtype
  float* dn_part;    // (blocks, S, d) f32 scratch
  float* loss_part;  // (blocks,) f32 scratch
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

// Element i of a block's (rows, d) slab: at src + i when the rows were
// gathered beforehand (src the slab), else of row ids[i / d] of the table
// src.
template <bool GATHER, typename T>
__device__ __forceinline__ const T* slab_elem(const T* src, const int* ids,
                                              int i, int d) {
  if (!GATHER) return src + i;
  const int r = i / d;
  return src + static_cast<long long>(ids[r]) * d + (i - r * d);
}

// Tile t takes rows [t bb, t bb + rows) of v and c and all S negatives:
// contiguous slabs gathered beforehand, or (GATHER) rows of the tables
// through their ids, which the block loads first. Block blk takes tiles
// blk, blk + blocks, ... in order (one tile a block at the trainer's
// minibatches). Every row load of a tile in flight at once (16-byte vectors
// when the rows allow), DOTS dot products a warp reduced together with
// their tails on DOTS lanes, dv and dc written a vector a thread, the
// tile's (S, d) dn partial and its loss (summed by one warp in a fixed
// order) added to the block's, in scratch. One grid-wide barrier, then the
// grid sums each dn element's block partials in block order and casts once;
// block 0 sums the loss partials. No float atomics: a call repeats bitwise, and the two
// instantiations give the same bits on the same rows. CHUNK: the S negatives
// do not fit beside a tile, and each tile is tile_grads_chunked's.
template <typename T, bool GATHER, bool CHUNK>
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
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nn = S * d;
  // one test for the whole grid: every row slab starts at a multiple of
  // bb d elements from a 16-byte aligned base
  const bool vec = d % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.v) |
                     reinterpret_cast<uintptr_t>(a.c) |
                     reinterpret_cast<uintptr_t>(a.n) |
                     reinterpret_cast<uintptr_t>(a.dv) |
                     reinterpret_cast<uintptr_t>(a.dc)) & 15) == 0;
  int* id_v = reinterpret_cast<int*>(g_s);
  int* id_c = id_v + bb;
  int* id_n = id_c + bb;
  // the block's dn partial and loss, over its tiles in order
  float* part = a.dn_part + static_cast<long long>(blockIdx.x) * nn;
  float loss = 0.0f;
  const int tiles = (a.B + bb - 1) / bb;
  if constexpr (CHUNK) {
    float* w = a.work ? a.work + static_cast<long long>(blockIdx.x) *
                                     a.work_floats
                      : gsmem;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const bool first = tile == static_cast<int>(blockIdx.x);
      const int row0 = tile * bb;
      const float l = tile_grads_chunked<T, GATHER, T>(
          static_cast<const T*>(a.v), static_cast<const T*>(a.c),
          static_cast<const T*>(a.n), a.idx_v, a.idx_c, a.idx_n, a.mask,
          a.mask_bf16, row0, min(bb, a.B - row0), bb, S, d, a.nc, w,
          static_cast<T*>(a.dv), static_cast<T*>(a.dc), part, first);
      if (warp == 0) loss = first ? l : loss + l;
    }
  } else {
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int row0 = tile * bb;
    const int rows = min(bb, a.B - row0);
    const long long off = static_cast<long long>(row0) * d;
    const T* vsrc = static_cast<const T*>(a.v) + (GATHER ? 0 : off);
    const T* csrc = static_cast<const T*>(a.c) + (GATHER ? 0 : off);
    const T* nsrc = static_cast<const T*>(a.n);
    const int nr = rows * d;

    // the ids of the v, c and n rows (GATHER), one round trip, kept where
    // the scores go later: g_s and l_s hold 2 bb (S + 1) >= 2 bb + S words
    const float m = tid < rows ? load_mask(a.mask, a.mask_bf16, row0 + tid)
                               : 0.0f;
    if (GATHER) {
      for (int t = tid; t < 2 * bb + S; t += THREADS) {
        int id = 0;
        if (t < rows)
          id = a.idx_v[row0 + t];
        else if (t >= bb && t - bb < rows)
          id = a.idx_c[row0 + t - bb];
        else if (t >= 2 * bb)
          id = a.idx_n[t - 2 * bb];
        id_v[t] = id;
      }
      __syncthreads();
    }
    // the rows: v, c and n, a vector of each per thread per step, every load
    // of a step (and the mask, bb <= THREADS) issued before any store
    if (vec) {
      for (int i0 = 0; i0 < max(nr, nn); i0 += THREADS * VEC) {
        const int i = i0 + tid * VEC;
        float x[VEC], y[VEC], z[VEC];
        if (i < nr) {
          load_vec(slab_elem<GATHER>(vsrc, id_v, i, d), x);
          load_vec(slab_elem<GATHER>(csrc, id_c, i, d), y);
        }
        if (i < nn) load_vec(slab_elem<GATHER>(nsrc, id_n, i, d), z);
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
          v_s[i] = to_f32(*slab_elem<GATHER>(vsrc, id_v, i, d));
          c_s[i] = to_f32(*slab_elem<GATHER>(csrc, id_c, i, d));
        }
        if (i < nn) n_s[i] = to_f32(*slab_elem<GATHER>(nsrc, id_n, i, d));
      }
    }
    if (tid < bb) m_s[tid] = m;
    __syncthreads();

    // scores: one warp per dot product, DOTS of a warp's dots reduced
    // together by one fixed shuffle tree each; lane i takes dot i's sigmoid
    // and softplus
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
    // the tile's dn partial, its rows in order, added to the block's (each
    // element by the same thread every tile)
    for (int i = tid; i < nn; i += THREADS) {
      const int s = i / d, k = i - s * d;
      float acc = 0.0f;
      for (int r = 0; r < rows; ++r)
        acc += g_s[r * T1 + 1 + s] * v_s[r * d + k];
      part[i] = first ? acc : part[i] + acc;
    }
    // the tile's loss: warp 0, lane j the terms j, j + 32, ... in order,
    // then one shuffle tree
    if (warp == 0) {
      float acc = 0.0f;
      for (int q = lane; q < ndots; q += 32) acc += l_s[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      loss = first ? acc : loss + acc;
    }
    __syncthreads();        // the next tile reuses the shared memory
  }
  }
  if (warp == 0 && lane == 0) a.loss_part[blockIdx.x] = loss;
  cooperative_groups::this_grid().sync();

  // dn[i] = the partials of blocks 0, 1, ... added in order (read at L2:
  // other blocks wrote them), PARTS loads in flight at a time; then cast
  const int nblk = gridDim.x;
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

// One cooperative launch of `blocks` blocks (at most one per SM, so every
// block is resident at once; cudaLaunchCooperativeKernel refuses a grid
// that is not).
template <typename T, bool GATHER, bool CHUNK>
int launch_grads_coop(const GradsArgs& a, int blocks, int smem,
                      cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgns_grads_coop<T, GATHER, CHUNK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  GradsArgs args = a;
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sgns_grads_coop<T, GATHER, CHUNK>),
      dim3(blocks), dim3(THREADS), params, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One cooperative launch of `grid` blocks of `kernel`, refused (with the
// error returned) unless every block can be resident at once: the
// grid-wide barriers need them all.
int launch_update(const void* kernel, const UpdateArgs& a, int grid,
                  int smem, cudaStream_t st) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  UpdateArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), params,
                                  static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CHUNK>
int launch_fused(const UpdateArgs& a, int grid, int smem, cudaStream_t st) {
  const void* k =
      a.sort_chunk ? reinterpret_cast<const void*>(sgns_update_sorted<T, CHUNK>)
                   : reinterpret_cast<const void*>(sgns_update_fused<T, CHUNK>);
  return launch_update(k, a, grid, smem, st);
}

}  // namespace

// dtype: 0 = f32 tables, 1 = bf16. mask: (B,) f32, or bf16 when mask_bf16.
// Tables are updated in place. Tiles of bb rows; nc > 0 stages the
// negatives nc at a time, in a workspace of work_floats per block in
// fscratch (0: in shared memory). sort_chunk == 0: one gradient block a
// tile (nblk = ceil(B / bb) of them), then the two sorting blocks, then
// more up to `blocks` for the combine; smem: the larger of a gradient
// tile's and a sort's 12 n2 + 4 bytes, n2 being B + S rounded up to a power
// of two. sort_chunk > 0: `blocks` blocks (one an SM) stride over the
// tiles, nblk = min(blocks, tiles) hold partials, and the 2B + S keys,
// sort_keys of them with the padding, are sorted sort_chunk at a time in
// shared memory (smem at least 8 sort_chunk). fscratch: f32 dv, dc (B, d),
// dn partials (nblk, S, d), the workspaces (blocks, work_floats), loss
// partials (nblk,), then the loss (its last element, the output);
// iscratch, 16-byte aligned: 5 (2B + S) + 2 int32 (sort_chunk == 0), or
// sort_keys 64-bit keys and then 2B + S int32.
extern "C" int sgns_fused_update(int dtype, int mask_bf16, void* vert,
                                 void* ctx, const void* idx_v,
                                 const void* idx_c, const void* idx_n,
                                 const void* mask, int B, int S, int d,
                                 float lr, int bb, int nblk, int blocks,
                                 int smem, int nc, int work_floats,
                                 int sort_chunk, int sort_keys,
                                 void* fscratch, void* iscratch,
                                 void* stream) {
  const int n = 2 * B + S;
  const long long bd = static_cast<long long>(B) * d;
  float* f = static_cast<float*>(fscratch);
  int* i = static_cast<int*>(iscratch);
  float* dn_part = f + 2 * bd;
  float* work = dn_part + static_cast<long long>(nblk) * S * d;
  float* loss_part = work + static_cast<long long>(blocks) * work_floats;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(i);
  UpdateArgs a{vert, ctx,
               static_cast<const int*>(idx_v),
               static_cast<const int*>(idx_c),
               static_cast<const int*>(idx_n),
               mask, mask_bf16, B, S, d, bb, nblk, -lr, nc, work_floats,
               sort_chunk, sort_keys,
               f, f + bd, dn_part, work_floats ? work : nullptr, loss_part,
               loss_part + nblk,
               reinterpret_cast<int4*>(i), i + 4 * n, i + 5 * n, keys};
  if (sort_chunk) a.pos = i + 2 * static_cast<long long>(sort_keys);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (B + bb - 1) / bb;
  if (nblk != (sort_chunk ? min(blocks, tiles) : tiles) ||
      (!sort_chunk && blocks < nblk + 2) ||
      (sort_chunk && (sort_keys % sort_chunk || sort_keys < n)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return nc ? launch_fused<float, true>(a, blocks, smem, st)
              : launch_fused<float, false>(a, blocks, smem, st);
  if (dtype == 1)
    return nc ? launch_fused<__nv_bfloat16, true>(a, blocks, smem, st)
              : launch_fused<__nv_bfloat16, false>(a, blocks, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool GATHER>
int launch_grads_t(const GradsArgs& a, int blocks, int smem, cudaStream_t st) {
  return a.nc ? launch_grads_coop<T, GATHER, true>(a, blocks, smem, st)
              : launch_grads_coop<T, GATHER, false>(a, blocks, smem, st);
}

// The gradients of rows gathered beforehand (sgns_grads: v, c (B, d) and n
// (S, d), idx_* null) or of table rows through their ids (sgns_fused_grads:
// vert, ctx and idx_v, idx_c (B,), idx_n (S,) int32): dv, dc (B, d), dn (S,
// d) in the rows' dtype, loss (1,) f32; tiles of bb <= 256 rows over
// `blocks` blocks, at most one per SM; dn_part (blocks, S, d) and loss_part
// (blocks,) f32 scratch (plan_sgns_grads). nc > 0 stages the negatives nc
// at a time, each block in its work_floats of `work` (null: in shared
// memory). One cooperative launch.
static int launch_grads(int dtype, const GradsArgs& a, int blocks, int smem,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gather = a.idx_v != nullptr;
  if (a.bb < 1 || a.bb > THREADS || blocks < 1 || a.nc < 0 ||
      (gather && (a.idx_c == nullptr || a.idx_n == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return gather ? launch_grads_t<float, true>(a, blocks, smem, st)
                  : launch_grads_t<float, false>(a, blocks, smem, st);
  if (dtype == 1)
    return gather ? launch_grads_t<__nv_bfloat16, true>(a, blocks, smem, st)
                  : launch_grads_t<__nv_bfloat16, false>(a, blocks, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sgns_fused_grads(int dtype, int mask_bf16, const void* vert,
                                const void* ctx, const void* idx_v,
                                const void* idx_c, const void* idx_n,
                                const void* mask, int B, int S, int d, int bb,
                                int blocks, int smem, int nc, int work_floats,
                                void* work, void* dv, void* dc,
                                void* dn_part, void* loss_part, void* dn,
                                void* loss, void* stream) {
  const GradsArgs a{vert, ctx, ctx,
                    static_cast<const int*>(idx_v),
                    static_cast<const int*>(idx_c),
                    static_cast<const int*>(idx_n),
                    mask, mask_bf16, B, S, d, bb, nc, work_floats,
                    static_cast<float*>(work),
                    dv, dc, dn, static_cast<float*>(dn_part),
                    static_cast<float*>(loss_part), static_cast<float*>(loss)};
  return launch_grads(dtype, a, blocks, smem, stream);
}

extern "C" int sgns_grads(int dtype, int mask_bf16, const void* v,
                          const void* c, const void* n, const void* mask,
                          int B, int S, int d, int bb, int blocks, int smem,
                          int nc, int work_floats, void* work, void* dv,
                          void* dc, void* dn_part, void* loss_part, void* dn,
                          void* loss, void* stream) {
  const GradsArgs a{v, c, n, nullptr, nullptr, nullptr, mask, mask_bf16, B,
                    S, d, bb, nc, work_floats, static_cast<float*>(work),
                    dv, dc, dn, static_cast<float*>(dn_part),
                    static_cast<float*>(loss_part), static_cast<float*>(loss)};
  return launch_grads(dtype, a, blocks, smem, stream);
}
