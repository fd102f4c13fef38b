// Row scatter-add table[idx[p]] += upd[p], in place and in position order,
// for Hopper: the port of the JAX package's kernels/sgns.py::scatter_add_rows
// (the blocked TPU kernel, rows_per_block positions per grid step) and of
// its one-row-per-grid-step reference scatter_add_rows_rowwise. The
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
// Bound on an H100: bytes. The update rows are read once and each unique
// row read and written once, plus the ids (B = 256 + 5 context rows of 128
// f32: about 0.4 MB, 0.10 us at 3.35 TB/s); one add per element. At the
// trainer's sizes latency sets the time: a launch, a few dependent
// device-memory round trips, and the longest run of one row (a Zipf hub
// row's tens of positions), whose adds are serial by the semantics.
//
// Hopper blocks run in no order, so each kernel gives every row of a chunk
// one owner that applies the row's positions in order:
//
//   scatter_sorted    B is cut into consecutive chunks of at most P =
//                     1024 positions (the wrapper's plan); the chunks are
//                     launched one after another on the stream, which is
//                     the same function, as the JAX kernel's blocks are.
//                     One block of 1024 threads per 8 columns (16 blocks
//                     at d = 128, so the loads spread over 16 SMs). Each
//                     thread loads one position's id and its share of the
//                     update slice; then every position's table slice is
//                     loaded while the keys (id << 32 | pos, one per
//                     thread) are bitonic-sorted, by shuffles for strides
//                     below 32 and through shared memory above: the
//                     position in the low bits makes the sort stable. A
//                     block scan of the run-start flags numbers the runs.
//                     Then one group of 8 lanes per run, one lane per
//                     column, adds the run's updates in sorted (=
//                     position) order out of shared memory and writes the
//                     row once. Each row has one owner: no atomics, and
//                     the result is that of the plain version bit for bit.
//   scatter_rowwise   no sort and no run walk: each output column is still
//                     produced by one thread that walks every position in
//                     order, rounding once per position, which is the
//                     semantics; only how the walk is fed differs from a
//                     plain loop. B is cut into consecutive chunks of at
//                     most P positions (the wrapper's plan from shared
//                     memory), launched one after another on the stream.
//                     One block of 512 threads per 8 columns loads the
//                     chunk's ids, update slices and the table slice of
//                     every position's row into shared memory, all loads in
//                     flight at once and every table read before any write.
//                     While the rows arrive, each position p finds prev[p],
//                     the latest earlier position of the chunk with the same
//                     id (or -1), by an equality scan of the earlier ids in
//                     shared memory: the duplicate test of the JAX fused
//                     update's equality matrix, not a sort. Then the column's
//                     thread walks p = 0 .. n-1:
//                       r[p] = add(prev[p] < 0 ? staged[p] : r[prev[p]], u[p])
//                     with r in shared memory (in place of staged), so no
//                     step waits on device memory; positions that are the
//                     last of their row write r[p] back, each row once, with
//                     no atomics. It is the reference scatter_sorted is held
//                     against, and shares only add_rounded with it.
//
// Why chunks staged in shared memory: a walk that loads a row from device
// memory, adds, stores, and only then loads the next position's row (it
// may be the row just stored) pays a cold round trip per position, about
// 390 ns on an H100 at the trainer's sizes; a sort on the host adds
// launches. In both kernels every load is independent of the others, so a
// chunk costs two round trips (ids and updates; then table rows, with the
// sort or the equality scan hidden under them), and the serial adds read
// shared memory, a few ns per step. Blocks of 8 columns spread the loads
// over 16 SMs at d = 128, and the shuffle stages spare the sort most of its
// barriers.
//
// Row offsets are 64-bit: a 26.25 M x 128 f32 table is 13.4 GB. No index
// bounds are checked (as on the TPU). __fadd_rn keeps the compiler from
// contracting the add with anything around it, so every position rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLICE = 8;            // columns per block, both kernels
constexpr int THREADS = 1024;       // scatter_sorted: positions per chunk
constexpr int WARPS = THREADS / 32;
constexpr int RW_THREADS = 512;     // threads of a scatter_rowwise block
constexpr int RW_POSITIONS = 2048;  // scatter_rowwise: positions per chunk
constexpr int RW_CELLS = RW_POSITIONS * SLICE / RW_THREADS;  // per thread
constexpr int WALK = 8;             // positions per step of the walk

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

__device__ __forceinline__ int key_row(unsigned long long key) {
  return static_cast<int>(key >> 32);
}
__device__ __forceinline__ int key_pos(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

// Shared memory of a chunk of n positions (n2: n rounded up to a power of
// two): the sorted keys, the update and table slices by position, the ids
// and the run starts.
template <typename T, typename U>
__host__ __device__ constexpr size_t sorted_smem(int n, int n2) {
  return sizeof(unsigned long long) * n2 +
         static_cast<size_t>(n) * SLICE * (sizeof(U) + sizeof(T)) +
         sizeof(int) * (2 * static_cast<size_t>(n) + 1);
}

// One chunk of n <= THREADS positions; n2 is n rounded up to a power of
// two. table is not __restrict__: it is read and written in one launch.
template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
    scatter_sorted(T* table, const int* __restrict__ idx,
                   const U* __restrict__ upd, int n, int d, int n2) {
  extern __shared__ unsigned long long srt[];      // (n2,) sorted (id, pos)
  U* su = reinterpret_cast<U*>(srt + n2);          // (n, SLICE) by position
  T* st = reinterpret_cast<T*>(su + n * SLICE);    // (n, SLICE) by position
  int* sid = reinterpret_cast<int*>(st + n * SLICE);   // (n,) ids
  int* start = sid + n;                            // (runs + 1,) run starts
  __shared__ int wcount[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * SLICE;
  const int cols = min(SLICE, d - c0);
  const long long dd = d;
  const int cells = n * SLICE;

  // 1. the ids and the update slice, every load in flight at once (a
  // chunk has at most THREADS * SLICE cells: SLICE loads per thread)
  const int id = tid < n ? idx[tid] : 0;
  U uv[SLICE];
#pragma unroll
  for (int b = 0; b < SLICE; ++b) {
    const int e = b * THREADS + tid;
    if (e < cells && e % SLICE < cols)
      uv[b] = upd[(e / SLICE) * dd + c0 + e % SLICE];
  }
  if (tid < n) sid[tid] = id;
#pragma unroll
  for (int b = 0; b < SLICE; ++b) {
    const int e = b * THREADS + tid;
    if (e < cells && e % SLICE < cols) su[e] = uv[b];
  }
  __syncthreads();

  // 2. every position's table slice in flight while the keys sort (a
  // row's slice is read before any of the chunk's writes, so each of its
  // positions holds the same bits)
  T tv[SLICE];
#pragma unroll
  for (int b = 0; b < SLICE; ++b) {
    const int e = b * THREADS + tid;
    if (e < cells && e % SLICE < cols)
      tv[b] = table[sid[e / SLICE] * dd + c0 + e % SLICE];
  }
  // bitonic sort of (id << 32 | pos), one key per thread, ascending: by
  // id, then by position. Strides below 32 exchange by shuffle, the rest
  // through shared memory.
  unsigned long long x =
      tid < n ? (static_cast<unsigned long long>(static_cast<unsigned>(id))
                     << 32) |
                    static_cast<unsigned>(tid)
              : ~0ull;
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long y;
      if (stride >= 32) {
        if (tid < n2) srt[tid] = x;
        __syncthreads();
        y = tid < n2 ? srt[tid ^ stride] : x;
        __syncthreads();
      } else {
        y = __shfl_xor_sync(0xffffffffu, x, stride);
      }
      const bool take_min = ((tid & stride) == 0) == ((tid & size) == 0);
      x = take_min ? min(x, y) : max(x, y);
    }
  }
  if (tid < n2) srt[tid] = x;
#pragma unroll
  for (int b = 0; b < SLICE; ++b) {
    const int e = b * THREADS + tid;
    if (e < cells && e % SLICE < cols) st[e] = tv[b];
  }
  __syncthreads();

  // 3. the runs of equal ids: a run starts where the id changes; its
  // number is the count of starts before it (a block scan of the flags)
  const bool head =
      tid < n && (tid == 0 || key_row(srt[tid - 1]) != key_row(x));
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  if (lane == 0) wcount[warp] = __popc(heads);
  __syncthreads();
  if (warp == 0) {
    int c = wcount[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += v;
    }
    wcount[lane] = c;                  // inclusive over warps
  }
  __syncthreads();
  const int runs = wcount[WARPS - 1];
  if (head) {
    start[(warp > 0 ? wcount[warp - 1] : 0) +
          __popc(heads & ((1u << lane) - 1))] = tid;
  }
  if (tid == 0) start[runs] = n;
  __syncthreads();

  // 4. one group of SLICE lanes per run, one lane per column: the run's
  // adds in sorted (= position) order out of shared memory, the row
  // written once
  const int g = tid / SLICE, c = tid % SLICE;
  for (int r = g; r < runs; r += THREADS / SLICE) {
    const int j = start[r], end = start[r + 1];
    const unsigned long long first = srt[j];
    if (c < cols) {
      T acc = st[key_pos(first) * SLICE + c];
#pragma unroll 4
      for (int p = j; p < end; ++p)
        acc = add_rounded(acc, su[key_pos(srt[p]) * SLICE + c]);
      table[key_row(first) * dd + c0 + c] = acc;
    }
  }
}

// Shared memory of a row-wise chunk of n positions: the update and row
// slices, the ids, the previous occurrences and the last-occurrence flags.
template <typename T, typename U>
__host__ __device__ constexpr size_t rowwise_smem(int n) {
  return static_cast<size_t>(n) *
         (SLICE * (sizeof(U) + sizeof(T)) + 3 * sizeof(int));
}

// One chunk of n <= RW_POSITIONS positions, SLICE columns per block. table
// is not __restrict__: it is read and written in one launch.
template <typename T, typename U>
__global__ void __launch_bounds__(RW_THREADS)
    scatter_rowwise(T* table, const int* __restrict__ idx,
                    const U* __restrict__ upd, int n, int d) {
  extern __shared__ __align__(16) unsigned char rw_smem[];
  U* su = reinterpret_cast<U*>(rw_smem);           // (n, SLICE) updates
  T* sr = reinterpret_cast<T*>(su + n * SLICE);    // (n, SLICE) rows
  int* sid = reinterpret_cast<int*>(sr + n * SLICE);   // (n,) ids
  int* prv = sid + n;                              // (n,) previous occurrence
  int* last = prv + n;                             // (n,) 1: last of its row
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * SLICE;
  const int cols = min(SLICE, d - c0);
  const long long dd = d;
  const int cells = n * SLICE;

  // 1. the ids and the update slice, every load in flight at once
  for (int p = tid; p < n; p += RW_THREADS) {
    sid[p] = idx[p];
    last[p] = 1;
  }
  U uv[RW_CELLS];
#pragma unroll
  for (int b = 0; b < RW_CELLS; ++b) {
    const int e = b * RW_THREADS + tid;
    if (e < cells && e % SLICE < cols)
      uv[b] = upd[(e / SLICE) * dd + c0 + e % SLICE];
  }
#pragma unroll
  for (int b = 0; b < RW_CELLS; ++b) {
    const int e = b * RW_THREADS + tid;
    if (e < cells && e % SLICE < cols) su[e] = uv[b];
  }
  __syncthreads();

  // 2. every position's table slice in flight (read before any write of the
  // chunk) while each position finds its previous occurrence: the lanes of
  // a warp read the same earlier id at each step (a broadcast) and keep the
  // latest equal one
  T tv[RW_CELLS];
#pragma unroll
  for (int b = 0; b < RW_CELLS; ++b) {
    const int e = b * RW_THREADS + tid;
    if (e < cells && e % SLICE < cols)
      tv[b] = table[sid[e / SLICE] * dd + c0 + e % SLICE];
  }
  for (int p0 = 0; p0 < n; p0 += RW_THREADS) {
    const int p = p0 + tid;
    const int w0 = p0 + (tid & ~31);               // the warp's first position
    if (w0 >= n) break;
    const int id = p < n ? sid[p] : 0;
    int pr = -1;
    const int4* s4 = reinterpret_cast<const int4*>(sid);
    for (int q = 0; q < w0; q += 4) {              // earlier than every lane's
      const int4 v = s4[q / 4];
      if (v.x == id) pr = q;
      if (v.y == id) pr = q + 1;
      if (v.z == id) pr = q + 2;
      if (v.w == id) pr = q + 3;
    }
    for (int q = w0; q < min(w0 + 31, n); ++q)
      if (q < p && sid[q] == id) pr = q;
    if (p < n) prv[p] = pr;
  }
#pragma unroll
  for (int b = 0; b < RW_CELLS; ++b) {
    const int e = b * RW_THREADS + tid;
    if (e < cells && e % SLICE < cols) sr[e] = tv[b];
  }
  __syncthreads();

  // 3. a position that a later one follows on its row writes nothing back
  for (int p = tid; p < n; p += RW_THREADS)
    if (prv[p] >= 0) last[prv[p]] = 0;

  // 4. the walk: one thread per column, every position in order, out of
  // shared memory; r[p] takes the place of the staged row slice. It goes
  // in steps of WALK positions whose shared-memory reads are all issued
  // first (the links and updates one step ahead): a position whose row an
  // earlier position of the same step wrote takes that result from a
  // register, any other its staged slice or the final r of an earlier step,
  // so the serial part of a step is its adds.
  if (tid < cols) {
    T* r = sr + tid;
    const U* u = su + tid;
    int pr[WALK];
    U up[WALK];
#pragma unroll
    for (int i = 0; i < WALK; ++i) {
      const int p = min(i, n - 1);
      pr[i] = prv[p];
      up[i] = u[p * SLICE];
    }
    for (int p0 = 0; p0 < n; p0 += WALK) {
      T base[WALK];
#pragma unroll
      for (int i = 0; i < WALK; ++i) {
        const int p = min(p0 + i, n - 1);
        base[i] = r[(pr[i] >= 0 && pr[i] < p0 ? pr[i] : p) * SLICE];
      }
      T res[WALK];
#pragma unroll
      for (int i = 0; i < WALK; ++i) {
        T x = base[i];
#pragma unroll
        for (int j = 0; j < i; ++j)
          if (pr[i] == p0 + j) x = res[j];
        res[i] = add_rounded(x, up[i]);
      }
#pragma unroll
      for (int i = 0; i < WALK; ++i) {           // the next step's links
        const int p = min(p0 + WALK + i, n - 1);
        pr[i] = prv[p];
        up[i] = u[p * SLICE];
      }
#pragma unroll
      for (int i = 0; i < WALK; ++i)
        if (p0 + i < n) r[(p0 + i) * SLICE] = res[i];
    }
  }
  __syncthreads();

  // 5. each row once, from its last position
  for (int e = tid; e < cells; e += RW_THREADS) {
    const int p = e / SLICE, c = e % SLICE;
    if (c < cols && last[p]) table[sid[p] * dd + c0 + c] = sr[e];
  }
}

template <typename T, typename U>
int launch_sorted(void* table, const void* idx, const void* upd, int B,
                  int d, int P, cudaStream_t st) {
  for (int p0 = 0; p0 < B; p0 += P) {
    const int n = min(P, B - p0);
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    const size_t smem = sorted_smem<T, U>(n, n2);
    cudaError_t e = cudaFuncSetAttribute(
        scatter_sorted<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    scatter_sorted<T, U><<<(d + SLICE - 1) / SLICE, THREADS, smem, st>>>(
        static_cast<T*>(table), static_cast<const int*>(idx) + p0,
        static_cast<const U*>(upd) + static_cast<size_t>(p0) * d, n, d, n2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T, typename U>
int launch_rowwise(void* table, const void* idx, const void* upd, int B,
                   int d, int P, cudaStream_t st) {
  for (int p0 = 0; p0 < B; p0 += P) {
    const int n = min(P, B - p0);
    const size_t smem = rowwise_smem<T, U>(n);
    cudaError_t e = cudaFuncSetAttribute(
        scatter_rowwise<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    scatter_rowwise<T, U><<<(d + SLICE - 1) / SLICE, RW_THREADS, smem, st>>>(
        static_cast<T*>(table), static_cast<const int*>(idx) + p0,
        static_cast<const U*>(upd) + static_cast<size_t>(p0) * d, n, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// dtype: 0 = f32 table, 1 = bf16. upd_f32: upd (B, d) is f32 (else in the
// table's dtype; an f32 table takes f32 only). The trainer's routes pass
// f32; upd in the table's dtype is taken as the JAX scatter_add_rows takes
// it, so the two are held against each other on the same inputs. idx:
// (B,) int32, unsorted. P: positions per chunk, one launch per chunk (the
// wrapper's plan; the launch fails if its shared memory does not fit).
extern "C" int scatter_add_rows(int dtype, int upd_f32, void* table,
                                const void* idx, const void* upd, int B, int d,
                                int P, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && upd_f32)
    return launch_sorted<float, float>(table, idx, upd, B, d, P, st);
  if (dtype == 1 && upd_f32)
    return launch_sorted<__nv_bfloat16, float>(table, idx, upd, B, d, P, st);
  if (dtype == 1)
    return launch_sorted<__nv_bfloat16, __nv_bfloat16>(table, idx, upd, B, d,
                                                       P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same function with no sort: one thread per column walks every
// position in order. idx (B,) int32 unsorted; P positions per chunk, one
// launch per chunk (the wrapper's plan; the launch fails if its shared
// memory does not fit).
extern "C" int scatter_add_rows_rowwise(int dtype, int upd_f32, void* table,
                                        const void* idx, const void* upd,
                                        int B, int d, int P, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > RW_POSITIONS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && upd_f32)
    return launch_rowwise<float, float>(table, idx, upd, B, d, P, st);
  if (dtype == 1 && upd_f32)
    return launch_rowwise<__nv_bfloat16, float>(table, idx, upd, B, d, P, st);
  if (dtype == 1)
    return launch_rowwise<__nv_bfloat16, __nv_bfloat16>(table, idx, upd, B, d,
                                                         P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
