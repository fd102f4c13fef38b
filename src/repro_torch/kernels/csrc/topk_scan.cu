// Exact MIPS top-k scans for Hopper: the port of the JAX package's
// embed_serve/topk.py::topk_mips (f32 and bf16 tables) and
// topk_mips_quant (int8 tables with per-row scales), both launched there
// by _launch_topk_scan. One kernel serves both: filter_kernel, instantiated
// per table dtype and width.
//
// What they compute: for every query q and every table row r < valid, the
// f32 score s = q . row (an int8 row: s = (q . row) * scale[r], the scale
// applied after the dot), and the k best (s, r) under the total order
// "score descending, then row ascending". Unfilled slots are
// (-inf, INT32_MAX). The score of a pair is one fmaf chain over j = 0..d-1
// in ascending order from 0.0, with the query in f32 and the row widened to
// f32; that chain is what the plain version (a TF32-free f32 GEMM) and the
// rowwise kernel (topk_rowwise.cu) give bit for bit, so it is the contract.
//
// The TPU kernel walks row tiles as a sequential grid axis into a revisited
// output block. Hopper blocks run in no order, so each scan writes partial
// lists, (Q, lists, k), and a merge kernel takes the top-k of each query's
// lists under the same order (one warp per query).
//
// A filter on the tensor cores in front of the exact chain (filter_kernel;
// int8 tables below the error bound).
//
//   Bound on an H100 at the serving shape (26.25 M x 128 bf16 rows, 256
//   queries): 2*Q*N*d = 1.7 TFLOP, which the bf16 tensor cores do in 1.7 ms
//   (989 TFLOP/s) and the f32 CUDA cores in 25.7 ms (67 TFLOP/s), against
//   6.7 GB of table (3.35 TB/s: 2.0 ms). The exact chain cannot run on the
//   tensor cores, so they only decide which pairs need it:
//
//   1. Approximate scores a = bf16(q) . bf16(row) with mma.sync m16n8k16
//      (bf16 in, f32 accumulation). A warp keeps the bf16 fragments of 8*NT
//      queries in registers for the whole scan (B operand) and takes table
//      rows 16 at a time from shared memory (A operand); the block's 8 warps
//      hold up to 256 queries at d <= 128, so at Q = 256 the table is read
//      once. Row
//      tiles of TR rows stream through a two-stage cp.async ring; each row
//      is padded by 16 bytes in shared memory, so a fragment load hits 32
//      distinct banks. A bf16 table is used as it is; an f32 table is
//      rounded to bf16 as its fragments are loaded.
//   2. The filter: pair (q, r) goes on iff !(a + eps_qr < tau_q). Every
//      list's k-th exact score is at most the final k-th, so tau_q is the
//      largest one found anywhere: the block's own list's and, read once a
//      tile from gtau[q] (atomicMax of an order-preserving key, by every
//      block whose list changes), every other block's. -inf (or a NaN key)
//      until a list is full; a stale copy is safe since tau only rises. A
//      non-finite a or eps passes.
//   3. The exact rescore: survivors queue in shared memory as (query, row),
//      32 per warp; when the queue is full (or the split ends) each lane
//      runs the contract's fmaf chain for one survivor (f32 query and row
//      from global memory: the row was streamed recently, so it is mostly
//      in L2) and inserts the exact score into its query's list itself,
//      under the list's lock (the warps of a block that see one query share
//      its list), lanes of one query taking turns. Rows and queries past
//      the valid range never pass. Until a list fills, its threshold would
//      be -inf, so the first tile seeds it from the approximate scores
//      instead (below).
//
//   The error bound. Let q~ = bf16(q), t~ = bf16(t) (t~ = t for a bf16
//   table), S = sum q_j t_j exactly, A = sum q~_j t~_j exactly and s the
//   fmaf chain. Then
//     |s - S| <= d 2^-24 (1 + d 2^-24) sum |q_j t_j|   (the chain);
//     |S - A| <= ||q - q~|| ||t|| + ||q~|| ||t - t~||   (Cauchy-Schwarz,
//                                                       cancellation too);
//     |A - a| <= d 2^-20 sum |q~_j t~_j|                (assumed, since the
//   tensor cores' f32 accumulation is not IEEE: a deliberately loose
//   allowance, checked on the card through topk_filter_export), with
//   sum |q_j t_j| <= ||q|| ||t||, ||t - t~|| <= rho_t ||t|| (rho_t = 0 for
//   bf16 tables, 2^-8 for f32 ones rounded to nearest), and ||q~||, ||t||
//   within a factor 1 + 2^-7 of ||q||, ||t~||. So
//     |s - a| <= 2 ||t~|| (||q - q~|| + ||q|| (rho_t + 2 d 2^-24 + d 2^-20))
//   and the kernel takes eps = E'_q n'_r with
//     E_q = 8 (||q - q~|| + ||q|| (rho_t + 2 d 2^-24 + d 2^-20)),
//     E'_q = E_q + 2^-40,  n'_r = ||t~_r|| + 2^-40
//   (norms in f32: their rounding is far inside the factor 8; the 2^-40
//   floors cover bf16 or f32 subnormals the tensor cores may flush, each
//   product below 2^-126 lost, at most d 2^-126 <= 2^-80 for d <= 2^46).
//   The factor 8 leaves room for the card's check |a - s| <= eps / 4 even
//   on rows aligned with q - q~, where Cauchy-Schwarz is tight. A skipped
//   pair has s <= a + eps < tau_q <= the k-th score of the final list, so it
//   could not have entered the list whatever its row id: the result is the
//   contract's bit for bit. (fmaf(E', n', a) rounds once and rounding is
//   monotone, so comparing the rounded sum with the float tau loses
//   nothing.)
//
//   The bound for any d. Nothing above assumes d <= 256: the chain's
//   factor 1 + d 2^-24 <= 2 needs d <= 2^24, and the floors cover
//   d <= 2^46. Past 256 columns (wide_scores) a is the same mma.sync
//   products, 256 columns at a time, added into the same f32
//   accumulators, which shared memory keeps exactly between slices: one
//   accumulation of d products, as the allowance d 2^-20 sum |q~_j t~_j|
//   assumes, and n'_r is the root of the slices' summed squares (rounding
//   far inside the factor 8, as above). So eps = E'_q n'_r stands for
//   every d <= 2^24, and chip_smoke.py holds |a - s| <= eps / 4 at
//   d = 1, 100, 300 and 1000 as at 128. (d here is the padded width: the
//   store pads a table's columns with zeros to a multiple of 8 and each
//   query batch with it, which adds exact zeros to every chain, and only
//   raises E'_q.)
//
//   Shapes: d (a multiple of 8) is padded with zeros to D in {32, 64, 128,
//   256} (KS = D / 16 k-steps); NT = min(8, 32 / KS) query tiles of 8 per
//   warp, so the query fragments take KS * NT * 2 <= 64 registers. Past
//   256 columns the kernel takes KS = 16 slices in turn (WIDE), packing a
//   slice's query fragments as it starts, its tile's scores kept in shared
//   memory (TR x bq f32) from slice to slice. A block of 8 warps is QW
//   query groups by 8 / QW row groups (QW from Q: 1, 2, 4 or 8); queries
//   past Q are zero and never pass. The host plans one block per SM over
//   the rows. Past what the merge's shared memory holds (k > 7,264), each
//   merge warp keeps its query's list in that query's output row.
//
// int8 tables (topk_mips_quant, filter_kernel<int8_t, KS>): the score is
// s_r * scale_r, s_r the chain over the row widened to f32, scale_r > 0
// (quantize_rows gives an all-zero row 1.0). An int8 value has at most 8
// significant bits, so bf16(row) = row: rho_t = 0 and n'_r = ||row|| +
// 2^-40 exactly as above (the sum of squares is an exact int32). The
// lists hold scaled scores, and a pair is skipped only when
//   fl(fl(a + eps) * scale_r) < tau_q
// (with the same tie rule at equality). Sound: s_r <= a + eps, and s_r is
// a float, so fl(a + eps) >= s_r (rounding is monotone); multiplying by
// scale_r > 0 and rounding is monotone too, so fl(fl(a + eps) scale_r) >=
// fl(s_r scale_r), the exact scaled score. The seed's lower bounds are
// fl(fl(a - eps) scale_r) <= fl(s_r scale_r) the same way. Survivors get
// the chain over the int8 row from the table, then the one multiply by
// scale_r. The ring stages int8 tiles (half a bf16 tile's bytes); each is
// widened once per block into a bf16 tile (exact bit arithmetic: widen4),
// the row norms taken on the way, and the fragments load from that, so the
// eight warps that share a tile at Q = 256 do not each convert it. Bound:
// the table's N (d + 4) bytes (1.03 ms at the serving shape), or one bf16
// tensor-core pass (1.74 ms) plus the survivors' chains. The seed keeps 5
// lower bounds per lane and query (40 a query), so the two-tier scan's m =
// 40 is seeded from the first tile.
//
// At m = 40 the survivors are the cost, not the products or the widening:
// each split's list of m takes about m ln(n / m) exact inserts over its n
// rows, and the max of the splits' m-th scores (gtau) is little above one
// split's. So the int8 scan also shares a threshold across splits by
// groups: split s belongs to group s % GROUPS and raises the group's word
// of query q (atomicMax of an order key) to its list's r-th score, r =
// ceil(m / GROUPS); a warp takes the least of the GROUPS words (read with
// gtau at the end of each tile). Sound: group g's word is the r-th score
// of some list of a split in g, lists only improve, and the splits of
// different groups hold different rows, so at least GROUPS r >= m distinct
// pairs score at least the least word, and so does the final m-th. (Until
// every group has a word the least is key 0, a NaN, and gtau alone
// counts.) The least word is close to the m-th best of every row scanned
// so far, not of one split's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MERGE_WARPS = 4;       // queries per merge block
constexpr int IDX_SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A float as an unsigned key in the same order (for atomicMax); key 0 is
// below every float's and decodes to a NaN, which no filter test rejects.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float from_order_key(unsigned u) {
  return __uint_as_float(u & 0x80000000u ? u & 0x7fffffffu : ~u);
}

// A list's k-th entry (score, row) as one word, read and written whole.
__device__ __forceinline__ unsigned long long kth_word(float v, int i) {
  return static_cast<unsigned long long>(__float_as_uint(v)) << 32 |
         static_cast<unsigned>(i);
}

// Whether pair (bound x = a + eps, row r) must be scored exactly, against
// the threshold tau and its list's k-th entry *kw: not when x < tau, nor
// when x reaches only the k-th score at a later row. tau is at least that
// score once the list holds it, so the second test can matter only when x
// == tau (a stale tau only misses a skip). A NaN x goes on.
__device__ __forceinline__ bool goes_on(float x, float tau,
                                        const unsigned long long* kw, int r) {
  if (x < tau) return false;
  if (x != tau) return true;
  const unsigned long long w = *kw;
  return !(x <= __uint_as_float(static_cast<unsigned>(w >> 32)) &&
           r > static_cast<int>(w & 0xffffffffu));
}

// A pair's edge fl(a +- eps) on the lists' scale: times the row's scale
// for an int8 table (rounded once; monotone, as the note's proof needs).
template <bool Q8>
__device__ __forceinline__ float scaled(float x, float s) {
  if constexpr (Q8) return __fmul_rn(x, s);
  return x;
}

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

// The filter scan's merge: one warp per query over its (lists, k) entries,
// 32 at a time in memory order, so the loads need not wait for the
// inserts; an entry below gtau[q] (the largest k-th score of any list, at
// most the final k-th) is never offered. The list is kept in shared memory,
// or (in_out: past what shared memory holds) in the query's output row
// itself, through the same code and generic pointers.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    filter_merge_kernel(const float* __restrict__ part_v,
                        const int* __restrict__ part_i,
                        const unsigned* __restrict__ gtau, int Q, int lists,
                        int k, float* out_v, int* out_i, int in_out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= Q) return;  // whole warp; no block-wide barrier follows
  float* Lv = reinterpret_cast<float*>(smem4) + warp * k;
  int* Li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem4) +
                                   MERGE_WARPS * k) + warp * k;
  if (in_out) {
    Lv = out_v + static_cast<size_t>(q) * k;
    Li = out_i + static_cast<size_t>(q) * k;
  }
  for (int i = lane; i < k; i += 32) {
    Lv[i] = -INFINITY;
    Li[i] = IDX_SENTINEL;
  }
  __syncwarp();
  const float tau = from_order_key(gtau[q]);
  const int n = lists * k;
  const float* pv = part_v + static_cast<size_t>(q) * n;
  const int* pi = part_i + static_cast<size_t>(q) * n;
#pragma unroll 4
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const float v = i < n ? pv[i] : -INFINITY;
    const int gi = i < n ? pi[i] : IDX_SENTINEL;
    warp_offer(Lv, Li, k, v, gi, i < n && !(v < tau), lane);
  }
  if (in_out) return;
  for (int i = lane; i < k; i += 32) {
    out_v[static_cast<size_t>(q) * k + i] = Lv[i];
    out_i[static_cast<size_t>(q) * k + i] = Li[i];
  }
}

// --------------------------------------------------------------------------
// the filter scan (f32, bf16 and int8 tables)
// --------------------------------------------------------------------------
constexpr int FW = 8;                // warps of a filter block
constexpr int FT = FW * 32;
constexpr int QCAP = 32;             // survivors queued per warp
constexpr int GROUPS = 8;            // int8: split groups of the thresholds
constexpr size_t kSmemPerBlock = 232448;   // H100: 227 KB per block
// 2^-40: the floors of E'_q and n'_r (the kernel's note)
constexpr float FLOOR = 9.094947017729282e-13f;

__host__ __device__ constexpr int query_tiles(int ks) {
  return 32 / ks < 8 ? 32 / ks : 8;
}
template <typename T, int KS>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) * KS * 16 > 512 ? 64 : 128;
}
// shared-memory row stride in elements: D plus 16 bytes
template <typename T, int KS>
__host__ __device__ constexpr int row_stride() {
  return KS * 16 + 16 / static_cast<int>(sizeof(T));
}
template <typename T, int KS>
__host__ __device__ constexpr size_t tile_bytes() {
  return static_cast<size_t>(tile_rows<T, KS>()) * row_stride<T, KS>() *
         sizeof(T);
}
template <typename T>
constexpr bool kInt8 = std::is_same<T, int8_t>::value;
// The type the tensor cores read a staged row in: an int8 tile is widened
// to bf16 (exactly) once per block before its fragments load.
template <typename T>
struct Frag {
  using type = T;
};
template <>
struct Frag<int8_t> {
  using type = __nv_bfloat16;
};
// The row staging of a block: the two stages of the tile ring; for int8
// also the bf16 tile the fragments load from and the stages' row scales.
template <typename T, int KS>
__host__ __device__ constexpr size_t staging_bytes() {
  return 2 * tile_bytes<T, KS>() +
         (kInt8<T> ? tile_bytes<__nv_bfloat16, KS>() +
                         2 * tile_rows<T, KS>() * sizeof(float)
                   : 0);
}
// Lower bounds a lane keeps per query slot for the first-tile seed: the 8
// lane groups' values of a query are 8 SD distinct pairs, so the seed
// covers k <= 8 SD (16 for f32 and bf16; 40 for int8, the two-tier scan's
// m = 4k at k = 10).
template <typename T>
__host__ __device__ constexpr int seed_depth() {
  return kInt8<T> ? 5 : 2;
}
template <typename T>
__host__ __device__ constexpr int seed_slots() {
  return 8 * seed_depth<T>();
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 8 and 4 bytes (int8 rows of d % 16 == 8; one row scale), through L1
template <int N>
__device__ __forceinline__ void cp_small(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(valid ? N : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a * b: one m16n8k16 bf16 product, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two consecutive row elements at p as a bf16 pair (an f32 row rounded to
// nearest).
__device__ __forceinline__ uint32_t frag2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t frag2(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}

// Eight consecutive row elements as f32 (a staged tile or the table).
__device__ __forceinline__ void row8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void row8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
// (an int8 row in the table, for the exact rescore: widened exactly)
__device__ __forceinline__ void row8(const int8_t* p, float* x) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = static_cast<float>(
        static_cast<signed char>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
}

// Four int8 values (one word) as four bf16 (two words), exactly: byte b
// becomes the float with bits 0x4B0000 | (b + 128), 2^23 + b + 128, minus
// 2^23 + 128; a float of magnitude <= 128 has 8 significant bits at most,
// so its bf16 is its top half.
__device__ __forceinline__ uint2 widen4(unsigned w) {
  const unsigned u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)),
                     8388736.0f);
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// A staged int8 tile (row stride D + 16 bytes) widened to the bf16 tile the
// fragments load from (row stride D + 8), and each row's n'_r = ||x_r|| +
// 2^-40: the sum of squares in int32 (__dp4a; exact, at most 256 * 127^2
// < 2^24, so its float is too). FT / TR adjacent threads a row, 16 bytes a
// step.
template <int KS, bool ACC = false>
__device__ void widen_tile(const int8_t* src, __nv_bfloat16* dst,
                           float* nrm) {
  constexpr int D = KS * 16, TR = tile_rows<int8_t, KS>(), TPR = FT / TR;
  constexpr int RS8 = row_stride<int8_t, KS>();
  constexpr int RSB = row_stride<__nv_bfloat16, KS>();
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  int ss = 0;
#pragma unroll
  for (int j = 16 * part; j < D; j += 16 * TPR) {
    const uint4 u = *reinterpret_cast<const uint4*>(src + r * RS8 + j);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    uint2 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ss = __dp4a(static_cast<int>(w[i]), static_cast<int>(w[i]), ss);
      h[i] = widen4(w[i]);
    }
    uint4* out = reinterpret_cast<uint4*>(dst + r * RSB + j);
    out[0] = make_uint4(h[0].x, h[0].y, h[1].x, h[1].y);
    out[1] = make_uint4(h[2].x, h[2].y, h[3].x, h[3].y);
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) ss += __shfl_xor_sync(FULL, ss, o);
  // ACC: a slice's sum of squares added to the row's (wide rows)
  if (part == 0) {
    if constexpr (ACC)
      nrm[r] += static_cast<float>(ss);
    else
      nrm[r] = sqrtf(static_cast<float>(ss)) + FLOOR;
  }
}

// The scales of rows [r0, r0 + TR) into a stage (0 at or past `end`).
template <int TR>
__device__ __forceinline__ void load_scales(float* dst, const float* scales,
                                            long long r0, long long end) {
  for (int i = threadIdx.x; i < TR; i += FT) {
    const bool ok = r0 + i < end;
    cp_small<4>(dst + i, scales + (ok ? r0 + i : 0), ok);
  }
}

// The contract's score: the fmaf chain over j = 0..d-1 from 0.0.
template <typename T>
__device__ __forceinline__ float exact_score(const float* q, const T* row,
                                             int d) {
  float s = 0.f;
  // eight 8-element steps' loads at once: a row of 128 takes two round
  // trips to L2 or the table
#pragma unroll 8
  for (int j = 0; j < d; j += 8) {
    float x[8];
    row8(row + j, x);
    const float4 a = __ldg(reinterpret_cast<const float4*>(q + j));
    const float4 b = __ldg(reinterpret_cast<const float4*>(q + j) + 1);
    s = fmaf(a.x, x[0], s);
    s = fmaf(a.y, x[1], s);
    s = fmaf(a.z, x[2], s);
    s = fmaf(a.w, x[3], s);
    s = fmaf(b.x, x[4], s);
    s = fmaf(b.y, x[5], s);
    s = fmaf(b.z, x[6], s);
    s = fmaf(b.w, x[7], s);
  }
  return s;
}

// What a filter block and the export block share: the geometry, the block's
// E'_q in shared memory, a warp's query fragments in registers, the
// staging of row tiles, their rows' n'_r and the approximate scores of one
// 16-row m-tile.
template <typename T, int KS>
struct Filter {
  static constexpr int D = KS * 16;
  static constexpr int NT = query_tiles(KS);
  static constexpr int PER_WARP = 8 * NT;
  static constexpr int TR = tile_rows<T, KS>();
  static constexpr int RS = row_stride<T, KS>();

  // E'_q of the block's queries [q0, q0 + bq) (0 past Q)
  static __device__ void query_bounds(const float* queries, int Q, int d,
                                      int q0, int bq, float rho_t,
                                      float* E) {
    for (int i = threadIdx.x; i < bq; i += FT) {
      float e = 0.f;
      if (q0 + i < Q) {
        const float* q = queries + static_cast<size_t>(q0 + i) * d;
        float nq = 0.f, nr = 0.f;
#pragma unroll 8
        for (int j = 0; j < d; ++j) {
          const float x = q[j];
          const float r = x - __bfloat162float(__float2bfloat16_rn(x));
          nq = fmaf(x, x, nq);
          nr = fmaf(r, r, nr);
        }
        // 2 d 2^-24 + d 2^-20 = d (2^-23 + 2^-20)
        const float acc = rho_t + static_cast<float>(d) *
                                      (1.1920928955078125e-07f +
                                       9.5367431640625e-07f);
        // a zero query scores every finite row +0 exactly, both ways
        e = nq > 0.f ? 8.f * (sqrtf(nr) + sqrtf(nq) * acc) + FLOOR : 0.f;
      }
      E[i] = e;
    }
  }

  // the bf16 fragments of the warp's 8 NT queries from qw0 on
  static __device__ void query_frags(const float* queries, int Q, int d,
                                     int qw0, int lane,
                                     uint32_t (&b)[KS][NT][2], int c0 = 0) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int q = qw0 + 8 * nt + g;
      const float* p = queries + static_cast<size_t>(q) * d;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = c0 + 16 * ks + 2 * t + 8 * h;
          const float x0 = q < Q && j < d ? p[j] : 0.f;
          const float x1 = q < Q && j + 1 < d ? p[j + 1] : 0.f;
          b[ks][nt][h] = pack_bf16(x0, x1);
        }
      }
    }
  }

  // zero the padding columns [d, D) of both stages (cp.async never writes
  // them)
  static __device__ void zero_pad(T* tiles, int d) {
    if (d == D) return;
    for (int e = threadIdx.x; e < 2 * TR * (D - d); e += FT) {
      const int r = e / (D - d), c = d + e % (D - d);
      tiles[r * RS + c] = T(0.f);
    }
  }

  // columns [c0, c0 + w) of rows [r0, r0 + TR) into a stage (w = d: whole
  // rows); rows at or past `end` zero-filled
  static __device__ void load_tile(T* dst, const T* table, int d,
                                   long long r0, long long end, int c0 = 0,
                                   int w = -1) {
    if (w < 0) w = d;
    if constexpr (kInt8<T>) {
      if (d % 16 || w % 16) {                 // 8-byte rows' copies
        const int ch = w / 8;
        for (int i = threadIdx.x; i < TR * ch; i += FT) {
          const int r = i / ch, c = i - r * ch;
          const bool ok = r0 + r < end;
          cp_small<8>(dst + r * RS + c * 8,
                      table + (ok ? (r0 + r) * d : 0) + c0 + c * 8, ok);
        }
        return;
      }
    }
    constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte copy
    const int ch = w / EPC;                   // copies per row
    for (int i = threadIdx.x; i < TR * ch; i += FT) {
      const int r = i / ch, c = i - r * ch;
      const bool ok = r0 + r < end;
      cp16(dst + r * RS + c * EPC,
           table + (ok ? (r0 + r) * d : 0) + c0 + c * EPC, ok);
    }
  }

  // zero columns [w, D) of one stage (the last slice of a wide row)
  static __device__ void zero_cols(T* tile, int w) {
    for (int e = threadIdx.x; e < TR * (D - w); e += FT) {
      const int r = e / (D - w), c = w + e % (D - w);
      tile[r * RS + c] = T(0.f);
    }
  }

  // n'_r of every row of a staged tile (the f32 values of an f32 row, the
  // bf16 values of a bf16 one), FT / TR adjacent threads a row
  template <bool ACC = false>
  static __device__ void row_norms(const T* tile, float* nrm) {
    constexpr int TPR = FT / TR;
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
    float s = 0.f;
#pragma unroll
    for (int j = 8 * part; j < D; j += 8 * TPR) {
      float x[8];
      row8(tile + r * RS + j, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) s = fmaf(x[i], x[i], s);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) s += __shfl_xor_sync(FULL, s, o);
    // ACC: a slice's sum of squares added to the row's (wide rows)
    if (part == 0) {
      if constexpr (ACC)
        nrm[r] += s;
      else
        nrm[r] = sqrtf(s) + FLOOR;
    }
  }

  // The approximate scores of m-tile rows [16 mt, 16 mt + 16) of a staged
  // tile against the warp's queries: acc[nt] holds rows g, g + 8 by queries
  // 8 nt + 2t, 8 nt + 2t + 1 (the mma accumulator layout).
  static __device__ __forceinline__ void scores(
      const T* tile, int mt, int lane, const uint32_t (&b)[KS][NT][2],
      float (&acc)[NT][4], bool add = false) {
    const int g = lane >> 2, t = lane & 3;
    const T* r0 = tile + (16 * mt + g) * RS + 2 * t;
    const T* r8 = r0 + 8 * RS;
    if (!add) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t a[4] = {frag2(r0 + 16 * ks), frag2(r8 + 16 * ks),
                             frag2(r0 + 16 * ks + 8),
                             frag2(r8 + 16 * ks + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[nt], a, b[ks][nt]);
    }
  }
};

// The approximate scores of one row tile of a wide table (d > 256) against
// a warp's queries: the tile's 256-column slices staged one after another
// into stage 0 (the last slice's columns past d zeroed), an int8 slice
// widened into `wide`; the warp's query fragments of each slice packed
// from the f32 queries; each of the warp's m-tiles' mma.sync products
// added into its accumulators, which A (TR x bq f32, laid out (m-tile,
// query group, nt, c, lane)) keeps from slice to slice; each row's sum of
// squares added slice by slice, and nrm[r] = its root + 2^-40 at the end.
// The filter then reads a pair's a from A, as the narrow kernel reads its
// accumulators.
template <typename T, int KS>
__device__ void wide_scores(const T* table, const float* queries, int Q,
                            int d, long long r0, long long end, int qw,
                            int qw0, int rw, int rws, int lane, T* tiles,
                            typename Frag<T>::type* wide, float* nrm,
                            float* A) {
  using FragT = typename Frag<T>::type;
  using R = Filter<T, KS>;
  using F = Filter<FragT, KS>;
  constexpr int NT = F::NT, TR = R::TR, D = R::D;
  const int qg = (threadIdx.x >> 5) % qw;
  for (int i = threadIdx.x; i < TR; i += FT) nrm[i] = 0.f;
  for (int c0 = 0; c0 < d; c0 += D) {
    const int wd = min(D, d - c0);
    R::load_tile(tiles, table, d, r0, end, c0, wd);
    cp_commit();
    if (wd < D) R::zero_cols(tiles, wd);
    cp_wait<0>();
    __syncthreads();
    const FragT* tile;
    if constexpr (kInt8<T>) {
      widen_tile<KS, true>(tiles, wide, nrm);
      tile = wide;
      __syncthreads();
    } else {
      tile = tiles;
      F::template row_norms<true>(tile, nrm);
    }
    uint32_t b[KS][NT][2];
    F::query_frags(queries, Q, d, qw0, lane, b, c0);
    for (int mt = rw; mt < TR / 16; mt += rws) {
      float* am = A + (mt * qw + qg) * NT * 4 * 32 + lane;
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[nt][c] = c0 ? am[(4 * nt + c) * 32] : 0.f;
      }
      F::scores(tile, mt, lane, b, acc, true);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) am[(4 * nt + c) * 32] = acc[nt][c];
      }
    }
    __syncthreads();            // the stage is refilled by the next slice
  }
  for (int i = threadIdx.x; i < TR; i += FT) nrm[i] = sqrtf(nrm[i]) + FLOOR;
  __syncthreads();
}

// A warp's accumulators of m-tile mt as wide_scores left them in A.
template <int NT>
__device__ __forceinline__ void wide_acc(const float* A, int mt, int qw,
                                         int lane, float (&acc)[NT][4]) {
  const float* am =
      A + (mt * qw + (threadIdx.x >> 5) % qw) * NT * 4 * 32 + lane;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = am[(4 * nt + c) * 32];
  }
}

// Shared memory of a filter block after its row staging (staging_bytes):
// the lists' k-th (score, row) words, E, the threshold keys and the list
// locks (bq each), each warp's float copy of its thresholds (FW x 8 NT),
// the seeds' candidates (FW x 8 NT x seed_slots floats), the survivor
// queues (FW x QCAP (query, row) pairs), the warps' survivor counts (FW
// ints) and a tile's n'_r (TR floats); then, when they are kept on chip,
// the block's lists (bq x k entries). A wide table's (WIDE) accumulators A
// (TR x bq f32) follow the n'_r, before the lists.
template <typename T, int KS, bool WIDE>
size_t filter_smem(int qw, int k, bool lists_on_chip) {
  const int per_warp = 8 * query_tiles(KS);
  const size_t bq = static_cast<size_t>(qw) * per_warp;
  return staging_bytes<T, KS>() + sizeof(unsigned long long) * bq +
         sizeof(float) * 3 * bq +
         sizeof(float) * (FW * per_warp * (seed_slots<T>() + 1) +
                          tile_rows<T, KS>()) +
         sizeof(int2) * FW * QCAP + sizeof(int) * FW +
         (WIDE ? sizeof(float) * tile_rows<T, KS>() * bq : 0) +
         (lists_on_chip ? (sizeof(float) + sizeof(int)) * bq *
                              static_cast<size_t>(k)
                        : 0);
}

// One block: queries [q0, q0 + QW * PER_WARP) over rows [begin, end) of its
// split. Warp w takes query group w % QW and row group w / QW: the m-tiles
// w / QW, w / QW + 8 / QW, ... of each tile. The row groups of a query
// share one list and one threshold per query: the list in shared memory
// when the block's lists fit there (lists_on_chip), else at (q, split) of
// part_v/part_i, (Q, splits, k), reached by the same code through generic
// pointers, and changed only under the query's lock; the threshold as an
// order key that only rises (atomicMax). Survivors queue as (query, table
// row) and are rescored when 32 have gathered (and at the end), the rows
// read again from the table (recently streamed, so mostly from L2). The
// merge kernel reads (Q, splits, k); counts[block] gets the pairs the block
// rescored. An int8 table (scales given) keeps its lists in scaled scores:
// a pair's bound is fl(fl(a + eps) * scale_r), its exact score the chain
// times scale_r (the note), the tile widened to bf16 before its fragments
// load. WIDE (d > 256, KS = 16): each row tile is scored slice by slice
// (wide_scores), its scores read back from shared memory.
template <typename T, int KS, bool WIDE>
__global__ void __launch_bounds__(FT, 1)
    filter_kernel(const T* __restrict__ table,
                  const float* __restrict__ scales,
                  const float* __restrict__ queries, int Q, int d, int valid,
                  int k, int qw, int rows_per_split, float rho_t,
                  float* part_v, int* part_i, int* __restrict__ counts,
                  unsigned* gtau, int lists_on_chip) {
  using FragT = typename Frag<T>::type;
  using R = Filter<T, KS>;                    // the ring of staged tiles
  using F = Filter<FragT, KS>;                // the fragments' tiles
  constexpr bool Q8 = kInt8<T>;
  constexpr int NT = F::NT, PER_WARP = F::PER_WARP, TR = R::TR, RS = R::RS;
  constexpr int SD = seed_depth<T>(), SEED = seed_slots<T>();
  constexpr int GW = (PER_WARP + 31) / 32;    // threshold words a lane reads
  static_assert(TR == F::TR, "an int8 tile widens into one bf16 tile");
  extern __shared__ __align__(16) unsigned char smem[];
  const int bq = qw * PER_WARP;
  T* tiles = reinterpret_cast<T*>(smem);
  // int8: the widened tile, then the two stages' row scales
  FragT* wide = reinterpret_cast<FragT*>(smem + 2 * tile_bytes<T, KS>());
  float* scale_st = reinterpret_cast<float*>(
      smem + 2 * tile_bytes<T, KS>() + tile_bytes<FragT, KS>());
  unsigned long long* kth_all = reinterpret_cast<unsigned long long*>(
      smem + staging_bytes<T, KS>());
  float* E = reinterpret_cast<float*>(kth_all + bq);
  unsigned* tkey_all = reinterpret_cast<unsigned*>(E + bq);
  int* lock_all = reinterpret_cast<int*>(tkey_all + bq);
  float* tauf_all = reinterpret_cast<float*>(lock_all + bq);
  float* seed_all = tauf_all + FW * PER_WARP;
  int2* queue_all = reinterpret_cast<int2*>(seed_all + FW * PER_WARP * SEED);
  int* wcount = reinterpret_cast<int*>(queue_all + FW * QCAP);
  float* nrm = reinterpret_cast<float*>(wcount + FW);
  float* A = nrm + TR;                        // WIDE: (TR, bq) accumulators
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = w / qw, rws = FW / qw;
  const int q0 = blockIdx.x * bq;
  const int qw0 = q0 + (w % qw) * PER_WARP;       // the warp's first query
  // the lists: (bq, k) on chip, or the partial output (Q, splits, k)
  float* lists_v = part_v;
  int* lists_i = part_i;
  if (lists_on_chip) {
    lists_v = A + (WIDE ? TR * bq : 0);
    lists_i = reinterpret_cast<int*>(lists_v + bq * k);
  }
  // where the list of query q starts
  auto list_at = [&](int q) {
    return lists_on_chip
               ? static_cast<size_t>(q - q0) * k
               : (static_cast<size_t>(q) * gridDim.y + blockIdx.y) * k;
  };
  unsigned* tkey = tkey_all + (qw0 - q0);        // the warp's queries'
  unsigned long long* kth = kth_all + (qw0 - q0);
  int* lock = lock_all + (qw0 - q0);
  // the warp's copy of tkey as floats, for the filter: refreshed each tile
  // and after the warp's own inserts (a stale copy is lower, so safe)
  float* tauf = tauf_all + w * PER_WARP;
  auto refresh = [&]() {
    __syncwarp();
    for (int j = lane; j < PER_WARP; j += 32)
      tauf[j] = from_order_key(tkey[j]);
    __syncwarp();
  };
  float* Ew = E + (qw0 - q0);
  int2* queue = queue_all + w * QCAP;
  // int8: this split's group word of each query (the note), and the rank r
  // of the list entry it takes: r GROUPS >= k
  unsigned* ggrp =
      gtau + static_cast<size_t>(1 + blockIdx.y % GROUPS) * Q;
  const int r_grp = (k + GROUPS - 1) / GROUPS;

  const long long begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long end =
      min(begin + rows_per_split, static_cast<long long>(valid));
  if constexpr (!WIDE) {
    R::load_tile(tiles, table, d, begin, end);
    if constexpr (Q8) load_scales<TR>(scale_st, scales, begin, end);
    cp_commit();
    R::zero_pad(tiles, d);
  }
  F::query_bounds(queries, Q, d, q0, bq, rho_t, E);
  for (int i = threadIdx.x; i < bq; i += FT) {
    tkey_all[i] = order_key(q0 + i < Q ? -INFINITY : INFINITY);
    kth_all[i] = kth_word(-INFINITY, IDX_SENTINEL);
    lock_all[i] = 0;
  }
  for (int i = threadIdx.x; i < bq * k; i += FT) {
    const int q = q0 + i / k;
    if (q < Q) {
      const size_t o = list_at(q) + i % k;
      lists_v[o] = -INFINITY;
      lists_i[o] = IDX_SENTINEL;
    }
  }
  uint32_t b[KS][NT][2];
  if constexpr (!WIDE) F::query_frags(queries, Q, d, qw0, lane, b);
  // the lane's accumulator slots that hold a real query (bit 4 nt + c)
  unsigned qmask = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int q = qw0 + 8 * nt + 2 * t;
    qmask |= ((q < Q ? 5u : 0u) | (q + 1 < Q ? 10u : 0u)) << (4 * nt);
  }
  int queued = 0;                   // warp-uniform
  int rescored = 0;                 // lane 0's count

  // rescore the queued pairs exactly and offer them to the lists
  auto flush = [&]() {
    __syncwarp();
    const bool live = lane < queued;
    float s = 0.f;
    int gi = 0, ql = 0;
    bool pass = false;
    if (live) {
      const int2 e = queue[lane];
      ql = e.x;
      gi = e.y;
      s = exact_score(queries + static_cast<size_t>(qw0 + ql) * d,
                      table + static_cast<long long>(gi) * d, d);
      if constexpr (Q8) s = __fmul_rn(s, __ldg(scales + gi));
      // without the lock, by value alone (one word, and it only rises)
      pass = !(s < lists_v[list_at(qw0 + ql) + k - 1]);
    }
    // each lane inserts its own candidate into its query's list under the
    // list's lock; of the lanes holding one query, the lowest goes first,
    // one per round
    while (__any_sync(FULL, pass)) {
      const unsigned peers = __match_any_sync(FULL, pass ? ql : -1 - lane);
      if (pass && lane == __ffs(peers) - 1) {
        while (atomicCAS(lock + ql, 0, 1) != 0) {
        }
        __threadfence_block();
        float* Lv = lists_v + list_at(qw0 + ql);
        int* Li = lists_i + list_at(qw0 + ql);
        if (better(s, gi, Lv[k - 1], Li[k - 1])) {
          int j = k - 1;
          for (; j > 0 && better(s, gi, Lv[j - 1], Li[j - 1]); --j) {
            Lv[j] = Lv[j - 1];
            Li[j] = Li[j - 1];
          }
          Lv[j] = s;
          Li[j] = gi;
          kth[ql] = kth_word(Lv[k - 1], Li[k - 1]);
          const unsigned key = order_key(Lv[k - 1]);
          atomicMax(tkey + ql, key);
          atomicMax(gtau + qw0 + ql, key);
          // int8: the split's group word takes the list's r-th score
          if constexpr (Q8) {
            if (j < r_grp)
              atomicMax(ggrp + qw0 + ql, order_key(Lv[r_grp - 1]));
          }
        }
        __threadfence_block();
        atomicExch(lock + ql, 0);
        pass = false;
      }
      __syncwarp();
    }
    rescored += queued;
    queued = 0;
    refresh();
  };

  // every list's k-th score is at most the final one, so the largest any
  // warp of the grid has found is a threshold for all: read at the end of
  // a tile, folded in at the start of the next
  unsigned gnext[GW];
#pragma unroll
  for (int i = 0; i < GW; ++i) gnext[i] = 0u;
  int stage = 0;
  for (long long r0 = begin; r0 < end; r0 += TR, stage ^= 1) {
    const FragT* tile = nullptr;
    const float* sc = nullptr;                // int8: the tile's row scales
    if constexpr (WIDE) {
      // the scales ride with the first slice's copies
      if constexpr (Q8) load_scales<TR>(scale_st, scales, r0, end);
      wide_scores<T, KS>(table, queries, Q, d, r0, end, qw, qw0, rw, rws,
                         lane, tiles, wide, nrm, A);
      if constexpr (Q8) sc = scale_st;
    } else {
    if (r0 + TR < end) {
      R::load_tile(tiles + (stage ^ 1) * TR * RS, table, d, r0 + TR, end);
      if constexpr (Q8)
        load_scales<TR>(scale_st + (stage ^ 1) * TR, scales, r0 + TR, end);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if constexpr (Q8) {
      widen_tile<KS>(tiles + stage * TR * RS, wide, nrm);
      tile = wide;
      sc = scale_st + stage * TR;
    } else {
      tile = tiles + stage * TR * RS;
      F::row_norms(tile, nrm);
    }
    }
    // a pair's approximate scores: the tensor cores' products of the staged
    // tile, or what wide_scores left in A
    auto scores_of = [&](int mt, float (&acc)[NT][4]) {
      if constexpr (WIDE)
        wide_acc<NT>(A, mt, qw, lane, acc);
      else
        F::scores(tile, mt, lane, b, acc);
    };
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      const int j = 32 * i + lane;
      if (gnext[i] != 0u && j < PER_WARP) atomicMax(tkey + j, gnext[i]);
    }
    __syncthreads();
    refresh();
    if (r0 == begin && k <= SEED) {
      // Seed tau before any exact score: s >= a - eps for every pair, so
      // the k-th largest a - eps of k distinct pairs is at most the k-th
      // largest exact score, itself at most the final k-th. A lane keeps
      // the SD largest a - eps of each of its queries over its rows of the
      // first tile; the 8 SD values of a query are distinct pairs. (int8:
      // fl(fl(a - eps) scale_r), at most the scaled exact score.)
      float top[NT][2][SD];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < SD; ++i) top[nt][0][i] = top[nt][1][i] = -INFINITY;
      }
      for (int mt = rw; mt < TR / 16; mt += rws) {
        float acc[NT][4];
        scores_of(mt, acc);
        const float n_g = nrm[16 * mt + g], n_g8 = nrm[16 * mt + g + 8];
        const bool ok_g = r0 + 16 * mt + g < end;
        const bool ok_g8 = r0 + 16 * mt + g + 8 < end;
        float s_g = 1.f, s_g8 = 1.f;
        if constexpr (Q8) {
          s_g = sc[16 * mt + g];
          s_g8 = sc[16 * mt + g + 8];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = Ew[8 * nt + 2 * t + (c & 1)];
            const bool ok = c >> 1 ? ok_g8 : ok_g;
            // a - eps rounded once: eps is 4x the error, far above an ulp
            const float lb =
                ok ? scaled<Q8>(fmaf(-e, c >> 1 ? n_g8 : n_g, acc[nt][c]),
                                c >> 1 ? s_g8 : s_g)
                   : -INFINITY;
            float(&tp)[SD] = top[nt][c & 1];
            if constexpr (SD == 2) {
              if (lb > tp[0]) {
                tp[1] = tp[0];
                tp[0] = lb;
              } else if (lb > tp[1]) {
                tp[1] = lb;
              }
            } else {
              float x = lb;           // insertion, largest first
#pragma unroll
              for (int i = 0; i < SD; ++i) {
                if (x > tp[i]) {
                  const float y = tp[i];
                  tp[i] = x;
                  x = y;
                }
              }
            }
          }
        }
      }
      float* seed = seed_all + w * PER_WARP * SEED;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* sq = seed + (8 * nt + 2 * t + h) * SEED + SD * g;
#pragma unroll
          for (int i = 0; i < SD; ++i) sq[i] = top[nt][h][i];
        }
      }
      __syncwarp();
      for (int j = lane; j < PER_WARP; j += 32) {
        // the k-th largest of the query's SEED values (a NaN never counts)
        const float* sq = seed + j * SEED;
        float kth = -INFINITY;
        for (int i = 0; i < SEED; ++i) {
          int above = 0;
          for (int u = 0; u < SEED; ++u)
            above += sq[u] > sq[i] || (sq[u] == sq[i] && u < i);
          if (above == k - 1) kth = sq[i];
        }
        if (qw0 + j < Q && kth > -INFINITY) {
          atomicMax(tkey + j, order_key(kth));
          atomicMax(gtau + qw0 + j, order_key(kth));
        }
      }
      refresh();
    }
    for (int mt = rw; mt < TR / 16; mt += rws) {
      float acc[NT][4];
      scores_of(mt, acc);
      const float n_g = nrm[16 * mt + g], n_g8 = nrm[16 * mt + g + 8];
      float s_g = 1.f, s_g8 = 1.f;
      if constexpr (Q8) {
        s_g = sc[16 * mt + g];
        s_g8 = sc[16 * mt + g + 8];
      }
      // !(a + eps < tau): a non-finite a or eps passes
      bool any = false;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 tq = *reinterpret_cast<const float2*>(tauf + 8 * nt +
                                                           2 * t);
        const float2 eq = *reinterpret_cast<const float2*>(Ew + 8 * nt +
                                                           2 * t);
        any |= !(scaled<Q8>(fmaf(eq.x, n_g, acc[nt][0]), s_g) < tq.x);
        any |= !(scaled<Q8>(fmaf(eq.y, n_g, acc[nt][1]), s_g) < tq.y);
        any |= !(scaled<Q8>(fmaf(eq.x, n_g8, acc[nt][2]), s_g8) < tq.x);
        any |= !(scaled<Q8>(fmaf(eq.y, n_g8, acc[nt][3]), s_g8) < tq.y);
      }
      if (!__any_sync(FULL, any)) continue;
      // rare: which pairs, of real rows and queries. A pair whose bound
      // reaches only the list's k-th score, at a later row, loses too:
      // s <= a + eps <= that score, and a tie goes to the smaller row
      const int rg = static_cast<int>(r0) + 16 * mt + g;
      const bool ok_g = rg < end;
      const bool ok_g8 = rg + 8 < end;
      unsigned bits = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 tq = *reinterpret_cast<const float2*>(tauf + 8 * nt +
                                                           2 * t);
        const float2 eq = *reinterpret_cast<const float2*>(Ew + 8 * nt +
                                                           2 * t);
        const unsigned long long* k0 = kth + 8 * nt + 2 * t;
        const bool p0 =
            ok_g && goes_on(scaled<Q8>(fmaf(eq.x, n_g, acc[nt][0]), s_g),
                            tq.x, k0, rg);
        const bool p1 =
            ok_g && goes_on(scaled<Q8>(fmaf(eq.y, n_g, acc[nt][1]), s_g),
                            tq.y, k0 + 1, rg);
        const bool p2 =
            ok_g8 && goes_on(scaled<Q8>(fmaf(eq.x, n_g8, acc[nt][2]), s_g8),
                             tq.x, k0, rg + 8);
        const bool p3 =
            ok_g8 && goes_on(scaled<Q8>(fmaf(eq.y, n_g8, acc[nt][3]), s_g8),
                             tq.y, k0 + 1, rg + 8);
        bits |= static_cast<unsigned>(p0 | p1 << 1 | p2 << 2 | p3 << 3)
                << (4 * nt);
      }
      bits &= qmask;
#pragma unroll 1
      for (int i = 0; i < 4 * NT; ++i) {
        const bool mine = (bits >> i) & 1;
        const unsigned bal = __ballot_sync(FULL, mine);
        if (bal == 0) continue;
        if (queued + __popc(bal) > QCAP) flush();
        if (mine) {
          const int ql = 8 * (i >> 2) + 2 * t + (i & 1);
          const long long r = r0 + 16 * mt + g + 8 * ((i >> 1) & 1);
          queue[queued + __popc(bal & ((1u << lane) - 1))] =
              make_int2(ql, static_cast<int>(r));
        }
        queued += __popc(bal);
      }
    }
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      const int j = 32 * i + lane;
      gnext[i] = j < PER_WARP && qw0 + j < Q ? __ldcg(gtau + qw0 + j) : 0u;
      if constexpr (Q8) {
        // and the least of the groups' words (0, a NaN, while a group has
        // no r-th score yet, so the max keeps gtau's)
        if (j < PER_WARP && qw0 + j < Q) {
          unsigned low = 0xffffffffu;
#pragma unroll
          for (int grp = 0; grp < GROUPS; ++grp)
            low = min(low, __ldcg(gtau + static_cast<size_t>(grp + 1) * Q +
                                  qw0 + j));
          gnext[i] = max(gnext[i], low);
        }
      }
    }
    __syncthreads();                  // the stage is refilled next
  }
  cp_wait<0>();                       // a split with no rows
  if (queued) flush();
  if (lane == 0) wcount[w] = rescored;
  __syncthreads();
  if (lists_on_chip) {
    for (int i = threadIdx.x; i < bq * k; i += FT) {
      if (q0 + i / k < Q) {
        const size_t o =
            (static_cast<size_t>(q0 + i / k) * gridDim.y + blockIdx.y) * k +
            i % k;
        part_v[o] = lists_v[i];
        part_i[o] = lists_i[i];
      }
    }
  }
  if (threadIdx.x == 0) {
    int c = 0;
    for (int i = 0; i < FW; ++i) c += wcount[i];
    counts[blockIdx.y * gridDim.x + blockIdx.x] = c;
  }
}

// The filter's approximate scores a and bounds eps of rows [0, n) against
// every query (test-only): out_a and out_eps are (Q, n) f32. One block per
// (query block, row tile), the same fragments, norms and E'_q as the scan
// (an int8 table's unscaled: the scan compares them times the row's scale).
template <typename T, int KS, bool WIDE>
__global__ void __launch_bounds__(FT, 1)
    filter_export_kernel(const T* __restrict__ table,
                         const float* __restrict__ queries, int Q, int d,
                         int n, int qw, float rho_t,
                         float* __restrict__ out_a,
                         float* __restrict__ out_eps) {
  using FragT = typename Frag<T>::type;
  using R = Filter<T, KS>;
  using F = Filter<FragT, KS>;
  constexpr int NT = F::NT, PER_WARP = F::PER_WARP, TR = R::TR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  FragT* wide = reinterpret_cast<FragT*>(smem + 2 * tile_bytes<T, KS>());
  float* E = reinterpret_cast<float*>(smem + staging_bytes<T, KS>());
  float* nrm = E + qw * PER_WARP;
  float* A = nrm + TR;                        // WIDE: (TR, bq) accumulators
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = w / qw, rws = FW / qw;
  const int q0 = blockIdx.x * qw * PER_WARP;
  const int qw0 = q0 + (w % qw) * PER_WARP;
  const long long r0 = static_cast<long long>(blockIdx.y) * TR;
  const FragT* tile = nullptr;
  uint32_t b[KS][NT][2];
  F::query_bounds(queries, Q, d, q0, qw * PER_WARP, rho_t, E);
  if constexpr (WIDE) {
    wide_scores<T, KS>(table, queries, Q, d, r0, n, qw, qw0, rw, rws, lane,
                       tiles, wide, nrm, A);
  } else {
    R::load_tile(tiles, table, d, r0, n);
    cp_commit();
    R::zero_pad(tiles, d);
    F::query_frags(queries, Q, d, qw0, lane, b);
    cp_wait<0>();
    __syncthreads();
    if constexpr (kInt8<T>) {
      widen_tile<KS>(tiles, wide, nrm);
      tile = wide;
    } else {
      tile = tiles;
      F::row_norms(tile, nrm);
    }
    __syncthreads();
  }
  const float* Ew = E + (w % qw) * PER_WARP;
  for (int mt = rw; mt < TR / 16; mt += rws) {
    float acc[NT][4];
    if constexpr (WIDE)
      wide_acc<NT>(A, mt, qw, lane, acc);
    else
      F::scores(tile, mt, lane, b, acc);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ql = 8 * nt + 2 * t + (c & 1);
        const int rt = 16 * mt + g + 8 * (c >> 1);
        if (qw0 + ql < Q && r0 + rt < n) {
          const size_t o = static_cast<size_t>(qw0 + ql) * n + r0 + rt;
          out_a[o] = acc[nt][c];
          out_eps[o] = Ew[ql] * nrm[rt];
        }
      }
    }
  }
}

template <typename T, int KS, bool WIDE>
int launch_filter(bool export_only, const void* table, const void* scales,
                  const void* queries, int Q, int d, int valid, int k, int qw,
                  int rows_per_split, int splits, void* part_v, void* part_i,
                  void* counts, void* gtau, void* out_a, void* out_eps,
                  cudaStream_t st) {
  const bool on_chip = !export_only &&
                       filter_smem<T, KS, WIDE>(qw, k, true) <= kSmemPerBlock;
  const size_t smem = filter_smem<T, KS, WIDE>(qw, k, on_chip);
  const int per_block = qw * 8 * query_tiles(KS);
  // 2^-8 for an f32 table rounded to bf16; 0 for bf16 and int8 rows
  const float rho_t = sizeof(T) == 4 ? 0.00390625f : 0.f;
  if (export_only) {
    cudaError_t e = cudaFuncSetAttribute(
        filter_export_kernel<T, KS, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((Q + per_block - 1) / per_block,
                    (valid + tile_rows<T, KS>() - 1) / tile_rows<T, KS>());
    filter_export_kernel<T, KS, WIDE><<<grid, FT, smem, st>>>(
        static_cast<const T*>(table), static_cast<const float*>(queries), Q,
        d, valid, qw, rho_t, static_cast<float*>(out_a),
        static_cast<float*>(out_eps));
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = cudaFuncSetAttribute(
      filter_kernel<T, KS, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // gtau, then for int8 the GROUPS group words of each query
  if (e == cudaSuccess)
    e = cudaMemsetAsync(
        gtau, 0,
        sizeof(unsigned) * static_cast<size_t>(Q) * (kInt8<T> ? 1 + GROUPS : 1),
        st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Q + per_block - 1) / per_block, splits);
  filter_kernel<T, KS, WIDE><<<grid, FT, smem, st>>>(
      static_cast<const T*>(table), static_cast<const float*>(scales),
      static_cast<const float*>(queries), Q, d, valid, k, qw, rows_per_split,
      rho_t, static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<int*>(counts), static_cast<unsigned*>(gtau),
      on_chip ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The arguments of one filter launch, passed down by width and dtype.
struct FilterCall {
  bool export_only;
  const void* table;
  const void* scales;
  const void* queries;
  int Q, d, valid, k, qw, rows_per_split, splits;
  void* part_v;
  void* part_i;
  void* counts;
  void* gtau;
  void* out_a;
  void* out_eps;
  cudaStream_t st;
};

template <typename T, int KS, bool WIDE = false>
int launch_call(const FilterCall& c) {
  return launch_filter<T, KS, WIDE>(c.export_only, c.table, c.scales, c.queries,
                              c.Q, c.d, c.valid, c.k, c.qw, c.rows_per_split,
                              c.splits, c.part_v, c.part_i, c.counts, c.gtau,
                              c.out_a, c.out_eps, c.st);
}

template <typename T>
int dispatch_width(int width, const FilterCall& c) {
  // past 256 columns: 256-column slices (any width a multiple of 256 that
  // covers d)
  if (width > 256) {
    if (width % 256 || c.d > width || c.d <= width - 256)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_call<T, 16, true>(c);
  }
  switch (width) {
    case 32:
      return launch_call<T, 2>(c);
    case 64:
      return launch_call<T, 4>(c);
    case 128:
      return launch_call<T, 8>(c);
    case 256:
      return launch_call<T, 16>(c);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_dtype(int dtype, int width, const FilterCall& c) {
  if (c.qw != 1 && c.qw != 2 && c.qw != 4 && c.qw != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_width<float>(width, c);
  if (dtype == 1) return dispatch_width<__nv_bfloat16>(width, c);
  if (dtype == 2) return dispatch_width<int8_t>(width, c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The filter scan. dtype: 0 = f32, 1 = bf16, 2 = int8 (scales: (rows,) f32,
// positive, required; scores are (q . row) * scale); width: d padded to 32,
// 64, 128 or 256, or past 256 d rounded up to a multiple of 256 (scored in
// 256-column slices); qw in {1, 2, 4, 8} query groups per block. The table is
// (rows, d) row-major with d % 8 == 0 and 16-byte rows aligned, queries
// (Q, d) f32 16-byte aligned; rows >= valid are never read. Grid: one
// block per (query block, split); part_v/part_i: (Q, splits, k), each
// block's lists for topk_filter_merge; counts: (query blocks * splits)
// ints, the pairs each block rescored; gtau: (Q,) unsigned (int8: (1 +
// GROUPS, Q)), zeroed here, the grid's thresholds.
extern "C" int topk_filter_partials(int dtype, int width, int qw,
                                    const void* table, const void* scales,
                                    const void* queries, int Q, int d,
                                    int valid, int k, int rows_per_split,
                                    int splits, void* part_v, void* part_i,
                                    void* counts, void* gtau, void* stream) {
  if ((dtype == 2) != (scales != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dtype(
      dtype, width,
      FilterCall{false, table, scales, queries, Q, d, valid, k, qw,
                 rows_per_split, splits, part_v, part_i, counts, gtau,
                 nullptr, nullptr, static_cast<cudaStream_t>(stream)});
}

// (Q, splits, k) lists of the filter scan -> (Q, k), skipping entries below
// each query's threshold gtau.
extern "C" int topk_filter_merge(const void* part_v, const void* part_i,
                                 const void* gtau, int Q, int splits, int k,
                                 void* out_v, void* out_i, void* stream) {
  // the warps' lists in shared memory while they fit, else in the output
  const bool in_out = static_cast<size_t>(MERGE_WARPS) * k *
                          (sizeof(float) + sizeof(int)) > kSmemPerBlock;
  const size_t smem = in_out ? 0
                             : static_cast<size_t>(MERGE_WARPS) * k *
                                   (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      filter_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (Q + MERGE_WARPS - 1) / MERGE_WARPS;
  filter_merge_kernel<<<blocks, MERGE_WARPS * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const unsigned*>(gtau), Q, splits, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i), in_out ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The filter's approximate scores and error bounds of rows [0, n) against
// every query, each (Q, n) f32 (test-only; arguments as above; an int8
// table's unscaled).
extern "C" int topk_filter_export(int dtype, int width, int qw,
                                  const void* table, const void* queries,
                                  int Q, int d, int n, void* out_a,
                                  void* out_eps, void* stream) {
  return dispatch_dtype(
      dtype, width,
      FilterCall{true, table, nullptr, queries, Q, d, n, 0, qw, 0, 0,
                 nullptr, nullptr, nullptr, nullptr, out_a, out_eps,
                 static_cast<cudaStream_t>(stream)});
}
