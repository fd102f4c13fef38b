// Online-softmax (flash) attention forward for Hopper: the port of the JAX
// package's kernels/flash_attention.py::flash_attention. The LM serving
// path's prefill attention runs on it (models/attention.py): q of a whole
// prompt against the keys and values it just wrote, an enc-dec decoder's q
// against the encoder memory (not causal), and MLA's q/k heads of 192
// against v heads of 128.
//
// What it computes, per (b, h) and query row qpos (GQA: kv head h / G):
//   s[kpos] = (q . k[kpos]) * scale                f32 dot of f32-widened rows
//   masked to -1e30 where causal and kpos > qpos, or where window > 0 and
//   qpos - kpos >= window (positions counted from 0 in q and in k: Sq != Skv
//   is aligned top-left, as in the TPU kernel's iota masks)
//   out = sum_k softmax(s)[kpos] v[kpos], in f32, cast to q's dtype.
// q and k are HD wide, v and out HDV: (HD, HD) for HD in 8 .. 128, and
// (192, 128), deepseek-v3's MLA heads.
// -1e30 is finite: a row masked everywhere (a window with Sq > Skv) comes
// out as the mean of v over the Skv keys, as in the TPU kernel and mha_ref.
//
// Bound on an H100: operations. Causal prefill at B = 4, H = 32, S = 2048,
// hd = 64 does 4 * B * H * S(S+1)/2 * hd = 6.9e10 flop on 168 MB of q, k,
// v and out: 1.03 ms at the 67 TFLOP/s f32 rate of the CUDA cores, 0.42 ms
// at a third of the 495 TFLOP/s TF32 tensor-core rate (below), 0.05 ms of
// memory.
//
// Design: the two products on the tensor cores in 3xTF32. TF32 keeps 10
// mantissa bits, too few for the f32 tolerance the JAX tests hold (rtol
// 2e-4), so each f32 operand x is split into hi = tf32(x), rounded as
// cvt.rna.tf32.f32 rounds (an integer add and mask), and lo = x - hi, which
// the tensor core truncates to TF32 as it reads it; a product takes three
// mma.sync.m16n8k8.tf32 with f32 accumulation: lo*hi' and hi*lo' first,
// then hi*hi'; the dropped lo*lo' and lo's truncation leave a relative
// error near 2^-21. bf16 inputs are widened to f32 at load, exactly TF32:
// their lo terms are 0 and their products are not issued (q k^T takes one
// pass, P v two). f32 fragments of q and k come from shared memory by
// ldmatrix (a 32-bit element is two b16 halves, and an 8 x 4 block of them
// lands in the TF32 fragment layout), four registers an instruction.
//
// Geometry, per (HD, HDV) instance (GeomOf below): a block of WARPS warps
// per (b, h, BQ = 16 * MT * WARPS query rows), each warp MT m-tiles of 16
// rows, and a loop over tiles of BK keys. Below an output width of 128:
// 4 warps of 2 m-tiles (128 rows), 64-key tiles, two blocks an SM: each k
// and v fragment split feeds two products. At an HDV of 128 that template
// held 64 rows a block in 169-218 KB of shared memory, one block (4 warps)
// an SM, and spilled (o 64 and s 32 floats a thread, past 255 registers).
// The wide instances keep 8 warps an SM with no spill
// (tools/flash_geometry.py timed the others on the card):
// - hd 128: 4 warps of 2 m-tiles (128 rows) over 16-key tiles, 101,376 B,
//   two blocks an SM; s is 16 floats a thread beside o's 128.
// - (192, 128): q alone is 100,352 B at 128 rows, so 8 warps of one m-tile
//   over 32-key tiles, 184,320 B, one block an SM.
// Each warp splits the q, k and v fragments it loads, q's once a key tile:
// both halves of 128 rows would take 200,704 B at 192 (past what the ring
// leaves), and held in registers they spilled; a split is 3 instructions,
// and splitting a tile once for the block (a pass into hi and lo buffers)
// took shared memory and saved no time. SEP: q k^T's lo terms go to
// accumulators of their own, added to the hi terms' after the tile's last
// k-step (two chains of products instead of one; what (192, 128) needs to
// schedule well).
//
// K and V tiles go through a ring in shared memory filled by 16-byte
// cp.async copies: tile t + 1 loads while tile t multiplies. Rows are
// padded by 16 bytes, so the fragment loads of a warp (8 rows x 4 columns
// of k; 4 row pairs x 8 columns of v) hit 32 distinct banks in f32. Keys
// past Skv are zero-filled by the copy. V's tiles have their own width and
// stride.
//
// S = Q K^T lands in the mma accumulator layout: lane (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8, key columns 2t and 2t + 1 of each
// 8-key group. The online softmax works there: a row's max and sum go
// across its 4 lanes by xor shuffles, exponentials are exp2f with log2(e)
// folded into the scale. P then feeds P V as the A operand with no
// shuffle: A's column t is taken to be key 2t and its column t + 4 key
// 2t + 1, and v's rows are read from shared memory in that same permuted
// order; a sum over keys does not depend on their order.
//
// Masks are applied only on tiles that straddle the causal diagonal, the
// window's edge or Skv: key positions >= Skv weigh exactly 0 (-inf, not
// -1e30), the others -1e30. Tiles every row of the block masks out entirely
// are skipped (causal: keys past the block's last row; window: keys before
// its first row's window), and under causal masks a warp skips a tile whose
// keys all lie past its own rows. That is exact: after a row has seen a
// valid key a masked key weighs exp(-1e30 - m) = 0. A block holding a row
// with no valid key at all visits every tile, so that row gets the mean of
// v. Query rows >= Sq are computed on zero-filled q and not stored. Under
// causal masks the heaviest query tiles (the last ones) are launched first.
//
// Strides are taken for q, k, v and out (the last dim contiguous; every
// pointer and row, head and batch stride 16-byte aligned, which the
// wrapper checks), so the caller passes (B, S, H, hd) buffers as
// (B, H, S, hd) views without a copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int W, int M, int K, int SE>
struct Geom {
  static constexpr int WARPS = W, MT = M, BK = K, SEP = SE;
  static constexpr int THREADS = 32 * W, BQ = 16 * M * W;
  static_assert(K % 16 == 0, "key tiles are pairs of 8-key groups");
};
// Geom<warps a block, 16-row m-tiles a warp, keys a tile, separate lo
// accumulators>. hd <= 64: the two-m-tile template; an HDV of 128: the
// wide geometry
template <int HD, int HDV>
struct GeomOf {
  using G = Geom<4, 2, 64, 0>;
};
template <>
struct GeomOf<128, 128> {
  using G = Geom<4, 2, 16, 1>;
};
template <>
struct GeomOf<192, 128> {
  using G = Geom<8, 1, 32, 1>;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// shared-memory row stride in elements: hd plus 16 bytes
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

// Q's rows and the ring's 2 stages of K tiles (stride of HD), then its 2
// stages of V tiles (stride of HDV)
template <typename T, int HD, int HDV>
__host__ __device__ constexpr size_t smem_bytes() {
  using G = typename GeomOf<HD, HDV>::G;
  return (static_cast<size_t>(G::BQ + 2 * G::BK) * row_stride<T, HD>() +
          static_cast<size_t>(2 * G::BK) * row_stride<T, HDV>()) *
         sizeof(T);
}

// TF32 bits of x rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero): half a TF32 step added to the magnitude, the low 13 bits
// cleared. The same bits as the cvt for every finite x, on the integer pipe.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi in TF32, lo = x - hi exactly (an f32 of at most 13
// significant bits), passed as it is: the tensor core reads a TF32
// operand's top 19 bits, so lo is truncated there instead of rounded
// here, at an error below 2^-21 of x, and a split is 3 instructions, not 5
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a * b: one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the lo terms first, then hi * hi; a lo that is 0
// (a bf16 operand) is not multiplied
template <bool LO_A, bool LO_B>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if (LO_B) mma(c, ah, bl0, bl1);
  if (LO_A) mma(c, al, bh0, bh1);
  mma(c, ah, bh0, bh1);
}

// four 8 x 4 blocks of 32-bit words from shared memory, one a register:
// lanes 8i .. 8i + 7 give block i's row addresses (16 bytes each), and lane
// (g, t) receives word t of row g of each block
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + ROWS - 1 of a (rows, hd) matrix into a padded shared
// tile; rows at or past n are zero-filled
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int r0, int n) {
  constexpr int RS = row_stride<T, HD>();
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int CH = HD / EPC;              // copies per row
#pragma unroll
  for (int it = 0; it < (ROWS * CH + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (ROWS * CH % THREADS == 0 || i < ROWS * CH) {
      const int r = i / CH, c = i % CH;
      const bool valid = r0 + r < n;
      cp16(dst + r * RS + c * EPC,
           src + (valid ? (r0 + r) * stride : 0) + c * EPC, valid);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int G, Sq, Skv, causal, window;
  float scale;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(GeomOf<HD, HDV>::G::THREADS)
    flash_fwd(const Args a) {
  using G = typename GeomOf<HD, HDV>::G;
  constexpr int BK = G::BK, NB = BK / 8, MT = G::MT, BQ = G::BQ;
  constexpr int THREADS = G::THREADS;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int RS = row_stride<T, HD>();
  constexpr int RSV = row_stride<T, HDV>();
  constexpr int KD = HD / 8;                 // 8-wide steps over q/k's dim
  constexpr int KDV = HDV / 8;               // and over v's
  constexpr bool SEP = G::SEP && F32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);        // (BQ, RS)
  T* ringK = sQ + BQ * RS;                   // [stage] (BK, RS)
  T* ringV = ringK + 2 * BK * RS;            // [stage] (BK, RSV)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.G;
  const T* Q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* K = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* V = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;

  // The keys this block visits. A row has no valid key only under a window,
  // when qpos - window + 1 > Skv - 1; rows grow down the block, so its last
  // row decides.
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  int k_lo = 0, k_hi = a.Skv - 1;
  if (!(a.window > 0 && q_last - a.window + 1 > a.Skv - 1)) {
    if (a.causal) k_hi = min(k_hi, q_last);
    if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  }
  const int ntiles = (k_hi - k_lo) / BK + 1;

  load_tile<T, HD, BQ, THREADS>(sQ, Q, a.qs, q0, a.Sq);
  cp_commit();
  load_tile<T, HD, BK, THREADS>(ringK, K, a.ks, k_lo, a.Skv);
  load_tile<T, HDV, BK, THREADS>(ringV, V, a.vs, k_lo, a.Skv);
  cp_commit();

  // this warp's MT m-tiles of 16 rows; in m-tile i this lane holds rows
  // w0 + 16 i + g (accumulator entries 0, 1) and + 8 (entries 2, 3)
  const int w0 = warp * 16 * MT;
  const int w_last = q0 + w0 + 16 * MT - 1;      // the warp's last row
  // ldmatrix: this lane's row and column within an (16 rows x 8 columns)
  // A block (blocks: rows 0-7 and 8-15 at columns 0-3, then at 4-7), and
  // within a (16 keys x 8 dims) pair of B blocks (keys 0-7 and 8-15, each
  // at dims 0-3 and 4-7)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 4 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 4 * ((lane >> 3) & 1);
  // q's A fragments of m-tile i: rows as above, columns 8kk + t4 (+ 4)
  auto q_frag = [&](int i, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    if constexpr (F32) {
      uint32_t r[4];
      ldsm4(r, sQ + (w0 + 16 * i + a_row) * RS + 8 * kk + a_col);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), hi[e], lo[e]);
    } else {
      const T* p = sQ + (w0 + 16 * i + g) * RS + 8 * kk + t4;
      hi[0] = __float_as_uint(to_f32(p[0]));
      hi[1] = __float_as_uint(to_f32(p[8 * RS]));
      hi[2] = __float_as_uint(to_f32(p[4]));
      hi[3] = __float_as_uint(to_f32(p[8 * RS + 4]));
      lo[0] = lo[1] = lo[2] = lo[3] = 0u;
    }
  };
  // k's B fragments of key groups j and j + 1 (key 8j + g, dims 8kk + t4
  // and + 4): hi[0..1], lo[0..1] for group j, hi[2..3], lo[2..3] for j + 1
  auto k_frag = [&](const T* sK, int j, int kk, uint32_t (&hi)[4],
                    uint32_t (&lo)[4]) {
    if constexpr (F32) {
      uint32_t r[4];
      ldsm4(r, sK + (8 * j + b_row) * RS + 8 * kk + b_col);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), hi[e], lo[e]);
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const T* p = sK + (8 * (j + u) + g) * RS + 8 * kk + t4;
        hi[2 * u] = __float_as_uint(to_f32(p[0]));
        hi[2 * u + 1] = __float_as_uint(to_f32(p[4]));
      }
      lo[0] = lo[1] = lo[2] = lo[3] = 0u;
    }
  };

  float o[MT][KDV][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < KDV; ++n)
      o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
    m[i][0] = m[i][1] = MASKED;
    l[i][0] = l[i][1] = 0.f;
  }
  const float sc = a.scale * LOG2E;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * BK;
    // tile t + 1's copies go into the other stage while tile t multiplies
    if (t + 1 < ntiles) {
      const int nxt = (t + 1) & 1, k1 = k0 + BK;
      load_tile<T, HD, BK, THREADS>(ringK + nxt * BK * RS, K, a.ks, k1,
                                    a.Skv);
      load_tile<T, HDV, BK, THREADS>(ringV + nxt * BK * RSV, V, a.vs, k1,
                                     a.Skv);
    }
    cp_commit();
    cp_wait<1>();               // tile t has landed
    __syncthreads();
    const T* sK = ringK + (t & 1) * BK * RS;
    const T* sV = ringV + (t & 1) * BK * RSV;

    // Under causal masks a tile whose keys all lie past the warp's rows
    // changes nothing for them (each has seen its valid keys, and masked
    // keys weigh 0 after those): the warp skips it.
    if (!(a.causal && k0 > w_last)) {
      // S = Q K^T: per m-tile 16 rows x BK keys, NB accumulators of 8 keys
      // (SEP: the lo terms in sl, added to the hi terms' s at the end, so
      // the three products of a k-step are two independent chains)
      float s[MT][NB][4], sl[SEP ? MT : 1][SEP ? NB : 1][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
      if constexpr (SEP) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j)
            sl[i][j][0] = sl[i][j][1] = sl[i][j][2] = sl[i][j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) q_frag(i, kk, ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t bh[4], bl[4];
          k_frag(sK, j, kk, bh, bl);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if constexpr (SEP) {
                mma(sl[i][j + u], ah[i], bl[2 * u], bl[2 * u + 1]);
                mma(sl[i][j + u], al[i], bh[2 * u], bh[2 * u + 1]);
                mma(s[i][j + u], ah[i], bh[2 * u], bh[2 * u + 1]);
              } else {
                mma3<F32, F32>(s[i][j + u], ah[i], al[i], bh[2 * u],
                               bh[2 * u + 1], bl[2 * u], bl[2 * u + 1]);
              }
            }
        }
      }
      if constexpr (SEP) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][j][e] += sl[i][j][e];
      }

      // scale (log2 domain), masks on edge tiles, online softmax
      const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > q0) ||
                        (a.window > 0 && q_last - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int qp0 = q0 + w0 + 16 * i + g, qp1 = qp0 + 8;
        float mx0 = m[i][0], mx1 = m[i][1];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[i][j][e] * sc;
            if (edge) {
              const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
              const int qp = e < 2 ? qp0 : qp1;
              if (kp >= a.Skv)
                x = __int_as_float(0xff800000);  // -inf: a ragged key
              else if ((a.causal && kp > qp) ||
                       (a.window > 0 && qp - kp >= a.window))
                x = MASKED;
            }
            s[i][j][e] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(s[i][j][0], s[i][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[i][j][2], s[i][j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float al0 = exp2f(m[i][0] - mx0), al1 = exp2f(m[i][1] - mx1);
        m[i][0] = mx0;
        m[i][1] = mx1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          s[i][j][0] = exp2f(s[i][j][0] - mx0);
          s[i][j][1] = exp2f(s[i][j][1] - mx0);
          s[i][j][2] = exp2f(s[i][j][2] - mx1);
          s[i][j][3] = exp2f(s[i][j][3] - mx1);
          ps0 += s[i][j][0] + s[i][j][1];
          ps1 += s[i][j][2] + s[i][j][3];
        }
        l[i][0] = l[i][0] * al0 + ps0;   // this lane's share; summed at the end
        l[i][1] = l[i][1] * al1 + ps1;
        // o is rescaled unless no row of the warp's m-tile moved its max
        // (a factor of exactly 1, the common case after the first tiles)
        if (!__all_sync(0xffffffffu, al0 == 1.f && al1 == 1.f)) {
#pragma unroll
          for (int n = 0; n < KDV; ++n) {
            o[i][n][0] *= al0;
            o[i][n][1] *= al0;
            o[i][n][2] *= al1;
            o[i][n][3] *= al1;
          }
        }
      }

      // O += P V. The k-step over keys 8j .. 8j + 7 takes P's accumulator
      // as its A fragment, column t4 being key 2 t4 and column t4 + 4 key
      // 2 t4 + 1; v's rows are read in that order.
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          split(s[i][j][0], ph[i][0], pl[i][0]);
          split(s[i][j][2], ph[i][1], pl[i][1]);
          split(s[i][j][1], ph[i][2], pl[i][2]);
          split(s[i][j][3], ph[i][3], pl[i][3]);
        }
        const int vo = (8 * j + 2 * t4) * RSV + g;
#pragma unroll
        for (int n = 0; n < KDV; ++n) {
          uint32_t bh0, bh1, bl0 = 0u, bl1 = 0u;
          if constexpr (F32) {
            split(to_f32(sV[vo + 8 * n]), bh0, bl0);
            split(to_f32(sV[vo + RSV + 8 * n]), bh1, bl1);
          } else {
            bh0 = __float_as_uint(to_f32(sV[vo + 8 * n]));
            bh1 = __float_as_uint(to_f32(sV[vo + RSV + 8 * n]));
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma3<true, F32>(o[i][n], ph[i], pl[i], bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();            // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float l0 = l[i][0], l1 = l[i][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int qp0 = q0 + w0 + 16 * i + g, qp1 = qp0 + 8;
    T* O = static_cast<T*>(a.o) + b * a.ob + h * a.oh + 2 * t4;
    if (qp0 < a.Sq) {
#pragma unroll
      for (int n = 0; n < KDV; ++n)
        store2<T>(O + qp0 * a.os + 8 * n, o[i][n][0] / d0, o[i][n][1] / d0);
    }
    if (qp1 < a.Sq) {
#pragma unroll
      for (int n = 0; n < KDV; ++n)
        store2<T>(O + qp1 * a.os + 8 * n, o[i][n][2] / d1, o[i][n][3] / d1);
    }
  }
}

template <typename T, int HD, int HDV>
cudaError_t prepare() {
  constexpr size_t smem = smem_bytes<T, HD, HDV>();
  static_assert(smem <= 232448, "past the shared memory a block may use");
  return cudaFuncSetAttribute(flash_fwd<T, HD, HDV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD, int HDV>
int launch(const Args& a, int B, int H, cudaStream_t st) {
  using G = typename GeomOf<HD, HDV>::G;
  const cudaError_t e = prepare<T, HD, HDV>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (a.Sq + G::BQ - 1) / G::BQ);
  flash_fwd<T, HD, HDV>
      <<<grid, G::THREADS, smem_bytes<T, HD, HDV>(), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[0..8): registers a thread, local (spill) bytes a thread, shared bytes
// a block, resident blocks an SM, warps a block, query rows a block, keys
// a tile, separate lo accumulators (f32)
template <typename T, int HD, int HDV>
int info(int* out) {
  using G = typename GeomOf<HD, HDV>::G;
  cudaError_t e = prepare<T, HD, HDV>();
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, flash_fwd<T, HD, HDV>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_fwd<T, HD, HDV>, G::THREADS,
        smem_bytes<T, HD, HDV>());
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem_bytes<T, HD, HDV>() + fa.sharedSizeBytes);
  out[3] = blocks;
  out[4] = G::WARPS;
  out[5] = G::BQ;
  out[6] = G::BK;
  out[7] = G::SEP && sizeof(T) == 4 ? 1 : 0;
  return 0;
}

struct Launch {
  const Args& a;
  int B, H;
  cudaStream_t st;
  template <typename T, int HD, int HDV>
  int operator()() const { return launch<T, HD, HDV>(a, B, H, st); }
};
struct Info {
  int* out;
  template <typename T, int HD, int HDV>
  int operator()() const { return info<T, HD, HDV>(out); }
};

// f.operator()<T, HD, HDV>() for the instance (hd, hdv), or an error code
template <typename T, typename F>
int dispatch(int hd, int hdv, const F& f) {
  if (hd == 192 && hdv == 128) return f.template operator()<T, 192, 128>();
  if (hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return f.template operator()<T, 8, 8>();
    case 16: return f.template operator()<T, 16, 16>();
    case 32: return f.template operator()<T, 32, 32>();
    case 64: return f.template operator()<T, 64, 64>();
    case 128: return f.template operator()<T, 128, 128>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int by_dtype(int dtype, int hd, int hdv, const F& f) {
  if (dtype == 0) return dispatch<float>(hd, hdv, f);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, hdv, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike). (hd, hdv) is (h, h)
// for h in {8, 16, 32, 64, 128}, or (192, 128). q (B, H, Sq, hd), k (B,
// Hkv, Skv, hd), v (B, Hkv, Skv, hdv), out (B, H, Sq, hdv), each given by
// its batch, head and row strides in elements (the last dim contiguous;
// pointers and strides 16-byte aligned).
extern "C" int flash_attention_fwd(
    int dtype, int hd, int hdv, const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int Sq, int Skv, int causal, int window,
    float scale, long long qb, long long qh, long long qs, long long kb,
    long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Skv <= 0 || window < 0 || B > 65535 ||
      Sq > 65535 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, H / Hkv, Sq, Skv, causal, window, scale,
               qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, hd, hdv, Launch{a, B, H, st});
}

// The compiled instance (dtype, hd, hdv) as the card runs it: out[0..8) as
// info() fills it (registers, local bytes, shared bytes, resident blocks an
// SM, warps, query rows, keys a tile, separate lo accumulators).
extern "C" int flash_attention_info(int dtype, int hd, int hdv, int* out) {
  return by_dtype(dtype, hd, hdv, Info{out});
}
