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
// memory. At hd 128 in f32 ptxas spills 32 bytes a thread (255 registers).
//
// Design: the two products on the tensor cores in 3xTF32. TF32 keeps 10
// mantissa bits, too few for the f32 tolerance the JAX tests hold (rtol
// 2e-4), so each f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), both rounded as cvt.rna.tf32.f32 rounds, and a product
// takes three mma.sync.m16n8k8.tf32 with f32 accumulation: lo*hi' and
// hi*lo' first, then hi*hi'; the dropped lo*lo' leaves a relative error
// near 2^-21. bf16 inputs are widened to f32 at load and take the same
// path (their lo terms are 0). The splits weigh about as much as the
// products, so they are made cheap: the rounding is an integer add and
// mask (the bits of cvt.rna), and each warp holds two 16-row m-tiles, so
// each k and v fragment split feeds two products.
//
// One block of 4 warps per (b, h, 128 query rows; 64 at an HDV of 128,
// whose accumulators leave no room for a second m-tile); a loop over tiles
// of 64 keys. q's rows are copied to shared memory once and their hi/lo
// fragments split from there on each tile. K and V tiles go through a
// double-buffered ring in shared memory filled by 16-byte cp.async copies:
// tile t + 1 loads while tile t multiplies. Rows are padded by 16 bytes, so
// the fragment loads of a warp (8 rows x 4 columns of k; 4 row pairs x 8
// columns of v) hit 32 distinct banks in f32. Keys past Skv are zero-filled
// by the copy. V's tiles have their own width and stride: at (192, 128) in
// f32 one stride of 196 floats for Q and the whole ring would take
// (64 + 4 * 64) * 196 * 4 = 250,880 bytes, past the 232,448 a block may
// opt into; with V's 132 it is (64 + 2 * 64) * 196 * 4 + 2 * 64 * 132 * 4 =
// 218,112.
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

constexpr int BK = 64;           // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 16-row m-tiles per warp: two below an output width (HDV) of 128, so each
// k and v fragment split feeds twice the products (at 128 the accumulators
// would not fit)
__host__ __device__ constexpr int m_tiles(int hdv) {
  return hdv <= 64 ? 2 : 1;
}
// query rows per block
__host__ __device__ constexpr int block_rows(int hdv) {
  return WARPS * 16 * m_tiles(hdv);
}

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
  return (static_cast<size_t>(block_rows(HDV) + 2 * BK) * row_stride<T, HD>() +
          static_cast<size_t>(2 * BK) * row_stride<T, HDV>()) *
         sizeof(T);
}

// TF32 bits of x rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero): half a TF32 step added to the magnitude, the low 13 bits
// cleared. The same bits as the cvt for every finite x, on the integer pipe.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a * b: one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the lo terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, ah, bl0, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bh0, bh1);
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
template <typename T, int HD, int ROWS>
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
__global__ void __launch_bounds__(THREADS) flash_fwd(const Args a) {
  constexpr int RS = row_stride<T, HD>();
  constexpr int RSV = row_stride<T, HDV>();
  constexpr int KD = HD / 8;                 // 8-wide steps over q/k's dim
  constexpr int KDV = HDV / 8;               // and over v's
  constexpr int MT = m_tiles(HDV);
  constexpr int BQ = block_rows(HDV);
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

  load_tile<T, HD, BQ>(sQ, Q, a.qs, q0, a.Sq);
  cp_commit();
  load_tile<T, HD, BK>(ringK, K, a.ks, k_lo, a.Skv);
  load_tile<T, HDV, BK>(ringV, V, a.vs, k_lo, a.Skv);
  cp_commit();

  // this warp's MT m-tiles of 16 rows; in m-tile i this lane holds rows
  // w0 + 16 i + g (accumulator entries 0, 1) and + 8 (entries 2, 3)
  const int w0 = warp * 16 * MT;
  const int w_last = q0 + w0 + 16 * MT - 1;      // the warp's last row
  // q's A fragments of m-tile i: rows as above, columns 8kk + t4 (+ 4)
  auto q_frag = [&](int i, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const T* p = sQ + (w0 + 16 * i + g) * RS + 8 * kk + t4;
    split(to_f32(p[0]), hi[0], lo[0]);
    split(to_f32(p[8 * RS]), hi[1], lo[1]);
    split(to_f32(p[4]), hi[2], lo[2]);
    split(to_f32(p[8 * RS + 4]), hi[3], lo[3]);
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
    if (t + 1 < ntiles) {
      const int nxt = (t + 1) & 1;
      load_tile<T, HD, BK>(ringK + nxt * BK * RS, K, a.ks, k0 + BK, a.Skv);
      load_tile<T, HDV, BK>(ringV + nxt * BK * RSV, V, a.vs, k0 + BK, a.Skv);
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
      // S = Q K^T: per m-tile 16 rows x 64 keys, 8 accumulators of 8 keys
      float s[MT][8][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) q_frag(i, kk, ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // B fragment (k x n = dim x key): key 8j + g, dims 8kk + t4 (+ 4)
          const T* p = sK + (8 * j + g) * RS + 8 * kk + t4;
          uint32_t bh0, bh1, bl0, bl1;
          split(to_f32(p[0]), bh0, bl0);
          split(to_f32(p[4]), bh1, bl1);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma3(s[i][j], ah[i], al[i], bh0, bh1, bl0, bl1);
        }
      }

      // scale (log2 domain), masks on edge tiles, online softmax
      const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > q0) ||
                        (a.window > 0 && q_last - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int qp0 = q0 + w0 + 16 * i + g, qp1 = qp0 + 8;
        float mx0 = m[i][0], mx1 = m[i][1];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
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
        for (int j = 0; j < 8; ++j) {
          s[i][j][0] = exp2f(s[i][j][0] - mx0);
          s[i][j][1] = exp2f(s[i][j][1] - mx0);
          s[i][j][2] = exp2f(s[i][j][2] - mx1);
          s[i][j][3] = exp2f(s[i][j][3] - mx1);
          ps0 += s[i][j][0] + s[i][j][1];
          ps1 += s[i][j][2] + s[i][j][3];
        }
        l[i][0] = l[i][0] * al0 + ps0;   // this lane's share; summed at the end
        l[i][1] = l[i][1] * al1 + ps1;
#pragma unroll
        for (int n = 0; n < KDV; ++n) {
          o[i][n][0] *= al0;
          o[i][n][1] *= al0;
          o[i][n][2] *= al1;
          o[i][n][3] *= al1;
        }
      }

      // O += P V. The k-step over keys 8j .. 8j + 7 takes P's accumulator
      // as its A fragment, column t4 being key 2 t4 and column t4 + 4 key
      // 2 t4 + 1; v's rows are read in that order.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          split(s[i][j][0], ph[i][0], pl[i][0]);
          split(s[i][j][2], ph[i][1], pl[i][1]);
          split(s[i][j][1], ph[i][2], pl[i][2]);
          split(s[i][j][3], ph[i][3], pl[i][3]);
        }
        const T* p = sV + (8 * j + 2 * t4) * RSV + g;
#pragma unroll
        for (int n = 0; n < KDV; ++n) {
          uint32_t bh0, bh1, bl0, bl1;
          split(to_f32(p[8 * n]), bh0, bl0);
          split(to_f32(p[RSV + 8 * n]), bh1, bl1);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma3(o[i][n], ph[i], pl[i], bh0, bh1, bl0, bl1);
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
int launch(const Args& a, int B, int H, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, HD, HDV>();
  static_assert(smem <= 232448, "past the shared memory a block may use");
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (a.Sq + block_rows(HDV) - 1) / block_rows(HDV));
  flash_fwd<T, HD, HDV><<<grid, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, int hdv, const Args& a, int B, int H, cudaStream_t st) {
  if (hd == 192 && hdv == 128) return launch<T, 192, 128>(a, B, H, st);
  if (hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return launch<T, 8, 8>(a, B, H, st);
    case 16: return launch<T, 16, 16>(a, B, H, st);
    case 32: return launch<T, 32, 32>(a, B, H, st);
    case 64: return launch<T, 64, 64>(a, B, H, st);
    case 128: return launch<T, 128, 128>(a, B, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == 0) return dispatch<float>(hd, hdv, a, B, H, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, hdv, a, B, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
