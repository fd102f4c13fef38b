// Online-softmax (flash) attention forward for Hopper: the port of the JAX
// package's kernels/flash_attention.py::flash_attention. The LM serving
// path's prefill attention (models/attention.py::attention_extend) runs on
// it: q of a whole prompt against the keys and values it just wrote.
//
// What it computes, per (b, h) and query row qpos (GQA: kv head h / G):
//   s[kpos] = (q . k[kpos]) * scale                f32 dot of f32-widened rows
//   masked to -1e30 where causal and kpos > qpos, or where window > 0 and
//   qpos - kpos >= window (positions counted from 0 in q and in k: Sq != Skv
//   is aligned top-left, as in the TPU kernel's iota masks)
//   out = sum_k softmax(s)[kpos] v[kpos], in f32, cast to q's dtype.
// -1e30 is finite: a row masked everywhere (a window with Sq > Skv) comes
// out as the mean of v over the Skv keys, as in the TPU kernel and mha_ref.
//
// Design: one block per (b, h, 64 query rows); a loop inside the block over
// tiles of 32 keys, each tile's k and v staged in shared memory transposed
// (dim-major, so a thread reads four keys of one dim in one 16-byte load).
// TPR = hd / 32 threads share a query row (1 below hd 64), each holding
// hd / TPR of its dims (dims t, t + TPR, ...: neighbouring threads read
// neighbouring smem rows, no bank conflict) of q and of the f32
// accumulator in registers; the partial dot products of a row are summed
// across its TPR lanes with xor shuffles, so every lane holds the same
// scores and keeps the same running max and denominator. Tiles every row
// of the block masks out entirely are skipped (causal: keys past the
// block's last row; window: keys before its first row's window), which is
// exact: after a row has seen a valid key a masked key weighs
// exp(-1e30 - m) = 0. A block holding a row with no valid key at all visits
// every tile, so that row gets the mean of v. Ragged edges are masked here:
// key positions >= Skv weigh exactly 0 (-inf, not -1e30), query rows >= Sq
// are computed and not stored. Strides are taken for q, k, v and out (the
// last dim contiguous), so the caller passes (B, S, H, hd) buffers as
// (B, H, S, hd) views without a copy.
//
// Bound on an H100: operations. Causal prefill at B = 4, H = 32, S = 2048,
// hd = 64 does 4 * B * H * S(S+1)/2 * hd = 6.9e10 flop on 168 MB of q, k,
// v and out: 1.03 ms at the 67 TFLOP/s f32 rate of the CUDA cores, 0.05 ms
// of memory. This kernel stays on the CUDA cores in f32, as the TPU kernel
// computes in f32; bf16 tensor cores (wgmma, 989 TFLOP/s) are a later
// design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per tile
constexpr int KPAD = BK + 4;     // smem row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int G, Sq, Skv, causal, window;
  float scale;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// threads sharing a query row: each holds at most 32 of its dims
#define FLASH_TPR(HD) ((HD) > 32 ? (HD) / 32 : 1)

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * FLASH_TPR(HD))
    flash_fwd(const Args a) {
  constexpr int TPR = FLASH_TPR(HD);
  constexpr int DPT = HD / TPR;  // dims per thread
  constexpr int NT = BQ * TPR;
  __shared__ __align__(16) float kT[HD][KPAD];
  __shared__ __align__(16) float vT[HD][KPAD];

  const int tid = threadIdx.x;
  const int row = tid / TPR, t = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const int qpos = q0 + row;
  const bool live = qpos < a.Sq;

  const T* Q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh +
               static_cast<long long>(live ? qpos : 0) * a.qs;
  const T* K = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* V = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;

  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = to_f32(Q[t + TPR * i]);
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // The keys this block visits. A row has no valid key only under a window,
  // when qpos - window + 1 > Skv - 1; rows grow down the block, so its last
  // row decides.
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  int k_lo = 0, k_hi = a.Skv - 1;
  if (!(a.window > 0 && q_last - a.window + 1 > a.Skv - 1)) {
    if (a.causal) k_hi = min(k_hi, q_last);
    if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  }

  for (int k0 = k_lo; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < a.Skv) {
        kv = to_f32(K[kp * a.ks + d]);
        vv = to_f32(V[kp * a.vs + d]);
      }
      kT[d][j] = kv;
      vT[d][j] = vv;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const float4* kr = reinterpret_cast<const float4*>(&kT[t + TPR * i][0]);
#pragma unroll
      for (int j4 = 0; j4 < BK / 4; ++j4) {
        const float4 k4 = kr[j4];
        s[4 * j4 + 0] = fmaf(q[i], k4.x, s[4 * j4 + 0]);
        s[4 * j4 + 1] = fmaf(q[i], k4.y, s[4 * j4 + 1]);
        s[4 * j4 + 2] = fmaf(q[i], k4.z, s[4 * j4 + 2]);
        s[4 * j4 + 3] = fmaf(q[i], k4.w, s[4 * j4 + 3]);
      }
    }
    // the row's partial dots, summed across its TPR neighbouring lanes
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) {
#pragma unroll
      for (int j = 0; j < BK; ++j)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    }

    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kp = k0 + j;
      float x;
      if (kp >= a.Skv) {
        x = __int_as_float(0xff800000);  // -inf: a ragged key weighs 0
      } else {
        x = s[j] * a.scale;
        if ((a.causal && kp > qpos) ||
            (a.window > 0 && qpos - kp >= a.window))
          x = NEG_INF;
      }
      s[j] = x;
      mt = fmaxf(mt, x);
    }
    const float alpha = expf(m - mt);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mt);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const float4* vr = reinterpret_cast<const float4*>(&vT[t + TPR * i][0]);
      float ai = acc[i] * alpha;
#pragma unroll
      for (int j4 = 0; j4 < BK / 4; ++j4) {
        const float4 v4 = vr[j4];
        ai = fmaf(s[4 * j4 + 0], v4.x, ai);
        ai = fmaf(s[4 * j4 + 1], v4.y, ai);
        ai = fmaf(s[4 * j4 + 2], v4.z, ai);
        ai = fmaf(s[4 * j4 + 3], v4.w, ai);
      }
      acc[i] = ai;
    }
    m = mt;
  }

  if (live) {
    T* O = static_cast<T*>(a.o) + b * a.ob + h * a.oh +
           static_cast<long long>(qpos) * a.os;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) O[t + TPR * i] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, int H, cudaStream_t st) {
  const dim3 grid((a.Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, BQ * FLASH_TPR(HD), 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const Args& a, int B, int H, cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(a, B, H, st);
    case 16: return launch<T, 16>(a, B, H, st);
    case 32: return launch<T, 32>(a, B, H, st);
    case 64: return launch<T, 64>(a, B, H, st);
    case 128: return launch<T, 128>(a, B, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike). hd in {8, 16, 32, 64,
// 128}. q (B, H, Sq, hd), k and v (B, Hkv, Skv, hd), out like q, each given
// by its batch, head and row strides in elements (the last dim contiguous).
extern "C" int flash_attention_fwd(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int Sq, int Skv, int causal, int window,
    float scale, long long qb, long long qh, long long qs, long long kb,
    long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Skv <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, H / Hkv, Sq, Skv, causal, window, scale,
               qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(hd, a, B, H, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, a, B, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
