// JAX's random streams on Hopper: threefry-2x32 (20 rounds), partitionable
// as in JAX 0.9 (jax_threefry_partitionable on), and the draws the port
// takes from it in bulk. It replaces no Pallas kernel: the JAX package draws
// these numbers with jax.random, which XLA lowers to its own threefry loop,
// at src/repro/core/hybrid.py:105 (the resident trainer's per-minibatch
// split and randint), src/repro/core/tiered.py:372, core/baseline_ps.py:96
// and models/common.py:32-41 (the LM initialisers). The plain versions are
// src/repro_torch/prng.py's, which the CPU tests hold against jax.random.
//
// negative_positions: a trainer's (T, S) pool positions. chain_kernel (one
// thread) walks key, kneg = split(key) T times, writing each kneg; then
// randint_kernel (a grid-stride loop, a thread a position) draws
// randint(kneg_t, (S,), 0, pool_n): split kneg into (k1, k2), the 32-bit
// random bits of k1 and k2 at counter s, each modulo the span, joined by
// the 2^32 mod span multiplier in uint32 arithmetic that wraps as JAX's
// does (past a span of 2^16 the multiplier is 0). The chain is serial:
// each link hashes the previous key. At the trainers' shapes (T a few
// hundred to a few thousand links) it is microseconds, and the trainers
// keep its output per episode shape, so it runs once per shape.
//
// fill_random: n draws of one kind at counters 0 .. n - 1 (the flat index
// as a 64-bit (hi, lo) counter; bits = b0 ^ b1), times a scale, in f32:
// bits (int32 words), uniform [0, 1), normal, truncated normal on (-2, 2)
// (the LM initialisers' dense_init and embed_init, before their cast).
// The float transforms follow XLA:CPU, whose jax.random numbers the port
// reproduces: every multiply feeding an add is one fused multiply-add
// (__fmaf_rn), every other operation rounds on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no contraction the plain
// version would not make), log and log1p are XLA:CPU's Cephes polynomials
// and erf_inv is chlo.erf_inv's f32 polynomial. Constants are written as
// double literals cast to float, as XLA and numpy round them.
//
// Bound on an H100: operations. A hash is about 80 32-bit integer
// operations (20 rounds of add, funnel-shift rotate and xor, five key
// injections); a draw of fill_random is one hash plus its transform, a
// position of negative_positions four hashes (the split of its link and
// the bits of k1 and k2). At 64 int32 lanes an SM that is far above the
// 4 (fill_random) or 8 (negative_positions) bytes each writes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;     // one wave of 8 blocks an SM

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ Words threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, ROT[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            unsigned long long i) {
  const Words w = threefry(k0, k1, static_cast<uint32_t>(i >> 32),
                           static_cast<uint32_t>(i));
  return w.a ^ w.b;
}

// ---------------------------------------------------------------- positions
__global__ void chain_kernel(uint32_t k0, uint32_t k1, long long T,
                             uint32_t* __restrict__ kneg) {
  for (long long t = 0; t < T; ++t) {
    const Words n = threefry(k0, k1, 0u, 1u);
    const Words k = threefry(k0, k1, 0u, 0u);
    kneg[2 * t] = n.a;
    kneg[2 * t + 1] = n.b;
    k0 = k.a;
    k1 = k.b;
  }
}

__global__ void __launch_bounds__(THREADS)
    randint_kernel(const uint32_t* __restrict__ kneg, long long T, int S,
                   uint32_t span, uint32_t mult, long long* __restrict__ out) {
  const long long n = T * S;
  for (long long idx = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * THREADS) {
    const long long t = idx / S;
    const uint32_t s = static_cast<uint32_t>(idx - t * S);
    const uint32_t a = __ldg(kneg + 2 * t), b = __ldg(kneg + 2 * t + 1);
    const Words k1 = threefry(a, b, 0u, 0u);
    const Words k2 = threefry(a, b, 0u, 1u);
    const uint32_t hi = bits_at(k1.a, k1.b, s);
    const uint32_t lo = bits_at(k2.a, k2.b, s);
    const uint32_t off = (hi % span) * mult + lo % span;   // wraps
    out[idx] = static_cast<long long>(off % span);
  }
}

// ------------------------------------------------------------------- floats
constexpr int BITS = 0, UNIFORM = 1, NORMAL = 2, TRUNCATED_NORMAL = 3;

__device__ __forceinline__ float f32(double c) {
  return static_cast<float>(c);
}

__device__ float log_xla(float v) {   // XLA:CPU's f32 log, v > 0 finite
  v = fmaxf(v, __int_as_float(0x00800000));            // FLT_MIN
  int ei;
  const float m = frexpf(v, &ei);
  const bool low = m < f32(0.707106781186547524);
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float e = __fsub_rn(static_cast<float>(ei), low ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(x, f32(7.0376836292E-2), f32(-1.1514610310E-1));
  float y1 = __fmaf_rn(x, f32(-1.2420140846E-1), f32(1.4249322787E-1));
  float y2 = __fmaf_rn(x, f32(2.0000714765E-1), f32(-2.4999993993E-1));
  y = __fmaf_rn(y, x, f32(1.1676998740E-1));
  y1 = __fmaf_rn(y1, x, f32(-1.6668057665E-1));
  y2 = __fmaf_rn(y2, x, f32(3.3333331174E-1));
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(f32(-2.12194440e-4), e));
  const float t = __fadd_rn(__fmaf_rn(-x2, 0.5f, x), y);
  return __fmaf_rn(f32(0.693359375), e, t);
}

__device__ float log1p_xla(float x) {  // XLA:CPU's f32 log1p, x > -1
  constexpr double NUM[7] = {
      4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
      6.5787325942061044846969E0,  2.9911919328553073277375E1,
      6.0949667980987787057556E1,  5.7112963590585538103336E1,
      2.0039553499201281259648E1};
  constexpr double DEN[7] = {
      1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
      2.2176239823732856465394E2, 3.0909872225312059774938E2,
      2.1642788614495947685003E2, 6.0118660497603843919306E1};
  if (fabsf(x) >= f32(0.41421356237309504880)) {
    return log_xla(__fadd_rn(x, 1.0f));
  }
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    num = __fmaf_rn(num, x, f32(NUM[i]));
    den = __fmaf_rn(den, x, f32(DEN[i]));
  }
  const float xs = __fmul_rn(x, x);
  const float small = __fmul_rn(__fmul_rn(x, xs), __fdiv_rn(num, den));
  return __fadd_rn(x, __fmaf_rn(-0.5f, xs, small));
}

__device__ float erf_inv_xla(float x) {   // chlo.erf_inv, f32
  constexpr double LT5[9] = {2.81022636e-08,  3.43273939e-07, -3.5233877e-06,
                             -4.39150654e-06, 0.00021858087,  -0.00125372503,
                             -0.00417768164,  0.246640727,    1.50140941};
  constexpr double GE5[9] = {-0.000200214257, 0.000100950558, 0.00134934322,
                             -0.00367342844,  0.00573950773,  -0.0076224613,
                             0.00943887047,   1.00167406,     2.83297682};
  float w = -log1p_xla(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? f32(LT5[0]) : f32(GE5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    p = __fmaf_rn(p, w, lt ? f32(LT5[i]) : f32(GE5[i]));
  }
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : __fmul_rn(p, x);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    fill_kernel(uint32_t k0, uint32_t k1, long long n, float scale,
                void* __restrict__ out) {
  const float sqrt2 = __int_as_float(0x3FB504F3);        // f32(sqrt(2))
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * THREADS) {
    const uint32_t bits = bits_at(k0, k1, static_cast<unsigned long long>(i));
    if (KIND == BITS) {
      static_cast<uint32_t*>(out)[i] = bits;
      continue;
    }
    // the mantissa bits under the exponent of 1.0, minus 1: [0, 1)
    const float f = __fsub_rn(__int_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    float x;
    if (KIND == UNIFORM) {
      x = fmaxf(0.0f, __fmaf_rn(f, 1.0f, 0.0f));
    } else if (KIND == NORMAL) {
      const float lo = __int_as_float(0xBF7FFFFF);      // nextafter(-1, 0)
      const float u = fmaxf(lo, __fmaf_rn(f, __fsub_rn(1.0f, lo), lo));
      x = __fmul_rn(sqrt2, erf_inv_xla(u));
    } else {
      // XLA's f32 erf(-+2 / sqrt(2)), and the open interval's ends
      const float a = __int_as_float(0xBF745A18), b = __int_as_float(0x3F745A18);
      const float u = fmaxf(a, __fmaf_rn(f, __fsub_rn(b, a), a));
      x = __fmul_rn(sqrt2, erf_inv_xla(u));
      x = fminf(fmaxf(x, __int_as_float(0xBFFFFFFF)),
                __int_as_float(0x3FFFFFFF));
    }
    static_cast<float*>(out)[i] = __fmul_rn(x, scale);
  }
}

int blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// (T, S) int64 positions of the chain from key (k0, k1), each in
// [0, span); kneg: a (T, 2) uint32 scratch. Two launches on one stream.
extern "C" int negative_positions(unsigned int k0, unsigned int k1,
                                  long long T, int S, unsigned int span,
                                  void* kneg, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  chain_kernel<<<1, 1, 0, st>>>(k0, k1, T, static_cast<uint32_t*>(kneg));
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const uint32_t m = 65536u % span;
  const uint32_t mult = (m * m) % span;               // uint32: wraps
  const long long n = T * S;
  if (n > 0) {
    randint_kernel<<<blocks_for(n), THREADS, 0, st>>>(
        static_cast<const uint32_t*>(kneg), T, S, span, mult,
        static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// n draws of kind (0 bits, 1 uniform, 2 normal, 3 truncated normal) times
// scale into out (int32 words for bits, else f32).
extern "C" int fill_random(unsigned int k0, unsigned int k1, long long n,
                           int kind, float scale, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  switch (kind) {
    case BITS:
      fill_kernel<BITS><<<blocks, THREADS, 0, st>>>(k0, k1, n, scale, out);
      break;
    case UNIFORM:
      fill_kernel<UNIFORM><<<blocks, THREADS, 0, st>>>(k0, k1, n, scale, out);
      break;
    case NORMAL:
      fill_kernel<NORMAL><<<blocks, THREADS, 0, st>>>(k0, k1, n, scale, out);
      break;
    case TRUNCATED_NORMAL:
      fill_kernel<TRUNCATED_NORMAL><<<blocks, THREADS, 0, st>>>(k0, k1, n,
                                                                scale, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
