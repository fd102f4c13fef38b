"""JAX's random streams in the port: the partitionable threefry-2x32.

The JAX package draws every random number it uses from ``jax.random``:
the embedding trainers' negative positions, the LM initialisers and the
serving launcher's sampling. This module gives the same numbers for the
same key, so one seed gives both packages the same negatives, weights and
samples. It follows JAX 0.9's default generator, threefry-2x32 with
``jax_threefry_partitionable`` on (``jax/_src/prng.py``:
``threefry_2x32``, ``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_randint``, ``_uniform``, ``_normal_real``, ``_truncated_normal``,
``_gumbel``, ``categorical``); it has no other mode.

A key is two 32-bit words, a (2,) numpy uint32 array (an int64 tensor or
any pair of integers is taken too). The key functions (:func:`key`,
:func:`fold_in`, :func:`split`) run on the host in numpy. The bulk draws
(:func:`random_bits`, :func:`randint`, :func:`uniform`, :func:`normal`,
:func:`truncated_normal`, :func:`categorical`) are plain PyTorch on any
device: the bulk hashes run on int32 tensors whose adds and left shifts
wrap (right shifts masked to be logical), the few hashes of keys and
chains on Python ints masked to 32 bits; integer draws come back as int64
tensors.

The float draws follow what ``jax.random`` computes on its CPU backend,
the reference the tests hold the port to. XLA:CPU contracts every multiply
whose only use is an add into one fused multiply-add, and computes ``log``
and ``log1p`` with its own Cephes polynomials; ``erf_inv`` is
``chlo.erf_inv``'s f32 polynomial. The port runs the same operations in
the same order (:func:`erf_inv`, :func:`log_f32`, :func:`log1p_f32`), each
fused multiply-add exact (:func:`fma_f32`: the f64 sum rounded to odd,
then to f32) and every square root correctly rounded, as XLA's is (through
f64: PyTorch's vectorised f32 sqrt on the CPU can be an ulp off). So the
draws equal JAX's bit for bit on the tests' seeds; the tests hold
``normal`` and ``truncated_normal`` to 2 ulp, the tolerance the port
promises. A normal or truncated-normal draw depends on its uniform's 23
mantissa bits alone, so the plain versions keep each mantissa's value
once computed (a table of 2^23 a kind and device): a process computes at
most 2^23 of each, however many it draws.

Two CUDA kernels (``kernels/csrc/threefry.cu``) produce the streams the
port draws in bulk; each wrapper takes its plain version for a CPU
tensor, launches its kernel for a CUDA one, and on the ``meta`` device (the
dry-run's trace) draws nothing and makes its output:

* :func:`negative_positions`: a trainer's (T, S) pool positions, the chain
  ``key, kneg = split(key)`` walked T times, then ``randint(kneg, (S,), 0,
  pool_n)`` for each link (``core/hybrid.py``, ``tiered.py``,
  ``baseline_ps.py``);
* :func:`fill_random`: n draws of one kind (bits, uniform, normal or
  truncated normal on ±2) times a scale, in f32: ``models/common.py``'s
  ``dense_init`` and ``embed_init`` before their cast.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# launches of each CUDA kernel of this module (counted where it launches)
LAUNCHES = {"negative_positions": 0, "fill_random": 0}
# the kinds of fill_random, as csrc/threefry.cu numbers them
KINDS = {"bits": 0, "uniform": 1, "normal": 2, "truncated_normal": 3}

_F32 = np.float32
# XLA's f32 erf(±2 / sqrt(2)), the bounds of truncated_normal's uniform
# draw (jax.random.truncated_normal(key, -2.0, 2.0) computes them so)
_ERF_F32 = {2.0: np.uint32(0x3F745A18).view(_F32)}
_ERF_F32[-2.0] = -_ERF_F32[2.0]
_SQRT2 = _F32(np.sqrt(2))
_NORMAL_LO = np.nextafter(_F32(-1.0), _F32(0.0))
_TINY = np.finfo(_F32).tiny
# XLA's erf_inv(x) for f32: w = -log1p(-x * x), then a degree-8 polynomial
# in w - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5), times x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA:CPU's f32 log (Cephes): log(1 + x) on [sqrt(1/2) - 1, sqrt(2) - 1]
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375      # ln 2 = q2 + q1
_SQRTHF = 0.707106781186547524
# XLA:CPU's log1p below |x| < sqrt(2) - 1: x - x^2/2 + x^3 N(x) / D(x)
_LOG1P_N = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
            6.5787325942061044846969E0, 2.9911919328553073277375E1,
            6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_LOG1P_D = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880


# --------------------------------------------------------------------------
# the hash and the keys
# --------------------------------------------------------------------------
def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds, JAX's rotations and key schedule) of the
    counter words ``(x0, x1)`` under ``key``: Python ints, uint64 numpy
    arrays or int64 tensors holding 32-bit words (each key word may be an
    array too, broadcast against the counters). Returns the two words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def words(key) -> tuple[int, int]:
    """A key's two words as Python ints."""
    if torch.is_tensor(key):
        key = key.tolist()
    k0, k1 = (int(w) for w in np.asarray(key).reshape(2).tolist())
    return k0 & M32, k1 & M32


def _key_array(k0, k1) -> np.ndarray:
    return np.array([k0, k1], dtype=np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: JAX keeps a seed's low 32 bits (high
    word 0)."""
    return _key_array(0, int(seed) & M32)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the hash of the counter (0, data)."""
    return _key_array(*threefry2x32(words(k), 0, int(data) & M32))


def split(k, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``, fold-like: key i is the hash of the
    counter (hi(i), lo(i)). Returns (n, 2) uint32."""
    i = np.arange(n, dtype=np.uint64)
    k0, k1 = (np.uint64(w) for w in words(k))
    b0, b1 = threefry2x32((k0, k1), i >> np.uint64(32), i & np.uint64(M32))
    return np.stack([b0, b1], axis=-1).astype(np.uint32).reshape(n, 2)


def _chain(k, T: int) -> np.ndarray:
    """The (T, 2) keys ``kneg`` of T links of ``k, kneg = split(k)``."""
    k0, k1 = words(k)
    out = np.empty((T, 2), dtype=np.uint32)
    for t in range(T):
        out[t] = threefry2x32((k0, k1), 0, 1)
        k0, k1 = threefry2x32((k0, k1), 0, 0)
    return out


# --------------------------------------------------------------------------
# bulk draws: plain PyTorch on any device
# --------------------------------------------------------------------------
def _numel(shape) -> int:
    return math.prod(shape)


def _signed(w: int) -> int:
    """A 32-bit word as the int32 value with its bits."""
    return w - (1 << 32) if w >= 1 << 31 else w


def _threefry_i32(key, x0: torch.Tensor, x1: torch.Tensor):
    """:func:`threefry2x32` of int32 counter tensors under a key of two
    words: the same bits, in int32 arithmetic that wraps (adds and left
    shifts; right shifts masked to be logical), a quarter of the int64
    version's work."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + _signed(k0)
    x1 = x1 + _signed(k1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            high = x1 << r                     # in place from here on
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x1.bitwise_or_(high).bitwise_xor_(x0)
        x0 += _signed(ks[(i + 1) % 3])
        x1 += _signed((ks[(i + 2) % 3] + i + 1) & M32)
    return x0, x1


def _bits32(k, n: int, device) -> torch.Tensor:
    """The (n,) 32-bit random bits of ``k`` as int32 words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry_i32(words(k), (i >> 32).to(torch.int32),
                           (i & M32).to(torch.int32))
    return b0 ^ b1


def random_bits(k, shape, *, device="cpu") -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``b0 ^ b1`` of the hash of each element's
    flat index as a 64-bit (hi, lo) counter. An int64 tensor of uint32
    values."""
    return (_bits32(k, _numel(shape), device).long() & M32).reshape(shape)


def _bits_per_key(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(K, n) random bits of each of K keys (a (K, 2) int64 tensor) at
    counters 0 .. n - 1."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32((keys[:, :1], keys[:, 1:]), i >> 32, i & M32)
    return b0 ^ b1


def _randint_from_bits(higher, lower, span: int) -> torch.Tensor:
    """``_randint``'s offset: the 2^32 mod span multiplier, in uint32
    arithmetic (products and sums wrap, as JAX's do: past a span of 2^16
    the multiplier's square wraps to 0, and so does the multiplier)."""
    mult = (((65536 % span) * (65536 % span)) & M32) % span
    off = (((higher % span) * mult) & M32) + (lower % span)
    return (off & M32) % span


def randint(k, shape, minval: int, maxval: int, *,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` at int32 (JAX
    refuses bounds past int32): split into (k1, k2), higher bits from k1
    and lower from k2, each modulo the span, joined by the 2^32 mod span
    multiplier; an empty range gives minval. An int64 tensor."""
    minval, maxval = int(minval), int(maxval)
    if not -(1 << 31) <= min(minval, maxval) <= max(minval, maxval) < 1 << 31:
        raise ValueError(f"randint: bounds ({minval}, {maxval}) past int32")
    span = max(maxval - minval, 1)
    k1, k2 = split(k)
    off = _randint_from_bits(random_bits(k1, shape, device=device),
                             random_bits(k2, shape, device=device), span)
    return minval + off


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(_F32(x), dtype=torch.float32, device=device)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding (the fused multiply-add XLA
    contracts to, CUDA's ``__fmaf_rn``). The product is exact in f64 and
    the f64 sum s rounds to f32 correctly unless s sits exactly on a
    midpoint between two f32 values (or below f32's normal range) having
    been rounded there: those few sums step one f64 ulp toward their
    error (TwoSum), i.e. round to odd, before the rounding to f32."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    si = s.view(torch.int64)
    risky = ((si & 0x1FFFFFFF) == 0x10000000) | (s.abs() < 2.0 ** -125)
    if bool(risky.any()):
        bb = s - p
        err = (p - (s - bb)) + (cd - bb)
        step = torch.where((err > 0) == (s > 0), 1, -1)
        si = torch.where(risky & (err != 0) & ((si & 1) == 0), si + step, si)
        s = si.view(torch.float64)
    return s.float()


def _poly(x, coeffs) -> torch.Tensor:
    """Horner from the highest coefficient, one fused multiply-add a step
    (XLA's ``EvaluatePolynomial`` starts from 0, whose first step gives
    the first coefficient exactly)."""
    p = _f32(coeffs[0], x.device).expand_as(x)
    for c in coeffs[1:]:
        p = fma_f32(p, x, _f32(c, x.device))
    return p


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` of positive finite values: the mantissa m in
    [sqrt(1/2), sqrt(2)), log(m) by Cephes' polynomial, plus e ln 2 in two
    parts, with XLA's fused multiply-adds."""
    dev = v.device
    m, e = torch.frexp(torch.clamp_min(v, _f32(_TINY, dev)))
    e = e.float()
    low = m < _f32(_SQRTHF, dev)
    x = (m - 1.0) + torch.where(low, m, _f32(0.0, dev))
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    P = [_f32(c, dev) for c in _LOG_P]
    y = fma_f32(x, P[0], P[1])
    y1 = fma_f32(x, P[3], P[4])
    y2 = fma_f32(x, P[6], P[7])
    y = fma_f32(y, x, P[2])
    y1 = fma_f32(y1, x, P[5])
    y2 = fma_f32(y2, x, P[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, _f32(_LOG_Q1, dev) * e)
    t = fma_f32(-x2, _f32(0.5, dev), x) + y
    return fma_f32(_f32(_LOG_Q2, dev), e, t)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p`` on (-1, inf): Cephes' rational form below
    |x| < sqrt(2) - 1, :func:`log_f32` of 1 + x above."""
    dev = x.device
    is_small = x.abs() < _f32(_LOG1P_SMALL, dev)
    out = torch.empty_like(x)
    xv = x[is_small]                  # each element takes its one branch
    xs = xv * xv
    small = (xv * xs) * (_poly(xv, _LOG1P_N) / _poly(xv, _LOG1P_D))
    out[is_small] = xv + fma_f32(_f32(-0.5, dev), xs, small)
    out[~is_small] = log_f32(x[~is_small] + 1.0)
    return out


def _floats01(bits: torch.Tensor) -> torch.Tensor:
    """The 23 high bits of 32-bit words (int32 or int64) as the mantissa of
    a float in [1, 2), minus 1."""
    fb = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _uniform_from_bits(bits, minval, maxval, device) -> torch.Tensor:
    lo, hi = _f32(minval, device), _f32(maxval, device)
    return torch.maximum(lo, fma_f32(_floats01(bits), hi - lo, lo))


def uniform(k, shape, minval=0.0, maxval=1.0, *,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` at f32: ``max(minval, u * (maxval - minval) +
    minval)`` (one fused multiply-add), u in [0, 1) from the mantissa
    bits."""
    return _uniform_from_bits(_bits32(k, _numel(shape), device), minval,
                              maxval, device).reshape(shape)


def _sqrt_f32(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's and CUDA's), through
    f64: PyTorch's vectorised f32 sqrt on the CPU can be an ulp off."""
    return torch.sqrt(w.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (``chlo.erf_inv``), operation by operation."""
    w = -log1p_f32(x * -x)
    lt = w < 5.0
    p = torch.empty_like(x)
    for mask, shift, coeffs in ((lt, None, _ERFINV_LT5),
                                (~lt, 3.0, _ERFINV_GE5)):
        wv = w[mask]                  # each element takes its one branch
        wv = wv - 2.5 if shift is None else _sqrt_f32(wv) - shift
        p[mask] = _poly(wv, coeffs)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# a draw of normal or truncated_normal is a function of the 23 mantissa
# bits of its uniform alone: per kind and device, the values of the
# mantissas met so far (a process computes each at most once)
_BY_MANTISSA: dict = {}


def _by_mantissa(bits, kind: str, direct, device) -> torch.Tensor:
    """``direct(bits)`` of 32-bit words through the table of ``kind`` on
    ``device``: only mantissas not met before are computed."""
    m = ((bits >> 9) & 0x7FFFFF).long()
    key = (kind, str(torch.device(device)))
    if key not in _BY_MANTISSA:
        _BY_MANTISSA[key] = (
            torch.empty(1 << 23, dtype=torch.float32, device=device),
            torch.zeros(1 << 23, dtype=torch.bool, device=device))
    values, known = _BY_MANTISSA[key]
    new = m[~known[m]]
    if new.numel():
        new = torch.unique(new)
        values[new] = direct(new << 9, device)
        known[new] = True
    return values[m]


def _normal_direct(bits, device) -> torch.Tensor:
    u = _uniform_from_bits(bits, _NORMAL_LO, 1.0, device)
    return _f32(_SQRT2, device) * erf_inv(u)


def _normal_from_bits(bits, device) -> torch.Tensor:
    return _by_mantissa(bits, "normal", _normal_direct, device)


def normal(k, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.normal`` at f32: sqrt(2) erf_inv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    return _normal_from_bits(_bits32(k, _numel(shape), device),
                             device).reshape(shape)


def _check_bounds(lower, upper):
    if (lower, upper) != (-2.0, 2.0):
        raise ValueError(f"truncated_normal: bounds ({lower}, {upper}); the "
                         f"port carries JAX's f32 erf only for (-2, 2)")


def _truncated_normal_direct(bits, device) -> torch.Tensor:
    u = _uniform_from_bits(bits, _ERF_F32[-2.0], _ERF_F32[2.0], device)
    out = _f32(_SQRT2, device) * erf_inv(u)
    lo = np.nextafter(_F32(-2.0), _F32(np.inf))
    hi = np.nextafter(_F32(2.0), _F32(-np.inf))
    return torch.clamp(out, _f32(lo, device), _f32(hi, device))


def _truncated_normal_from_bits(bits, device, lower=-2.0, upper=2.0):
    _check_bounds(lower, upper)
    return _by_mantissa(bits, "truncated_normal", _truncated_normal_direct,
                        device)


def truncated_normal(k, shape, lower=-2.0, upper=2.0, *,
                     device="cpu") -> torch.Tensor:
    """``jax.random.truncated_normal`` at f32 on (lower, upper) = (-2, 2),
    the initialisers' bounds: sqrt(2) erf_inv(u), u uniform between JAX's
    f32 erf of the bounds over sqrt(2), clipped inside the bounds."""
    return _truncated_normal_from_bits(_bits32(k, _numel(shape), device),
                                       device, lower, upper).reshape(shape)


def categorical(k, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` (with replacement, the "low" Gumbel
    mode): the argmax of ``logits`` plus ``-log(-log(u))``, u uniform on
    [tiny, 1) of the logits' shape, in f32 (XLA:CPU's log). An int64
    tensor."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical: f32 logits (both LM packages' "
                         f"heads), got {logits.dtype}")
    u = uniform(k, tuple(logits.shape), _TINY, 1.0, device=logits.device)
    gumbel = -log_f32(-log_f32(u))
    return torch.argmax(gumbel + logits, dim=axis)


# --------------------------------------------------------------------------
# the kernels' plain versions and wrappers
# --------------------------------------------------------------------------
def negative_positions_plain(k, T: int, S: int, pool_n: int, *,
                             device="cpu") -> torch.Tensor:
    """(T, S) int64: row t is ``randint(kneg_t, (S,), 0, pool_n)`` for the
    t-th ``kneg`` of the chain ``k, kneg = split(k)`` (the chain walked on
    the host, the draws on ``device``)."""
    if pool_n < 1:
        raise ValueError(f"negative_positions: pool_n {pool_n} < 1")
    kneg = torch.from_numpy(_chain(k, T).astype(np.int64)).to(device)
    if T == 0 or S == 0:
        return torch.zeros((T, S), dtype=torch.int64, device=device)
    # split(kneg) per link: k1 at counter (0, 0), k2 at (0, 1)
    pair = []
    for c in (0, 1):
        b0, b1 = threefry2x32((kneg[:, 0], kneg[:, 1]), 0, c)
        pair.append(torch.stack([b0, b1], dim=1))
    higher = _bits_per_key(pair[0], S)
    lower = _bits_per_key(pair[1], S)
    return _randint_from_bits(higher, lower, pool_n)


def _fill_plain(k, n: int, kind: str, scale: float, device) -> torch.Tensor:
    bits = _bits32(k, n, device)
    if kind == "bits":
        return bits
    if kind == "uniform":
        x = _uniform_from_bits(bits, 0.0, 1.0, device)
    elif kind == "normal":
        x = _normal_from_bits(bits, device)
    else:
        x = _truncated_normal_from_bits(bits, device)
    return x * _f32(scale, device)


def fill_random_plain(k, n: int, kind: str, scale: float,
                      out: torch.Tensor) -> torch.Tensor:
    """:func:`fill_random`'s function in plain PyTorch: ``out``'s first n
    elements (flat) are draws 0 .. n - 1 of ``kind`` under ``k``, times
    ``scale`` in f32 (bits as int32 words, the scale not applied)."""
    _check_fill(n, kind, out)
    out.view(-1)[:n] = _fill_plain(k, n, kind, scale, out.device).to(
        out.dtype)
    return out


def _check_fill(n, kind, out):
    if kind not in KINDS:
        raise ValueError(f"fill_random: unknown kind {kind!r}; expected one "
                         f"of {sorted(KINDS)}")
    want = torch.int32 if kind == "bits" else torch.float32
    if out.dtype != want or not out.is_contiguous() or out.numel() < n:
        raise ValueError(f"fill_random: {kind} fills a contiguous {want} "
                         f"tensor of at least {n} elements, got {out.dtype} "
                         f"{tuple(out.shape)}")


def _launch(dev, fn, *args) -> int:
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def negative_positions(k, T: int, S: int, pool_n: int, *,
                       device="cpu") -> torch.Tensor:
    """(T, S) int64 pool positions of the chain ``k, kneg = split(k)`` walked
    T times, row t ``randint(kneg_t, (S,), 0, pool_n)``, on ``device``: the
    CUDA kernel on a card, the plain version on the CPU, nothing drawn on
    ``meta``."""
    device = torch.device(device)
    if device.type == "cpu":
        return negative_positions_plain(k, T, S, pool_n, device=device)
    out = torch.empty((T, S), dtype=torch.int64, device=device)
    if device.type == "meta":
        return out
    if device.type != "cuda":
        raise ValueError(f"negative_positions: unsupported device {device}")
    if pool_n < 1:
        raise ValueError(f"negative_positions: pool_n {pool_n} < 1")
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build

    scratch = torch.empty((T, 2), dtype=torch.int32, device=device)
    k0, k1 = words(k)
    rc = _launch(device, build.library("threefry").negative_positions,
                 k0, k1, T, S, pool_n, scratch.data_ptr(), out.data_ptr())
    build.check(rc, "negative_positions")
    LAUNCHES["negative_positions"] += 1
    return out


def fill_random(k, n: int, kind: str, scale: float,
                out: torch.Tensor) -> torch.Tensor:
    """Fill ``out``'s first n elements with draws 0 .. n - 1 of ``kind``
    under ``k`` (bits: int32 words; uniform on [0, 1), normal, truncated
    normal on (-2, 2): f32 times ``scale``), as the JAX initialisers draw
    before their cast. The CUDA kernel for a CUDA ``out``, the plain
    version for a CPU one, nothing on ``meta``. Returns ``out``."""
    if out.device.type == "cpu":
        return fill_random_plain(k, n, kind, scale, out)
    if out.device.type == "meta":
        _check_fill(n, kind, out)
        return out
    if out.device.type != "cuda":
        raise ValueError(f"fill_random: unsupported device {out.device}")
    _check_fill(n, kind, out)
    if n == 0:
        return out
    from repro_torch.kernels import build

    k0, k1 = words(k)
    rc = _launch(out.device, build.library("threefry").fill_random,
                 k0, k1, n, KINDS[kind], float(_F32(scale)), out.data_ptr())
    build.check(rc, "fill_random")
    LAUNCHES["fill_random"] += 1
    return out
