"""``repro_torch.prng`` against ``jax.random``: the partitionable
threefry-2x32 keys and bits bit for bit, the float draws within the ulps
stated, and the plain versions of the two kernels of
``kernels/csrc/threefry.cu`` against JAX's own chains.

JAX runs on its CPU backend here: its float draws are XLA:CPU's (fused
multiply-adds, its Cephes log and log1p, IEEE sqrt), which the port
reproduces operation by operation. ``normal`` and ``truncated_normal`` are
held to 2 ulp; the largest difference observed over these tests' draws
(a million of each included) is 0 ulp: bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch import prng

HYP = settings(max_examples=40, deadline=None,
               suppress_health_check=[HealthCheck.too_slow])
SEEDS = st.integers(0, 2**31 - 1)
SHAPES = st.one_of(st.just(()), st.just((0,)), st.just((1,)), st.just((3, 0)),
                   st.tuples(st.integers(1, 300)),
                   st.tuples(st.integers(1, 17), st.integers(1, 33)))


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in f32 steps between two arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if np.size(a) else 0


def test_reference_runs_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable, (
        "repro_torch.prng follows the partitionable threefry (JAX 0.9's "
        "default): split, fold_in and the bits' counters differ without it")


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, counter, want):
    """Random123's known answers for threefry-2x32 at 20 rounds, on Python
    ints, numpy uint64 and int64 tensors alike."""
    assert prng.threefry2x32(key, *counter) == want
    x = [np.array([c], np.uint64) for c in counter]
    assert [int(w[0]) for w in prng.threefry2x32(
        tuple(np.uint64(k) for k in key), *x)] == list(want)
    t = [torch.tensor([c], dtype=torch.int64) for c in counter]
    assert [int(w[0]) for w in prng.threefry2x32(key, *t)] == list(want)


def test_split_fold_in_randint_known_values():
    k = prng.key(0)
    ks = prng.split(k)
    np.testing.assert_array_equal(
        ks, [[1797259609, 2579123966], [928981903, 3453687069]])
    assert prng.randint(ks[1], (5,), 0, 1000).tolist() == [22, 22, 496, 135,
                                                           51]
    assert prng.fold_in(k, 3).tolist() == [2467461003, 3840466878]
    np.testing.assert_array_equal(ks, _kd(jax.random.split(
        jax.random.PRNGKey(0))))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**31, 2**32 + 5, -1])
def test_key_keeps_jax_32_bit_seed(seed):
    np.testing.assert_array_equal(prng.key(seed),
                                  _kd(jax.random.PRNGKey(seed)))


@HYP
@given(seed=SEEDS, n=st.integers(1, 40), data=st.integers(0, 2**32 - 1))
def test_split_and_fold_in_match_jax(seed, n, data):
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(prng.key(seed), n),
                                  _kd(jax.random.split(jk, n)))
    np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data),
                                  _kd(jax.random.fold_in(jk, data)))


@HYP
@given(seed=SEEDS, shape=SHAPES)
def test_random_bits_match_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32)).astype(np.int64)
    got = prng.random_bits(prng.key(seed), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@HYP
@given(seed=SEEDS, shape=SHAPES, span=st.integers(1, 2**31 - 1),
       low=st.integers(-2**20, 2**20))
def test_randint_matches_jax(seed, shape, span, low):
    """Spans past 2^16 included, where JAX's multiplier wraps to 0."""
    hi = min(low + span, 2**31 - 1)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         low, hi))
    got = prng.randint(prng.key(seed), shape, low, hi)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("low,high", [(5, 5), (9, 3), (-2**31, 2**31 - 1),
                                      (2**31 - 2, 2**31 - 1)])
def test_randint_edges_match_jax(low, high):
    """An empty range gives minval; the widest int32 span wraps nothing."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (64,), low,
                                         high))
    got = prng.randint(prng.key(4), (64,), low, high)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.key(4), (64,), 0, 2**31)


@HYP
@given(seed=SEEDS, shape=SHAPES,
       bounds=st.sampled_from([(0.0, 1.0), (-3.0, 5.0), (0.25, 0.5),
                               (-1e-3, 2e4)]))
def test_uniform_matches_jax_bitwise(seed, shape, bounds):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32, *bounds))
    got = prng.uniform(prng.key(seed), shape, *bounds).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@HYP
@given(seed=SEEDS, shape=SHAPES)
def test_normal_within_2_ulp_of_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert _ulps(prng.normal(prng.key(seed), shape).numpy(), want) <= 2


@HYP
@given(seed=SEEDS, shape=SHAPES)
def test_truncated_normal_within_2_ulp_of_jax(seed, shape):
    want = np.asarray(jax.random.truncated_normal(
        jax.random.PRNGKey(seed), -2.0, 2.0, shape))
    got = prng.truncated_normal(prng.key(seed), shape).numpy()
    assert _ulps(got, want) <= 2


@pytest.mark.parametrize("draw", ["normal", "truncated_normal"])
def test_largest_float_difference_on_a_million_draws(draw):
    """A million draws of each (keys 0 and 1) within 2 ulp of JAX's (the
    largest difference observed on this suite's machine is 0: bit for
    bit)."""
    worst = 0
    for seed in (0, 1):
        jk = jax.random.PRNGKey(seed)
        if draw == "normal":
            want = np.asarray(jax.random.normal(jk, (500_000,)))
        else:
            want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0,
                                                          (500_000,)))
        got = getattr(prng, draw)(prng.key(seed), (500_000,)).numpy()
        worst = max(worst, _ulps(got, want))
    assert worst <= 2


def test_truncated_normal_takes_only_the_initialisers_bounds():
    with pytest.raises(ValueError, match="bounds"):
        prng.truncated_normal(prng.key(0), (4,), -1.0, 1.0)


def test_xla_log_and_log1p_match_jax_bitwise():
    """XLA:CPU's f32 log and log1p (Cephes, with fused multiply-adds), which
    erf_inv and the Gumbel draw take."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.random(20_000) * 30 + 1e-6,
                        rng.random(20_000)]).astype(np.float32)
    x = (rng.random(40_000) * 1.95 - 0.95).astype(np.float32)
    np.testing.assert_array_equal(
        prng.log_f32(torch.from_numpy(v)).numpy(),
        np.asarray(jax.jit(jnp.log)(v)))
    np.testing.assert_array_equal(
        prng.log1p_f32(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jax.lax.log1p)(x)))


def test_fma_is_one_rounding():
    """fma_f32 against exact rational arithmetic on products that need the
    round-to-odd step (sums of large and tiny terms, ties)."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.integers(-2, 3, 2000)
                                          * 2.0**-24)).astype(np.float32)
    got = prng.fma_f32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        lo = np.float32(float(exact))
        # the nearest f32 to the exact value, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(f)) - exact) for f in cands]
        best = min(errs)
        near = [f for f, e in zip(cands, errs) if e == best]
        want = near[0] if len(near) == 1 else next(
            f for f in near if int(np.float32(f).view(np.int32)) % 2 == 0)
        assert got[i] == want, i


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 11, 12345])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_categorical_gives_jax_indices(seed, temperature):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((4, 1024)) * 3).astype(np.float32)
    lg = torch.from_numpy(logits) / torch.tensor(temperature)
    want = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(seed), jnp.asarray(lg.numpy()), -1))
    got = prng.categorical(prng.key(seed), lg)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="f32"):
        prng.categorical(prng.key(seed), lg.double())


def _jax_chain(key, T, S, pool_n):
    """The JAX trainers' chain: one split a link, randint of the other."""
    out = np.zeros((T, S), np.int64)
    for t in range(T):
        key, kneg = jax.random.split(key)
        out[t] = np.asarray(jax.random.randint(kneg, (S,), 0, pool_n))
    return out


@pytest.mark.parametrize("seed,fold,T,S,pool_n", [
    (0, 0, 12, 8, 2048), (3, 1, 7, 5, 65536), (11, 3, 5, 3, 100_003),
    (2**31 - 1, 0, 3, 1, 1), (5, 2, 0, 4, 10), (6, 0, 4, 0, 10)])
def test_negative_positions_plain_is_the_jax_chain(seed, fold, T, S, pool_n):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    got = prng.negative_positions(prng.fold_in(prng.key(seed), fold), T, S,
                                  pool_n)
    assert got.dtype == torch.int64 and tuple(got.shape) == (T, S)
    np.testing.assert_array_equal(got.numpy(), _jax_chain(jk, T, S, pool_n))


@pytest.mark.parametrize("kind", sorted(prng.KINDS))
@pytest.mark.parametrize("scale", [1.0, 0.02, 0.0625])
def test_fill_random_plain_is_jax_times_scale(kind, scale):
    n, k = 1001, prng.fold_in(prng.key(9), 2)
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 2)
    out = torch.full((n + 3,), -7, dtype=torch.int32 if kind == "bits"
                     else torch.float32)
    prng.fill_random(k, n, kind, scale, out)
    if kind == "bits":
        want = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).view(
            np.int32)
        np.testing.assert_array_equal(out[:n].numpy(), want)
    else:
        draw = {"uniform": lambda: jax.random.uniform(jk, (n,)),
                "normal": lambda: jax.random.normal(jk, (n,)),
                "truncated_normal": lambda: jax.random.truncated_normal(
                    jk, -2.0, 2.0, (n,))}[kind]()
        want = np.asarray(draw * scale)
        assert _ulps(out[:n].numpy(), want) <= 2
    assert (out[n:] == -7).all()


def test_fill_random_checks_its_output_and_draws_nothing_on_meta():
    with pytest.raises(ValueError, match="kind"):
        prng.fill_random(prng.key(0), 4, "gamma", 1.0, torch.empty(4))
    with pytest.raises(ValueError, match="int32"):
        prng.fill_random(prng.key(0), 4, "bits", 1.0, torch.empty(4))
    with pytest.raises(ValueError, match="at least 5"):
        prng.fill_random(prng.key(0), 5, "normal", 1.0, torch.empty(4))
    before = dict(prng.LAUNCHES)
    meta = torch.empty((3, 5), device="meta")
    assert prng.fill_random(prng.key(0), 15, "normal", 1.0, meta) is meta
    pos = prng.negative_positions(prng.key(0), 6, 4, 100, device="meta")
    assert pos.device.type == "meta" and tuple(pos.shape) == (6, 4)
    assert prng.LAUNCHES == before
