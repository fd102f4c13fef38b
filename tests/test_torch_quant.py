"""The port's two-tier quantized scan against the JAX package: int8
quantization, the int8 first pass (Pallas kernel in interpret mode), the
row gather and the exact rescore. Integer data, so every comparison is
bitwise. The kernels are held against the plain versions on the card in
``test_torch_card.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embed_serve import quant as jqz
from repro.embed_serve import topk as jtk
from repro.kernels import sgns as jsgns
from repro_torch.embed_serve import quant as qz
from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sgns


def _int(n, d, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _pair(arr, bf16):
    j, t = jnp.asarray(arr), torch.from_numpy(arr)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def _assert_same(port, jax_out):
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(jax_out[1]))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(jax_out[0]))


@pytest.mark.parametrize("seed,mag,bf16", [
    (0, 1.0, False), (1, 1e-3, False), (2, 1e3, False), (3, 1.0, True),
])
def test_quantize_rows_bitwise(seed, mag, bf16):
    """Continuous rows at several magnitudes (and an all-zero row): the
    torch quantization equals the JAX package's numpy one bit for bit."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, mag, size=(64, 48))
         * rng.uniform(0.01, 1, size=(64, 1))).astype(np.float32)
    x[7] = 0.0
    jx, tx = _pair(x, bf16)
    jq, js = jqz.quantize_rows(jx)
    q, s = qz.quantize_rows(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert s[7] == 1.0 and (q[7] == 0).all()
    np.testing.assert_array_equal(qz.dequantize_rows(q, s),
                                  jqz.dequantize_rows(jq, js))


def test_quantize_rows_chunked(monkeypatch):
    x = torch.from_numpy(_int(50, 16, 4)) * 0.37
    whole = qz.quantize_rows(x)
    monkeypatch.setattr(qz, "_QUANT_CHUNK_ROWS", 7)
    parts = qz.quantize_rows(x)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])


def test_overfetch_m_matches_jax():
    for args in [(10, 4.0, 10_000), (10, 4.0, 25), (10, 1.0, 10_000),
                 (3, 2.5, 10_000), (10, 4.0, 4)]:
        assert qz.overfetch_m(*args) == jqz.overfetch_m(*args)


@pytest.mark.parametrize("bf16,N,Q,m", [
    (False, 230, 17, 25),
    (True, 230, 17, 25),
    (False, 130, 5, 40),
])
def test_quant_first_pass_matches_jax_kernel(bf16, N, Q, m):
    jt, _ = _pair(_int(N, 32, 1), bf16)
    j8, js = jqz.quantize_rows(jt)
    q = _int(Q, 32, 2)
    want = jtk.topk_mips_quant(jnp.asarray(j8), jnp.asarray(js),
                               jnp.asarray(q), m=m, valid=N - 3, block_q=8,
                               block_n=64, interpret=True)
    got = tk.topk_mips_quant(torch.from_numpy(j8), torch.from_numpy(js),
                             torch.from_numpy(q), m, N - 3)
    _assert_same(got, want)
    want = jtk.topk_mips_quant_xla(jnp.asarray(j8), jnp.asarray(js),
                                   jnp.asarray(q), m=m, valid=N - 3)
    _assert_same(got, want)


def test_quant_padded_rows_masked():
    tbl = np.full((64, 8), -2.0, np.float32)
    tbl[40:] = 0.0
    q8, sc = qz.quantize_rows(torch.from_numpy(tbl))
    _, i = tk.topk_mips_quant(q8, sc, torch.ones((3, 8)), 12, 40)
    assert int(i[i != tk.IDX_SENTINEL].max()) < 40


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gather_rows_matches_jax_kernel(bf16):
    jt, tt = _pair(_int(50, 24, 5), bf16)
    idx = np.random.default_rng(6).integers(0, 50, size=13).astype(np.int32)
    want = jsgns.gather_rows(jt, jnp.asarray(idx), interpret=True)
    got = sgns.gather_rows(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_rescore_handles_sentinels_and_reranks():
    """Tier two re-ranks candidates the int8 pass ordered wrongly and keeps
    sentinel slots losing, exactly as the JAX rescore does."""
    tbl = np.diag([1.0, 2.0, 3.0, 4.0]).astype(np.float32)
    q = np.ones((1, 4), np.float32)
    cand = np.array([[0, 2, 3, 1, tk.IDX_SENTINEL]], np.int32)
    want = jqz.rescore_exact(jnp.asarray(tbl), jnp.asarray(q),
                             jnp.asarray(cand), k=3, gather="pallas",
                             interpret=True)
    got = qz.rescore_exact(torch.from_numpy(tbl), torch.from_numpy(q),
                           torch.from_numpy(cand), 3)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1].numpy(), [[3, 2, 1]])
    # more slots than real candidates: the sentinel pair comes back
    got = qz.rescore_exact(torch.from_numpy(tbl), torch.from_numpy(q),
                           torch.from_numpy(cand), 5)
    assert got[1][0, 4] == tk.IDX_SENTINEL and torch.isneginf(got[0][0, 4])


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_two_tier_matches_oracle_and_jax(k, bf16):
    """int8 first pass + exact rescore equals topk_mips_ref exactly at the
    default overfetch, and equals the JAX two-tier scan."""
    N = 317
    jt, tt = _pair(_int(N, 32, 6), bf16)
    q = _int(9, 32, 7)
    j8, js = jqz.quantize_rows(jt)
    q8, sc = qz.quantize_rows(tt)
    got = qz.topk_mips_quant_rescored(tt, q8, sc, torch.from_numpy(q), k,
                                      valid=N)
    rv, ri = tref.topk_mips_ref(np.asarray(jt.astype(jnp.float32)), q, k)
    np.testing.assert_array_equal(got[1].numpy(), ri)
    np.testing.assert_array_equal(got[0].numpy(), rv)
    want = jqz.topk_mips_quant_rescored(jt, jnp.asarray(j8), jnp.asarray(js),
                                        jnp.asarray(q), k=k, valid=N,
                                        impl="xla")
    _assert_same(got, want)
