"""The port's flash attention (its plain version on the CPU) and
``mha_plain`` against the JAX package's ``flash_attention`` (Pallas,
interpret mode) and ``mha_ref``, on the same numpy-seeded inputs.

Tolerances are those of ``tests/test_flash_attention.py``: rtol 2e-4,
atol 2e-5 in f32 (two softmax-attention evaluations in f32 that sum in
other orders) and 2e-2 in bf16 (the output rounds to bf16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import mha_ref
from repro_torch.kernels import flash_attention as fa

F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(B, H, Hkv, Sq, Skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(0, 1, shape) * 0.5).astype(np.float32)
                 for shape in ((B, H, Sq, hd), (B, Hkv, Skv, hd),
                               (B, Hkv, Skv, hd)))


def _both(q, k, v, causal, window, tq, tk, dtype=np.float32):
    """(JAX kernel, JAX mha_ref, port flash_attention, port mha_plain), all
    as f32 numpy, on the same inputs cast to ``dtype``."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == np.float32
                else (jnp.bfloat16, torch.bfloat16))
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    outs = (jax_flash(jq, jk, jv, causal=causal, window=window, tile_q=tq,
                      tile_k=tk, interpret=True),
            mha_ref(jq, jk, jv, causal=causal, window=window),
            fa.flash_attention(tq_, tk_, tv_, causal=causal, window=window),
            fa.mha_plain(tq_, tk_, tv_, causal=causal, window=window))
    return [np.asarray(o.float() if isinstance(o, torch.Tensor)
                       else o.astype(jnp.float32)) for o in outs]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,causal,window,tq,tk", [
    (2, 4, 4, 64, 64, 32, True, 0, 32, 32),
    (1, 4, 2, 64, 128, 32, True, 0, 32, 64),      # GQA, Sq < Skv (top-left)
    (2, 2, 2, 96, 96, 16, True, 24, 32, 32),      # sliding window
    (1, 2, 1, 64, 64, 64, False, 0, 64, 32),      # cross-attn style
    (1, 8, 8, 128, 128, 8, True, 0, 128, 32),
    (1, 4, 2, 32, 96, 16, True, 0, 32, 32),       # GQA, Sq < Skv, ragged tiles
])
def test_flash_matches_jax(B, H, Hkv, Sq, Skv, hd, causal, window, tq, tk):
    jk, jr, tk_out, tp = _both(*_qkv(B, H, Hkv, Sq, Skv, hd), causal, window,
                               tq, tk)
    for want in (jk, jr):
        np.testing.assert_allclose(tk_out, want, **F32_TOL)
        np.testing.assert_allclose(tp, want, **F32_TOL)


def test_flash_bf16_matches_jax():
    jk, jr, tk_out, tp = _both(*_qkv(1, 2, 2, 64, 64, 32), True, 0, 32, 32,
                               dtype="bf16")
    for want in (jk, jr):
        np.testing.assert_allclose(tk_out, want, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(tp, want, rtol=2e-2, atol=2e-2)


def test_fully_masked_rows_are_the_mean_of_v():
    """A window with Sq > Skv leaves rows qpos >= Skv + window - 1 with no
    valid key: both packages give the mean of v over all keys there."""
    q, k, v = _qkv(1, 2, 1, 64, 32, 16, seed=3)
    jk, jr, tk_out, tp = _both(q, k, v, True, 8, 32, 32)
    for want in (jk, jr):
        np.testing.assert_allclose(tk_out, want, **F32_TOL)
        np.testing.assert_allclose(tp, want, **F32_TOL)
    masked = np.arange(64) >= 32 + 8 - 1
    mean_v = v[0, 0].mean(axis=0)
    np.testing.assert_allclose(tk_out[0, :, masked],
                               np.broadcast_to(mean_v, (2, masked.sum(), 16)
                                               ).swapaxes(0, 1), **F32_TOL)


def test_rows_are_convex_combinations():
    """All-ones v gives exactly ones (the weights sum to 1), masked rows
    included."""
    q, k, v = _qkv(1, 2, 1, 48, 32, 8, seed=4)
    ones = torch.ones_like(torch.from_numpy(v))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 ones, causal=causal, window=window)
        np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5)


def test_strided_views_and_no_launch_on_cpu():
    """(B, S, H, hd) buffers go in as transposed views, as attention passes
    them; a CPU tensor takes the plain version and counts no launch."""
    q, k, v = _qkv(2, 4, 2, 40, 40, 16, seed=5)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (tq_, tk_, tv_)]
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(*views, causal=True, window=7)
    assert fa.LAUNCHES["flash_attention"] == before
    torch.testing.assert_close(got, fa.mha_plain(tq_, tk_, tv_, causal=True,
                                                 window=7), rtol=0, atol=0)


@pytest.mark.parametrize("shapes,dtypes,match", [
    (((1, 4, 8, 16), (1, 3, 8, 16)), None, "do not fit"),
    (((1, 4, 8, 24), (1, 2, 8, 24)), None, "head dim"),
    (((1, 4, 8, 16), (1, 2, 8, 16)), (torch.float32, torch.bfloat16),
     "one dtype"),
])
def test_kernel_argument_checks(shapes, dtypes, match):
    """What the CUDA wrapper refuses before it launches anything."""
    qd, kd = dtypes or (torch.float32, torch.float32)
    q = torch.zeros(shapes[0], dtype=qd)
    k = torch.zeros(shapes[1], dtype=kd)
    with pytest.raises(ValueError, match=match):
        fa._check_args(q, k, k.clone(), 0)
