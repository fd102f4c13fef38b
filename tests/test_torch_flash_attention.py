"""The port's flash attention (its plain version on the CPU) and
``mha_plain`` against the JAX package's ``flash_attention`` (Pallas,
interpret mode) and ``mha_ref``, on the same numpy-seeded inputs; and a
numpy model of the CUDA kernel's arithmetic (3xTF32 tensor-core products,
permuted key order in P V, online softmax over each instance's key tiles)
against both.

Tolerances are those of ``tests/test_flash_attention.py``: rtol 2e-4,
atol 2e-5 in f32 (two softmax-attention evaluations in f32 that sum in
other orders) and 2e-2 in bf16 (the output rounds to bf16)."""
import math

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


# --------------------------------------------------------------------------
# A numpy model of the CUDA kernel's arithmetic (csrc/flash_attention.cu)
# --------------------------------------------------------------------------
KEY_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])   # P V's k-step columns


def _tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero, the low 13 mantissa bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _truncate_tf32(x):
    """The TF32 a tensor core reads from an f32 register: its top 19 bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def _product(a, b, terms):
    """a @ b from TF32 operands in f32: 3 terms (lo * hi' + hi * lo', then
    hi * hi') or 1 (hi * hi' alone); hi rounded as cvt.rna rounds, lo = x -
    hi passed unrounded, so the tensor core truncates it."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _truncate_tf32(a - ah), _truncate_tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _kernel_model(q, k, v, causal, window, terms=3):
    """The kernel's function on f32 numpy arrays: per (b, h) and block of
    query rows, the block's key range in tiles from its first valid key
    (every tile when a row has no valid key; rows and keys a tile as the
    instance's geometry gives them, ``fa.block_geometry``), scores in the
    log2 domain
    masked to -1e30 (-inf past Skv), an online softmax with exp2, and P V
    with each 8-key group's columns taken in the kernel's A-fragment order
    (keys 0, 2, 4, 6, 1, 3, 5, 7) and v's rows in the same order."""
    B, H, Sq, hd = q.shape
    Hkv, Skv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    sc = np.float32(1 / math.sqrt(hd)) * np.float32(math.log2(math.e))
    rows, TILE = fa.block_geometry(hd, hd_v)
    order = (np.arange(0, TILE, 8)[:, None] + KEY_ORDER).ravel()
    out = np.zeros((B, H, Sq, hd_v), np.float32)
    pad = -(-Skv // TILE) * TILE + TILE         # keys past Skv are zeros
    for b in range(B):
        for h in range(H):
            K = np.zeros((pad, hd), np.float32)
            V = np.zeros((pad, hd_v), np.float32)
            K[:Skv], V[:Skv] = k[b, h // G], v[b, h // G]
            for q0 in range(0, Sq, rows):
                n = min(rows, Sq - q0)
                Q = np.zeros((rows, hd), np.float32)
                Q[:n] = q[b, h, q0:q0 + n]
                q_last = q0 + n - 1
                k_lo, k_hi = 0, Skv - 1
                if not (window and q_last - window + 1 > Skv - 1):
                    if causal:
                        k_hi = min(k_hi, q_last)
                    if window:
                        k_lo = max(0, q0 - window + 1)
                m = np.full(rows, -1e30, np.float32)
                l = np.zeros(rows, np.float32)
                o = np.zeros((rows, hd_v), np.float32)
                qp = (q0 + np.arange(rows))[:, None]
                for k0 in range(k_lo, k_hi + 1, TILE):
                    kp = (k0 + np.arange(TILE))[None, :]
                    x = _product(Q, K[k0:k0 + TILE].T, terms) * sc
                    masked = np.zeros((rows, TILE), bool)
                    if causal:
                        masked |= kp > qp
                    if window:
                        masked |= qp - kp >= window
                    x = np.where(masked, np.float32(-1e30), x)
                    x = np.where(kp >= Skv, np.float32(-np.inf), x)
                    mx = np.maximum(m, x.max(axis=1))
                    alpha = np.exp2(m - mx)
                    p = np.exp2(x - mx[:, None])
                    l = l * alpha + p.sum(axis=1, dtype=np.float32)
                    o = o * alpha[:, None] + _product(
                        p[:, order], V[k0:k0 + TILE][order], terms)
                    m = mx
                out[b, h, q0:q0 + n] = (o / np.maximum(l, np.float32(1e-30))
                                        [:, None])[:n]
    return out


CASES = [  # B, H, Hkv, Sq, Skv, hd, causal, window, tq, tk
    (2, 4, 4, 64, 64, 32, True, 0, 32, 32),
    (1, 4, 2, 64, 128, 32, True, 0, 32, 64),      # GQA, Sq < Skv (top-left)
    (2, 2, 2, 96, 96, 16, True, 24, 32, 32),      # sliding window
    (1, 2, 1, 64, 64, 64, False, 0, 64, 32),      # cross-attn style
    (1, 8, 8, 128, 128, 8, True, 0, 128, 32),
    (1, 4, 2, 32, 96, 16, True, 0, 32, 32),       # GQA, Sq < Skv, ragged tiles
    (1, 2, 1, 192, 160, 64, True, 40, 64, 32),    # two query blocks, ragged
    (1, 2, 1, 130, 130, 128, False, 0, 65, 65),   # hd 128: two blocks of 128
    (1, 4, 2, 201, 77, 128, True, 24, 67, 77),    # ragged rows and 16-key tiles
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,causal,window,tq,tk", CASES)
def test_flash_matches_jax(B, H, Hkv, Sq, Skv, hd, causal, window, tq, tk):
    """The port's flash attention and mha_plain, and the numpy model of the
    CUDA kernel's 3xTF32 arithmetic, within F32_TOL of the JAX kernel and
    of mha_ref (1xTF32, hi * hi' alone, lands 2.6x to 12.2x outside the
    same tolerance on these cases: see the last test)."""
    q, k, v = _qkv(B, H, Hkv, Sq, Skv, hd)
    jk, jr, tk_out, tp = _both(q, k, v, causal, window, tq, tk)
    model = _kernel_model(q, k, v, causal, window)
    for want in (jk, jr):
        np.testing.assert_allclose(tk_out, want, **F32_TOL)
        np.testing.assert_allclose(tp, want, **F32_TOL)
        np.testing.assert_allclose(model, want, **F32_TOL)
    np.testing.assert_allclose(model, tp, **F32_TOL)


# MLA's (192, 128) instance: q/k heads of 192 against v heads of 128
MLA_CASES = [  # B, H, Hkv, Sq, Skv, causal, window
    (1, 2, 2, 130, 130, True, 0),     # two blocks of 128 rows, ragged
    (2, 2, 1, 70, 33, False, 0),      # GQA, Sq > Skv, two tiles, one ragged
    (1, 2, 2, 100, 40, True, 8),      # rows with no valid key
    (1, 4, 2, 150, 140, True, 40),    # GQA, a window over ragged tiles
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,causal,window", MLA_CASES)
def test_mla_widths_match_mha_ref(B, H, Hkv, Sq, Skv, causal, window):
    """At q/k 192 and v 128 (scores over sqrt(192), the output v's width)
    the port's flash attention and mha_plain, and the numpy model of the
    kernel's arithmetic, within F32_TOL of the JAX package's mha_ref."""
    rng = np.random.default_rng(11)
    q, k = ((rng.normal(0, 1, s) * 0.5).astype(np.float32)
            for s in ((B, H, Sq, 192), (B, Hkv, Skv, 192)))
    v = (rng.normal(0, 1, (B, Hkv, Skv, 128)) * 0.5).astype(np.float32)
    want = np.asarray(mha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, window=window))
    assert want.shape == (B, H, Sq, 128)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    for got in (fa.flash_attention(tq_, tk_, tv_, causal=causal,
                                   window=window).numpy(),
                fa.mha_plain(tq_, tk_, tv_, causal=causal,
                             window=window).numpy(),
                _kernel_model(q, k, v, causal, window)):
        np.testing.assert_allclose(got, want, **F32_TOL)


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
    model = _kernel_model(q, k, v, True, 8)
    for want in (jk, jr):
        np.testing.assert_allclose(tk_out, want, **F32_TOL)
        np.testing.assert_allclose(tp, want, **F32_TOL)
        np.testing.assert_allclose(model, want, **F32_TOL)
    masked = np.arange(64) >= 32 + 8 - 1
    mean_v = v[0, 0].mean(axis=0)
    for got in (tk_out, model):
        np.testing.assert_allclose(got[0, :, masked], np.broadcast_to(
            mean_v, (2, masked.sum(), 16)).swapaxes(0, 1), **F32_TOL)


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
    # MLA's (192, 128) instance takes its v width; (64, 32) has none
    (((1, 4, 8, 192), (1, 4, 8, 192), (1, 4, 8, 128)), None, None),
    (((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 32)), None, "head dim"),
])
def test_kernel_argument_checks(shapes, dtypes, match):
    """What the CUDA wrapper refuses before it launches anything, and the
    (q/k, v) width pair it takes."""
    qd, kd = dtypes or (torch.float32, torch.float32)
    q = torch.zeros(shapes[0], dtype=qd)
    k = torch.zeros(shapes[1], dtype=kd)
    v = torch.zeros(shapes[2], dtype=kd) if len(shapes) > 2 else k.clone()
    if match is None:
        assert fa._check_args(q, k, v, 0)[-2:] == (shapes[0][3], shapes[2][3])
        return
    with pytest.raises(ValueError, match=match):
        fa._check_args(q, k, v, 0)


@pytest.mark.parametrize("what", ["pointer", "row stride", "bf16 row stride"])
def test_kernel_refuses_unaligned_views(what):
    """The kernel copies 16 bytes at a time: a view whose pointer or row
    stride is not a multiple of 16 bytes is refused; the model's views
    (``models/attention.py``) pass."""
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    assert fa._check_args(q, k, k, 0)
    base = torch.zeros((1, 4, 8, 20))
    if what == "pointer":
        q = base[..., 1:17]                      # 4 bytes past an aligned row
    elif what == "row stride":
        q = torch.zeros((1, 4, 8, 17))[..., :16]  # rows 68 bytes apart
    else:
        q, k = (torch.zeros((1, n, 8, 20), dtype=torch.bfloat16)[..., :16]
                for n in (4, 2))                 # rows 40 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_args(q, k, k, 0)


def test_geometry_mirrors_the_kernel_source():
    """``fa.GEOMETRY`` (the blocks the model above walks) is the .cu's
    ``GeomOf``: the two-m-tile template and each wide instance's own."""
    import re
    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention.cu").read_text()
    geom = lambda body: tuple(int(x) for x in body.split(","))[:3]  # noqa: E731
    template = geom(re.search(r"struct GeomOf \{\s*using G = Geom<([^>]*)>",
                              src).group(1))
    wide = {(int(h), int(hv)): geom(body) for h, hv, body in re.findall(
        r"struct GeomOf<(\d+), (\d+)> \{\s*using G = Geom<([^>]*)>", src)}
    assert set(wide) == {(128, 128), (192, 128)}
    assert fa.GEOMETRY == {**{(h, h): template for h in fa.HEAD_DIMS},
                           **wide}


def test_tf32_rounding_is_cvt_rna():
    """Nearest, ties away from zero, 10 mantissa bits kept."""
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20,
                  1 + 1.5 * ulp, 3.0], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0],
                           np.float32))
    r = np.random.default_rng(0).normal(0, 1, 1000).astype(np.float32)
    assert not (_tf32(r).view(np.uint32) & 0x1fff).any()
    assert (np.abs(_tf32(r) - r) <= np.abs(r) * 2.0 ** -11).all()


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,causal,window,tq,tk", CASES)
def test_one_term_tf32_misses_the_f32_tolerance(B, H, Hkv, Sq, Skv, hd,
                                                causal, window, tq, tk):
    """Why three terms: hi * hi' alone is more than twice the tolerance away
    from plain on every case (2.6x to 12.2x), 3 terms under 1 % of it."""
    q, k, v = _qkv(B, H, Hkv, Sq, Skv, hd)
    want = fa.mha_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal, window=window).numpy()
    limit = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    ratio = {terms: (np.abs(_kernel_model(q, k, v, causal, window, terms)
                            - want) / limit).max() for terms in (1, 3)}
    assert ratio[1] > 2 and ratio[3] < 0.01, ratio
