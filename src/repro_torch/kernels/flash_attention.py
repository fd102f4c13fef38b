"""Online-softmax (flash) attention: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``kernels/flash_attention.py``.
:func:`flash_attention` replaces the TPU kernel ``flash_attention``
(``flash_attention.py:80``) and launches ``kernels/csrc/flash_attention.cu``:
one block per (batch, head, 128 query rows) walking the keys in tiles
through a ring in shared memory (:data:`GEOMETRY`: 4 warps and 64-key
tiles below a v width of 128, 4 warps and 16-key tiles at hd 128, 8 warps
and 32-key tiles at (192, 128), each SM holding 8 warps), both products
on the tensor cores in 3xTF32 (f32 accuracy), the running max,
denominator and accumulator in f32 registers. :func:`mha_plain` is the
counterpart of ``mha_ref``: the whole score matrix, masked, softmaxed.
:func:`kernel_info` reads an instance's registers, spill, shared memory and
resident blocks off the card.

Layout as in the JAX package: q (B, H, Sq, hd), k (B, Hkv, Skv, hd), v
(B, Hkv, Skv, hd_v), the kv head of head h being ``h // (H // Hkv)``. v's
width is q's (:data:`HEAD_DIMS`) or one of :data:`WIDTH_PAIRS` (MLA's
192-wide q/k heads against 128-wide v heads); the output is v's width.
Positions count from 0 in q and in k, so ``Sq != Skv`` is aligned
top-left. Masked scores are -1e30 (finite), so a row with no valid key
comes out as the mean of v. The kernel reads any strides whose last one
is 1 and whose others, like the pointers, are multiples of 16 bytes (its
copies move 16 bytes), so ``x.transpose(1, 2)`` of a (B, S, H, hd) tensor
goes in without a copy; the output is a (B, Sq, H, hd_v) tensor seen the
same way.

A tensor on the CPU takes :func:`mha_plain`; a tensor on the card goes to
the kernel or the call raises; a tensor without storage (the dry-run's
``meta`` tensors) gets the kernel's output buffer and reports the kernel's
work (:func:`valid_pairs`; ``build.traced``), never taking the plain
version, whose score matrix the kernel never makes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)      # the kernel's (hd, hd) instantiations
WIDTH_PAIRS = ((192, 128),)           # and its (q/k, v) ones (MLA)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# an instance's block as the .cu's GeomOf builds it: (warps, 16-row m-tiles
# a warp, keys a tile); query rows a block are 16 x warps x m-tiles
GEOMETRY = {**{(h, h): (4, 2, 64) for h in HEAD_DIMS},
            (128, 128): (4, 2, 16), (192, 128): (8, 1, 32)}
INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm",
             "warps", "rows", "key_tile", "separate_lo")

# launches of the CUDA kernel of this module (counted where it launches)
LAUNCHES = {"flash_attention": 0}


def mha_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain attention, the same function as :func:`flash_attention`: f32
    scores of the f32-widened rows over ``sqrt(hd)``, masked to -1e30,
    softmax, f32 product with v, cast to q's dtype."""
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def valid_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the kernel scores a (batch, head): each row's
    valid keys (a row with none scores all Skv)."""
    q = np.arange(Sq)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = np.minimum(Skv - 1, q) if causal else np.full_like(q, Skv - 1)
    n = np.maximum(hi - lo + 1, 0)
    return int(np.where(n > 0, n, Skv).sum())


def block_geometry(hd: int, hd_v: int) -> tuple[int, int]:
    """(query rows, keys) of one block's tile of instance (hd, hd_v)."""
    warps, m_tiles, keys = GEOMETRY[hd, hd_v]
    return 16 * warps * m_tiles, keys


def kernel_info(dtype: torch.dtype, hd: int, hd_v: int, lib=None) -> dict:
    """The compiled instance as the card runs it (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): registers a thread,
    local (spilled) bytes a thread, shared bytes a block, resident blocks an
    SM, and its geometry (warps, rows, key tile, whether q k^T's f32 lo
    terms take accumulators of their own). ``lib``: another build of the
    source (default: the repo's)."""
    import ctypes

    out = (ctypes.c_int * len(INFO_KEYS))()
    lib = lib or build.library("flash_attention")
    build.check(lib.flash_attention_info(_DTYPES[dtype], hd, hd_v,
                                         ctypes.addressof(out)),
                "flash_attention_info")
    return dict(zip(INFO_KEYS, out))


def _check_args(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q (B, H, Sq, hd), k (B, Hkv, "
                         f"Skv, hd) and v (B, Hkv, Skv, hd_v) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    hd_v = v.shape[3]
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch, head dim, H % Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (hd == hd_v and hd in HEAD_DIMS or (hd, hd_v) in WIDTH_PAIRS):
        raise ValueError(f"flash_attention: head dims (q/k {hd}, v {hd_v}) "
                         f"not instantiated: equal ones in {HEAD_DIMS} or a "
                         f"pair in {WIDTH_PAIRS}")
    if Skv == 0 or window < 0:
        raise ValueError(f"flash_attention: Skv = {Skv}, window = {window}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            where = "" if t.is_meta else f"pointer {t.data_ptr():#x}, "
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned ({where}strides {t.stride()} of "
                             f"{t.element_size()} bytes)")
    return B, H, Hkv, Sq, Skv, hd, hd_v


def _aligned(t) -> bool:
    """The pointer and the batch, head and row strides (of dims longer than
    1) are multiples of 16 bytes, as the kernel's 16-byte copies need (a
    tensor without storage has its strides checked)."""
    return (t.is_meta or t.data_ptr() % 16 == 0) and all(
        t.stride(i) * t.element_size() % 16 == 0
        for i in range(3) if t.shape[i] > 1)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, H, Sq, hd), k (B, Hkv, Skv, hd), v (B, Hkv, Skv, hd_v) -> (B,
    H, Sq, hd_v) in q's dtype, scores scaled by 1 / sqrt(hd).

    Causal and/or a sliding window of ``window`` keys (0: none). f32 or
    bf16, f32 inside; hd = hd_v in :data:`HEAD_DIMS`, or (hd, hd_v) in
    :data:`WIDTH_PAIRS`. A CPU tensor takes :func:`mha_plain`.
    """
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal, window=window)
    B, H, Hkv, Sq, Skv, hd, hd_v = _check_args(q, k, v, window)
    # a (B, Sq, H, hd_v) buffer, the model's layout, seen as (B, H, Sq, hd_v)
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if q.is_meta:
        build.traced("flash_attention", 2.0 * (hd + hd_v) * B * H
                     * valid_pairs(Sq, Skv, causal, window),
                     sum(t.numel() * t.element_size() for t in (q, k, v, out)))
        return out
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], hd, hd_v, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Skv, int(causal),
            int(window),
            1.0 / math.sqrt(hd), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], stream)
    build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
