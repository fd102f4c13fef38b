"""Online-softmax (flash) attention: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``kernels/flash_attention.py``.
:func:`flash_attention` replaces the TPU kernel ``flash_attention``
(``flash_attention.py:80``) and launches ``kernels/csrc/flash_attention.cu``:
one block of 4 warps per (batch, head, 128 query rows; 64 at hd 128)
walking the keys in tiles of 64 through a double-buffered ring in shared
memory, both products
on the tensor cores in 3xTF32 (f32 accuracy), the running max, denominator
and accumulator in f32 registers. :func:`mha_plain` is the counterpart of
``mha_ref``: the whole score matrix, masked, softmaxed.

Layout as in the JAX package: q (B, H, Sq, hd), k and v (B, Hkv, Skv, hd),
the kv head of head h being ``h // (H // Hkv)``. Positions count from 0 in
q and in k, so ``Sq != Skv`` is aligned top-left. Masked scores are -1e30
(finite), so a row with no valid key comes out as the mean of v. The
kernel reads any strides whose last one is 1 and whose others, like the
pointers, are multiples of 16 bytes (its copies move 16 bytes), so
``x.transpose(1, 2)`` of a (B, S, H, hd) tensor goes in without a copy; the
output has q's strides.

A tensor on the CPU takes :func:`mha_plain`; a tensor on the card goes to
the kernel or the call raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)      # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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


def _check_args(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, H, Sq, hd) and k, v "
                         f"(B, Hkv, Skv, hd) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch, head dim, H % Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if Skv == 0 or window < 0:
        raise ValueError(f"flash_attention: Skv = {Skv}, window = {window}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (pointer {t.data_ptr():#x}, strides "
                             f"{t.stride()} of {t.element_size()} bytes)")
    return B, H, Hkv, Sq, Skv, hd


def _aligned(t) -> bool:
    """The pointer and the batch, head and row strides (of dims longer than
    1) are multiples of 16 bytes, as the kernel's 16-byte copies need."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * t.element_size() % 16 == 0
        for i in range(3) if t.shape[i] > 1)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, H, Sq, hd), k/v (B, Hkv, Skv, hd) -> (B, H, Sq, hd) in q's dtype.

    Causal and/or a sliding window of ``window`` keys (0: none). f32 or
    bf16, f32 inside; hd in :data:`HEAD_DIMS`. A CPU tensor takes
    :func:`mha_plain`.
    """
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal, window=window)
    B, H, Hkv, Sq, Skv, hd = _check_args(q, k, v, window)
    out = torch.empty_like(q)     # q's strides if q is dense, else contiguous
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, Hkv, Sq, Skv, int(causal), int(window),
            1.0 / math.sqrt(hd), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], stream)
    build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
