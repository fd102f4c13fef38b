"""Shared model building blocks: norms, RoPE, initializers, parameter
trees.

The port of the JAX package's ``models/common.py``. Initializers take a
``jax.random`` key (``repro_torch.prng``) and draw JAX's numbers for it
(``prng.fill_random``: the CUDA kernel on a card), so the same key gives
both packages the same weights. A parameter tree is nested dicts and lists
of tensors; :func:`tree_map` and :func:`tree_leaves` stand in for
``jax.tree``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype, then times ``scale``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), rotate-half layout, in f32; positions
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(key, shape, *, in_axis: int = -2, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal (±2 std) fan-in init, std 1/sqrt(shape[in_axis]):
    ``jax.random.truncated_normal(key, -2, 2, shape)`` times the f32 std,
    then cast, as JAX's ``dense_init``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    prng.fill_random(key, t.numel(), "truncated_normal",
                     1.0 / np.sqrt(shape[in_axis]), t)
    return t.to(dtype)


def embed_init(key, shape, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` times 0.02 in f32, then cast."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    prng.fill_random(key, t.numel(), "normal", 0.02, t)
    return t.to(dtype)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (nested dicts and lists);
    each tree of ``rest`` may hold a subtree where ``tree`` has a leaf
    (the optimizers' factored state dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in its insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def count_params(params) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(params))
