"""Shared model building blocks: norms, RoPE, initializers.

The port of the JAX package's ``models/common.py``. Initializers draw from
an explicit ``torch.Generator``; they cannot give ``jax.random``'s numbers,
so the tests carry JAX weights across with ``models/convert.py``.
"""
from __future__ import annotations

import numpy as np
import torch


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


def dense_init(gen: torch.Generator, shape, *, in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal (±2 std) fan-in init, std 1/sqrt(shape[in_axis])."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(1.0 / np.sqrt(shape[in_axis])).to(dtype)


def embed_init(gen: torch.Generator, shape, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, 0.02, generator=gen).to(dtype)
