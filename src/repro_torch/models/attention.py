"""GQA attention (optional QKV bias, sliding window) with a ring-buffer
KV cache: full-sequence forward, prefill-extend and one-token decode.

The port of the GQA part of the JAX package's ``models/attention.py`` (MLA
and cross-attention wait for their families). Parameters are plain dicts
of tensors in the JAX layout: ``wq`` (d, H, hd), ``wk``/``wv`` (d, Hkv, hd),
``wo`` (H, hd, d), biases (H, hd) / (Hkv, hd). Shapes: x (B, S, d). A cache
is a dict ``{"k", "v": (B, W, Hkv, hd), "pos": (B, W) int32, "t": int}``;
the port writes it in place (JAX returns new arrays) and keeps ``t``, the
next position, as a Python int, so the route choice below needs no sync.

Prefill attention (:func:`attention_extend`) takes the flash kernel
(``kernels/flash_attention.py``) when ``t == 0`` and ``S <= W``: the chunk
then attends causally to ring slots ``0 .. S-1``, which hold its own
positions, and every other slot holds ``pos = -1`` and weighs exactly 0
in the masked form. That is ``flash_attention(q, k[:, :S], v[:, :S],
causal=True, window=cfg.sliding_window)`` on the cache's k and v, the
values JAX's masked path sees. Otherwise (a later chunk of a chunked
prefill, or a ring that wraps) it takes the masked plain route, as decode
always does: one query against W slots, which the JAX package also
computes outside any Pallas kernel. :data:`ROUTE_CALLS` counts the two.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, dense_init
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30

# calls of attention_extend per route (flash kernel / masked plain route)
ROUTE_CALLS = {"flash_calls": 0, "masked_calls": 0}


def init_attention_params(gen: torch.Generator, cfg: ModelConfig, *,
                          device=None) -> dict:
    d = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    p = {
        "wq": dense_init(gen, (d, H, hd), **kw),
        "wk": dense_init(gen, (d, Hkv, hd), **kw),
        "wv": dense_init(gen, (d, Hkv, hd), **kw),
        "wo": dense_init(gen, (H, hd, d), in_axis=1, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), **kw)
        p["bk"] = torch.zeros((Hkv, hd), **kw)
        p["bv"] = torch.zeros((Hkv, hd), **kw)
    return p


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o, w):
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.reshape(h * k, d)


def _qkv(params, x, positions, cfg: ModelConfig):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd): projections, biases, RoPE."""
    q, k, v = (_proj(x, params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores_combine(q, k, v, mask):
    """q: (B,Sq,H,hd) k/v: (B,Skv,Hkv,hd) mask: (B,1,Sq,Skv) bool."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1])


def _attend(q, k, v, positions, kv_pos, cfg: ModelConfig):
    """Masked attention of q against (k, v); kv entries with kv_pos < 0 are
    invalid (empty ring slots). One pass: JAX's chunked-query loop computes
    the same rows."""
    mask = (kv_pos[:, None, None, :] >= 0) & \
        (positions[:, None, :, None] >= kv_pos[:, None, None, :])
    if cfg.sliding_window:
        mask &= (positions[:, None, :, None] - kv_pos[:, None, None, :]
                 < cfg.sliding_window)
    return _gqa_scores_combine(q, k, v, mask)


def attention_forward(params, x, cfg: ModelConfig, *, positions=None):
    """Full-sequence causal attention (with the sliding window if set)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(params, x, positions, cfg)
    out = _attend(q, k, v, positions, positions, cfg)
    return _out(out.to(x.dtype), params["wo"])


def _ring_write(cache: dict, new: dict, positions):
    """Write S_c new entries at positions % W, in place (the last W if
    S_c > W). Every batch row holds the same positions."""
    W = cache["pos"].shape[1]
    take = min(positions.shape[1], W)
    pos = positions[:, -take:]
    slots = pos[0] % W
    for name, val in new.items():
        cache[name].index_copy_(1, slots,
                                val[:, -take:].to(cache[name].dtype))
    cache["pos"].index_copy_(1, slots, pos.to(torch.int32))
    return cache


def attention_extend(params, x, cache: dict, cfg: ModelConfig, *,
                     flash: bool = True):
    """Prefill step: S_c tokens attend to the cache and themselves
    (causal), then are written into the ring. Returns (out (B, S_c, d),
    cache).

    Route: the flash kernel when ``flash`` and ``t == 0`` and ``S_c <= W``
    (the module docstring says why that is the same function), else the
    masked plain route. ``flash=False`` forces the masked route, for the
    tests that hold the two against each other.
    """
    B, Sc, _ = x.shape
    t = cache["t"]
    W = cache["pos"].shape[1]
    positions = (t + torch.arange(Sc, device=x.device)).expand(B, Sc)
    q, k1, v1 = _qkv(params, x, positions, cfg)
    _ring_write(cache, {"k": k1, "v": v1}, positions)
    if flash and t == 0 and Sc <= W:
        ROUTE_CALLS["flash_calls"] += 1
        out = flash_attention(
            q.transpose(1, 2), cache["k"][:, :Sc].transpose(1, 2),
            cache["v"][:, :Sc].transpose(1, 2), causal=True,
            window=cfg.sliding_window).transpose(1, 2)
    else:
        ROUTE_CALLS["masked_calls"] += 1
        out = _attend(q, cache["k"], cache["v"], positions, cache["pos"], cfg)
    cache["t"] = t + Sc
    return _out(out.to(x.dtype), params["wo"]), cache


def init_cache(cfg: ModelConfig, batch: int, length: int, *,
               device=None) -> dict:
    """Ring-buffer cache. ``length`` = window size for sliding-window decode
    or the full context. Positions start at -1 (invalid)."""
    dt = getattr(torch, cfg.compute_dtype)
    W = min(length, cfg.sliding_window) if cfg.sliding_window else length
    Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, W, Hkv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, W, Hkv, hd), dtype=dt, device=device),
        "pos": torch.full((batch, W), -1, dtype=torch.int32, device=device),
        "t": 0,
    }


def attention_decode(params, x1, cache: dict, cfg: ModelConfig):
    """One-token decode against the ring. x1: (B, 1, d). Returns
    (out (B, 1, d), cache)."""
    B = x1.shape[0]
    t = cache["t"]
    W = cache["pos"].shape[1]
    pos1 = torch.full((B, 1), t, device=x1.device)
    q, k1, v1 = _qkv(params, x1, pos1, cfg)
    slot = t % W
    cache["k"][:, slot] = k1[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v1[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = t
    valid = cache["pos"] >= 0
    if cfg.sliding_window:
        valid &= (t - cache["pos"]) < cfg.sliding_window
    out = _gqa_scores_combine(q, cache["k"], cache["v"],
                              valid[:, None, None, :])
    cache["t"] = t + 1
    return _out(out.to(x1.dtype), params["wo"]), cache
