"""Attention: GQA (optional QKV bias, sliding window), cross-attention and
MLA (DeepSeek), with a ring-buffer KV cache: full-sequence forward,
prefill-extend and one-token decode (MLA's absorbed decode over the
compressed cache).

The port of the JAX package's ``models/attention.py``. Parameters are
plain dicts of tensors in the JAX layout. GQA and cross-attention: ``wq``
(d, H, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd, d), biases (H, hd)
/ (Hkv, hd). MLA: ``wdq`` (d, q_lora), ``q_norm``, ``wuq`` (q_lora, H,
nope + rope), ``wdkv`` (d, kv_lora), ``kv_norm``, ``wkr`` (d, rope),
``wuk`` (kv_lora, H, nope), ``wuv`` (kv_lora, H, v), ``wo`` (H, v, d).
Shapes: x (B, S, d). A cache is a dict ``{"k", "v": (B, W, Hkv, hd)}``
(MLA: ``{"ckv": (B, W, kv_lora), "kr": (B, W, rope)}``) with ``"pos": (B,
W) int32`` and ``"t"``, plus an enc-dec decoder layer's ``"enc_k"``,
``"enc_v"`` (B, Se, Hkv, hd); the port writes it in place (JAX returns new
arrays) and keeps ``t``, the next position, as a Python int, so the route
choice below needs no sync.

Prefill attention (:func:`attention_extend`) takes the flash kernel
(``kernels/flash_attention.py``) when ``t == 0`` and ``S <= W``: the chunk
then attends causally to ring slots ``0 .. S-1``, which hold its own
positions, and every other slot holds ``pos = -1`` and weighs exactly 0
in the masked form. That is ``flash_attention(q, k[:, :S], v[:, :S],
causal=True, window=cfg.sliding_window)`` on the cache's k and v (MLA:
the first S rows of the compressed ring expanded, q/k 192 wide and v 128
at deepseek's widths), the values JAX's masked path sees. Otherwise (a
later chunk of a chunked prefill, or a ring that wraps) it takes the
masked plain route, as decode always does: one query against W slots,
which the JAX package also computes outside any Pallas kernel.
Cross-attention in prefill (:func:`cross_extend`) is the chunk's q (no
RoPE) against the whole encoder memory, ``causal=False``, on every
chunk; an encoder in prefill (``attention_forward(flash=True)``) is
causal attention over positions 0..S-1. :data:`ROUTE_CALLS` counts each
route.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, dense_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard

NEG_INF = -1e30

# calls per route: self-attention prefill (attention_extend), the
# cross-attention of a prefill chunk (cross_extend), an encoder's
# attention in prefill (attention_forward(flash=True))
ROUTE_CALLS = {"flash_calls": 0, "masked_calls": 0, "cross_flash_calls": 0,
               "cross_masked_calls": 0, "encoder_flash_calls": 0}


def init_attention_params(key, cfg: ModelConfig, *, cross: bool = False,
                          device=None) -> dict:
    """The layer's attention leaves from ``split(key, 8)``, as JAX's."""
    d = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    ks = prng.split(key, 8)
    if cfg.mla and not cross:
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
        return {
            "wdq": dense_init(ks[0], (d, ql), **kw),
            "q_norm": torch.ones((ql,), **kw),
            "wuq": dense_init(ks[1], (ql, H, nope + rope), in_axis=0, **kw),
            "wdkv": dense_init(ks[2], (d, kvl), **kw),
            "kv_norm": torch.ones((kvl,), **kw),
            "wkr": dense_init(ks[3], (d, rope), **kw),
            "wuk": dense_init(ks[4], (kvl, H, nope), in_axis=0, **kw),
            "wuv": dense_init(ks[5], (kvl, H, vd), in_axis=0, **kw),
            "wo": dense_init(ks[6], (H, vd, d), in_axis=1, **kw),
        }
    p = {
        "wq": dense_init(ks[0], (d, H, hd), **kw),
        "wk": dense_init(ks[1], (d, Hkv, hd), **kw),
        "wv": dense_init(ks[2], (d, Hkv, hd), **kw),
        "wo": dense_init(ks[3], (H, hd, d), in_axis=1, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), **kw)
        p["bk"] = torch.zeros((Hkv, hd), **kw)
        p["bv"] = torch.zeros((Hkv, hd), **kw)
    return p


def attention_param_count(cfg: ModelConfig, *, cross: bool = False) -> int:
    """The number of parameters :func:`init_attention_params` makes."""
    d = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.mla and not cross:
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
        return (d * ql + ql + ql * H * (nope + rope) + d * kvl + kvl
                + d * rope + kvl * H * (nope + vd) + H * vd * d)
    n = 2 * d * H * hd + 2 * d * Hkv * hd
    return n + (H + 2 * Hkv) * hd if cfg.qkv_bias else n


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o, w):
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.reshape(h * k, d)


def _cross_q(params, x):
    """Cross-attention's q (B, S, H, hd): the projection and bias, no
    RoPE."""
    q = _proj(x, params["wq"])
    return q + params["bq"] if "bq" in params else q


def _qkv(params, x, positions, cfg: ModelConfig):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd): projections, biases, RoPE."""
    q, k, v = (_proj(x, params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def cross_kv(params, enc_out):
    """Cross-attention k, v (B, Se, Hkv, hd) of the encoder output (no
    RoPE), cached once per decoder layer."""
    k, v = _proj(enc_out, params["wk"]), _proj(enc_out, params["wv"])
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    return k, v


# --------------------------------------------------------------------------
# MLA projections
# --------------------------------------------------------------------------
def _mla_q(params, x, positions, cfg: ModelConfig):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) with RoPE)."""
    cq = rms_norm(x @ params["wdq"], params["q_norm"], cfg.norm_eps)
    q = _proj(cq, params["wuq"])
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                             dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params, x, positions, cfg: ModelConfig):
    """The compressed cache entries: ckv (B, S, kv_lora), normed, and kr (B,
    S, rope), the shared rope key with RoPE."""
    ckv = rms_norm(x @ params["wdkv"], params["kv_norm"], cfg.norm_eps)
    kr = apply_rope((x @ params["wkr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def _mla_expand(params, ckv, kr, cfg: ModelConfig, dtype):
    """k (B, W, H, nope + rope) and v (B, W, H, v) from compressed rows."""
    ckv = ckv.to(dtype)
    k_nope = _proj(ckv, params["wuk"])
    k_rope = kr[:, :, None, :].to(dtype).expand(
        *k_nope.shape[:3], cfg.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope], dim=-1), _proj(ckv, params["wuv"])


def _mla_qkv(params, x, positions, cfg: ModelConfig):
    """MLA projections for full-sequence mode (uncompressed k/v)."""
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    ckv, kr = _mla_latent(params, x, positions, cfg)
    k, v = _mla_expand(params, ckv, kr, cfg, x.dtype)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


# --------------------------------------------------------------------------
# core attention math
# --------------------------------------------------------------------------
def _gqa_scores_combine(q, k, v, mask):
    """q: (B,Sq,H,hd) k: (B,Skv,Hkv,hd) v: (B,Skv,Hkv,hd_v) mask:
    (B,1,Sq,Skv) bool. Scores over sqrt(q's width); out (B,Sq,H,hd_v)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1])


def _chunk_mask(qpos, kv_pos, cfg: ModelConfig):
    """(b, 1, Sq, Skv) validity of a query chunk's positions against the kv
    positions: causal, inside the window, kv_pos >= 0."""
    mask = (kv_pos[:, None, None, :] >= 0) & \
        (qpos[:, None, :, None] >= kv_pos[:, None, None, :])
    if cfg.sliding_window:
        mask &= (qpos[:, None, :, None] - kv_pos[:, None, None, :]
                 < cfg.sliding_window)
    return mask


def _chunked(q, positions, attn, q_chunk: int):
    """``attn(q_chunk, its positions)`` over chunks of ``q_chunk`` queries
    (the last one short), concatenated: no score tensor wider than a
    chunk's is made."""
    S = q.shape[1]
    if S <= q_chunk:
        return attn(q, positions)
    return torch.cat([attn(q[:, i:i + q_chunk],
                           None if positions is None
                           else positions[:, i:i + q_chunk])
                      for i in range(0, S, q_chunk)], dim=1)


def _use_seq_parallel(cfg: ModelConfig, H: int, S: int, mesh) -> bool:
    tp = cfg.tp_size
    return (mesh is not None and tp > 1 and H % tp != 0 and S % tp == 0
            and S > tp)


def _attend(q, k, v, positions, kv_pos, cfg: ModelConfig, *,
            q_chunk: int = 1024, mesh=None):
    """Chunked-query attention of q against (k, v) with position-derived
    masking; kv entries with kv_pos < 0 are invalid (empty ring slots).
    Each chunk of ``q_chunk`` queries builds its own mask and scores. On a
    mesh whose heads do not divide ``cfg.tp_size``, the sequence-parallel
    island: each rank of the "model" axis takes its slice of the queries
    (k and v whole), and the slices are gathered."""
    def attn(qc, qpos):
        return _gqa_scores_combine(qc, k, v, _chunk_mask(qpos, kv_pos, cfg))

    if _use_seq_parallel(cfg, q.shape[2], q.shape[1], mesh):
        out = _chunked(shard.block_of(q, mesh, "model", 1),
                       shard.block_of(positions, mesh, "model", 1), attn,
                       q_chunk)
        return shard.all_gather(out, mesh, "model", 1)
    return _chunked(q, positions, attn, q_chunk)


def _attend_all(q, k, v, q_chunk: int = 1024):
    """Cross-attention: every query against every key (JAX's all-ones
    mask), in chunks of ``q_chunk`` queries."""
    def attn(qc, _):
        mask = torch.ones((qc.shape[0], 1, qc.shape[1], k.shape[1]),
                          dtype=torch.bool, device=q.device)
        return _gqa_scores_combine(qc, k, v, mask)
    return _chunked(q, None, attn, q_chunk)


def _view(params, spec, cfg: ModelConfig, mesh):
    """The block's parameters for compute and whether its heads are split
    over "model" (``sharding/shard.py::block_view``); (params, False)
    without a mesh."""
    if mesh is None:
        return params, False
    return shard.block_view(params, spec, mesh, shard.HEAD_DIMS)


def _project_out(out, params, dtype, mesh, split: bool):
    """``wo`` of the heads' output; row-parallel (then summed over "model")
    when the heads are split."""
    y = _out(out.to(dtype), params["wo"])
    return shard.all_reduce(y, mesh, "model") if split else y


def _flash(q, k, v, *, causal: bool, window: int = 0):
    """:func:`flash_attention` on (B, S, H, hd) tensors."""
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)


def attention_forward(params, x, cfg: ModelConfig, *, positions=None,
                      enc_out=None, flash: bool = False, q_chunk: int = 1024,
                      mesh=None, spec=None):
    """Full-sequence attention (training, an encoder, JAX's whole-sequence
    prefill): causal, with the sliding window if set, or cross-attention
    (no mask, no RoPE, k and v from ``enc_out``), in chunks of ``q_chunk``
    queries. ``flash`` takes the flash kernel for the causal form over
    positions 0..S-1 (``positions`` None): an encoder in prefill; training
    keeps the masked plain path, as JAX's does. ``mesh`` (with the block's
    ``spec``): this rank's shards; the heads split over "model" where the
    weights are sharded so, else gathered whole."""
    params, split = _view(params, spec, cfg, mesh)
    B, S, _ = x.shape
    if enc_out is not None:
        k, v = cross_kv(params, enc_out)
        out = _attend_all(_cross_q(params, x), k, v, q_chunk)
        return _project_out(out, params, x.dtype, mesh, split)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.mla:
        q, k, v = _mla_qkv(params, x, positions, cfg)
    else:
        q, k, v = _qkv(params, x, positions, cfg)
    if flash:
        ROUTE_CALLS["encoder_flash_calls"] += 1
        out = _flash(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = _attend(q, k, v, positions, positions, cfg, q_chunk=q_chunk,
                      mesh=None if split else mesh)
    return _project_out(out, params, x.dtype, mesh, split)


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
                     flash: bool = True, mesh=None, spec=None):
    """Prefill step: S_c tokens attend to the cache and themselves
    (causal), then are written into the ring. Returns (out (B, S_c, d),
    cache).

    Route: the flash kernel when ``flash`` and ``t == 0`` and ``S_c <= W``
    (the module docstring says why that is the same function), else the
    masked plain route. ``flash=False`` forces the masked route, for the
    tests that hold the two against each other. MLA writes the compressed
    entries and attends to them expanded (the absorbed form is
    decode-only, as in JAX). ``mesh``/``spec``: as
    :func:`attention_forward`; the cache then holds this rank's kv heads
    where the heads are split.
    """
    params, split = _view(params, spec, cfg, mesh)
    B, Sc, _ = x.shape
    t = cache["t"]
    W = cache["pos"].shape[1]
    positions = (t + torch.arange(Sc, device=x.device)).expand(B, Sc)
    take_flash = flash and t == 0 and Sc <= W
    if cfg.mla:
        q = torch.cat(_mla_q(params, x, positions, cfg), dim=-1)
        ckv, kr = _mla_latent(params, x, positions, cfg)
        _ring_write(cache, {"ckv": ckv, "kr": kr}, positions)
        rows = slice(0, Sc) if take_flash else slice(None)
        k, v = _mla_expand(params, cache["ckv"][:, rows],
                           cache["kr"][:, rows], cfg, x.dtype)
    else:
        q, k1, v1 = _qkv(params, x, positions, cfg)
        _ring_write(cache, {"k": k1, "v": v1}, positions)
        k, v = cache["k"], cache["v"]
        if take_flash:
            k, v = k[:, :Sc], v[:, :Sc]
    if take_flash:
        ROUTE_CALLS["flash_calls"] += 1
        out = _flash(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        ROUTE_CALLS["masked_calls"] += 1
        out = _attend(q, k, v, positions, cache["pos"], cfg)
    cache["t"] = t + Sc
    return _project_out(out, params, x.dtype, mesh, split), cache


def cross_extend(params, x, cache: dict, *, flash: bool = True, cfg=None,
                 mesh=None, spec=None):
    """A prefill chunk's cross-attention: its q (no RoPE) against the
    cached encoder memory ``enc_k``/``enc_v``, every key valid (JAX's
    ``attention_decode(cross=True)`` on the chunk). The flash kernel with
    ``causal=False`` unless ``flash=False``. Returns out (B, S_c, d).
    ``cfg``/``mesh``/``spec``: as :func:`attention_forward`."""
    params, split = _view(params, spec, cfg, mesh)
    q = _cross_q(params, x)
    k, v = cache["enc_k"], cache["enc_v"]
    if flash:
        ROUTE_CALLS["cross_flash_calls"] += 1
        out = _flash(q, k, v, causal=False)
    else:
        ROUTE_CALLS["cross_masked_calls"] += 1
        out = _attend_all(q, k, v)
    return _project_out(out, params, x.dtype, mesh, split)


def cross_decode(params, x1, cache: dict, *, cfg=None, mesh=None,
                 spec=None):
    """One token's cross-attention, on the masked plain route."""
    params, split = _view(params, spec, cfg, mesh)
    out = _attend_all(_cross_q(params, x1), cache["enc_k"], cache["enc_v"])
    return _project_out(out, params, x1.dtype, mesh, split)


def init_cache(cfg: ModelConfig, batch: int, length: int, *,
               device=None) -> dict:
    """Ring-buffer cache. ``length`` = window size for sliding-window decode
    or the full context. Positions start at -1 (invalid)."""
    dt = getattr(torch, cfg.compute_dtype)
    W = min(length, cfg.sliding_window) if cfg.sliding_window else length
    kw = dict(dtype=dt, device=device)
    if cfg.mla:
        cache = {"ckv": torch.zeros((batch, W, cfg.kv_lora_rank), **kw),
                 "kr": torch.zeros((batch, W, cfg.qk_rope_head_dim), **kw)}
    else:
        Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache = {"k": torch.zeros((batch, W, Hkv, hd), **kw),
                 "v": torch.zeros((batch, W, Hkv, hd), **kw)}
    cache["pos"] = torch.full((batch, W), -1, dtype=torch.int32,
                              device=device)
    cache["t"] = 0
    return cache


def _valid(cache, t, cfg: ModelConfig):
    valid = cache["pos"] >= 0
    if cfg.sliding_window:
        valid &= (t - cache["pos"]) < cfg.sliding_window
    return valid


def _mla_decode(params, x1, cache: dict, cfg: ModelConfig, pos1, slot, t):
    """The absorbed decode: scores and values against the compressed ring,
    never expanding it, in f32 as JAX casts."""
    q_nope, q_rope = _mla_q(params, x1, pos1, cfg)
    ckv1, kr1 = _mla_latent(params, x1, pos1, cfg)
    cache["ckv"][:, slot] = ckv1[:, 0].to(cache["ckv"].dtype)
    cache["kr"][:, slot] = kr1[:, 0].to(cache["kr"].dtype)
    cache["pos"][:, slot] = t
    ckv = cache["ckv"].float()
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                         params["wuk"].float())           # (B, 1, H, r)
    sc = (torch.einsum("bshr,bwr->bhw", q_abs, ckv)
          + torch.einsum("bshk,bwk->bhw", q_rope.float(),
                         cache["kr"].float()))
    sc = sc / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    sc = torch.where(_valid(cache, t, cfg)[:, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)                         # (B, H, W)
    ctx = torch.einsum("bhw,bwr->bhr", p, ckv)
    out = torch.einsum("bhr,rhk->bhk", ctx, params["wuv"].float())
    return out[:, None]                                   # (B, 1, H, v)


def attention_decode(params, x1, cache: dict, cfg: ModelConfig, *,
                     mesh=None, spec=None):
    """One-token decode against the ring. x1: (B, 1, d). Returns
    (out (B, 1, d), cache). MLA takes the absorbed decode. ``mesh``/
    ``spec``: as :func:`attention_extend`."""
    params, split = _view(params, spec, cfg, mesh)
    B = x1.shape[0]
    t = cache["t"]
    W = cache["pos"].shape[1]
    pos1 = torch.full((B, 1), t, device=x1.device)
    slot = t % W
    if cfg.mla:
        out = _mla_decode(params, x1, cache, cfg, pos1, slot, t)
    else:
        q, k1, v1 = _qkv(params, x1, pos1, cfg)
        cache["k"][:, slot] = k1[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v1[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = t
        out = _gqa_scores_combine(q, cache["k"], cache["v"],
                                  _valid(cache, t, cfg)[:, None, None, :])
    cache["t"] = t + 1
    return _project_out(out, params, x1.dtype, mesh, split), cache
