"""Decoder stack for the dense LM family: full forward, prefill and decode.

The port of the dense part of the JAX package's ``models/transformer.py``.
JAX stacks the layers of each *segment* (``segments_of``) and scans over
them; the port keeps one dict per layer in ``params["layers"]``, in the
scan's group-major order, and loops in Python. ``models/convert.py`` moves
weights between the two layouts.

Parameters: ``{"embed": (V, d), "final_norm": (d,), "layers": [{"ln1",
"attn": {...}, "ln2", "ffn": {...}}, ...]}`` plus ``"lm_head"`` (d, V)
unless the embeddings are tied. Caches: one ``attention.init_cache`` dict
per layer.

Entry points: :func:`prefill` (the prompt, in ``cfg.prefill_chunk`` chunks
or whole, building the caches) and :func:`decode_step` (one token for the
whole batch). Other families (MoE, MLA, SSM, hybrid, enc-dec, VLM) raise
in :func:`check_family`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models.common import embed_init, rms_norm
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# segments
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    groups: int                      # scan length
    sig: tuple                       # per-slot (ltype, is_moe)


def segments_of(cfg: ModelConfig, num_layers: int | None = None,
                layer_offset: int = 0) -> list[Segment]:
    L = num_layers if num_layers is not None else cfg.num_layers
    types = cfg.layer_types()
    sigs = [(types[layer_offset + i], cfg.is_moe_layer(layer_offset + i))
            for i in range(L)]
    for p in range(1, min(16, L) + 1):
        # p == L would be a full unroll; prefer run-splitting instead
        if (p < L or L == 1) and L % p == 0 and \
                all(sigs[i] == sigs[i % p] for i in range(L)):
            return [Segment(groups=L // p, sig=tuple(sigs[:p]))]
    # fall back to maximal constant runs (deepseek: 3 dense + 58 moe)
    segs, i = [], 0
    while i < L:
        j = i
        while j < L and sigs[j] == sigs[i]:
            j += 1
        segs.append(Segment(groups=j - i, sig=(sigs[i],)))
        i = j
    return segs


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder-only text LM."""
    other = [name for name, on in (
        ("MoE", cfg.moe_num_experts > 0), ("MLA", cfg.mla),
        ("SSM/hybrid", any(t != "A" for t in cfg.layer_types())),
        ("enc-dec", cfg.is_encdec), ("VLM/audio", cfg.modality != "text"),
        (f"arch_type {cfg.arch_type!r}", cfg.arch_type != "dense")) if on]
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(other)} not ported to PyTorch yet "
            f"(ROADMAP.md, Queue 1 item 8)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_layer(gen, cfg: ModelConfig, device) -> dict:
    dt = getattr(torch, cfg.param_dtype)
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
         "attn": attn.init_attention_params(gen, cfg, device=device)}
    if cfg.d_ff > 0:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["ffn"] = mlp.init_ffn_params(gen, cfg.d_model, cfg.d_ff, dt,
                                       device=device)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    made on ``device``."""
    check_family(cfg)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dt,
                            device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "layers": [_init_layer(gen, cfg, device)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=dt, device=device)
    return params


# --------------------------------------------------------------------------
# layer body, embedding, head
# --------------------------------------------------------------------------
def _ffn(p, x, cfg: ModelConfig):
    if "ffn" in p:
        x = x + mlp.ffn_forward(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x


def _layer_fwd(p, x, cfg: ModelConfig, *, positions=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attention_forward(p["attn"], h, cfg, positions=positions)
    return _ffn(p, x, cfg)


def _run_segments(layers, x, cfg: ModelConfig, *, positions=None):
    """Full-sequence forward through every layer (training-forward math,
    which prefill is held against)."""
    for p in layers:
        x = _layer_fwd(p, x, cfg, positions=positions)
    return x


def _embed_tokens(params, tokens):
    return params["embed"][tokens]


def _lm_logits(params, x):
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (x @ head).float()


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------
def _layer_extend(p, x, cache, cfg: ModelConfig, *, flash: bool = True):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    h, cache = attn.attention_extend(p["attn"], h, cache, cfg, flash=flash)
    return _ffn(p, x + h, cfg), cache


def _layer_decode(p, x1, cache, cfg: ModelConfig):
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    h, cache = attn.attention_decode(p["attn"], h, cache, cfg)
    return _ffn(p, x1 + h, cfg), cache


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int) -> list:
    """One ring-buffer cache per layer, on the parameters' device."""
    dev = params["embed"].device
    return [attn.init_cache(cfg, batch, cache_len, device=dev)
            for _ in params["layers"]]


def _run_segments_cached(params, x, caches, layer_step):
    """The prefill-extend and decode loop: every layer in the scan's
    group-major order, each updating its cache in place."""
    new = []
    for p, c in zip(params["layers"], caches):
        x, c = layer_step(p, x, c)
        new.append(c)
    return x, new


def extend_chunk(params, x, caches, cfg: ModelConfig, *, flash: bool = True):
    """Run one chunk of tokens through all layers, updating caches."""
    return _run_segments_cached(
        params, x, caches,
        lambda p, x, c: _layer_extend(p, x, c, cfg, flash=flash))


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, *,
            flash: bool = True):
    """Chunked prefill of ``batch["tokens"]`` (B, S). Returns (last-token
    logits (B, 1, V) f32, caches). ``flash=False`` keeps every chunk on the
    masked attention route (``attention.attention_extend``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, tokens)
    caches = init_caches(params, cfg, B, cache_len)
    chunk = cfg.prefill_chunk or S
    if S % chunk != 0:
        raise ValueError(f"prefill length {S} not divisible by chunk {chunk}")
    for i in range(0, S, chunk):
        xi, caches = extend_chunk(params, x[:, i:i + chunk], caches, cfg,
                                  flash=flash)
    h_last = rms_norm(xi[:, -1:], params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, h_last), caches


def decode_step(params, token1, caches, cfg: ModelConfig):
    """One serve step: token1 (B, 1) -> (logits (B, 1, V) f32, caches)."""
    x = _embed_tokens(params, token1)
    x, caches = _run_segments_cached(
        params, x, caches, lambda p, x, c: _layer_decode(p, x, c, cfg))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x), caches
