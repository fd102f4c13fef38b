"""The LM stack of every family (dense, MoE, SSM, hybrid, VLM, enc-dec,
MLA with MTP): the training forward with its loss, prefill and decode.

The port of the JAX package's ``models/transformer.py``. JAX stacks the
layers of each *segment* (``segments_of``) and scans over them; the port
keeps one dict per layer in ``params["layers"]`` (an encoder's in
``params["enc_layers"]``), in the scan's group-major order, and loops in
Python. ``models/convert.py`` moves weights between the two layouts.

Parameters: ``{"embed": (V, d), "final_norm": (d,), "layers": [{"ln1",
"attn" | "mixer": {...}, "ln2", "ffn" | "moe": {...}}, ...]}`` plus
``"lm_head"`` (d, V) unless the embeddings are tied. A layer holds
``"attn"`` where ``cfg.layer_types()[i]`` is "A" (MLA's leaves where
``cfg.mla``) and the Mamba-2 ``"mixer"`` (``models/mamba.py``) where it is
"M"; ``"moe"`` where ``cfg.is_moe_layer(i)``; ``"ln2"`` only with an FFN
or MoE block (mamba2's layers are ``ln1`` and ``mixer`` alone). An
enc-dec config adds ``"enc_layers"`` (``cfg.encoder_layers`` GQA layers,
``mla`` off) and ``"enc_norm"``, and its decoder layers hold ``"ln_x"``
and the GQA ``"cross"`` attention after the self-attention. An MTP config
adds ``"mtp_proj"`` (2d, d), ``"mtp_layer"`` (one attention layer with the
dense FFN, not stacked in JAX either) and ``"mtp_norm"``. Caches: one dict
per layer, ``attention.init_cache``'s (with the encoder memory's
``enc_k``, ``enc_v`` in an enc-dec decoder) or
``mamba.init_mamba_cache``'s.

Entry points: :func:`forward_train` (the full sequence, next-token cross
entropy plus 0.01 times the MoE load-balance loss plus 0.3 times the MTP
loss; its attention is the masked plain path, as JAX's training takes),
:func:`prefill` (the prompt, in ``cfg.prefill_chunk`` chunks or whole,
building the caches) and :func:`decode_step` (one token for the whole
batch). A VLM batch's ``patch_embeds`` (B, P, d) go before the token
embeddings in the training forward and the prefill; an enc-dec batch's
``frames`` (B, Se, d) are the encoder's input. The encoder is causal
attention with RoPE, as the JAX reference runs it (``_encoder_forward``
takes no mask of its own); in prefill its attention and each chunk's
cross-attention take the flash kernel. ``moe_dispatch`` picks the MoE
route of :func:`forward_train` (``models/mlp.py``); serving takes the
dense oracle, as JAX serves without a mesh.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
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
    """Raise unless ``cfg`` is an LM of a modality and arch type the
    stack knows (the embedding workload is not an LM)."""
    other = [name for name, on in (
        (f"modality {cfg.modality!r}",
         cfg.modality not in ("text", "vision", "audio")),
        (f"arch_type {cfg.arch_type!r}",
         cfg.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm",
                               "audio")))
        if on]
    if other:
        raise NotImplementedError(f"{cfg.name}: {', '.join(other)} is not "
                                  f"an LM of this stack")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_layer(gen, cfg: ModelConfig, i: int, device, *,
                cross: bool = False, ltype: str | None = None,
                is_moe: bool | None = None) -> dict:
    dt = getattr(torch, cfg.param_dtype)
    is_moe = cfg.is_moe_layer(i) if is_moe is None else is_moe
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device)}
    if (ltype or cfg.layer_types()[i]) == "A":
        p["attn"] = attn.init_attention_params(gen, cfg, device=device)
    else:
        p["mixer"] = ssm.init_mamba_params(gen, cfg, device=device)
    if cross:
        p["ln_x"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["cross"] = attn.init_attention_params(gen, cfg, cross=True,
                                                device=device)
    if cfg.d_ff > 0 or is_moe:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        if is_moe:
            p["moe"] = mlp.init_moe_params(gen, cfg, device=device)
        else:
            p["ffn"] = mlp.init_ffn_params(gen, cfg.d_model, cfg.d_ff, dt,
                                           device=device)
    return p


def param_count(cfg: ModelConfig) -> int:
    """The number of parameters :func:`init_params` makes, from the config
    alone (nothing is allocated)."""
    check_family(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    di, N, Hs = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_heads
    conv_c = di + 2 * N
    mixer_n = (d * (2 * di + 2 * N + Hs) + (cfg.ssm_conv + 1) * conv_c
               + 3 * Hs + di + di * d)

    def layer_n(c, ltype, is_moe, cross=False):
        n = d + (attn.attention_param_count(c) if ltype == "A" else mixer_n)
        if cross:
            n += d + attn.attention_param_count(c, cross=True)
        if is_moe:
            E, ff = c.moe_num_experts, c.moe_d_ff
            n += d + d * E + 3 * E * d * ff + 3 * d * ff * c.moe_num_shared
        elif c.d_ff > 0:
            n += d + 3 * d * c.d_ff
        return n

    n = V * d * (1 if cfg.tie_embeddings else 2) + d
    for i, ltype in enumerate(cfg.layer_types()):
        n += layer_n(cfg, ltype, cfg.is_moe_layer(i), cfg.is_encdec)
    if cfg.is_encdec:
        enc = dataclasses.replace(cfg, mla=False)
        n += d + sum(layer_n(enc, ltype, is_moe)
                     for seg in segments_of(cfg, cfg.encoder_layers)
                     for _ in range(seg.groups) for ltype, is_moe in seg.sig)
    if cfg.mtp:
        n += 2 * d * d + layer_n(cfg, "A", False) + d
    return n


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
        "layers": [_init_layer(gen, cfg, i, device, cross=cfg.is_encdec)
                   for i in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=dt, device=device)
    if cfg.is_encdec:
        # the encoder's layers in segments_of's group-major order, as JAX
        # builds them, with MLA off
        enc = dataclasses.replace(cfg, mla=False)
        params["enc_layers"] = [
            _init_layer(gen, enc, 0, device, ltype=ltype, is_moe=is_moe)
            for seg in segments_of(cfg, cfg.encoder_layers)
            for _ in range(seg.groups) for ltype, is_moe in seg.sig]
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=device)
    if cfg.mtp:
        params["mtp_proj"] = embed_init(gen, (2 * cfg.d_model, cfg.d_model),
                                        dtype=dt, device=device)
        params["mtp_layer"] = _init_layer(gen, cfg, 0, device, ltype="A",
                                          is_moe=False)
        params["mtp_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=device)
    return params


# --------------------------------------------------------------------------
# layer body, embedding, head
# --------------------------------------------------------------------------
def _ffn(p, x, cfg: ModelConfig, *, moe_dispatch: bool = False):
    """The layer's FFN or MoE block with its residual: (x, MoE aux or
    None)."""
    if "moe" in p:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, aux = mlp.moe_forward(p["moe"], h2, cfg, dispatch=moe_dispatch)
        return x + y, aux
    if "ffn" in p:
        x = x + mlp.ffn_forward(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, None


def _layer_fwd(p, x, cfg: ModelConfig, *, positions=None, enc_out=None,
               moe_dispatch: bool = False, flash: bool = False):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if "mixer" in p:
        h = ssm.mamba_forward(p["mixer"], h, cfg)
    else:
        h = attn.attention_forward(p["attn"], h, cfg, positions=positions,
                                   flash=flash)
    x = x + h
    if "cross" in p:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + attn.attention_forward(p["cross"], hx, cfg, enc_out=enc_out)
    return _ffn(p, x, cfg, moe_dispatch=moe_dispatch)


def _run_layers(layers, x, cfg: ModelConfig, *, positions=None,
                enc_out=None, moe_dispatch: bool = False,
                flash: bool = False):
    """Full-sequence forward through every layer: (x, the MoE aux loss
    summed over layers, f32)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        x, aux = _layer_fwd(p, x, cfg, positions=positions, enc_out=enc_out,
                            moe_dispatch=moe_dispatch, flash=flash)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _run_segments(layers, x, cfg: ModelConfig, *, positions=None,
                  enc_out=None):
    """Full-sequence forward through every layer (training-forward math,
    which prefill is held against)."""
    return _run_layers(layers, x, cfg, positions=positions,
                       enc_out=enc_out)[0]


def _encoder_forward(params, frames, cfg: ModelConfig, *,
                     moe_dispatch: bool = False, flash: bool = False):
    """The encoder over ``frames`` (B, Se, d): causal self-attention with
    RoPE at positions 0..Se-1, as JAX's reference runs it, then
    ``enc_norm``. ``flash`` takes the flash kernel (prefill). Returns
    (enc_out, the encoder's MoE aux loss)."""
    x, aux = _run_layers(params["enc_layers"], frames, cfg,
                         moe_dispatch=moe_dispatch, flash=flash)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps), aux


def _embed_tokens(params, tokens):
    return params["embed"][tokens]


def _lm_logits(params, x):
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (x @ head).float()


def softmax_xent(logits, labels, mask):
    """logits (B,S,V) f32, labels (B,S) int, mask (B,S)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------
def _with_prefix(params, batch: dict, cfg: ModelConfig):
    """The token embeddings, after a VLM batch's ``patch_embeds`` (cast to
    their dtype) where the config is a vision one: (x, prefix length)."""
    x = _embed_tokens(params, batch["tokens"])
    pe = batch.get("patch_embeds")
    if cfg.modality != "vision" or pe is None:
        return x, 0
    return torch.cat([pe.to(x.dtype), x], dim=1), pe.shape[1]


def forward_train(params, batch: dict, cfg: ModelConfig, *,
                  moe_dispatch: bool = False):
    """Returns (loss, metrics ``{"xent", "aux"}``, plus ``"mtp"`` for an MTP
    config). batch: ``tokens`` (B, S) int, optional ``positions`` (B, S),
    ``loss_mask`` (B, S), for a VLM ``patch_embeds`` (B, P, d): prepended
    to the token stream, the positions extended on the left (the prefix
    takes 0..P-1, the tokens shift by P), the prefix cut before the logits;
    for an enc-dec config ``frames`` (B, Se, d), the encoder's input. Loss:
    next-token cross entropy on the token positions 1..S-1 under the mask,
    plus 0.01 times the MoE aux loss summed over layers (the encoder's
    too), plus 0.3 times the MTP loss: the final-normed hidden state of
    positions 0..S-3 and the embeddings of tokens 1..S-2 through
    ``mtp_proj``, ``mtp_layer`` and ``mtp_norm`` predict tokens 2..S-1."""
    check_family(cfg)
    tokens = batch["tokens"]
    x, prefix = _with_prefix(params, batch, cfg)
    enc_out, aux_enc = None, 0.0
    if cfg.is_encdec:
        enc_out, aux_enc = _encoder_forward(
            params, batch["frames"].to(x.dtype), cfg,
            moe_dispatch=moe_dispatch)
    positions = batch.get("positions")
    if positions is not None and x.shape[1] != positions.shape[1]:
        pre = x.shape[1] - positions.shape[1]
        positions = torch.cat(
            [torch.arange(pre, device=x.device).expand(x.shape[0], pre),
             positions + pre], dim=1)
    x, aux = _run_layers(params["layers"], x, cfg, positions=positions,
                         enc_out=enc_out, moe_dispatch=moe_dispatch)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, prefix:]
    logits = _lm_logits(params, x)
    labels = tokens[:, 1:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    loss = softmax_xent(logits[:, :-1], labels, mask[:, 1:])
    metrics = {"xent": loss, "aux": aux + aux_enc}
    loss = loss + 0.01 * (aux + aux_enc)
    if cfg.mtp:
        nxt = _embed_tokens(params, tokens[:, 1:-1])
        hm = torch.cat([x[:, :-2], nxt], dim=-1).to(x.dtype) \
            @ params["mtp_proj"]
        hm, _ = _layer_fwd(params["mtp_layer"], hm, cfg)
        hm = rms_norm(hm, params["mtp_norm"], cfg.norm_eps)
        mtp = softmax_xent(_lm_logits(params, hm), tokens[:, 2:],
                           mask[:, 2:])
        metrics["mtp"] = mtp
        loss = loss + 0.3 * mtp
    return loss, metrics


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------
def _layer_extend(p, x, cache, cfg: ModelConfig, *, flash: bool = True):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if "mixer" in p:
        h, cache["state"], tail = ssm.mamba_forward(
            p["mixer"], h, cfg, init_state=cache["state"],
            conv_init=cache["conv"], return_state=True)
        cache["conv"] = tail.to(cache["conv"].dtype)
    else:
        h, cache = attn.attention_extend(p["attn"], h, cache, cfg,
                                         flash=flash)
    x = x + h
    if "cross" in p:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + attn.cross_extend(p["cross"], hx, cache, flash=flash)
    return _ffn(p, x, cfg)[0], cache


def _layer_decode(p, x1, cache, cfg: ModelConfig):
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    if "mixer" in p:
        h, cache = ssm.mamba_decode(p["mixer"], h, cache, cfg)
    else:
        h, cache = attn.attention_decode(p["attn"], h, cache, cfg)
    x1 = x1 + h
    if "cross" in p:
        hx = rms_norm(x1, p["ln_x"], cfg.norm_eps)
        x1 = x1 + attn.cross_decode(p["cross"], hx, cache)
    return _ffn(p, x1, cfg)[0], cache


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int, *,
                enc_out=None) -> list:
    """One cache per layer, on the parameters' device: a ring buffer for an
    attention layer, the (f32) SSM state and conv tail for a mixer. With
    ``enc_out``, each enc-dec decoder layer's cross-attention k and v of
    it, projected once (``enc_k``, ``enc_v``)."""
    dev = params["embed"].device
    caches = []
    for p in params["layers"]:
        c = (ssm.init_mamba_cache(cfg, batch, device=dev) if "mixer" in p
             else attn.init_cache(cfg, batch, cache_len, device=dev))
        if "cross" in p and enc_out is not None:
            c["enc_k"], c["enc_v"] = attn.cross_kv(p["cross"], enc_out)
        caches.append(c)
    return caches


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
    """Chunked prefill of ``batch["tokens"]`` (B, S), after a VLM batch's
    ``patch_embeds``; an enc-dec batch's ``frames`` (B, Se, d) go through
    the encoder first, whose output every decoder layer's cross-attention
    reads. Returns (last-token logits (B, 1, V) f32, caches).
    ``flash=False`` keeps every chunk, the encoder and the cross-attention
    on the masked attention route (``models/attention.py``)."""
    x, _ = _with_prefix(params, batch, cfg)
    B, S = x.shape[:2]
    enc_out = None
    if cfg.is_encdec:
        enc_out, _ = _encoder_forward(params, batch["frames"].to(x.dtype),
                                      cfg, flash=flash)
    caches = init_caches(params, cfg, B, cache_len, enc_out=enc_out)
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
