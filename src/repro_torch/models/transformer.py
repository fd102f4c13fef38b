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
dense oracle, as JAX serves without a mesh. Training attention runs in
query chunks of 1,024, and with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``).

On a mesh (``mesh``, a ``sharding.mesh.Mesh`` with its batch axes set,
and ``specs``, ``param_shardings`` of the whole tree) every entry takes
this rank's parameter shards and batch rows: attention heads, FFN width
and the vocabulary (the embedding lookup, the logits and a vocab-parallel
cross entropy) split over "model" where ``spec_for`` sharded them so,
every other sharded leaf gathered just before its layer uses it, MoE
layers expert-parallel; the caches are the rank's shards by
``cache_shardings`` (:class:`ShardedCaches`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import mlp
from repro_torch.models.common import embed_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard
from repro_torch.sharding.specs import cache_shardings


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
def _init_layer(key, cfg: ModelConfig, ltype: str, is_moe: bool, device, *,
                cross: bool = False) -> dict:
    """One layer from ``split(key, 6)``, as JAX's ``_init_slot``: the
    attention or mixer from key 0, the cross-attention from 1, the FFN or
    MoE from 2."""
    dt = getattr(torch, cfg.param_dtype)
    ks = prng.split(key, 6)
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device)}
    if ltype == "A":
        p["attn"] = attn.init_attention_params(ks[0], cfg, device=device)
    else:
        p["mixer"] = ssm.init_mamba_params(ks[0], cfg, device=device)
    if cross:
        p["ln_x"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["cross"] = attn.init_attention_params(ks[1], cfg, cross=True,
                                                device=device)
    if cfg.d_ff > 0 or is_moe:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        if is_moe:
            p["moe"] = mlp.init_moe_params(ks[2], cfg, device=device)
        else:
            p["ffn"] = mlp.init_ffn_params(ks[2], cfg.d_model, cfg.d_ff, dt,
                                           device=device)
    return p


def _init_layers(key, segs: list[Segment], cfg: ModelConfig, device, *,
                 cross: bool) -> list[dict]:
    """The layers of ``segs`` in group-major order, each from JAX's key:
    segment i's ``fold_in(key, i)``, folded with the slot, split into the
    segment's groups (``_init_segment``)."""
    layers = []
    for i, seg in enumerate(segs):
        skey = prng.fold_in(key, i)
        gks = [prng.split(prng.fold_in(skey, s), seg.groups)
               for s in range(len(seg.sig))]
        for g in range(seg.groups):
            for s, (ltype, is_moe) in enumerate(seg.sig):
                layers.append(_init_layer(gks[s][g], cfg, ltype, is_moe,
                                          device, cross=cross))
    return layers


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
    """Random weights made on ``device``: JAX's ``init_params(PRNGKey(seed),
    cfg)`` leaf for leaf (its key tree: ``split(key, 8)`` at the root, then
    each segment's and layer's keys as :func:`_init_layers` folds them)."""
    check_family(cfg)
    ks = prng.split(prng.key(seed), 8)
    dt = getattr(torch, cfg.param_dtype)
    params = {
        "embed": embed_init(ks[0], (cfg.vocab_size, cfg.d_model), dtype=dt,
                            device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "layers": _init_layers(ks[1], segments_of(cfg), cfg, device,
                               cross=cfg.is_encdec),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(ks[2], (cfg.d_model, cfg.vocab_size),
                                       dtype=dt, device=device)
    if cfg.is_encdec:
        # the encoder's layers with MLA off
        enc = dataclasses.replace(cfg, mla=False)
        params["enc_layers"] = _init_layers(
            ks[3], segments_of(cfg, cfg.encoder_layers), enc, device,
            cross=False)
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=device)
    if cfg.mtp:
        params["mtp_proj"] = embed_init(ks[4], (2 * cfg.d_model, cfg.d_model),
                                        dtype=dt, device=device)
        params["mtp_layer"] = _init_layer(ks[5], cfg, "A", False, device)
        params["mtp_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=device)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """:func:`init_params`'s tree on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated or drawn (JAX's ``eval_shape`` of
    its init)."""
    with torch.device("meta"):
        return init_params(cfg)


# --------------------------------------------------------------------------
# layer body, embedding, head
# --------------------------------------------------------------------------
def _w(p, spec, name, mesh):
    """Leaf ``name`` of ``p`` for compute: whole (gathered on a mesh)."""
    return p[name] if mesh is None else shard.whole(p[name], spec[name], mesh)


def _sub(spec, name):
    return None if spec is None else spec[name]


def _ffn(p, x, cfg: ModelConfig, *, moe_dispatch: bool = False, mesh=None,
         spec=None):
    """The layer's FFN or MoE block with its residual: (x, MoE aux or
    None)."""
    if "moe" in p:
        h2 = rms_norm(x, _w(p, spec, "ln2", mesh), cfg.norm_eps)
        y, aux = mlp.moe_forward(p["moe"], h2, cfg, dispatch=moe_dispatch,
                                 mesh=mesh, spec=_sub(spec, "moe"))
        return x + y, aux
    if "ffn" in p:
        h2 = rms_norm(x, _w(p, spec, "ln2", mesh), cfg.norm_eps)
        y = (mlp.ffn_forward(p["ffn"], h2) if mesh is None else
             mlp.ffn_sharded(p["ffn"], h2, mesh, spec["ffn"]))
        x = x + y
    return x, None


def _layer_fwd(p, x, cfg: ModelConfig, *, positions=None, enc_out=None,
               moe_dispatch: bool = False, flash: bool = False, mesh=None,
               spec=None):
    h = rms_norm(x, _w(p, spec, "ln1", mesh), cfg.norm_eps)
    if "mixer" in p:
        mixer = p["mixer"] if mesh is None else \
            shard.whole_tree(p["mixer"], spec["mixer"], mesh)
        h = ssm.mamba_forward(mixer, h, cfg)
    else:
        h = attn.attention_forward(p["attn"], h, cfg, positions=positions,
                                   flash=flash, mesh=mesh,
                                   spec=_sub(spec, "attn"))
    x = x + h
    if "cross" in p:
        hx = rms_norm(x, _w(p, spec, "ln_x", mesh), cfg.norm_eps)
        x = x + attn.attention_forward(p["cross"], hx, cfg, enc_out=enc_out,
                                       mesh=mesh, spec=_sub(spec, "cross"))
    return _ffn(p, x, cfg, moe_dispatch=moe_dispatch, mesh=mesh, spec=spec)


def _run_layers(layers, x, cfg: ModelConfig, *, positions=None,
                enc_out=None, moe_dispatch: bool = False,
                flash: bool = False, mesh=None, specs=None):
    """Full-sequence forward through every layer: (x, the MoE aux loss
    summed over layers, f32). With ``cfg.remat`` and gradients on
    (training), each layer runs under ``torch.utils.checkpoint``, as JAX
    wraps ``_layer_fwd`` in ``jax.checkpoint``: its activations are
    recomputed in the backward pass instead of kept."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(layers):
        kw = dict(cfg=cfg, moe_dispatch=moe_dispatch, flash=flash, mesh=mesh,
                  spec=None if specs is None else specs[i])
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer_remat, p, x, positions, enc_out, kw,
                use_reentrant=False)
        else:
            x, aux = _layer_fwd(p, x, positions=positions, enc_out=enc_out,
                                **kw)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _layer_remat(p, x, positions, enc_out, kw):
    return _layer_fwd(p, x, positions=positions, enc_out=enc_out, **kw)


def _run_segments(layers, x, cfg: ModelConfig, *, positions=None,
                  enc_out=None):
    """Full-sequence forward through every layer (training-forward math,
    which prefill is held against)."""
    return _run_layers(layers, x, cfg, positions=positions,
                       enc_out=enc_out)[0]


def _encoder_forward(params, frames, cfg: ModelConfig, *,
                     moe_dispatch: bool = False, flash: bool = False,
                     mesh=None, specs=None):
    """The encoder over ``frames`` (B, Se, d): causal self-attention with
    RoPE at positions 0..Se-1, as JAX's reference runs it, then
    ``enc_norm``. ``flash`` takes the flash kernel (prefill). Returns
    (enc_out, the encoder's MoE aux loss)."""
    x, aux = _run_layers(params["enc_layers"], frames, cfg,
                         moe_dispatch=moe_dispatch, flash=flash, mesh=mesh,
                         specs=_sub(specs, "enc_layers"))
    return rms_norm(x, _w(params, specs, "enc_norm", mesh),
                    cfg.norm_eps), aux


def _vocab_view(params, specs, name, mesh):
    """(leaf ``name`` for compute, first vocab row it holds or None when
    whole): the vocabulary split over "model" where ``spec_for`` put it
    there (``embed`` dim 0, ``lm_head`` dim 1), else gathered whole."""
    dim = 0 if name == "embed" else 1
    view, split = shard.block_view({name: params[name]},
                                   {name: specs[name]}, mesh, {name: dim})
    t = view[name]
    if not split:
        return t, None
    return t, mesh.group("model").index * t.shape[dim]


def _embed_tokens(params, tokens, mesh=None, specs=None):
    """The token embeddings; on a mesh with the vocabulary split, each
    rank looks up the rows it holds (zero elsewhere), summed over
    "model"."""
    if mesh is None:
        return params["embed"][tokens]
    table, v0 = _vocab_view(params, specs, "embed", mesh)
    if v0 is None:
        return table[tokens]
    local = tokens.long() - v0
    inside = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return shard.all_reduce(x, mesh, "model")


def _lm_logits(params, x, mesh=None, specs=None, *, whole: bool = True):
    """Logits in f32. On a mesh: over this rank's vocabulary slice where
    the head (``lm_head``, or ``embed`` when tied) is split over "model";
    ``whole`` gathers the slices (serving). Returns the logits, and on a
    mesh with ``whole=False`` also the slice's first vocab id (None when
    the logits are whole)."""
    if mesh is None:
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        return (x @ head).float()
    if "lm_head" in params:
        head, v0 = _vocab_view(params, specs, "lm_head", mesh)
    else:
        head, v0 = _vocab_view(params, specs, "embed", mesh)
        head = head.T
    logits = (x @ head).float()
    if whole:
        return logits if v0 is None else shard.all_gather(
            logits, mesh, "model", logits.ndim - 1)
    return logits, v0


def softmax_xent(logits, labels, mask):
    """logits (B,S,V) f32, labels (B,S) int, mask (B,S)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _xent_share(logits, v0, labels, mask, mesh):
    """This rank's share of :func:`softmax_xent` over the global batch: its
    rows' masked nll sum over the global mask count, over the ranks that
    hold the same rows. With ``v0`` (the vocabulary split over "model"),
    the max, the sum of exponentials and the label's logit are each
    reduced over "model"."""
    if v0 is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None].long())[..., 0]
    else:
        mx = shard.all_reduce_(logits.detach().amax(dim=-1), mesh, "model",
                               op=torch.distributed.ReduceOp.MAX)
        se = shard.all_reduce((logits - mx[..., None]).exp().sum(dim=-1),
                              mesh, "model")
        lse = se.log() + mx
        local = labels.long() - v0
        inside = (local >= 0) & (local < logits.shape[-1])
        ll = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None]
                           )[..., 0]
        ll = shard.all_reduce(torch.where(inside, ll, torch.zeros_like(ll)),
                              mesh, "model")
    nll = ((lse - ll) * mask).sum()
    count = mask.sum().detach()
    if mesh.b_axes:
        count = shard.all_reduce_(count, mesh, mesh.b_axes)
    reps = mesh.size // mesh.axis_size(mesh.b_axes)
    return nll / torch.clamp(count, min=1.0) / reps


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------
def _with_prefix(params, batch: dict, cfg: ModelConfig, mesh=None,
                 specs=None):
    """The token embeddings, after a VLM batch's ``patch_embeds`` (cast to
    their dtype) where the config is a vision one: (x, prefix length)."""
    x = _embed_tokens(params, batch["tokens"], mesh, specs)
    pe = batch.get("patch_embeds")
    if cfg.modality != "vision" or pe is None:
        return x, 0
    return torch.cat([pe.to(x.dtype), x], dim=1), pe.shape[1]


def forward_train(params, batch: dict, cfg: ModelConfig, *,
                  moe_dispatch: bool = False, mesh=None, specs=None):
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
    ``mtp_proj``, ``mtp_layer`` and ``mtp_norm`` predict tokens 2..S-1.

    ``mesh`` (a ``sharding.mesh.Mesh`` whose ``b_axes`` split the global
    batch, ``Mesh.for_batch``) with ``specs`` (``param_shardings`` of the
    whole tree): ``params`` are this rank's shards and ``batch`` its rows.
    The loss returned is then this rank's share (the shares sum to the
    loss over the global batch; the gradients of the shares, summed over
    the ranks that hold a leaf, are the loss's), and the metrics are the
    global values, detached."""
    check_family(cfg)
    tokens = batch["tokens"]
    x, prefix = _with_prefix(params, batch, cfg, mesh, specs)
    enc_out, aux_enc = None, 0.0
    if cfg.is_encdec:
        enc_out, aux_enc = _encoder_forward(
            params, batch["frames"].to(x.dtype), cfg,
            moe_dispatch=moe_dispatch, mesh=mesh, specs=specs)
    positions = batch.get("positions")
    if positions is not None and x.shape[1] != positions.shape[1]:
        pre = x.shape[1] - positions.shape[1]
        positions = torch.cat(
            [torch.arange(pre, device=x.device).expand(x.shape[0], pre),
             positions + pre], dim=1)
    x, aux = _run_layers(params["layers"], x, cfg, positions=positions,
                         enc_out=enc_out, moe_dispatch=moe_dispatch,
                         mesh=mesh, specs=_sub(specs, "layers"))
    x = rms_norm(x, _w(params, specs, "final_norm", mesh),
                 cfg.norm_eps)[:, prefix:]
    labels = tokens[:, 1:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    if mesh is None:
        loss = softmax_xent(_lm_logits(params, x)[:, :-1], labels,
                            mask[:, 1:])
    else:
        logits, v0 = _lm_logits(params, x, mesh, specs, whole=False)
        loss = _xent_share(logits[:, :-1], v0, labels, mask[:, 1:], mesh)
    metrics = {"xent": loss, "aux": aux + aux_enc}
    # on a mesh the aux loss is the same on every rank: a share of 1/size
    share = 1.0 if mesh is None else 1.0 / mesh.size
    loss = loss + 0.01 * (aux + aux_enc) * share
    if cfg.mtp:
        nxt = _embed_tokens(params, tokens[:, 1:-1], mesh, specs)
        hm = torch.cat([x[:, :-2], nxt], dim=-1).to(x.dtype) \
            @ _w(params, specs, "mtp_proj", mesh)
        hm, _ = _layer_fwd(params["mtp_layer"], hm, cfg, mesh=mesh,
                           spec=_sub(specs, "mtp_layer"))
        hm = rms_norm(hm, _w(params, specs, "mtp_norm", mesh), cfg.norm_eps)
        if mesh is None:
            mtp = softmax_xent(_lm_logits(params, hm), tokens[:, 2:],
                               mask[:, 2:])
        else:
            logits, v0 = _lm_logits(params, hm, mesh, specs, whole=False)
            mtp = _xent_share(logits, v0, tokens[:, 2:], mask[:, 2:], mesh)
        metrics["mtp"] = mtp
        loss = loss + 0.3 * mtp
    if mesh is not None:
        metrics = {k: shard.all_reduce_(v.detach(), mesh, mesh.axis_names)
                   if k != "aux" else v.detach()
                   for k, v in metrics.items()}
    return loss, metrics


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------
def _layer_extend(p, x, cache, cfg: ModelConfig, *, flash: bool = True,
                  mesh=None, spec=None):
    h = rms_norm(x, _w(p, spec, "ln1", mesh), cfg.norm_eps)
    if "mixer" in p:
        mixer = p["mixer"] if mesh is None else \
            shard.whole_tree(p["mixer"], spec["mixer"], mesh)
        h, cache["state"], tail = ssm.mamba_forward(
            mixer, h, cfg, init_state=cache["state"],
            conv_init=cache["conv"], return_state=True)
        cache["conv"] = tail.to(cache["conv"].dtype)
    else:
        h, cache = attn.attention_extend(p["attn"], h, cache, cfg,
                                         flash=flash, mesh=mesh,
                                         spec=_sub(spec, "attn"))
    x = x + h
    if "cross" in p:
        hx = rms_norm(x, _w(p, spec, "ln_x", mesh), cfg.norm_eps)
        x = x + attn.cross_extend(p["cross"], hx, cache, flash=flash,
                                  cfg=cfg, mesh=mesh,
                                  spec=_sub(spec, "cross"))
    return _ffn(p, x, cfg, mesh=mesh, spec=spec)[0], cache


def _layer_decode(p, x1, cache, cfg: ModelConfig, *, mesh=None, spec=None):
    h = rms_norm(x1, _w(p, spec, "ln1", mesh), cfg.norm_eps)
    if "mixer" in p:
        mixer = p["mixer"] if mesh is None else \
            shard.whole_tree(p["mixer"], spec["mixer"], mesh)
        h, cache = ssm.mamba_decode(mixer, h, cache, cfg)
    else:
        h, cache = attn.attention_decode(p["attn"], h, cache, cfg, mesh=mesh,
                                         spec=_sub(spec, "attn"))
    x1 = x1 + h
    if "cross" in p:
        hx = rms_norm(x1, _w(p, spec, "ln_x", mesh), cfg.norm_eps)
        x1 = x1 + attn.cross_decode(p["cross"], hx, cache, cfg=cfg,
                                    mesh=mesh, spec=_sub(spec, "cross"))
    return _ffn(p, x1, cfg, mesh=mesh, spec=spec)[0], cache


class ShardedCaches(list):
    """A rank's caches (one dict per layer, each leaf this rank's shard)
    with their specs (``specs.cache_shardings``) in ``.specs``."""

    def __init__(self, caches, specs):
        super().__init__(caches)
        self.specs = specs


# the cache leaves that follow a split block's kv heads (dim 2)
_HEAD_CACHES = {"attn": ("k", "v"), "cross": ("enc_k", "enc_v")}


def _cache_wants(p, spec, cache, cspec):
    """Each tensor leaf's (layout, compute layout): its spec less the
    batch entry (the caches hold this rank's rows), with "model" kept only
    on the kv heads (dim 2) of a block whose heads are split."""
    keep = {n for block, names in _HEAD_CACHES.items()
            if block in p and shard.is_split(p[block], spec[block],
                                             shard.HEAD_DIMS)
            for n in names}
    wants = {}
    for n, s in cspec.items():
        if not torch.is_tensor(cache[n]):
            continue
        ents = [None, *tuple(s)[1:]]
        ents += [None] * (cache[n].ndim - len(ents))
        wants[n] = (shard.P(*ents), shard.P(*(
            e if n in keep and d == 2 else None for d, e in enumerate(ents))))
    return wants


def _with_cache_views(step, p, x, cache, cspec, mesh, spec):
    """``step(p, x, view)`` on the compute view of a rank's cache: leaves
    whose model dim the compute does not split are gathered whole, and the
    rank's blocks of what the step wrote go back into its shards."""
    wants = {n: w for n, w in _cache_wants(p, spec, cache, cspec).items()
             if w[0] != w[1]}
    view = dict(cache)
    for n, (have, want) in wants.items():
        view[n] = shard.to_layout(cache[n], have, want, mesh)
    x, view = step(p, x, view)
    for n, v in view.items():
        cache[n] = (shard.to_layout(v, wants[n][1], wants[n][0], mesh).clone()
                    if n in wants else v)
    return x, cache


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int, *,
                enc_out=None, mesh=None, specs=None) -> list:
    """One cache per layer, on the parameters' device: a ring buffer for an
    attention layer, the (f32) SSM state and conv tail for a mixer. With
    ``enc_out``, each enc-dec decoder layer's cross-attention k and v of
    it, projected once (``enc_k``, ``enc_v``). On a mesh (``batch`` this
    rank's rows of the global batch): a :class:`ShardedCaches` of this
    rank's shards by ``cache_shardings``."""
    dev = params["embed"].device
    caches = []
    for i, p in enumerate(params["layers"]):
        c = (ssm.init_mamba_cache(cfg, batch, device=dev) if "mixer" in p
             else attn.init_cache(cfg, batch, cache_len, device=dev))
        if "cross" in p and enc_out is not None:
            cross = p["cross"] if mesh is None else \
                shard.whole_tree(p["cross"], specs["layers"][i]["cross"],
                                 mesh)
            c["enc_k"], c["enc_v"] = attn.cross_kv(cross, enc_out)
        caches.append(c)
    if mesh is None:
        return caches
    B = batch * mesh.axis_size(mesh.b_axes)
    cspecs = cache_shardings(caches, B, mesh)
    for c, cs in zip(caches, cspecs):
        for n, s in cs.items():
            if torch.is_tensor(c[n]):
                c[n] = shard.local_shard(c[n], shard.P(None, *tuple(s)[1:]),
                                         mesh)
    return ShardedCaches(caches, cspecs)


def _run_segments_cached(params, x, caches, layer_step, *, mesh=None,
                         specs=None):
    """The prefill-extend and decode loop: every layer in the scan's
    group-major order, each updating its cache in place (on a mesh, its
    shards through :func:`_with_cache_views`)."""
    new = []
    for i, (p, c) in enumerate(zip(params["layers"], caches)):
        if mesh is None:
            x, c = layer_step(p, x, c)
        else:
            spec = specs["layers"][i]
            x, c = _with_cache_views(
                lambda p, x, c, spec=spec: layer_step(p, x, c, spec=spec),
                p, x, c, caches.specs[i], mesh, spec)
        new.append(c)
    return x, (new if mesh is None else ShardedCaches(new, caches.specs))


def extend_chunk(params, x, caches, cfg: ModelConfig, *, flash: bool = True,
                 mesh=None, specs=None):
    """Run one chunk of tokens through all layers, updating caches."""
    return _run_segments_cached(
        params, x, caches,
        lambda p, x, c, spec=None: _layer_extend(p, x, c, cfg, flash=flash,
                                                 mesh=mesh, spec=spec),
        mesh=mesh, specs=specs)


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, *,
            flash: bool = True, mesh=None, specs=None):
    """Chunked prefill of ``batch["tokens"]`` (B, S), after a VLM batch's
    ``patch_embeds``; an enc-dec batch's ``frames`` (B, Se, d) go through
    the encoder first, whose output every decoder layer's cross-attention
    reads. Returns (last-token logits (B, 1, V) f32, caches).
    ``flash=False`` keeps every chunk, the encoder and the cross-attention
    on the masked attention route (``models/attention.py``). ``mesh``
    (``b_axes`` set by ``Mesh.for_batch``) with ``specs``: this rank's
    parameter shards and batch rows; the logits are its rows', over the
    whole vocabulary."""
    x, _ = _with_prefix(params, batch, cfg, mesh, specs)
    B, S = x.shape[:2]
    enc_out = None
    if cfg.is_encdec:
        enc_out, _ = _encoder_forward(params, batch["frames"].to(x.dtype),
                                      cfg, flash=flash, mesh=mesh,
                                      specs=specs)
    caches = init_caches(params, cfg, B, cache_len, enc_out=enc_out,
                         mesh=mesh, specs=specs)
    chunk = cfg.prefill_chunk or S
    if S % chunk != 0:
        raise ValueError(f"prefill length {S} not divisible by chunk {chunk}")
    for i in range(0, S, chunk):
        xi, caches = extend_chunk(params, x[:, i:i + chunk], caches, cfg,
                                  flash=flash, mesh=mesh, specs=specs)
    h_last = rms_norm(xi[:, -1:], _w(params, specs, "final_norm", mesh),
                      cfg.norm_eps)
    return _lm_logits(params, h_last, mesh, specs), caches


def decode_step(params, token1, caches, cfg: ModelConfig, *, mesh=None,
                specs=None):
    """One serve step: token1 (B, 1) -> (logits (B, 1, V) f32, caches).
    ``mesh``/``specs``: as :func:`prefill`, with its caches."""
    x = _embed_tokens(params, token1, mesh, specs)
    x, caches = _run_segments_cached(
        params, x, caches,
        lambda p, x, c, spec=None: _layer_decode(p, x, c, cfg, mesh=mesh,
                                                 spec=spec),
        mesh=mesh, specs=specs)
    x = rms_norm(x, _w(params, specs, "final_norm", mesh), cfg.norm_eps)
    return _lm_logits(params, x, mesh, specs), caches
