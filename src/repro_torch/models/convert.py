"""Weights between the JAX package's LM parameter tree and the port's.

JAX stacks each segment's layers: ``tree["segments"][i]["slots"][s]`` is a
slot's parameter dict whose leaves carry a leading ``groups`` dimension,
and the scan runs group-major (group 0's slots, then group 1's, ...).
granite-3-2b is one segment of 40 groups of one slot, phi3.5-moe one of
32, jamba one of L/8 groups of 8 slots (layer ``g * 8 + s``); a depth
that is not a whole number of periods falls back to one segment per
constant run (``segments_of``). The port keeps one dict per layer in that
order (``models/transformer.py``). Both directions move no bits: f32 leaves stay
f32, bf16 leaves cross as raw 16-bit words (JAX to the port). The optional
``lm_head`` (untied embeddings), the QKV biases, MLA's attention leaves, a
MoE layer's ``"moe"`` leaves (the router, the stacked ``(groups, E, ...)``
experts, the optional ``shared`` FFN) and an enc-dec decoder layer's
``ln_x`` and ``cross`` ride along. An encoder's ``enc_segments``
(stacked by ``segments_of(cfg, cfg.encoder_layers)``) become the port's
``enc_layers``; ``enc_norm``, ``mtp_proj``, ``mtp_layer`` and
``mtp_norm`` cross as they are (``mtp_layer`` is one layer, not stacked,
in both). :func:`params_from_arrays` rebuilds the parameters from a
checkpoint's flat ``a/0/b`` keys (``train/checkpoint.py::load_arrays``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_family, segments_of
from repro_torch.train.checkpoint import numpy_to_tensor

_LAYER_KEYS = {"ln1", "attn", "mixer", "ln_x", "cross", "ln2", "ffn", "moe"}
# the top-level leaves other than the stacked layers, which cross as they are
_PLAIN_KEYS = ("embed", "final_norm", "lm_head", "enc_norm", "mtp_proj",
               "mtp_layer", "mtp_norm")
# the JAX tree's stacked layers and the port's per-layer lists
_STACKED = {"segments": "layers", "enc_segments": "enc_layers"}
_TOP_KEYS = {*_PLAIN_KEYS, *_STACKED}


def layers_from_segments(segments) -> list[dict]:
    """Unstack JAX segments (leaves with a leading groups dim) into one
    dict per layer, group-major. Works for parameters (``{"slots": [...]}``
    per segment) and caches (a list of slots per segment) alike."""
    layers = []
    for seg in segments:
        slots = seg["slots"] if isinstance(seg, dict) else seg
        groups = len(tree_leaves(slots[0])[0])
        for g in range(groups):
            for slot in slots:
                layers.append(tree_map(lambda a, g=g: a[g], slot))
    return layers


def params_from_jax(tree: dict, *, device="cpu") -> dict:
    """The port's parameters from the JAX tree (numpy or JAX arrays)."""
    stray = set(tree) - _TOP_KEYS
    if stray:
        raise ValueError(f"params_from_jax: unknown top-level keys "
                         f"{sorted(stray)}")

    def tensor(a):
        return numpy_to_tensor(np.asarray(a)).to(device)

    out = {k: tree_map(tensor, tree[k]) for k in _PLAIN_KEYS if k in tree}
    for jax_key, key in _STACKED.items():
        if jax_key not in tree:
            continue
        layers = layers_from_segments(tree[jax_key])
        for p in layers:
            if set(p) - _LAYER_KEYS:
                raise ValueError(f"params_from_jax: unknown layer keys "
                                 f"{sorted(set(p) - _LAYER_KEYS)}")
        out[key] = [tree_map(tensor, p) for p in layers]
    return out


def restack(ts: list) -> torch.Tensor:
    """``torch.stack(ts)``; when ``ts`` are the consecutive views ``base[0],
    base[1], ...`` of one tensor (:func:`unstack_layers`'s leaves), that
    tensor itself, with no copy."""
    base = ts[0]._base
    if (base is not None and base.is_contiguous()
            and base.shape[0] == len(ts)
            and all(t._base is base and t.shape == base.shape[1:]
                    and t.stride() == base.stride()[1:]
                    and t.data_ptr() == base[i].data_ptr()
                    for i, t in enumerate(ts))):
        return base
    return torch.stack(ts)


def stack_layers(params: dict, cfg: ModelConfig, *, stack=restack) -> dict:
    """The JAX tree layout of the port's parameters (or of a tree shaped
    like them: gradients, per-layer state): each segment slot's layer
    leaves stacked along a leading groups dim by ``segments_of(cfg)`` (an
    encoder's by ``segments_of(cfg, cfg.encoder_layers)``; ``stack``: a
    copy, unless the layers are views of one stack already), the other
    top-level leaves, ``mtp_layer`` among them, as they are."""
    check_family(cfg)
    tree = {k: params[k] for k in _PLAIN_KEYS if k in params}
    tree["segments"] = _segments(params["layers"], segments_of(cfg), stack)
    if "enc_layers" in params:
        tree["enc_segments"] = _segments(
            params["enc_layers"], segments_of(cfg, cfg.encoder_layers), stack)
    return tree


def _segments(layers, segs, stack) -> list:
    layers = iter(layers)
    segments = []
    for seg in segs:
        per_group = [[next(layers) for _ in seg.sig] for _ in range(seg.groups)]
        slots = []
        for s in range(len(seg.sig)):
            group_layers = [per_group[g][s] for g in range(seg.groups)]
            slots.append(_stack(group_layers, stack))
        segments.append({"slots": slots})
    if next(layers, None) is not None:
        raise ValueError(f"stack_layers: more layers than "
                         f"{sum(seg.groups * len(seg.sig) for seg in segs)}")
    return segments


def unstack_layers(tree: dict) -> dict:
    """The inverse of :func:`stack_layers` on tensors: the port's layout
    whose layer leaves are views into the stacked ones (no copy)."""
    out = {k: tree[k] for k in _PLAIN_KEYS if k in tree}
    for jax_key, key in _STACKED.items():
        if jax_key in tree:
            out[key] = layers_from_segments(tree[jax_key])
    return out


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: a JAX-layout tree of numpy
    arrays, layers restacked by ``segments_of(cfg)``. f32 only (numpy has
    no bf16 without ml_dtypes, which the port does not import)."""
    def array(t):
        if t.dtype == torch.bfloat16:
            raise ValueError("params_to_jax: bf16 leaves need ml_dtypes")
        return t.detach().cpu().numpy()

    return stack_layers(tree_map(array, params), cfg, stack=np.stack)


def _stack(dicts, stack):
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts], stack) for k in first}
    return stack(dicts)


def params_from_arrays(arrays: dict, *, device="cpu") -> dict:
    """The port's parameters from a checkpoint of the JAX tree, as
    ``train/checkpoint.py::load_arrays`` returns it (``"segments/0/slots/0/
    attn/wq"`` -> tensor): the flat keys rebuilt into the tree (a numeric
    key part is a list index), then :func:`params_from_jax`."""
    tree: dict = {}
    for key, val in arrays.items():
        node, parts = tree, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val.numpy() if isinstance(val, torch.Tensor) else val
    return params_from_jax(_lists(tree), device=device)


def _lists(node):
    """Dicts whose keys are 0..n-1 as lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and \
            sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out
