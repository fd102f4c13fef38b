"""Weights between the JAX package's LM parameter tree and the port's.

JAX stacks each segment's layers: ``tree["segments"][i]["slots"][s]`` is a
slot's parameter dict whose leaves carry a leading ``groups`` dimension,
and the scan runs group-major (group 0's slots, then group 1's, ...).
granite-3-2b is one segment of 40 groups of one slot. The port keeps one
dict per layer in that order (``models/transformer.py``). Both directions
move no bits: f32 leaves stay f32, bf16 leaves cross as raw 16-bit words.
The optional ``lm_head`` (untied embeddings) and the QKV biases ride
along. Families other than dense raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_family, segments_of
from repro_torch.train.checkpoint import numpy_to_tensor

_LAYER_KEYS = {"ln1", "attn", "ln2", "ffn"}
_TOP_KEYS = {"embed", "final_norm", "segments", "lm_head"}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def layers_from_segments(segments) -> list[dict]:
    """Unstack JAX segments (leaves with a leading groups dim) into one
    dict per layer, group-major. Works for parameters (``{"slots": [...]}``
    per segment) and caches (a list of slots per segment) alike."""
    layers = []
    for seg in segments:
        slots = seg["slots"] if isinstance(seg, dict) else seg
        groups = len(next(iter(_leaves(slots[0]))))
        for g in range(groups):
            for slot in slots:
                layers.append(_map(slot, lambda a, g=g: a[g]))
    return layers


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_jax(tree: dict, *, device="cpu") -> dict:
    """The port's parameters from the JAX tree (numpy or JAX arrays)."""
    stray = set(tree) - _TOP_KEYS
    if stray:
        raise NotImplementedError(f"params_from_jax: {sorted(stray)} belong to "
                                  f"a family not ported yet (ROADMAP.md)")

    def tensor(a):
        return numpy_to_tensor(np.asarray(a)).to(device)

    layers = layers_from_segments(tree["segments"])
    for p in layers:
        if set(p) - _LAYER_KEYS or "wdq" in p.get("attn", {}):
            raise NotImplementedError(
                f"params_from_jax: layer keys {sorted(p)} (attn "
                f"{sorted(p.get('attn', {}))}) are not the dense family's")
    out = {"embed": tensor(tree["embed"]),
           "final_norm": tensor(tree["final_norm"]),
           "layers": [_map(p, tensor) for p in layers]}
    if "lm_head" in tree:
        out["lm_head"] = tensor(tree["lm_head"])
    return out


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: a JAX-layout tree of numpy
    arrays, layers restacked by ``segments_of(cfg)``. f32 only (numpy has
    no bf16 without ml_dtypes, which the port does not import)."""
    check_family(cfg)

    def array(t):
        if t.dtype == torch.bfloat16:
            raise ValueError("params_to_jax: bf16 leaves need ml_dtypes")
        return t.detach().cpu().numpy()

    layers = iter(params["layers"])
    segments = []
    for seg in segments_of(cfg):
        per_group = [[next(layers) for _ in seg.sig] for _ in range(seg.groups)]
        slots = []
        for s in range(len(seg.sig)):
            group_layers = [per_group[g][s] for g in range(seg.groups)]
            slots.append(_stack(group_layers, array))
        segments.append({"slots": slots})
    if next(layers, None) is not None:
        raise ValueError(f"params_to_jax: more layers than {cfg.num_layers}")
    tree = {"embed": array(params["embed"]),
            "final_norm": array(params["final_norm"]), "segments": segments}
    if "lm_head" in params:
        tree["lm_head"] = array(params["lm_head"])
    return tree


def _stack(dicts, array):
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts], array) for k in first}
    return np.stack([array(t) for t in dicts])
