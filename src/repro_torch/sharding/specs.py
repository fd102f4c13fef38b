"""Sharding rules: hierarchical tensor/expert parallel + best-effort FSDP.

The port of the JAX package's ``sharding/specs.py`` and of
``cache_shardings`` (``train/serve_step.py``), line for line. The paper's
two-level partitioning (the fast axis shards the hot dimension, the slow
axes shard the bulk) as a rule engine:

* each parameter name has a preferred tensor-parallel dim, sharded over
  ``"model"`` when it divides (attention heads, FFN width, experts, the
  vocabulary);
* large parameters also shard one remaining dim over the slow (``"pod"``,
  ``"data"``) axes, FSDP-style;
* anything that does not divide falls back to fewer axes.

A spec is a :class:`P`: one entry per leading dimension, each None, an
axis name or a tuple of axis names (row-major over them, as JAX numbers
devices). A mesh is anything with ``.shape`` (axis name -> size) and
``.axis_names`` (``sharding/mesh.py``'s :class:`Mesh`, or a duck mesh).

The port keeps one dict per layer where JAX stacks a segment's layers
(``models/convert.py``): :func:`param_shardings` applies the rule to the
JAX-layout stacked leaf (whose leading group dim is never sharded) and
gives each layer that spec without the group dim. Optimizer state takes
the rule by its own leaf names, as JAX shards it: AdamW's ``m``/``v``
inherit the parameter's name, Adafactor's ``vr``/``vc``/``v`` take the
default rule (:func:`state_shardings`).
"""
from __future__ import annotations

import numpy as np

# preferred (model-axis dim, data-axes dim) per param leaf name; dims are
# tried in order, first divisible wins.
_PREFERRED: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    "embed":    ((0,), (1,)),     # vocab over model, d over data
    "lm_head":  ((1,), (0,)),
    "wq":       ((1,), (0,)),     # heads over model, d over data
    "wk":       ((1,), (0,)),
    "wv":       ((1,), (0,)),
    "wo":       ((0,), (2,)),
    "bq":       ((0,), ()),
    "bk":       ((0,), ()),
    "bv":       ((0,), ()),
    "w_gate":   ((1,), (0,)),     # ff over model (experts: the 3-D case)
    "w_up":     ((1,), (0,)),
    "w_down":   ((0,), (1,)),
    "router":   ((), ()),
    "wuq":      ((1,), (0,)),     # MLA: heads over model, rank over data
    "wuk":      ((1,), (0,)),
    "wuv":      ((1,), (0,)),
    "wdq":      ((), (0,)),
    "wdkv":     ((), (0,)),
    "wkr":      ((), ()),
    "in_proj":  ((), (0,)),       # mamba: keep concat dim whole
    "out_proj": ((0,), (1,)),
    "conv_w":   ((), ()),
    "mtp_proj": ((), (0,)),
}
# 3-D expert tensors (E, d, ff): experts over model, d over data
_PREFERRED_EXPERT = ((0,), (1,))
_BIG = 1 << 20
# the JAX tree's stacked keys and the port's per-layer lists
_STACKED = {"segments": "layers", "enc_segments": "enc_layers"}


class P(tuple):
    """A partition spec: ``P(None, "model", ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def axes_of(entry) -> tuple:
    """A spec entry as a tuple of axis names (None: ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_for(shape: tuple[int, ...], name: str, mesh,
             offset: int = 0) -> P:
    """offset=1 for scan-stacked layer params (leading group dim, which must
    never be sharded — each scan iteration slices one group)."""
    model_n = mesh.shape.get("model", 1)
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    data_n = int(np.prod([mesh.shape[a] for a in data_axes])) if data_axes else 1
    numel = int(np.prod(shape)) if shape else 0
    if numel < (1 << 16):   # norms/biases/small vectors: replicate
        return P()

    pref = _PREFERRED.get(name, ((0,), (1,)))
    expert_case = (name in ("w_gate", "w_up", "w_down")
                   and len(shape) - offset == 3)
    if expert_case:
        pref = _PREFERRED_EXPERT
    pref_m = tuple(d + offset for d in pref[0])
    pref_d = tuple(d + offset for d in pref[1])

    assignment: list = [None] * len(shape)

    # 2-D expert parallelism: expert dim over (data x model) jointly when it
    # divides the whole mesh (matches mlp.moe_forward's EP choice)
    if expert_case and data_axes and \
            shape[offset] % (model_n * data_n) == 0 and model_n * data_n > 1:
        assignment[offset] = (*data_axes, "model")
        return P(*assignment)

    def try_assign(dims: tuple[int, ...], axes, size: int) -> bool:
        for dim in dims:
            if offset <= dim < len(shape) and assignment[dim] is None \
                    and shape[dim] % size == 0 and size > 1:
                assignment[dim] = axes
                return True
        return False

    # 1) model axis on the preferred TP dim, falling back to any divisible dim
    if not try_assign(pref_m, "model", model_n):
        try_assign(tuple(i for i in range(offset, len(shape))
                         if i not in pref_d), "model", model_n)
    # 2) FSDP over the (pod, data) axes for big tensors
    if numel >= _BIG and data_axes:
        if not try_assign(pref_d, data_axes, data_n):
            ok = False
            if len(data_axes) > 1:  # try the trailing 'data' axis alone
                sub = data_axes[-1:]
                ok = try_assign(pref_d, sub, mesh.shape[sub[0]])
            if not ok:  # any other shardable dim
                try_assign(tuple(range(offset, len(shape))), data_axes, data_n)
    return P(*assignment)


def _walk(tree, fn, path=(), stacked=False):
    """``fn(path, leaf, stacked)`` over a tree of dicts and lists whose
    leaves have ``.shape``; ``stacked`` under a JAX segments key."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, (*path, k), stacked or k in _STACKED)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, (*path, i), stacked) for i, v in enumerate(tree)]
    return fn(path, tree, stacked)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _jax_specs(tree, mesh):
    return _walk(tree, lambda path, leaf, stacked: spec_for(
        tuple(leaf.shape), _leaf_name(path), mesh,
        offset=1 if stacked else 0))


class Shape:
    """A leaf that is only a shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return Shape(tree.shape)


def param_shardings(params, mesh, cfg=None):
    """Specs for a parameter (or optimizer-state) tree via the rule engine.

    A JAX-layout tree (``segments``/``enc_segments`` stacked) gets JAX's
    specs leaf for leaf. The port's tree (``layers``/``enc_layers``, one
    dict per layer) needs ``cfg``: each layer's leaves get the spec of the
    stacked leaf they belong to (``convert.stack_layers``), less its group
    dim."""
    if not any(k in params for k in _STACKED.values()):
        return _jax_specs(params, mesh)
    from repro_torch.models.convert import stack_layers

    shapes = stack_layers(_shapes(params), cfg,
                          stack=lambda ts: Shape((len(ts), *ts[0].shape)))
    specs = _jax_specs(shapes, mesh)
    out = {k: v for k, v in specs.items() if k not in _STACKED}
    for jax_key, key in _STACKED.items():
        if jax_key in specs:
            out[key] = [
                _walk(slot, lambda p, s, st: P(*s[1:]))
                for seg, seg_shapes in zip(specs[jax_key], shapes[jax_key])
                for _ in range(_groups(seg_shapes["slots"][0]))
                for slot in seg["slots"]]
    return out


def _groups(slot) -> int:
    while isinstance(slot, (dict, list)):
        slot = next(iter(slot.values())) if isinstance(slot, dict) else slot[0]
    return slot.shape[0]


def state_shardings(state, mesh):
    """Specs for an optimizer state in the JAX layout (``opt.init``'s): the
    rule by the state's own leaf names, stacked under ``segments``."""
    return _jax_specs(state, mesh)


def batch_spec(global_batch: int, mesh) -> P:
    """Shard the batch dim over as many slow axes as divide it."""
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    for k in range(len(data_axes), 0, -1):
        axes = data_axes[:k]
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if global_batch % n == 0 and n > 1:
            return P(axes)
    return P()


def batch_shardings(batch_specs: dict, global_batch: int, mesh):
    """A spec for each leaf of a batch: its leading dim by
    :func:`batch_spec`, the rest whole."""
    bs = batch_spec(global_batch, mesh)
    return {k: P(*bs, *(None,) * (len(v.shape) - 1))
            for k, v in batch_specs.items()}


# preferred model-axis dims per cache leaf in the JAX layout (G, B, ...):
# kv heads first, then head_dim; ssm state prefers heads.
_CACHE_PREF = {"k": (3, 4), "v": (3, 4), "enc_k": (3, 4), "enc_v": (3, 4),
               "ckv": (3,), "kr": (3,), "state": (2, 3, 4), "conv": (3,)}


def _cache_spec(name, shp, bspec, model_n, offset):
    """JAX's rule for one cache leaf; ``offset`` 1 with the group dim (the
    JAX layout), 0 without it (the port's per-layer caches)."""
    if name in ("t",) or len(shp) < 1 + offset:
        return P()
    spec = [None] * offset + [bspec] + [None] * (len(shp) - 1 - offset)
    for dim in _CACHE_PREF.get(name, ()):
        dim = dim - 1 + offset
        if dim < len(shp) and shp[dim] % model_n == 0 and model_n > 1:
            spec[dim] = "model"
            break
    return P(*spec)


def cache_shardings(caches, global_batch: int, mesh):
    """Cache specs: batch over the slow axes, heads (or head_dim / ssm
    heads) over "model". A JAX-layout cache tree (a list of segments, each
    a list of slots whose leaves lead with the scan-group dim) gets JAX's
    specs; the port's (a list of per-layer dicts) the same specs less the
    group dim. A leaf without a shape (the port's position counter ``t``)
    is replicated."""
    bs = batch_spec(global_batch, mesh)
    bspec = bs[0] if len(bs) else None
    model_n = mesh.shape.get("model", 1)
    offset = 1 if caches and isinstance(caches[0], list) else 0

    def one(path, leaf, stacked):
        if not hasattr(leaf, "shape"):
            return P()
        return _cache_spec(_leaf_name(path), tuple(leaf.shape), bspec,
                           model_n, offset)
    return _walk(caches, one)
