"""Optimizers: SGD, AdamW, Adafactor (factored second moment).

A copy of the JAX package's ``train/optimizer.py`` on tensors: plain
tensor arithmetic under ``torch.no_grad()``, no ``torch.optim``, in JAX's
order of operations. Parameters are a tree of nested dicts and lists of
tensors; the state mirrors it leaf for leaf in the JAX layout (``{"_"}``
for SGD, ``{"m", "v"}`` for AdamW, ``{"f": {"vr", "vc"} | {"v"}}`` for
Adafactor), in f32 on the parameters' device. ``update(grads, state,
params, step)`` returns ``(new_params, new_state)``; the new parameters
keep their dtype.

On a mesh (``mesh`` and ``specs``, the JAX-layout specs of the
parameters, ``sharding/specs.py``) the tensors are this rank's shards,
and ``init`` takes the local parameter shards. SGD and AdamW are
elementwise, so their update is the one above on each shard (AdamW's
``m``/``v`` share the parameter's layout). Adafactor reduces across
shards: ``vr = mean(g², -1)``, ``vc = mean(g², -2)``, ``r = vr /
mean(vr, -1)`` and the RMS clip's ``mean(u²)`` each sum over every rank
that holds part of the reduced dims, and ``vr``/``vc``/``v`` are stored in
their own layout (the default rule by their leaf names, as JAX shards the
state), moved to and from the gradient's layout around the arithmetic.
Without a mesh every spec is whole, so each reduction is the local mean
and each move is the tensor itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.sharding import shard
from repro_torch.sharding.specs import P, Shape, state_shardings


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, step) -> (new_params, new_state)


def _unzip(tree, n: int):
    """A tree whose leaves are n-tuples (``tree_map`` of a function that
    returns n values) as n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in tree} for i in range(n))
    if isinstance(tree, list):
        parts = [_unzip(v, n) for v in tree]
        return tuple([p[i] for p in parts] for i in range(n))
    return tree


def _step_t(step, device) -> torch.Tensor:
    """JAX's ``step.astype(f32) + 1.0`` as an f32 scalar tensor."""
    return torch.as_tensor(step, device=device).to(torch.float32) + 1.0


def _size(mesh, axes) -> int:
    return 1 if mesh is None else mesh.axis_size(axes)


def global_shape(local_shape, spec, mesh) -> tuple:
    """The whole tensor's shape from a shard's and its spec."""
    ents = shard._entries(spec, len(local_shape))
    return tuple(n * _size(mesh, e) for n, e in zip(local_shape, ents))


def _local(shape, spec, mesh) -> tuple:
    ents = shard._entries(spec, len(shape))
    return tuple(n // _size(mesh, e) for n, e in zip(shape, ents))


def _factored_shapes(shape):
    if len(shape) >= 2:
        return {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
    return {"v": shape}


def _mean_over(x, dims: tuple, spec, mesh):
    """``x.mean(dims)`` of the whole tensor whose shard ``x`` (spec
    ``spec``) is: the local sum summed over the axes sharding ``dims``."""
    ents = shard._entries(spec, x.ndim, mesh)
    axes = tuple(a for a in (mesh.axis_names if mesh else ())
                 if any(a in ents[d] for d in dims))
    if not axes:
        return x.mean(dim=dims)
    n = mesh.axis_size(axes)
    for d in dims:
        n *= x.shape[d]
    return shard.all_reduce_(x.sum(dim=dims), mesh, axes) / n


def _drop(spec, ndim: int, *dims) -> P:
    ents = shard._entries(spec, ndim)
    return P(*(e for d, e in enumerate(ents) if d not in
               {x % ndim for x in dims}))


def make_optimizer(name: str, lr: float = 1e-4, *, wd: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   mesh=None, specs=None):
    def specs_of(params):
        return specs if mesh is not None else tree_map(lambda p: P(), params)

    if name == "sgd":
        def init(params):
            dev = tree_leaves(params)[0].device
            return {"_": torch.zeros((), device=dev)}

        @torch.no_grad()
        def update(grads, state, params, step):
            new = tree_map(lambda p, g: (p.float() - lr * g.float()
                                         ).to(p.dtype), params, grads)
            return new, state
        return Optimizer("sgd", init, update)

    if name == "adamw":
        def init(params):
            def z(p):
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            return {"m": tree_map(z, params), "v": tree_map(z, params)}

        @torch.no_grad()
        def update(grads, state, params, step):
            t = _step_t(step, tree_leaves(params)[0].device)
            c1 = 1 - torch.pow(b1, t)
            c2 = 1 - torch.pow(b2, t)

            def upd(p, g, m, v):
                g = g.float()
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mh = m / c1
                vh = v / c2
                delta = lr * (mh / (torch.sqrt(vh) + eps) + wd * p.float())
                return (p.float() - delta).to(p.dtype), m, v

            new_p, new_m, new_v = _unzip(
                tree_map(upd, params, grads, state["m"], state["v"]), 3)
            return new_p, {"m": new_m, "v": new_v}
        return Optimizer("adamw", init, update)

    if name == "adafactor":
        def state_specs(params, pspecs):
            """The factored moments' specs: the default rule by their
            names on the whole shapes (every spec whole without a mesh)."""
            shapes = {"f": tree_map(lambda p, s: {
                k: Shape(v) for k, v in _factored_shapes(
                    global_shape(p.shape, s, mesh)).items()}, params, pspecs)}
            if mesh is None:
                return tree_map(lambda s: P(), shapes)["f"]
            return state_shardings(shapes, mesh)["f"]

        def init(params):
            pspecs = specs_of(params)

            def state_of(p, s, ss):
                return {k: torch.zeros(_local(shp, ss[k], mesh),
                                       dtype=torch.float32, device=p.device)
                        for k, shp in _factored_shapes(
                            global_shape(p.shape, s, mesh)).items()}
            return {"f": tree_map(state_of, params, pspecs,
                                  state_specs(params, pspecs))}

        @torch.no_grad()
        def update(grads, state, params, step):
            t = _step_t(step, tree_leaves(params)[0].device)
            beta2t = 1.0 - t ** -0.8
            pspecs = specs_of(params)

            def upd(p, g, st, ps, ss):
                g = g.float()
                g2 = g * g + 1e-30
                n = g.ndim
                if n >= 2:
                    rows = _drop(ps, n, -1)            # g2.mean(-1)'s layout
                    cols = _drop(ps, n, -2)            # g2.mean(-2)'s layout
                    vr = beta2t * st["vr"] + (1 - beta2t) * shard.to_layout(
                        _mean_over(g2, (n - 1,), ps, mesh), rows, ss["vr"],
                        mesh)
                    vc = beta2t * st["vc"] + (1 - beta2t) * shard.to_layout(
                        _mean_over(g2, (n - 2,), ps, mesh), cols, ss["vc"],
                        mesh)
                    r = vr / _mean_over(vr, (vr.ndim - 1,), ss["vr"],
                                        mesh)[..., None]
                    r = shard.to_layout(r, ss["vr"], rows, mesh)
                    c = shard.to_layout(vc, ss["vc"], cols, mesh)
                    u = g / (torch.sqrt(r)[..., None]
                             * torch.sqrt(c)[..., None, :] + 1e-30)
                    ns = {"vr": vr, "vc": vc}
                else:
                    v = beta2t * st["v"] + (1 - beta2t) * shard.to_layout(
                        g2, ps, ss["v"], mesh)
                    u = g / (torch.sqrt(shard.to_layout(v, ss["v"], ps, mesh))
                             + 1e-30)
                    ns = {"v": v}
                # RMS clip to 1.0 (adafactor's relative step clipping)
                rms = torch.sqrt(_mean_over(u * u, tuple(range(n)), ps, mesh)
                                 + 1e-30)
                u = u / torch.clamp(rms, min=1.0)
                newp = (p.float() - lr * u - lr * wd * p.float()).to(p.dtype)
                return newp, ns

            new_p, new_f = _unzip(tree_map(upd, params, grads, state["f"],
                                           pspecs, state_specs(params,
                                                               pspecs)), 2)
            return new_p, {"f": new_f}
        return Optimizer("adafactor", init, update)

    raise ValueError(f"unknown optimizer {name}")
