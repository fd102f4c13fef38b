"""Optimizers: SGD, AdamW, Adafactor (factored second moment).

A copy of the JAX package's ``train/optimizer.py`` on tensors: plain
tensor arithmetic under ``torch.no_grad()``, no ``torch.optim``, in JAX's
order of operations. Parameters are a tree of nested dicts and lists of
tensors; the state mirrors it leaf for leaf in the JAX layout (``{"_"}``
for SGD, ``{"m", "v"}`` for AdamW, ``{"f": {"vr", "vc"} | {"v"}}`` for
Adafactor), in f32 on the parameters' device. ``update(grads, state,
params, step)`` returns ``(new_params, new_state)``; the new parameters
keep their dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map


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


def make_optimizer(name: str, lr: float = 1e-4, *, wd: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
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
        def init(params):
            def state_of(p):
                kw = dict(dtype=torch.float32, device=p.device)
                if p.ndim >= 2:
                    return {"vr": torch.zeros(p.shape[:-1], **kw),
                            "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                              **kw)}
                return {"v": torch.zeros(p.shape, **kw)}
            return {"f": tree_map(state_of, params)}

        @torch.no_grad()
        def update(grads, state, params, step):
            t = _step_t(step, tree_leaves(params)[0].device)
            beta2t = 1.0 - t ** -0.8

            def upd(p, g, s):
                g = g.float()
                g2 = g * g + 1e-30
                if p.ndim >= 2:
                    vr = beta2t * s["vr"] + (1 - beta2t) * g2.mean(dim=-1)
                    vc = beta2t * s["vc"] + (1 - beta2t) * g2.mean(dim=-2)
                    r = vr / vr.mean(dim=-1, keepdim=True)
                    u = g / (torch.sqrt(r)[..., None]
                             * torch.sqrt(vc)[..., None, :] + 1e-30)
                    ns = {"vr": vr, "vc": vc}
                else:
                    v = beta2t * s["v"] + (1 - beta2t) * g2
                    u = g / (torch.sqrt(v) + 1e-30)
                    ns = {"v": v}
                # RMS clip to 1.0 (adafactor's relative step clipping)
                rms = torch.sqrt((u * u).mean() + 1e-30)
                u = u / torch.clamp(rms, min=1.0)
                newp = (p.float() - lr * u - lr * wd * p.float()).to(p.dtype)
                return newp, ns

            new_p, new_f = _unzip(tree_map(upd, params, grads, state["f"]), 2)
            return new_p, {"f": new_f}
        return Optimizer("adafactor", init, update)

    raise ValueError(f"unknown optimizer {name}")
