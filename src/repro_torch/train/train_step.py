"""LM training step and the LM data stand-in.

The port of the JAX package's ``train/train_step.py``.
:func:`make_train_step` is loss + gradients (``torch.autograd``) + the
optimizer update, with JAX's gradient accumulation over
``cfg.train_microbatches`` microbatches. :func:`synthetic_batch` is a numpy
copy of its text, vision and audio branches, so one seed gives the same
prompt tokens, patch embeddings and audio frames in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import stack_layers, unstack_layers
from repro_torch.sharding import shard
from repro_torch.sharding.specs import P
from repro_torch.train.optimizer import make_optimizer


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0):
    """Random-token batch with zipf-ish marginals (data pipeline stand-in).
    A vision config's ``seq`` holds ``P = min(frontend_len_cap, seq // 2)``
    patch embeddings (N(0, 1), ``compute_dtype``) and ``seq - P`` tokens;
    an audio config's ``seq // 2`` encoder frames (N(0, 1),
    ``compute_dtype``) and ``seq // 2`` tokens."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.modality == "vision":
        P = min(cfg.frontend_len_cap, seq // 2)
        out["patch_embeds"] = rng.normal(0, 1, (batch, P, cfg.d_model)).astype(
            np.dtype(cfg.compute_dtype))
        seq = seq - P
    if cfg.modality == "audio":
        out["frames"] = rng.normal(0, 1, (batch, seq // 2, cfg.d_model)
                                   ).astype(np.dtype(cfg.compute_dtype))
        seq = seq // 2
    z = rng.zipf(1.3, size=(batch, seq))
    out["tokens"] = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
    out["positions"] = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                       (batch, seq)).copy()
    return out


def loss_and_grads(params, batch: dict, cfg: ModelConfig, *,
                   moe_dispatch: bool = False, mesh=None, specs=None):
    """``jax.value_and_grad(forward_train, has_aux=True)``: (loss,
    metrics, gradients in the parameters' tree), all detached. On a mesh
    (``forward_train``'s ``mesh``/``specs``) the loss is this rank's share
    and the gradients are its copies' (not yet summed over replicas)."""
    leaves = []

    def track(p):
        q = p.detach().requires_grad_(True)
        leaves.append(q)
        return q

    tracked = tree_map(track, params)
    with torch.enable_grad():
        loss, metrics = tfm.forward_train(tracked, batch, cfg,
                                          moe_dispatch=moe_dispatch,
                                          mesh=mesh, specs=specs)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # the dense oracle does not read the shared expert, as in JAX: its
    # gradient is zero. Any other leaf the loss does not read is a fault.
    oracle = (not moe_dispatch if mesh is None
              else cfg.moe_num_experts % mesh.shape["model"] != 0)
    unread = {id(t) for t in _shared(params)} if oracle else set()
    it = iter(grads)

    def grad_of(p):
        g = next(it)
        if g is not None:
            return g
        if id(p) not in unread:
            raise RuntimeError(f"forward_train does not read a parameter "
                               f"leaf of shape {tuple(p.shape)}")
        return torch.zeros_like(p)

    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(grad_of, params))


def _shared(tree) -> list:
    """The leaves of every ``shared`` (shared-expert) subtree of ``tree``."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in (tree_leaves(v) if k == "shared" else _shared(v))]
    if isinstance(tree, list):
        return [t for v in tree for t in _shared(v)]
    return []


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4,
                    moe_dispatch: bool = False, mesh=None, specs=None):
    """Returns ``(train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics), opt)``. ``batch`` holds tensors on the
    parameters' device: ``tokens`` (B, S) and optionally ``positions``,
    ``loss_mask``, a VLM's ``patch_embeds`` (B, P, d) and an enc-dec
    config's ``frames`` (B, Se, d). ``moe_dispatch`` sends MoE layers
    through the expert dispatch (JAX's trainer under its host mesh)
    instead of the dense oracle; a duck mesh (``.shape``, ``.axis_names``)
    there runs the expert-parallel dispatch of that mesh's ranks in one
    process (``mlp.moe_ep_plain``), what a sharded step computes.

    The optimizer runs on the JAX tree layout (``convert.stack_layers``):
    JAX updates each segment slot's stacked layer leaves as one leaf, and
    Adafactor's factored moments and RMS clip span the stack (a layer's
    norm scale is a row of a factored matrix there, not a vector of its
    own). So ``opt.init`` takes the port's parameters and returns state in
    JAX's layout, leaf for leaf (``opt.update`` takes that layout too; an
    encoder's layers are stacked as its segments, ``mtp_layer`` stays one
    layer, as in JAX);
    ``train_step`` stacks the layers (a copy, unless they are views of one
    stack already), accumulates the gradients into the stacked layout and
    returns parameters whose layer leaves are views into the updated
    stacks.

    ``mesh`` (``sharding.mesh.Mesh``) with ``specs`` (``param_shardings``
    of the whole parameters, the port's layout): ``params`` and the state
    are this rank's shards, and ``batch`` is the global batch (every rank
    the same). Microbatch i is global rows ``[i * B/k, (i + 1) * B/k)``,
    split over the data axes by ``batch_spec``, as JAX's scan reshards it;
    MoE layers take the expert-parallel dispatch. Each microbatch's
    gradients are summed into the accumulators; then every leaf's gradient
    is summed over the ranks that replicate it, and ``grad_norm`` counts
    each element once.
    """
    jspecs = None if mesh is None else stacked_specs(specs, cfg)
    base = make_optimizer(cfg.optimizer, lr=lr, mesh=mesh, specs=jspecs)
    opt = dataclasses.replace(base, init=lambda params: base.init(
        stack_layers(params, cfg)))
    everywhere = () if mesh is None else mesh.axis_names

    def train_step(params, opt_state, step, batch):
        # grad accumulation over k microbatches of the leading dim, summed
        # in f32 into the stacked layout
        k = max(1, cfg.train_microbatches)
        b = batch["tokens"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} "
                             f"microbatches")
        m = b // k
        view = None if mesh is None else mesh.for_batch(m)
        rows = slice(None) if mesh is None else mesh.batch_slice(m)
        grads = None
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for i in range(k):
            mb = {key: v[i * m:(i + 1) * m][rows] for key, v in batch.items()}
            l_i, metrics, g = loss_and_grads(params, mb, cfg,
                                             moe_dispatch=moe_dispatch,
                                             mesh=view, specs=specs)
            if grads is None:
                # made after the first backward, so not held through it
                grads = _zero_grads(params, cfg)
                views = unstack_layers(grads)
            tree_map(lambda acc, gi: acc.add_(gi.float()), views, g)
            del g
            loss = loss + shard.all_reduce_(l_i, mesh, everywhere)
        if k > 1:
            tree_map(lambda g: g.div_(k), grads)
            loss = loss / k
            metrics = {"xent": loss}
        if mesh is not None:
            shard.reduce_replicas(grads, jspecs, mesh)
        new, opt_state = base.update(grads, opt_state,
                                     stack_layers(params, cfg), step)
        sq = sum(g.float().square().sum() / shard.copies(s, mesh)
                 for g, s in zip(tree_leaves(grads), _specs_of(grads, jspecs)))
        gnorm = torch.sqrt(shard.all_reduce_(sq, mesh, everywhere))
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return unstack_layers(new), opt_state, metrics

    return train_step, opt


def stacked_specs(specs, cfg: ModelConfig):
    """The JAX-layout specs of the port-layout ``specs``: each stacked
    leaf's spec is its layers' with the group dim (never sharded) first."""
    return stack_layers(specs, cfg, stack=lambda ts: P(None, *ts[0]))


def _specs_of(tree, specs) -> list:
    """The leaves of ``specs``, or a whole spec a leaf of ``tree``."""
    return tree_leaves(specs) if specs is not None else [P()] * len(
        tree_leaves(tree))


def _zero_grads(params, cfg: ModelConfig) -> dict:
    """f32 zeros in the JAX layout of ``params``: the accumulators, made
    without copying the layers."""
    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    tree = stack_layers(params, cfg, stack=lambda ts: zeros(
        (len(ts), *ts[0].shape), ts[0]))
    return {k: v if k in ("segments", "enc_segments")
            else tree_map(lambda t: zeros(t.shape, t), v)
            for k, v in tree.items()}
