"""Shards of a parameter tree, and the collectives the sharded compute
needs, with their adjoints.

:func:`shard_params` gives each rank the slice of every leaf that JAX's
``NamedSharding(mesh, spec)`` puts on the device at the rank's mesh
coordinate (a dim whose spec entry names axes ``(a, b)`` is cut into
``size(a) * size(b)`` blocks, numbered row-major over the axes);
:func:`gather_params` rebuilds the whole tree on every rank.

The collectives are ``torch.autograd.Function``s whose backward is the
forward's adjoint: all-gather <-> reduce-scatter (an all-reduce then this
rank's block), all-reduce (sum) <-> all-reduce, all-to-all <-> all-to-all.
With these, each rank's backward computes the gradient of the SUM over the
ranks of what each rank seeded: the sharded train step
(``train/train_step.py``) seeds each rank with its share of the loss, so
that a leaf's gradient is the sum of its copies' gradients over the ranks
that hold it (:func:`reduce_replicas`).

Under ``gloo`` on a card (ranks sharing it), every collective stages its
tensor through host memory. Each call is counted in ``collectives.py``:
the bytes this rank sends, by kind and group, and its wall seconds.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.collectives import COLLECTIVES, count
from repro_torch.models.common import tree_map
from repro_torch.sharding.specs import P, axes_of


def _entries(spec, ndim: int, mesh=None) -> list:
    """A spec's entries as axis tuples, padded with () to ``ndim``; with
    ``mesh``, without its axes of size 1 (("data", "model") on a (1, 2)
    mesh is "model": the same blocks)."""
    spec = tuple(spec)
    ents = [axes_of(spec[d]) if d < len(spec) else () for d in range(ndim)]
    if mesh is None:
        return ents
    return [tuple(a for a in e if mesh.shape[a] > 1) for e in ents]


def _staged(mesh, t, op, kind, g):
    """``op(t)`` on a host copy when the mesh's ranks share a card under
    ``gloo``; the result back on ``t``'s device. Counted as ``kind`` over
    the group ``g``."""
    t0 = time.perf_counter()
    count(kind, t.numel() * t.element_size(), g.ranks)
    if mesh.host_staged and t.is_cuda:
        out = op(t.detach().cpu()).to(t.device)
    else:
        out = op(t.detach().contiguous())
    COLLECTIVES["s"] += time.perf_counter() - t0
    return out


def all_reduce_(t, mesh, axes, op=dist.ReduceOp.SUM, *,
                kind: str = "all-reduce"):
    """``t`` reduced over the group of ``axes`` (no autograd); ``t``
    itself without a mesh. ``kind``: what the call is counted as."""
    if mesh is None:
        return t
    g = mesh.group(axes)
    if g.size == 1:
        return t

    def run(x):
        x = x.clone()
        dist.all_reduce(x, op=op, group=g.group)
        return x
    return _staged(mesh, t, run, kind, g)


def _gather(t, mesh, axes, dim):
    g = mesh.group(axes)

    def run(x):
        parts = [torch.empty_like(x) for _ in range(g.size)]
        dist.all_gather(parts, x, group=g.group)
        return torch.cat(parts, dim=dim)
    return _staged(mesh, t, run, "all-gather", g)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, t.shape[dim]
        return _gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.mesh.group(ctx.axes)
        total = all_reduce_(grad, ctx.mesh, ctx.axes, kind="reduce-scatter")
        return (total.narrow(ctx.dim, g.index * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_to_all_(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all_(grad, ctx.mesh, ctx.axes), None, None


def all_to_all_(t, mesh, axes):
    """Block i of ``t``'s leading dim to the group's rank i; block j of the
    result from rank j (``all_to_all_single``, no autograd)."""
    g = mesh.group(axes)
    if g.size == 1:
        return t

    def run(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=g.group)
        return out
    return _staged(mesh, t, run, "all-to-all", g)


def all_reduce(t, mesh, axes):
    """Sum over the group of ``axes``; its adjoint is itself."""
    if mesh.group(axes).size == 1:
        return t
    return _AllReduce.apply(t, mesh, axes_of(axes))


def all_gather(t, mesh, axes, dim: int):
    """The group's blocks concatenated along ``dim`` in group order; its
    adjoint is the reduce-scatter."""
    if mesh.group(axes).size == 1:
        return t
    return _AllGather.apply(t, mesh, axes_of(axes), dim)


def all_to_all(t, mesh, axes):
    """:func:`all_to_all_` with its adjoint (itself)."""
    if mesh.group(axes).size == 1:
        return t
    return _AllToAll.apply(t, mesh, axes_of(axes))


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------
def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a whole tensor of ``shape`` under
    ``spec``."""
    ents = _entries(spec, len(shape))
    return tuple(n // (mesh.axis_size(e) if e else 1)
                 for n, e in zip(shape, ents))


def block_of(t, mesh, axes, dim: int):
    """This rank's block of the (whole along ``dim``) tensor ``t`` over the
    group of ``axes``."""
    g = mesh.group(axes)
    n = t.shape[dim] // g.size
    return t.narrow(dim, g.index * n, n)


def to_layout(t, have, want, mesh):
    """The local shard ``t`` of spec ``have`` as the shard of spec
    ``want``: each dim sharded other than ``want`` says is all-gathered over
    its axes, then each dim ``want`` shards other than ``have`` did is cut
    to this rank's block. Autograd-correct."""
    have, want = _entries(have, t.ndim, mesh), _entries(want, t.ndim, mesh)
    for d in range(t.ndim):
        if have[d] and have[d] != want[d]:
            t = all_gather(t, mesh, have[d], d)
    for d in range(t.ndim):
        if want[d] and want[d] != have[d]:
            t = block_of(t, mesh, want[d], d)
    return t


def local_shard(t, spec, mesh):
    """The block of a whole tensor ``t`` that ``spec`` puts on this rank
    (a copy)."""
    for d, axes in enumerate(_entries(spec, t.ndim)):
        if axes:
            t = block_of(t, mesh, axes, d)
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(tree, specs, mesh):
    """Every leaf of a whole tree cut to this rank's block of its spec."""
    return tree_map(lambda t, s: local_shard(t, s, mesh), tree, specs)


@torch.no_grad()
def gather_params(tree, specs, mesh):
    """The whole tree from every rank's shards (on every rank)."""
    return tree_map(lambda t, s: to_layout(t, s, P(), mesh), tree, specs)


def replicas(spec, mesh) -> tuple:
    """The mesh axes a leaf of ``spec`` is replicated over (in the mesh's
    order)."""
    used = {a for e in spec for a in axes_of(e)}
    return tuple(a for a in mesh.axis_names if a not in used)


def copies(spec, mesh) -> int:
    """How many ranks hold the same shard of a leaf of ``spec`` (1
    without a mesh)."""
    return 1 if mesh is None else mesh.axis_size(replicas(spec, mesh))


@torch.no_grad()
def reduce_replicas(grads, specs, mesh):
    """Each gradient shard summed over the ranks that hold the same shard
    (the axes its spec does not use), in place."""
    def one(g, s):
        axes = replicas(s, mesh)
        if axes and mesh.axis_size(axes) > 1:
            g.copy_(all_reduce_(g, mesh, axes))
        return g
    return tree_map(one, grads, specs)


# --------------------------------------------------------------------------
# compute views: which dims the compute splits, the rest gathered
# --------------------------------------------------------------------------
# the dim each block's compute splits over "model" (heads, FFN width); a
# block is split when every weight of it has "model" on that dim
HEAD_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "wuq": 1, "wuk": 1,
             "wuv": 1, "bq": 0, "bk": 0, "bv": 0}
FFN_DIMS = {"w_gate": 1, "w_up": 1, "w_down": 0}
_BIASES = ("bq", "bk", "bv")


def is_split(p, spec, dims) -> bool:
    """Whether every weight of the block ``p`` named in ``dims`` has
    exactly "model" on its dim there."""
    weights = [n for n in p if n in dims and n not in _BIASES]
    return bool(weights) and all(
        _entries(spec[n], p[n].ndim)[dims[n]] == ("model",) for n in weights)


def block_view(p, spec, mesh, dims):
    """The compute view of a block's leaves ``p`` (a flat dict, specs
    ``spec``) and whether it is split: the leaves named in ``dims`` keep
    "model" on their dim when every weight among them has exactly "model"
    there (the biases then take this rank's heads of their replicated
    whole); every other sharded dim is all-gathered just here, so its
    gradient is reduce-scattered. Sub-dicts are left out."""
    split = is_split(p, spec, dims)
    out = {}
    for n, t in p.items():
        if isinstance(t, dict):
            continue
        want = [None] * t.ndim
        if split and n in dims:
            want[dims[n]] = "model"
        out[n] = to_layout(t, spec[n], P(*want), mesh)
    return out, split


def whole(t, spec, mesh):
    """A leaf gathered whole (autograd-correct)."""
    return to_layout(t, spec, P(), mesh)


def whole_tree(p, spec, mesh):
    return tree_map(lambda t, s: whole(t, s, mesh), p, spec)
