"""Meshes of named axes over ``torch.distributed`` ranks.

The port of the JAX package's ``launch/mesh.py``. A :class:`Mesh` numbers
its ranks row-major over its axes, as ``jax.make_mesh`` numbers devices:
rank r sits at ``np.unravel_index(r, shape)``. It holds one
``torch.distributed`` subgroup for every set of its axes (each axis alone,
every combination of the data axes, the whole mesh); a group's ranks are
ordered by their flat index over its axes (row-major, in the mesh's axis
order), which is the order JAX's collectives over those axes use.

The backend is chosen before the default group starts
(:func:`init_ranks`, ``core/ring.py::backend_for``): ``gloo`` on the CPU
and for ranks that share one card (tensors staged through host memory by
``sharding/shard.py``), ``nccl`` for distinct cards.

:func:`make_production_mesh` is the 16 x 16 mesh of one pod (256 ranks)
or the 2 x 16 x 16 mesh of two (512), as the JAX package's
``launch/mesh.py`` builds it. No machine here has that many cards: the
dry-run (``launch/dryrun.py``) builds it inside :func:`fake_world`, a
default group of ``torch.distributed``'s ``fake`` backend in which this
process is one rank (rank 0) and every collective returns at once. Only
the dry-run starts one; the launchers' entry points never do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.specs import axes_of, batch_spec


def init_ranks(device: torch.device, shared_card: bool) -> str:
    """Start the default process group from the ``torchrun`` environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) with the
    backend for ranks on ``device``; returns the backend."""
    from repro_torch.core.ring import backend_for

    backend = backend_for(device, shared_card)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
    return backend


@dataclasses.dataclass
class _Group:
    group: object          # the process group (None: the default group)
    size: int
    index: int             # this rank's flat index over the group's axes
    ranks: tuple = ()      # the group's ranks in the default group


class Mesh:
    """Axes ``axis_names`` of sizes ``shape`` over the default group's
    ranks. ``host_staged``: the backend is ``gloo``, so a CUDA tensor
    crosses through host memory. ``b_axes``: the data axes the current
    batch is split over (:meth:`for_batch`)."""

    def __init__(self, shape, axis_names=("data", "model")):
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(n) for n in shape)
        self.shape = dict(zip(self.axis_names, self.dims))
        self.size = int(np.prod(self.dims))
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the group has {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.coord = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            self.rank, self.dims))))
        self.host_staged = dist.get_backend() == "gloo"
        self.b_axes: tuple = ()
        self._groups: dict = {}
        # every rank creates every group, in one order
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._make_groups(axes)

    def _make_groups(self, axes):
        others = [a for a in self.axis_names if a not in axes]
        sizes = [self.shape[a] for a in axes]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            ranks = []
            for flat in range(int(np.prod(sizes))):
                c = dict(zip(others, fixed))
                c.update(zip(axes, np.unravel_index(flat, sizes)))
                ranks.append(int(np.ravel_multi_index(
                    [c[a] for a in self.axis_names], self.dims)))
            group = (None if len(ranks) == self.size and ranks == sorted(ranks)
                     else dist.new_group(ranks))
            if self.rank in ranks:
                self._groups[axes] = _Group(group, len(ranks),
                                            ranks.index(self.rank),
                                            tuple(ranks))

    def group(self, axes) -> _Group:
        """The group over ``axes`` (a spec entry: a name or a tuple of
        names, in the mesh's order) that holds this rank."""
        axes = axes_of(axes)
        if tuple(a for a in self.axis_names if a in axes) != axes:
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return self._groups[axes]

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in axes_of(axes)]))

    def for_batch(self, global_batch: int) -> "Mesh":
        """This mesh with ``b_axes`` set to the axes ``batch_spec`` splits
        a global batch of ``global_batch`` rows over."""
        view = object.__new__(Mesh)
        view.__dict__.update(self.__dict__)
        bs = batch_spec(global_batch, self)
        view.b_axes = axes_of(bs[0]) if len(bs) else ()
        return view

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch, split by ``batch_spec``."""
        axes = self.for_batch(global_batch).b_axes
        if not axes:
            return slice(0, global_batch)
        g = self.group(axes)
        n = global_batch // g.size
        return slice(g.index * n, (g.index + 1) * n)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank})"


def make_host_mesh(shape=None, axes=("data", "model")):
    """A mesh over every rank of the default group: ``(1, world)`` by
    default, as the JAX launcher builds ``(1, n_dev)``."""
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    return Mesh(shape, axes)


# multi_pod -> (shape, axes) of the production mesh
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over the default group: ``("data", "model")``
    16 x 16, or ``("pod", "data", "model")`` 2 x 16 x 16 with
    ``multi_pod``. The group must have 256 (512) ranks."""
    return Mesh(*PRODUCTION[multi_pod])


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default group of ``world_size`` ranks on the ``fake`` backend, this
    process being rank 0, for tracing one rank of a cluster on tensors
    without storage (the dry-run); destroyed on exit. Collectives over it move
    nothing. Raises if a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists "
                           "already")
    dist.init_process_group("cpu:fake,cuda:fake,meta:fake", store=FakeStore(),
                            rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def data_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")
