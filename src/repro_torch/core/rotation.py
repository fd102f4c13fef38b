"""Two-level (three on multi-pod) ring rotation schedules (paper §III-B, §IV-B).

A copy of the JAX package's ``core/rotation.py``; one card runs the
(1, 1) schedule, the multi-card slice the rest.

Devices form nested rings: the fast inner ring is the ``"model"`` mesh axis
(paper: NVLink P2P inside a node → ICI here), the middle ring is ``"data"``
(paper: inter-node IB ring), and on multi-pod meshes an outer ``"pod"`` ring
(DCN). Context embedding shards are pinned to devices; vertex embedding
shards rotate through the rings so that every vertex shard meets every
context shard exactly once per episode.

Each device's vertex shard is further split into ``k`` **sub-parts**
(paper §III-B, k=4) which are trained and ppermuted one at a time so the
transfer of sub-part j overlaps the training of sub-part j+1 (the paper's
ping-pong buffers). Sub-parts rotate *with* their parent shard, so the
sub-part index is schedule-invariant.

Schedule (derived in DESIGN.md): device coordinate (q, a, b) on mesh
(Q, D, M), at round (u, t, r):
    vertex shard held = flatten(((q-u) mod Q, (a-t) mod D, (b-r) mod M))
    context shard     = flatten((q, a, b))     (pinned)
The inner scan runs r = 0..M-1 with a shift-by-one ppermute over "model"
after each round; after M inner rounds the shard is home again and a single
ppermute over "data" advances t; likewise for "pod".
"""
from __future__ import annotations

import itertools

import numpy as np


def flatten_coord(coord: tuple[int, ...], dims: tuple[int, ...]) -> int:
    out = 0
    for c, n in zip(coord, dims):
        out = out * n + c
    return out


def vertex_shard_at(device: tuple[int, ...], rounds: tuple[int, ...],
                    dims: tuple[int, ...]) -> int:
    """Vertex shard held by `device` at round index tuple `rounds`."""
    coord = tuple((d - r) % n for d, r, n in zip(device, rounds, dims))
    return flatten_coord(coord, dims)


def context_shard_at(device: tuple[int, ...], dims: tuple[int, ...]) -> int:
    return flatten_coord(device, dims)


def round_of_pair(device: tuple[int, ...], v_shard_coord: tuple[int, ...],
                  dims: tuple[int, ...]) -> tuple[int, ...]:
    """Inverse schedule: at which round does `device` hold vertex shard v?"""
    return tuple((d - v) % n for d, v, n in zip(device, v_shard_coord, dims))


def full_schedule(dims: tuple[int, ...]) -> np.ndarray:
    """sched[dev_flat, round_flat] = vertex shard id. For tests/analysis."""
    P = int(np.prod(dims))
    sched = np.zeros((P, P), dtype=np.int64)
    for dev in itertools.product(*[range(n) for n in dims]):
        for rnd in itertools.product(*[range(n) for n in dims]):
            sched[flatten_coord(dev, dims), flatten_coord(rnd, dims)] = (
                vertex_shard_at(dev, rnd, dims)
            )
    return sched


def check_schedule(dims: tuple[int, ...]) -> None:
    """Invariants: (1) every device sees every vertex shard exactly once per
    episode (row bijection); (2) at any round, no two devices hold the same
    vertex shard (column bijection) — the orthogonality that makes the 2D
    block updates conflict-free."""
    sched = full_schedule(dims)
    P = sched.shape[0]
    want = np.arange(P)
    for i in range(P):
        assert np.array_equal(np.sort(sched[i]), want), f"row {i} not a bijection"
        assert np.array_equal(np.sort(sched[:, i]), want), f"round {i} collision"
