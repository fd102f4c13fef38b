"""Synthetic graph generators mirroring the paper's benchmark networks
(numpy copies of the JAX package's ``graph/generators.py``, the same CSR
arrays from the same seeds).

* :func:`rmat_graph`      — Kronecker/R-MAT scale-free graph ("kron" in Table II).
* :func:`mesh_graph`      — uniform-degree 2D mesh ("delaunay"-like topology).
* :func:`powerlaw_graph`  — preferential-attachment social-network-like graph
  (the "generated A/B/C" family: "resemble the topology of real-world social
  networks").
* :func:`sbm_graph`       — stochastic block model with planted communities;
  the topology behind the paper's link-prediction AUC claims (Table IV) —
  held-out edges are predictable from learned embeddings, which makes it the
  graph to use when an AUC number has to MEAN something (CI sanity gates).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def rmat_graph(scale: int, edge_factor: int = 16, *, a: float = 0.57, b: float = 0.19,
               c: float = 0.19, seed: int = 0) -> CSRGraph:
    """R-MAT generator: 2**scale nodes, edge_factor * n edges (pre-dedup)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        # standard R-MAT: quadrants (0,0)=a (0,1)=b (1,0)=c (1,1)=d; c and d
        # set the source's bit at this level, b and d the destination's
        q_b = (r >= a) & (r < a + b)
        q_c = (r >= a + b) & (r < a + b + c)
        q_d = r >= a + b + c
        src |= ((q_c | q_d).astype(np.int64)) << level
        dst |= ((q_b | q_d).astype(np.int64)) << level
    edges = np.stack([src, dst], axis=1)
    return build_csr(edges, n)


def mesh_graph(side: int) -> CSRGraph:
    """side*side 2D grid — uniform degree distribution (delaunay-like)."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).ravel()
    right = vid[(jj < side - 1).ravel()]
    down = vid[(ii < side - 1).ravel()]
    edges = np.concatenate(
        [np.stack([right, right + 1], 1), np.stack([down, down + side], 1)], axis=0
    )
    return build_csr(edges, n)


def powerlaw_graph(n: int, m_per_node: int = 4, *, seed: int = 0) -> CSRGraph:
    """Barabási–Albert-style preferential attachment (vectorized approximation).

    Matches the skewed degree distribution of the paper's social networks.
    """
    rng = np.random.default_rng(seed)
    n0 = max(m_per_node + 1, 4)
    src_list = [np.repeat(np.arange(n0), n0 - 1)]
    dst0 = np.concatenate([np.delete(np.arange(n0), i) for i in range(n0)])
    dst_list = [dst0]
    # repeated-nodes trick: sample targets from the flat edge endpoint list
    endpoint_pool = [np.concatenate([src_list[0], dst_list[0]])]
    batch = max(1024, n // 64)
    v = n0
    while v < n:
        nb = min(batch, n - v)
        new_src = np.repeat(np.arange(v, v + nb), m_per_node)
        pool = np.concatenate(endpoint_pool)
        targets = pool[rng.integers(0, pool.size, size=nb * m_per_node)]
        # attach (approximate: pool not updated within the batch)
        src_list.append(new_src)
        dst_list.append(targets)
        endpoint_pool.append(np.concatenate([new_src, targets]))
        v += nb
    edges = np.stack([np.concatenate(src_list), np.concatenate(dst_list)], axis=1)
    return build_csr(edges, n)


def sbm_graph(n: int, communities: int = 12, *, p_in: float = 0.08,
              p_out: float = 0.001, rounds: int = 30, batch: int = 20000,
              seed: int = 0) -> CSRGraph:
    """Stochastic block model: `communities` planted groups, intra-community
    edges kept with `p_in`, cross-community with `p_out` (rejection-sampled
    in `rounds` batches of `batch` candidate pairs, so expected edges scale
    with rounds·batch rather than n²)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, n)
    src, dst = [], []
    for _ in range(rounds):
        a = rng.integers(0, n, batch)
        b = rng.integers(0, n, batch)
        keep = rng.random(batch) < np.where(comm[a] == comm[b], p_in, p_out)
        src.append(a[keep])
        dst.append(b[keep])
    edges = np.stack([np.concatenate(src), np.concatenate(dst)], axis=1)
    return build_csr(edges, n)
