"""CSR graph structure (a numpy copy of the JAX package's ``graph/csr.py``).

The walk engine is a CPU component (paper §IV-A): graphs live in host memory
as numpy CSR. Edges are directed internally; undirected graphs are stored
with both directions.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency. indptr: (n+1,) int64, indices: (m,) int32/int64."""

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def edge_list(self) -> np.ndarray:
        """(m, 2) array of (src, dst)."""
        src = np.repeat(np.arange(self.num_nodes, dtype=self.indices.dtype), self.degrees())
        return np.stack([src, self.indices], axis=1)

    def save(self, path: str) -> None:
        np.savez_compressed(path, indptr=self.indptr, indices=self.indices)

    @staticmethod
    def load(path: str) -> "CSRGraph":
        with np.load(path) as f:
            return CSRGraph(indptr=f["indptr"], indices=f["indices"])


def build_csr(edges: np.ndarray, num_nodes: int, *, symmetrize: bool = True,
              dedup: bool = True) -> CSRGraph:
    """Build a CSR graph from an (m, 2) edge array."""
    edges = np.asarray(edges)
    if edges.size == 0:
        return CSRGraph(np.zeros(num_nodes + 1, np.int64), np.zeros(0, np.int32))
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # drop self loops
    edges = edges[edges[:, 0] != edges[:, 1]]
    if dedup:
        key = edges[:, 0].astype(np.int64) * num_nodes + edges[:, 1].astype(np.int64)
        _, idx = np.unique(key, return_index=True)
        edges = edges[idx]
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    counts = np.bincount(edges[:, 0], minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=edges[:, 1].astype(np.int32))
