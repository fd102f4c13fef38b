"""Edge-list input for the walk engine (a copy of the JAX package's
``graph/io.py::load_edge_list``)."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def load_edge_list(path: str, num_nodes: int | None = None, **kw) -> CSRGraph:
    """Load a whitespace-separated `src dst` text file or an .npy (m,2) array."""
    if path.endswith(".npy"):
        edges = np.load(path)
    else:
        edges = np.loadtxt(path, dtype=np.int64, ndmin=2)
    if num_nodes is None:
        num_nodes = int(edges.max()) + 1
    return build_csr(edges, num_nodes, **kw)
