"""Host-side graphs for the walk engine (numpy copies of the JAX package's
``graph``)."""
from repro_torch.graph.csr import CSRGraph, build_csr  # noqa: F401
from repro_torch.graph.generators import (mesh_graph,  # noqa: F401
                                          powerlaw_graph, rmat_graph,
                                          sbm_graph)
