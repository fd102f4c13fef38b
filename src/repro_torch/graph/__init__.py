"""Host-side graphs for the walk engine (numpy copies of the JAX package's
``graph``)."""
from repro_torch.graph.csr import CSRGraph, build_csr  # noqa: F401
