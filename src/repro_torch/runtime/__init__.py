"""Failure vocabulary shared with the JAX package's runtime (a copy)."""
from repro_torch.runtime.errors import DeadlineExceeded  # noqa: F401
