"""Decoupled walk engine and the bounded sample store between it and the
trainer (numpy copies of the JAX package's ``walk``)."""
from repro_torch.walk.engine import WalkConfig, WalkEngine  # noqa: F401
from repro_torch.walk.store import (MemorySampleStore,  # noqa: F401
                                    SampleStore)
