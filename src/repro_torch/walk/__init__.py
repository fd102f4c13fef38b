"""Decoupled walk engine and the bounded sample stores between it and the
trainer (numpy copies of the JAX package's ``walk``)."""
from repro_torch.walk.engine import WalkConfig, WalkEngine  # noqa: F401
from repro_torch.walk.store import (DiskSampleStore,  # noqa: F401
                                    MemorySampleStore, SampleStore)
