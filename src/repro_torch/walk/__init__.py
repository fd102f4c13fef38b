"""Decoupled walk engine, the bounded sample stores between it and the
trainer, the alias sampler and the remote walk producers (numpy and
standard-library copies of the JAX package's ``walk``; no torch import, so
a spawned producer never loads CUDA)."""
from repro_torch.walk.alias import AliasTable  # noqa: F401
from repro_torch.walk.augment import walks_to_pairs  # noqa: F401
from repro_torch.walk.engine import WalkConfig, WalkEngine  # noqa: F401
from repro_torch.walk.remote import (RemoteEpisodeServer,  # noqa: F401
                                     RemoteProducer, RemoteWalkCoordinator)
from repro_torch.walk.store import (DiskSampleStore,  # noqa: F401
                                    MemorySampleStore, SampleStore)
