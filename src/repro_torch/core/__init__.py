"""Host-side partitioning shared by training and serving."""
from repro_torch.core.partition import NodePartition  # noqa: F401
