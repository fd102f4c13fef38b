"""tencent-embedding — the paper's own workload (Anonymized A, Table III).

A copy of the JAX package's ``configs/tencent_embedding.py``: 1.05B nodes,
d=128, 5 negatives, trained with the hybrid model-data parallel episode
step (``repro_torch.core.hybrid``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EmbeddingArchConfig:
    name: str = "tencent-embedding"
    arch_type: str = "embedding"
    num_nodes: int = 1_050_000_000
    dim: int = 128
    negatives: int = 5
    minibatch: int = 256
    subparts: int = 4            # paper's k
    neg_pool: int = 65536
    lr: float = 0.025
    # per-device episode geometry for the dry-run (see DESIGN.md §5):
    # each device holds (rounds x subparts) blocks of block_cap samples.
    block_cap: int = 8192
    dtype: str = "float32"       # paper-faithful; "bfloat16" = §Perf A.3


CONFIG = EmbeddingArchConfig()

# small variant for smoke tests / benchmarks on CPU
SMALL = dataclasses.replace(
    CONFIG, name="tencent-embedding-small", num_nodes=20000, neg_pool=4096,
    block_cap=512, minibatch=64, subparts=2)
