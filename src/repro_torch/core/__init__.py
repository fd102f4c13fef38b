"""Host-side partitioning, the rotation schedule, evaluation, the episode
pipeline, the hybrid trainer, its tiered tables (host master + device
cache of hot rows, bitwise the resident path) and the parameter-server
baseline."""
from repro_torch.core.baseline_ps import ParameterServerTrainer  # noqa: F401
from repro_torch.core.hybrid import (HybridConfig,  # noqa: F401
                                     HybridEmbeddingTrainer,
                                     StagedEpisodeBlocks)
from repro_torch.core.partition import (EpisodeBlocks,  # noqa: F401
                                        NodePartition, build_episode_blocks)
from repro_torch.core.pipeline import EpisodePipeline  # noqa: F401
from repro_torch.core.tiered import (CACHE_POLICIES,  # noqa: F401
                                     CacheStats, StagedTieredEpisode,
                                     TieredEmbeddingTrainer, TieredTable)
