"""Host-side partitioning, the rotation schedule, evaluation, the episode
pipeline and the single-card hybrid trainer."""
from repro_torch.core.hybrid import (HybridConfig,  # noqa: F401
                                     HybridEmbeddingTrainer,
                                     StagedEpisodeBlocks)
from repro_torch.core.partition import (EpisodeBlocks,  # noqa: F401
                                        NodePartition, build_episode_blocks)
from repro_torch.core.pipeline import EpisodePipeline  # noqa: F401
