"""The LM data stand-in of the JAX package's ``train/train_step.py``.

:func:`synthetic_batch` is a numpy copy of its text branch, so one seed
gives the same prompt tokens in both packages (the VLM and audio branches
wait for their families). The LM training step waits for its slice
(``ROADMAP.md``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0):
    """Random-token batch with zipf-ish marginals (data pipeline stand-in)."""
    if cfg.modality != "text":
        raise NotImplementedError(f"synthetic_batch: modality "
                                  f"{cfg.modality!r} not ported yet")
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.3, size=(batch, seq))
    return {"tokens": np.minimum(z, cfg.vocab_size - 1).astype(np.int32),
            "positions": np.broadcast_to(np.arange(seq, dtype=np.int32),
                                         (batch, seq)).copy()}
