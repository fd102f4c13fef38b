"""Serving steps: chunked prefill and one-token decode, on one card.

The port of ``make_prefill_step``, ``make_decode_step`` and
``cache_len_for`` of the JAX package's ``train/serve_step.py``. The mesh
and the cache shardings wait for the multi-card slice (``ROADMAP.md``).
"""
from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, flash: bool = True):
    def prefill_step(params, batch):
        return tfm.prefill(params, batch, cfg, cache_len, flash=flash)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode(params, token, caches):
        return tfm.decode_step(params, token, caches, cfg)
    return decode


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: the sliding window if set, else the full context."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
