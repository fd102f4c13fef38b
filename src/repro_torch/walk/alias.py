"""Alias-method sampler (Walker 1977), vectorized.

A numpy copy of the JAX package's ``walk/alias.py``: the same tables and
the same draws from one seeded generator.

Used for degree^0.75 negative sampling — the standard word2vec/SGNS noise
distribution the paper inherits from [15]/[16].
"""
from __future__ import annotations

import numpy as np


class AliasTable:
    """O(1)-per-draw sampling from an arbitrary discrete distribution."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.float64)
        if w.ndim != 1 or w.size == 0:
            raise ValueError("weights must be a non-empty 1-D array")
        if np.any(w < 0) or w.sum() <= 0:
            raise ValueError("weights must be non-negative with positive sum")
        n = w.size
        p = w * (n / w.sum())
        self.prob = np.ones(n, dtype=np.float64)
        self.alias = np.arange(n, dtype=np.int64)
        small = list(np.nonzero(p < 1.0)[0])
        large = list(np.nonzero(p >= 1.0)[0])
        while small and large:
            s = small.pop()
            l = large.pop()
            self.prob[s] = p[s]
            self.alias[s] = l
            p[l] = p[l] - (1.0 - p[s])
            (small if p[l] < 1.0 else large).append(l)
        for rest in (small, large):
            for i in rest:
                self.prob[i] = 1.0

    def sample(self, size: int | tuple, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, self.prob.size, size=size)
        accept = rng.random(size=idx.shape) < self.prob[idx]
        return np.where(accept, idx, self.alias[idx])


def negative_sampling_table(degrees: np.ndarray, power: float = 0.75) -> AliasTable:
    """The word2vec noise distribution: P(v) ∝ deg(v)^0.75."""
    w = np.asarray(degrees, dtype=np.float64) ** power
    w = np.maximum(w, 1e-12)  # keep isolated nodes sampleable
    return AliasTable(w)
