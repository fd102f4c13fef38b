"""Network augmentation: walks -> (src, dst) context pairs (paper Alg. 1).

A copy of the JAX package's ``walk/augment.py``.

One edge of the original network yields up to k*l augmented samples: every
pair of nodes within `window` hops on a walk becomes a positive edge.
"""
from __future__ import annotations

import numpy as np


def walks_to_pairs(walks: np.ndarray, window: int) -> np.ndarray:
    """(W, L+1) walks -> (P, 2) int32 (center, context) pairs.

    Pairs are emitted in both directions implicitly by emitting (w[t], w[t+d])
    for d in 1..window — matching Alg. 1's E_aug := E_aug ∪ (v, u).
    """
    W, L1 = walks.shape
    out = []
    for d in range(1, window + 1):
        if d >= L1:
            break
        src = walks[:, : L1 - d].ravel()
        dst = walks[:, d:].ravel()
        out.append(np.stack([src, dst], axis=1))
    if not out:
        return np.zeros((0, 2), dtype=np.int32)
    pairs = np.concatenate(out, axis=0).astype(np.int32)
    # drop self-pairs created by dead-end walks stalling in place
    return pairs[pairs[:, 0] != pairs[:, 1]]
