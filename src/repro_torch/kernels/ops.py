"""The SGNS minibatch step the hybrid trainer calls in its inner loop.

Counterpart of ``sgns_step`` in the JAX package's ``kernels/ops.py``. There
is no ``impl`` argument: the device of the tables picks the route (the CUDA
kernel on the card, its plain version on the CPU), and there is no launch
planner beyond the kernel wrapper's own. Every minibatch runs in one launch;
the JAX path splits a minibatch into sequential launches only past a size
its on-chip scratch cannot hold, far above the minibatches the trainer
issues.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import sgns


def sgns_step(vert, ctx, idx_v, idx_c, idx_n, mask, lr, *,
              reduction: str = "sum"):
    """One SGNS SGD minibatch against local (vert, ctx) shards, in place.

    vert: (Nv, d), ctx: (Nc, d); idx_v/idx_c: (B,), idx_n: (S,) int32;
    mask: (B,). Returns (vert', ctx', summed loss), the tables being the
    updated inputs.

    ``reduction="sum"`` is word2vec-faithful: every pair's gradient is
    applied at full lr, and a shared-negative row accumulates up to B
    aligned contributions per step. ``"mean"`` divides lr by B.
    """
    if reduction not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}; expected 'sum' "
                         f"or 'mean'")
    if reduction == "mean":
        lr = np.float32(lr) / np.float32(mask.shape[0])
    return sgns.sgns_fused_update(vert, ctx, idx_v, idx_c, idx_n, mask, lr)
