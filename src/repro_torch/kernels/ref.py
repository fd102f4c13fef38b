"""Numpy oracles for the port's kernels (copied from ``repro/kernels/ref.py``)."""
from __future__ import annotations

import numpy as np


def topk_mips_ref(table, queries, k: int):
    """Numpy oracle for exact-MIPS top-k retrieval (embed_serve.topk).

    table: (N, d); queries: (Q, d). Scores are the f32 inner products
    queries @ table.T (matching the kernels, which cast to f32 before the
    MXU dot); ties break toward the smaller row index — `kind="stable"` on
    the negated scores is exactly that rule.

    Returns (vals (Q, k) f32, idx (Q, k) int32). Numpy (not jnp) on
    purpose: this is the serving subsystem's ground truth, so it must not
    share an execution path with anything it validates.
    """
    t = np.asarray(table).astype(np.float32)
    q = np.asarray(queries).astype(np.float32)
    scores = q @ t.T                                  # (Q, N) f32
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, order, axis=1)
    return vals, order.astype(np.int32)
