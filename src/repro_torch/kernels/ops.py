"""The SGNS minibatch step the hybrid trainer calls in its inner loop.

Counterpart of the JAX package's ``kernels/ops.py``, with its ``impl``
strings, so a JAX command line runs unchanged on the port:

* ``"pallas_fused2"`` (the port's default): one :func:`sgns.sgns_fused_update`
  call, i.e. the fused CUDA gather, gradients, duplicate combine in f32 and
  in-place SGD. The JAX default is ``"ref"``, because its container has no
  TPU; the port's default is the kernel its main path runs on the card.
* ``"pallas_fused"``: :func:`sgns.sgns_fused_grads` (fused gather and
  gradients), then two :func:`sgns.scatter_add_rows` launches.
* ``"pallas"``: three :func:`sgns.gather_rows`, then :func:`sgns.sgns_grads`,
  then two :func:`sgns.scatter_add_rows`.
* ``"ref"``: the same composition through the plain functions, on whatever
  device the tables are on; the counterpart of the JAX package's jnp/XLA
  route. No other route, and no error path, reaches it.

Each kernel wrapper takes its plain version for a CPU tensor, so on the CPU
every route computes its function in plain PyTorch. There is no launch
planner beyond each wrapper's own: every minibatch runs in one pass. The
JAX path splits a minibatch into sequential launches only past a size its
on-chip scratch cannot hold, far above the minibatches the trainer issues,
and its ``block_b`` pins the TPU's tile, which the CUDA wrappers plan for
themselves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import sgns

STEP_IMPLS = ("ref", "pallas", "pallas_fused", "pallas_fused2")


def check_impl(impl: str, allowed=STEP_IMPLS) -> None:
    if impl not in allowed:
        raise ValueError(f"unknown impl {impl!r}; expected one of {allowed}")


def gather_rows(table, idx, *, impl: str = "ref"):
    check_impl(impl, ("ref", "pallas"))
    if impl == "ref":
        return sgns.gather_rows_plain(table, idx)
    return sgns.gather_rows(table, idx)


def sgns_grads(v, c, n, mask, *, impl: str = "ref"):
    """loss + (dv, dc, dn) for a shared-negative SGNS minibatch."""
    check_impl(impl, ("ref", "pallas"))
    if impl == "ref":
        return sgns.sgns_grads_plain(v, c, n, mask)
    return sgns.sgns_grads(v, c, n, mask)


def scatter_add_rows(table, idx, upd, *, impl: str = "ref"):
    """``table[idx[p]] += upd[p]`` in place, in position order."""
    check_impl(impl, ("ref", "pallas"))
    if impl == "ref":
        return sgns.scatter_add_rows_plain(table, idx, upd)
    return sgns.scatter_add_rows(table, idx, upd)


def sgns_step(vert, ctx, idx_v, idx_c, idx_n, mask, lr, *,
              impl: str = "pallas_fused2", reduction: str = "sum"):
    """One SGNS SGD minibatch against local (vert, ctx) shards, in place.

    vert: (Nv, d), ctx: (Nc, d); idx_v/idx_c: (B,), idx_n: (S,) int32;
    mask: (B,). Returns (vert', ctx', summed loss), the tables being the
    updated inputs.

    ``reduction="sum"`` is word2vec-faithful: every pair's gradient is
    applied at full lr, and a shared-negative row accumulates up to B
    aligned contributions per step. ``"mean"`` divides lr by B.

    The unfused routes scale the gradients as the JAX op does with its f32
    ``lr`` array: ``-lr * dv`` is f32 whatever the gradients' dtype, and is
    rounded to the table's dtype position by position inside the scatter.
    The context scatter runs over ``idx_c ++ idx_n``, positives first.
    """
    check_impl(impl)
    if reduction not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}; expected 'sum' "
                         f"or 'mean'")
    lr = np.float32(lr)
    if reduction == "mean":
        lr = lr / np.float32(mask.shape[0])
    if impl == "pallas_fused2":
        return sgns.sgns_fused_update(vert, ctx, idx_v, idx_c, idx_n, mask,
                                      lr)
    rows = "ref" if impl == "ref" else "pallas"     # the row ops' route
    if impl == "pallas_fused":
        # the kernel masks its ragged tile: only the B real rows exist
        loss, dv, dc, dn = sgns.sgns_fused_grads(vert, ctx, idx_v, idx_c,
                                                 idx_n, mask)
    else:
        v = gather_rows(vert, idx_v, impl=rows)
        c = gather_rows(ctx, idx_c, impl=rows)
        n = gather_rows(ctx, idx_n, impl=rows)
        loss, dv, dc, dn = sgns_grads(v, c, n, mask, impl=rows)
    neg_lr = float(-lr)
    scatter_add_rows(vert, idx_v, dv.float() * neg_lr, impl=rows)
    scatter_add_rows(ctx, torch.cat([idx_c, idx_n]),
                     torch.cat([dc, dn]).float() * neg_lr, impl=rows)
    return vert, ctx, loss
