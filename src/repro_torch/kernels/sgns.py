"""Embedding-row kernels shared by training and serving: the CUDA kernels
and their plain PyTorch versions.

Counterpart of the JAX package's ``kernels/sgns.py``. Three wrappers launch
two CUDA sources:

* :func:`gather_rows` replaces the TPU kernel ``gather_rows`` (blocked row
  DMAs); the two-tier retrieval scan uses it to fetch its survivors. Its
  source is ``csrc/gather_rows.cu``: one warp per output row, 16-byte loads
  when the row allows. Bound by bytes; at serving sizes the launch is most
  of its time.
* :func:`sgns_fused_update` replaces ``sgns_fused_update`` (the training
  hot loop: gather, SGNS gradients, duplicate combine and in-place SGD),
  and :func:`sgns_fused_grads` replaces ``sgns_fused_grads`` (gather and
  gradients only). Both launch ``csrc/sgns_update.cu``, whose header has
  the design: a tile-gradients kernel with per-block partials, then a
  combine-and-apply kernel with one warp per run of equal indices, so a
  run repeats bitwise.

A tensor on the CPU takes the plain version (``*_plain``); a tensor on the
card goes to the kernel or the call raises. The plain versions compute the
same function in plain PyTorch: gradients in f32 (:func:`tile_grads_plain`,
the counterpart of ``_tile_grads``), duplicates combined in f32, and one
cast per row.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

# launches of each CUDA kernel of this module (counted where it launches)
LAUNCHES = {"gather_rows": 0, "sgns_fused_grads": 0, "sgns_fused_update": 0}

SMEM_PER_BLOCK = 232_448          # H100: 227 KB of dynamic shared memory
GRAD_TILE_ROWS = 16               # minibatch rows per tile-gradients block
_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: (N, d) any dtype, (B,) integer ids -> (B, d)."""
    return table.index_select(0, idx.long())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, d) table, (B,) int32 ids -> (B, d) rows in the table's dtype.

    A CUDA table goes to the kernel; a CPU table takes the plain version.
    Ids are not bounds-checked on the card (as on the TPU): the caller
    keeps them in [0, N).
    """
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous (N, d) "
                         f"tensor, got shape {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != table.device:
        raise ValueError("gather_rows: idx must be a (B,) int32 tensor on "
                         f"{table.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    idx = idx.contiguous()
    B, d = idx.shape[0], table.shape[1]
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    if B == 0:
        return out
    lib = build.library("gather_rows")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.gather_rows(table.data_ptr(), idx.data_ptr(), B,
                             d * table.element_size(), out.data_ptr(), stream)
    build.check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


# --------------------------------------------------------------------------
# SGNS: plain versions
# --------------------------------------------------------------------------
def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, i.e. logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def tile_grads_plain(v, c, n, m):
    """v, c: (Bt, d); n: (S, d); m: (Bt, 1) — all f32.
    Returns (dv, dc, dn_tile, loss_tile) in f32 (``_tile_grads``)."""
    pos = torch.sum(v * c, dim=-1, keepdim=True)               # (Bt, 1)
    neg = v @ n.T                                              # (Bt, S)
    g_pos = (torch.sigmoid(pos) - 1.0) * m
    g_neg = torch.sigmoid(neg) * m
    dv = g_pos * c + g_neg @ n
    dc = g_pos * v
    dn = g_neg.T @ v                                           # (S, d)
    loss = torch.sum(m * _softplus(-pos)) + torch.sum(m * _softplus(neg))
    return dv, dc, dn, loss


def _gathered_grads(vert, ctx, idx_v, idx_c, idx_n, mask):
    f32 = torch.float32
    v = vert.index_select(0, idx_v.long()).to(f32)
    c = ctx.index_select(0, idx_c.long()).to(f32)
    n = ctx.index_select(0, idx_n.long()).to(f32)
    return tile_grads_plain(v, c, n, mask.to(f32).reshape(-1, 1))


def sgns_fused_grads_plain(vert, ctx, idx_v, idx_c, idx_n, mask):
    """(loss f32, dv, dc, dn) of one minibatch, the gradients in the tables'
    dtype, as ``sgns_fused_grads`` returns them."""
    dv, dc, dn, loss = _gathered_grads(vert, ctx, idx_v, idx_c, idx_n, mask)
    return loss, dv.to(vert.dtype), dc.to(ctx.dtype), dn.to(ctx.dtype)


def _apply_plain(table, idx, grad, lr32):
    """table[r] += cast(-lr * sum of grad rows aimed at r), once per unique
    r, the sum in f32 in position order (``index_add_``)."""
    uniq, inv = torch.unique(idx.long(), return_inverse=True)
    total = torch.zeros((uniq.numel(), grad.shape[1]), dtype=torch.float32,
                        device=grad.device).index_add_(0, inv, grad)
    upd = (total * (-lr32)).to(table.dtype)
    table[uniq] = (table[uniq].to(torch.float32)
                   + upd.to(torch.float32)).to(table.dtype)


def sgns_fused_update_plain(vert, ctx, idx_v, idx_c, idx_n, mask, lr):
    """One SGNS SGD minibatch, in place on ``vert`` and ``ctx``.

    The same function as ``sgns_fused_update(combine="segsum")``: gradients
    in f32 from the rows as they were before the update, duplicates of each
    table combined in f32 (the context side over ``idx_c ++ idx_n``), the
    update cast to the table's dtype and added once. Returns
    ``(vert, ctx, loss)``.
    """
    lr32 = float(np.float32(lr))
    dv, dc, dn, loss = _gathered_grads(vert, ctx, idx_v, idx_c, idx_n, mask)
    _apply_plain(vert, idx_v, dv, lr32)
    _apply_plain(ctx, torch.cat([idx_c, idx_n]), torch.cat([dc, dn]), lr32)
    return vert, ctx, loss


# --------------------------------------------------------------------------
# SGNS: the CUDA wrappers
# --------------------------------------------------------------------------
def grads_tile_smem_bytes(bb: int, S: int, d: int) -> int:
    """Shared memory of one tile-gradients block: the (bb, d) v and c rows
    and the (S, d) negatives in f32, the (bb, S + 1) gradients and loss
    terms, and the (bb,) mask."""
    return 4 * (2 * bb * d + S * d + 2 * bb * (S + 1) + bb)


def plan_grads_tile(B: int, S: int, d: int) -> tuple[int, int]:
    """(rows per block, shared bytes) of the tile-gradients kernel:
    ``GRAD_TILE_ROWS`` rows, halved while the block would exceed the
    card's 227 KB. Raises ``ValueError`` when one row does not fit (the S
    negative rows alone are too wide)."""
    bb = max(1, min(GRAD_TILE_ROWS, B))
    while bb > 1 and grads_tile_smem_bytes(bb, S, d) > SMEM_PER_BLOCK:
        bb //= 2
    smem = grads_tile_smem_bytes(bb, S, d)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"S={S} negatives of width d={d} do not fit the "
                         f"tile-gradients block's shared memory "
                         f"({smem} > {SMEM_PER_BLOCK} bytes)")
    return bb, smem


def _check_sgns_args(name, vert, ctx, idx_v, idx_c, idx_n, mask):
    """Validate what the CUDA kernels take; returns (B, S, d, mask_bf16)."""
    dev = vert.device
    if dev.type != "cuda" or ctx.device != dev:
        raise ValueError(f"{name}: vert and ctx must be on one CUDA device, "
                         f"got {vert.device} and {ctx.device}")
    if vert.dtype not in _TABLE_DTYPES or ctx.dtype != vert.dtype:
        raise ValueError(f"{name}: tables must share a dtype in "
                         f"{sorted(map(str, _TABLE_DTYPES))}, got "
                         f"{vert.dtype} and {ctx.dtype}")
    if (vert.dim() != 2 or ctx.dim() != 2 or vert.shape[1] != ctx.shape[1]
            or not vert.is_contiguous() or not ctx.is_contiguous()):
        raise ValueError(f"{name}: tables must be contiguous (N, d) tensors "
                         f"of one width, got {tuple(vert.shape)} and "
                         f"{tuple(ctx.shape)}")
    for label, t in (("idx_v", idx_v), ("idx_c", idx_c), ("idx_n", idx_n)):
        if (t.dtype != torch.int32 or t.dim() != 1 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous 1-D "
                             f"int32 tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, S = idx_v.shape[0], idx_n.shape[0]
    if idx_c.shape[0] != B or B < 1 or S < 1:
        raise ValueError(f"{name}: need len(idx_v) == len(idx_c) >= 1 and "
                         f"len(idx_n) >= 1, got {B}, {idx_c.shape[0]}, {S}")
    if (mask.shape != (B,) or mask.device != dev or not mask.is_contiguous()
            or mask.dtype not in (torch.float32, vert.dtype)):
        raise ValueError(f"{name}: mask must be a contiguous ({B},) float32 "
                         f"or {vert.dtype} tensor on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    return B, S, vert.shape[1], int(mask.dtype == torch.bfloat16)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def sgns_fused_grads(vert, ctx, idx_v, idx_c, idx_n, mask):
    """Fused gather + SGNS gradients of one minibatch.

    vert: (Nv, d), ctx: (Nc, d), f32 or bf16; idx_v, idx_c: (B,) and
    idx_n: (S,) int32; mask: (B,) f32 or the tables' dtype. Returns
    ``(loss, dv, dc, dn)``: loss a 0-d f32 tensor, the gradients in the
    tables' dtype. A CPU table takes the plain version.
    """
    if vert.device.type == "cpu":
        return sgns_fused_grads_plain(vert, ctx, idx_v, idx_c, idx_n, mask)
    B, S, d, mask_bf16 = _check_sgns_args("sgns_fused_grads", vert, ctx,
                                          idx_v, idx_c, idx_n, mask)
    bb, smem = plan_grads_tile(B, S, d)
    nblk = -(-B // bb)
    dev = vert.device
    dv = torch.empty((B, d), dtype=vert.dtype, device=dev)
    dc = torch.empty((B, d), dtype=vert.dtype, device=dev)
    dn = torch.empty((S, d), dtype=vert.dtype, device=dev)
    # f32 scratch: dn partials (nblk, S, d), loss partials (nblk,), loss
    scratch = torch.empty(nblk * S * d + nblk + 1, dtype=torch.float32,
                          device=dev)
    p = scratch.data_ptr()
    p_lp, p_loss = p + 4 * nblk * S * d, p + 4 * (nblk * S * d + nblk)
    lib = build.library("sgns_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sgns_fused_grads(
            _TABLE_DTYPES[vert.dtype], mask_bf16, vert.data_ptr(),
            ctx.data_ptr(), idx_v.data_ptr(), idx_c.data_ptr(),
            idx_n.data_ptr(), mask.data_ptr(), B, S, d, bb, smem,
            dv.data_ptr(), dc.data_ptr(), p, p_lp, dn.data_ptr(), p_loss,
            stream)
    build.check(rc, "sgns_fused_grads")
    LAUNCHES["sgns_fused_grads"] += 1
    return scratch[-1], dv, dc, dn


def sgns_fused_update(vert, ctx, idx_v, idx_c, idx_n, mask, lr):
    """One fused SGNS SGD minibatch, in place on ``vert`` and ``ctx``.

    Arguments as :func:`sgns_fused_grads`, plus ``lr`` (a Python float,
    passed to the kernel as f32). ``vert`` and ``ctx`` must not overlap in
    memory: each unique row is written by one warp, which reads its old
    value from the same table. The sort of the index vectors stays outside
    the kernels, as the JAX wrapper's argsort does: two stable
    ``torch.sort`` calls. Returns ``(vert, ctx, loss)``, the tables being
    the updated inputs. A CPU table takes the plain version.
    """
    if vert.device.type == "cpu":
        return sgns_fused_update_plain(vert, ctx, idx_v, idx_c, idx_n, mask,
                                       lr)
    B, S, d, mask_bf16 = _check_sgns_args("sgns_fused_update", vert, ctx,
                                          idx_v, idx_c, idx_n, mask)
    if _overlap(vert, ctx):
        raise ValueError("sgns_fused_update: vert and ctx overlap in memory; "
                         "the in-place update needs two distinct tables")
    bb, smem = plan_grads_tile(B, S, d)
    nblk = -(-B // bb)
    dev = vert.device
    ivs, perm_v = torch.sort(idx_v, stable=True)
    icns, perm_c = torch.sort(torch.cat([idx_c, idx_n]), stable=True)
    # f32 scratch: dv, dc (B, d), dn partials (nblk, S, d), loss partials
    # (nblk,), loss
    n_dn = nblk * S * d
    scratch = torch.empty(2 * B * d + n_dn + nblk + 1, dtype=torch.float32,
                          device=dev)
    p = scratch.data_ptr()
    p_dc, p_dn = p + 4 * B * d, p + 8 * B * d
    p_lp, p_loss = p_dn + 4 * n_dn, p_dn + 4 * (n_dn + nblk)
    lib = build.library("sgns_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sgns_fused_update(
            _TABLE_DTYPES[vert.dtype], mask_bf16, vert.data_ptr(),
            ctx.data_ptr(), idx_v.data_ptr(), idx_c.data_ptr(),
            idx_n.data_ptr(), mask.data_ptr(), B, S, d, float(lr), bb, smem,
            ivs.data_ptr(), perm_v.data_ptr(), icns.data_ptr(),
            perm_c.data_ptr(), p, p_dc, p_dn, p_lp, p_loss, stream)
    build.check(rc, "sgns_fused_update")
    LAUNCHES["sgns_fused_update"] += 1
    return vert, ctx, scratch[-1]
