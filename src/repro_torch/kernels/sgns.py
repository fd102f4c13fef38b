"""Embedding-row kernels shared by training and serving: the CUDA kernels
and their plain PyTorch versions.

Counterpart of the JAX package's ``kernels/sgns.py``. Seven wrappers launch
three CUDA sources:

* :func:`gather_rows` replaces the TPU kernel ``gather_rows`` (blocked row
  DMAs); the two-tier retrieval scan uses it to fetch its survivors, and
  the trainer's ``pallas`` route its minibatch rows. Its source is
  ``csrc/gather_rows.cu``: a group of lanes per row, the widest vector the
  row and the bases allow, one wave of blocks (:func:`plan_gather`). Bound
  by bytes; at serving sizes latency and the launch are most of its time.
  :func:`gather_rows_rowwise` replaces ``gather_rows_rowwise``, the
  one-row-per-grid-step reference the blocked gather is held against: one
  block per output row, in the same source.
* :func:`sgns_fused_update` replaces ``sgns_fused_update`` (the training
  hot loop: gather, SGNS gradients, duplicate combine and in-place SGD),
  :func:`sgns_fused_grads` replaces ``sgns_fused_grads`` (gather and
  gradients only) and :func:`sgns_grads` replaces ``sgns_grads`` (the
  gradients of pre-gathered rows). All three launch ``csrc/sgns_update.cu``,
  whose header has the design. The update is one cooperative launch per
  minibatch (:func:`plan_fused_update`): tile-gradient blocks with
  per-block partials while one block sorts the ids on chip, a grid-wide
  barrier, then every warp combines and applies runs of equal ids, so a
  run repeats bitwise. ``sgns_grads`` and ``sgns_fused_grads`` are one
  cooperative launch of one kernel (:func:`plan_sgns_grads`), with the
  rows gathered beforehand or read through the ids: 8-row gradient tiles,
  up to one block an SM (a block takes several tiles past that), a
  grid-wide barrier, then the blocks' dn partials summed in block order.
* :func:`scatter_add_rows` replaces ``scatter_add_rows`` (``table[idx[p]]
  += upd[p]`` in position order, in place) and
  :func:`scatter_add_rows_rowwise` its one-row-per-grid-step reference
  ``scatter_add_rows_rowwise``. Both launch ``csrc/scatter_rows.cu``, a
  block per 8 columns over chunks of positions staged in shared memory:
  one sorts a chunk's ids on chip and gives each run of equal ids to one
  group of lanes (:func:`plan_scatter` cuts the chunks); the other links
  each position to its row's previous one by an equality scan and walks
  every position in order, one thread per column
  (:func:`plan_scatter_rowwise`).

A tensor on the CPU takes the plain version (``*_plain``); a tensor on the
card goes to the kernel or the call raises. The plain versions compute the
same function in plain PyTorch: gradients in f32 (:func:`tile_grads_plain`,
the counterpart of ``_tile_grads``); for the fused update duplicates
combined in f32 and one cast per row; for the scatter one rounding to the
table's dtype per position, in position order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build

# launches of each CUDA kernel of this module (counted where it launches)
LAUNCHES = {"gather_rows": 0, "gather_rows_rowwise": 0, "sgns_grads": 0,
            "sgns_fused_grads": 0, "sgns_fused_update": 0,
            "scatter_add_rows": 0, "scatter_add_rows_rowwise": 0}

SMEM_PER_BLOCK = 232_448          # H100: 227 KB of dynamic shared memory
GRAD_TILE_ROWS = 16               # plan_grads_tile's rows per block
FUSED_TILE_ROWS = 8               # the same, in the fused update
GRADS_ROWS = 8                    # the same, a tile of (fused) sgns_grads
SCATTER_COLS = 8                  # columns per scatter block (#9, #10)
SCATTER_MAX_POSITIONS = 1024      # positions per chunk: one per thread
SCATTER_ROWWISE_SMEM = 96 << 10   # shared memory of a full row-wise chunk
SCATTER_ROWWISE_MAX_POSITIONS = 2048   # the row-wise kernel's staging
FUSED_WARPS = 8                   # warps of a fused-update block
# positions a sorting block of the fused update holds (a side's B or B + S):
# 8-byte keys and 4-byte run starts, a power of two of each, in one
# block's shared memory
FUSED_SORT_CAP = 1 << ((SMEM_PER_BLOCK // 12).bit_length() - 1)
_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: (N, d) any dtype, (B,) integer ids -> (B, d)."""
    return table.index_select(0, idx.long())


# --------------------------------------------------------------------------
# launching on the card: the wrappers' shared host path
# --------------------------------------------------------------------------
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream, with ``dev`` the
    current device. Returns ``fn``'s CUDA error code."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


GATHER_THREADS = 256              # threads of a gather block
GATHER_BLOCKS_PER_SM = 8          # blocks an SM holds (__launch_bounds__)
GATHER_VECTORS = (16, 8, 4, 2, 1)     # bytes a lane may move at once


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Geometry of one :func:`gather_rows`: each lane moves ``vec_bytes``
    at once, a row is ``units`` such vectors and takes ``lanes`` lanes (a
    power of two up to 32: a warp copies ``32 // lanes`` rows a step, and a
    row wider than 32 vectors loops within its lanes), over ``blocks``
    blocks of ``GATHER_THREADS``."""

    vec_bytes: int
    units: int
    lanes: int
    blocks: int


def plan_gather(B: int, row_bytes: int, sm_count: int = 132,
                align: int = 16) -> GatherPlan:
    """The gather's geometry for B rows of ``row_bytes``, table and output
    bases both ``align``-byte aligned (a power of two): the widest vector
    of ``GATHER_VECTORS`` that divides the row and the alignment, and as
    many blocks as B needs, at most one wave of ``sm_count *
    GATHER_BLOCKS_PER_SM`` (the kernel strides past it)."""
    vec = next(v for v in GATHER_VECTORS
               if row_bytes % v == 0 and align % v == 0)
    units = row_bytes // vec
    lanes = min(32, 1 << max(units - 1, 0).bit_length())
    per_block = GATHER_THREADS // lanes               # rows a block a step
    return GatherPlan(vec_bytes=vec, units=units, lanes=lanes,
                      blocks=max(1, min(sm_count * GATHER_BLOCKS_PER_SM,
                                        -(-B // per_block))))


def _check_gather(name, table, idx):
    """Validate what the gather kernels take; returns the ids contiguous."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: table must be a contiguous (N, d) "
                         f"tensor, got shape {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != table.device:
        raise ValueError(f"{name}: idx must be a (B,) int32 tensor on "
                         f"{table.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    return idx.contiguous()


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, d) table, (B,) int32 ids -> (B, d) rows in the table's dtype.

    A CUDA table goes to the kernel (:func:`plan_gather`); a CPU table
    takes the plain version. Ids are not bounds-checked on the card (as on
    the TPU): the caller keeps them in [0, N).
    """
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    idx = _check_gather("gather_rows", table, idx)
    B, d = idx.shape[0], table.shape[1]
    dev = table.device
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    row_bytes = d * table.element_size()
    base = table.data_ptr() | out.data_ptr() | 16
    plan = plan_gather(B, row_bytes, _sm_count(dev), base & -base)
    rc = _launch(dev, build.library("gather_rows").gather_rows,
                 table.data_ptr(), idx.data_ptr(), B, row_bytes,
                 plan.vec_bytes, plan.lanes.bit_length() - 1, plan.blocks,
                 out.data_ptr())
    build.check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


# the row-wise reference computes the blocked gather's function
gather_rows_rowwise_plain = gather_rows_plain


def gather_rows_rowwise(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows` one output row per block: the reference the
    blocked gather is held against bitwise. Arguments as there."""
    if table.device.type == "cpu":
        return gather_rows_rowwise_plain(table, idx)
    idx = _check_gather("gather_rows_rowwise", table, idx)
    B, d = idx.shape[0], table.shape[1]
    dev = table.device
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = _launch(dev, build.library("gather_rows").gather_rows_rowwise,
                 table.data_ptr(), idx.data_ptr(), B,
                 d * table.element_size(), out.data_ptr())
    build.check(rc, "gather_rows_rowwise")
    LAUNCHES["gather_rows_rowwise"] += 1
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


def _grads_f32(v, c, n, mask):
    f32 = torch.float32
    return tile_grads_plain(v.to(f32), c.to(f32), n.to(f32),
                            mask.to(f32).reshape(-1, 1))


def sgns_grads_plain(v, c, n, mask):
    """(loss f32, dv, dc, dn) of pre-gathered rows v, c: (B, d), n: (S, d)
    and mask (B,), computed in f32 and returned in the inputs' dtypes, as
    ``sgns_grads`` returns them (``ref.sgns_grads_ref``)."""
    dv, dc, dn, loss = _grads_f32(v, c, n, mask)
    return loss, dv.to(v.dtype), dc.to(c.dtype), dn.to(n.dtype)


def sgns_fused_grads_plain(vert, ctx, idx_v, idx_c, idx_n, mask):
    """(loss f32, dv, dc, dn) of one minibatch, the gradients in the tables'
    dtype, as ``sgns_fused_grads`` returns them."""
    return sgns_grads_plain(gather_rows_plain(vert, idx_v),
                            gather_rows_plain(ctx, idx_c),
                            gather_rows_plain(ctx, idx_n), mask)


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
    dv, dc, dn, loss = _grads_f32(gather_rows_plain(vert, idx_v),
                                  gather_rows_plain(ctx, idx_c),
                                  gather_rows_plain(ctx, idx_n), mask)
    _apply_plain(vert, idx_v, dv, lr32)
    _apply_plain(ctx, torch.cat([idx_c, idx_n]), torch.cat([dc, dn]), lr32)
    return vert, ctx, loss


def scatter_add_rows_plain(table, idx, upd):
    """``table[idx[p]] += upd[p]`` in place, in position order, the update
    rounded to the table's dtype and each add rounded to it: what the TPU
    kernel's sequential grid gives for duplicates. Returns ``table``.

    Vectorized by rank: each position's rank within its run of equal ids
    in the stable sort is how many earlier positions hit the same row, so
    round r adds every rank-r position, and the rows of one round are
    unique. There are as many rounds as the longest run.
    """
    n = idx.shape[0]
    if n == 0:
        return table
    srt, perm = torch.sort(idx.long(), stable=True)
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = srt[1:] != srt[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    upd_t = upd.to(table.dtype)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        rows, p = srt[sel], perm[sel]
        table[rows] = (table[rows].float() + upd_t[p].float()).to(table.dtype)
    return table


# the row-wise reference computes the sorted scatter's function
scatter_add_rows_rowwise_plain = scatter_add_rows_plain


# --------------------------------------------------------------------------
# SGNS: the CUDA wrappers
# --------------------------------------------------------------------------
def grads_tile_smem_bytes(bb: int, S: int, d: int) -> int:
    """Shared memory of one tile-gradients block: the (bb, d) v and c rows
    and the (S, d) negatives in f32, the (bb, S + 1) gradients and loss
    terms, and the (bb,) mask."""
    return 4 * (2 * bb * d + S * d + 2 * bb * (S + 1) + bb)


def plan_grads_tile(B: int, S: int, d: int,
                    rows: int = GRAD_TILE_ROWS) -> tuple[int, int]:
    """(rows per block, shared bytes) of the tile-gradients kernel:
    ``rows`` rows, halved while the block would exceed the card's 227 KB.
    Raises ``ValueError`` when one row does not fit (the S negative rows
    alone are too wide)."""
    bb = max(1, min(rows, B))
    while bb > 1 and grads_tile_smem_bytes(bb, S, d) > SMEM_PER_BLOCK:
        bb //= 2
    smem = grads_tile_smem_bytes(bb, S, d)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"S={S} negatives of width d={d} do not fit the "
                         f"tile-gradients block's shared memory "
                         f"({smem} > {SMEM_PER_BLOCK} bytes)")
    return bb, smem


@dataclasses.dataclass(frozen=True)
class GradsPlan:
    """Geometry of one :func:`sgns_grads`: ``bb`` minibatch rows per tile,
    ``tiles`` tiles, ``blocks`` blocks (one cooperative launch, at most one
    per SM, each taking tiles ``blockIdx``, ``blockIdx + blocks``, ...) and
    the dynamic shared memory of a block (:func:`grads_tile_smem_bytes`)."""

    bb: int
    tiles: int
    blocks: int
    smem_bytes: int


def plan_sgns_grads(B: int, S: int, d: int, *,
                    sm_count: int = 132) -> GradsPlan:
    """:func:`plan_grads_tile` with ``GRADS_ROWS`` rows a tile, and as many
    blocks as tiles, at most one per SM (the launch is cooperative, and one
    block per SM is the residency every grid of this size is sure of);
    past that each block takes several tiles. Raises ``ValueError`` when
    the S negative rows of width d do not fit a block's shared memory."""
    if B < 1 or S < 1:
        raise ValueError(f"sgns_grads: need B, S >= 1, got {B}, {S}")
    bb, smem = plan_grads_tile(B, S, d, GRADS_ROWS)
    tiles = -(-B // bb)
    return GradsPlan(bb=bb, tiles=tiles, blocks=min(tiles, sm_count),
                     smem_bytes=smem)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Geometry of one fused update: ``bb`` minibatch rows per gradient
    block (``grad_blocks`` of them), then two sorting blocks (the vertex
    side's B positions, the context side's B + S), then more up to
    ``blocks`` so the combine has a warp per position; ``sort_keys`` (B +
    S rounded up to a power of two, the larger side's keys), and the
    dynamic shared memory of a block (the larger of a gradient tile's and
    a sort's: the keys and the run starts)."""

    bb: int
    grad_blocks: int
    blocks: int
    sort_keys: int
    smem_bytes: int


def plan_fused_update(B: int, S: int, d: int, *,
                      sm_count: int = 132) -> FusedPlan:
    """The fused update's geometry (:func:`plan_grads_tile` for the
    gradient tiles, ``FUSED_TILE_ROWS`` rows each). Raises
    ``ValueError`` when a side's B + S positions pass ``FUSED_SORT_CAP`` (a
    sorting block's shared memory) or when the grid has more blocks than
    the card has SMs: the launch is cooperative, and one block per SM is
    the residency every grid of this size is sure of (the kernel also asks
    the card, and its launch fails rather than hang)."""
    bb, grads_smem = plan_grads_tile(B, S, d, FUSED_TILE_ROWS)
    if B + S > FUSED_SORT_CAP:
        raise ValueError(f"sgns_fused_update sorts B + S = {B + S} context "
                         f"positions on chip; a sorting block's shared "
                         f"memory holds {FUSED_SORT_CAP}")
    nblk = -(-B // bb)
    if nblk + 2 > sm_count:
        raise ValueError(f"sgns_fused_update at B={B} needs {nblk + 2} "
                         f"blocks resident at once, more than the card's "
                         f"{sm_count} SMs")
    n2 = 1 << (B + S - 1).bit_length()
    n = 2 * B + S
    return FusedPlan(bb=bb, grad_blocks=nblk,
                     blocks=min(sm_count, max(nblk + 2, -(-n // FUSED_WARPS))),
                     sort_keys=n2, smem_bytes=max(grads_smem, 12 * n2 + 4))


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


def _grads_launch(dev, dtype, B, S, d):
    """The plan of one cooperative gradients launch (:func:`plan_sgns_grads`)
    and its outputs: ``(plan, (loss, dv, dc, dn), pointers)``, dv and dc (B,
    d) and dn (S, d) in ``dtype``, the loss the last element of an f32
    scratch that first holds the blocks' dn partials (blocks, S, d) and loss
    partials (blocks,); ``pointers`` are the C entries' last six arguments
    (dv, dc, dn partials, loss partials, dn, loss)."""
    plan = plan_sgns_grads(B, S, d, sm_count=_sm_count(dev))
    nblk = plan.blocks
    dv = torch.empty((B, d), dtype=dtype, device=dev)
    dc = torch.empty((B, d), dtype=dtype, device=dev)
    dn = torch.empty((S, d), dtype=dtype, device=dev)
    scratch = torch.empty(nblk * S * d + nblk + 1, dtype=torch.float32,
                          device=dev)
    p = scratch.data_ptr()
    ptrs = (dv.data_ptr(), dc.data_ptr(), p, p + 4 * nblk * S * d,
            dn.data_ptr(), p + 4 * (nblk * S * d + nblk))
    return plan, (scratch[-1], dv, dc, dn), ptrs


def sgns_fused_grads(vert, ctx, idx_v, idx_c, idx_n, mask):
    """Fused gather + SGNS gradients of one minibatch.

    vert: (Nv, d), ctx: (Nc, d), f32 or bf16; idx_v, idx_c: (B,) and
    idx_n: (S,) int32; mask: (B,) f32 or the tables' dtype. Returns
    ``(loss, dv, dc, dn)``: loss a 0-d f32 tensor, the gradients in the
    tables' dtype. On the card the call is one cooperative kernel launch,
    :func:`sgns_grads`'s kernel with the rows read through the ids, so it
    equals ``sgns_grads(vert[idx_v], ctx[idx_c], ctx[idx_n], mask)``
    bitwise. A CPU table takes the plain version.
    """
    if vert.device.type == "cpu":
        return sgns_fused_grads_plain(vert, ctx, idx_v, idx_c, idx_n, mask)
    B, S, d, mask_bf16 = _check_sgns_args("sgns_fused_grads", vert, ctx,
                                          idx_v, idx_c, idx_n, mask)
    dev = vert.device
    plan, out, ptrs = _grads_launch(dev, vert.dtype, B, S, d)
    rc = _launch(dev, build.library("sgns_update").sgns_fused_grads,
                 _TABLE_DTYPES[vert.dtype], mask_bf16, vert.data_ptr(),
                 ctx.data_ptr(), idx_v.data_ptr(), idx_c.data_ptr(),
                 idx_n.data_ptr(), mask.data_ptr(), B, S, d, plan.bb,
                 plan.blocks, plan.smem_bytes, *ptrs)
    build.check(rc, "sgns_fused_grads")
    LAUNCHES["sgns_fused_grads"] += 1
    return out


def sgns_fused_update(vert, ctx, idx_v, idx_c, idx_n, mask, lr):
    """One fused SGNS SGD minibatch, in place on ``vert`` and ``ctx``.

    Arguments as :func:`sgns_fused_grads`, plus ``lr`` (a Python float,
    passed to the kernel as f32). ``vert`` and ``ctx`` must not overlap in
    memory: each unique row is written by one warp, which reads its old
    value from the same table. On the card the call is one kernel launch
    and nothing else on the device: the ids are sorted on chip
    (:func:`plan_fused_update`). Returns ``(vert, ctx, loss)``, the tables
    being the updated inputs. A CPU table takes the plain version.
    """
    if vert.device.type == "cpu":
        return sgns_fused_update_plain(vert, ctx, idx_v, idx_c, idx_n, mask,
                                       lr)
    B, S, d, mask_bf16 = _check_sgns_args("sgns_fused_update", vert, ctx,
                                          idx_v, idx_c, idx_n, mask)
    if _overlap(vert, ctx):
        raise ValueError("sgns_fused_update: vert and ctx overlap in memory; "
                         "the in-place update needs two distinct tables")
    dev = vert.device
    plan = plan_fused_update(B, S, d, sm_count=_sm_count(dev))
    nblk = plan.grad_blocks
    # f32 scratch: dv, dc (B, d), dn partials (nblk, S, d), loss partials
    # (nblk,), loss; int32: each run's (start, end, id, first position),
    # the sorted positions and the two sides' run counts
    fscratch = torch.empty(2 * B * d + nblk * S * d + nblk + 1,
                           dtype=torch.float32, device=dev)
    iscratch = torch.empty(5 * (2 * B + S) + 2, dtype=torch.int32,
                           device=dev)
    rc = _launch(dev, build.library("sgns_update").sgns_fused_update,
                 _TABLE_DTYPES[vert.dtype], mask_bf16, vert.data_ptr(),
                 ctx.data_ptr(), idx_v.data_ptr(), idx_c.data_ptr(),
                 idx_n.data_ptr(), mask.data_ptr(), B, S, d, float(lr),
                 plan.bb, plan.blocks, plan.smem_bytes, fscratch.data_ptr(),
                 iscratch.data_ptr())
    build.check(rc, "sgns_fused_update")
    LAUNCHES["sgns_fused_update"] += 1
    return vert, ctx, fscratch[-1]


def sgns_grads(v, c, n, mask):
    """SGNS loss and gradients of pre-gathered rows.

    v, c: (B, d) and n: (S, d), one dtype (f32 or bf16); mask: (B,) f32 or
    that dtype. Returns ``(loss, dv, dc, dn)``: loss a 0-d f32 tensor, dv
    and dc in the rows' dtype, dn summed in f32 over the tiles in a fixed
    order and cast once. On the card the call is one cooperative kernel
    launch (:func:`plan_sgns_grads`). A CPU tensor takes the plain version.
    """
    if v.device.type == "cpu":
        return sgns_grads_plain(v, c, n, mask)
    dev = v.device
    if dev.type != "cuda" or c.device != dev or n.device != dev:
        raise ValueError(f"sgns_grads: v, c and n must be on one CUDA "
                         f"device, got {v.device}, {c.device}, {n.device}")
    if v.dtype not in _TABLE_DTYPES or c.dtype != v.dtype or n.dtype != v.dtype:
        raise ValueError(f"sgns_grads: v, c and n must share a dtype in "
                         f"{sorted(map(str, _TABLE_DTYPES))}, got {v.dtype}, "
                         f"{c.dtype} and {n.dtype}")
    if (v.dim() != 2 or c.shape != v.shape or n.dim() != 2
            or n.shape[1] != v.shape[1] or v.shape[0] < 1 or n.shape[0] < 1
            or not all(t.is_contiguous() for t in (v, c, n))):
        raise ValueError(f"sgns_grads: need contiguous v, c (B, d) and n "
                         f"(S, d) with B, S >= 1, got {tuple(v.shape)}, "
                         f"{tuple(c.shape)} and {tuple(n.shape)}")
    (B, d), S = v.shape, n.shape[0]
    if (mask.shape != (B,) or mask.device != dev or not mask.is_contiguous()
            or mask.dtype not in (torch.float32, v.dtype)):
        raise ValueError(f"sgns_grads: mask must be a contiguous ({B},) "
                         f"float32 or {v.dtype} tensor on {dev}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    plan, out, ptrs = _grads_launch(dev, v.dtype, B, S, d)
    rc = _launch(dev, build.library("sgns_update").sgns_grads,
                 _TABLE_DTYPES[v.dtype], int(mask.dtype == torch.bfloat16),
                 v.data_ptr(), c.data_ptr(), n.data_ptr(), mask.data_ptr(),
                 B, S, d, plan.bb, plan.blocks, plan.smem_bytes, *ptrs)
    build.check(rc, "sgns_grads")
    LAUNCHES["sgns_grads"] += 1
    return out


def _check_scatter_args(name, table, idx, upd):
    """Validate what the scatter kernels take; returns (B, d, upd_f32)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if (table.dtype not in _TABLE_DTYPES or table.dim() != 2
            or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be a contiguous (N, d) tensor "
                         f"of dtype in {sorted(map(str, _TABLE_DTYPES))}, "
                         f"got {table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != dev:
        raise ValueError(f"{name}: idx must be a (B,) int32 tensor on {dev}, "
                         f"got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    B, d = idx.shape[0], table.shape[1]
    if (upd.shape != (B, d) or upd.device != dev or not upd.is_contiguous()
            or upd.dtype not in (torch.float32, table.dtype)):
        raise ValueError(f"{name}: upd must be a contiguous ({B}, {d}) "
                         f"float32 or {table.dtype} tensor on {dev}, got "
                         f"{upd.dtype} {tuple(upd.shape)} on {upd.device}")
    if _overlap(table, upd):
        raise ValueError(f"{name}: upd overlaps the table in memory")
    return B, d, int(upd.dtype == torch.float32)


def scatter_smem_bytes(n: int, table_itemsize: int,
                       upd_itemsize: int) -> int:
    """Shared memory of one sorted-scatter block over a chunk of ``n``
    positions: the 64-bit sort keys (``n`` rounded up to a power of two),
    ``n`` rows of ``SCATTER_COLS`` columns of the updates and of the
    table, the ids and the run starts."""
    n2 = 1 << max(n - 1, 0).bit_length()
    return (8 * n2 + n * SCATTER_COLS * (table_itemsize + upd_itemsize)
            + 4 * (2 * n + 1))


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Launch geometry of one sorted scatter: ``positions`` per chunk, one
    launch per chunk in order (``chunks``, the [lo, hi) position ranges
    the C entry point walks), ``blocks`` of ``SCATTER_COLS`` columns each,
    and the shared memory of a full chunk's block."""

    positions: int
    chunks: tuple[tuple[int, int], ...]
    blocks: int
    smem_bytes: int


def plan_scatter(B: int, d: int, table_itemsize: int,
                 upd_itemsize: int) -> ScatterPlan:
    """Chunks of ``SCATTER_MAX_POSITIONS`` consecutive positions (one per
    thread of a block; a full chunk's block takes under 90 KB of shared
    memory at any supported dtypes). Applying consecutive chunks one
    after another is the same function as applying all B positions in
    order (the JAX kernel's ``rows_per_block`` blocks do the same)."""
    P = SCATTER_MAX_POSITIONS
    chunks = tuple((lo, min(lo + P, B)) for lo in range(0, B, P))
    return ScatterPlan(positions=P, chunks=chunks,
                       blocks=-(-d // SCATTER_COLS),
                       smem_bytes=scatter_smem_bytes(
                           P, table_itemsize, upd_itemsize))


def plan_scatter_rowwise(table_itemsize: int, upd_itemsize: int) -> int:
    """Positions per chunk of the row-wise scatter: as many as fit
    ``SCATTER_ROWWISE_SMEM``, a multiple of 32, at most
    ``SCATTER_ROWWISE_MAX_POSITIONS`` (the kernel's staging limit): 1280 at
    f32, 1632 for a bf16 table with f32 updates, 2048 at bf16. A position
    takes ``SCATTER_COLS`` columns of the update and of the table, and its
    id, previous occurrence and last-occurrence flag (``rowwise_smem`` in
    ``csrc/scatter_rows.cu``, which cuts B into these chunks and launches
    one after another; one at the trainer's sizes)."""
    per = SCATTER_COLS * (table_itemsize + upd_itemsize) + 12
    return min(SCATTER_ROWWISE_MAX_POSITIONS,
               SCATTER_ROWWISE_SMEM // per // 32 * 32)


def scatter_add_rows(table, idx, upd):
    """``table[idx[p]] += upd[p]`` in place, in position order.

    table: (N, d) f32 or bf16; idx: (B,) int32; upd: (B, d) f32 or the
    table's dtype. Each position's update is rounded to the table's dtype
    and each add rounded to it, so a duplicated row takes its updates one
    after another, as on the TPU's sequential grid. The kernel sorts each
    chunk's ids on chip (:func:`plan_scatter`; one launch per chunk, one
    at the trainer's sizes), keeping position order within each run.
    Returns ``table``. A CPU table takes the plain version.
    """
    if table.device.type == "cpu":
        return scatter_add_rows_plain(table, idx, upd)
    B, d, upd_f32 = _check_scatter_args("scatter_add_rows", table, idx, upd)
    if B == 0:
        return table
    idx = idx.contiguous()
    plan = plan_scatter(B, d, table.element_size(), upd.element_size())
    rc = _launch(table.device,
                 build.library("scatter_rows").scatter_add_rows,
                 _TABLE_DTYPES[table.dtype], upd_f32, table.data_ptr(),
                 idx.data_ptr(), upd.data_ptr(), B, d, plan.positions)
    build.check(rc, "scatter_add_rows")
    LAUNCHES["scatter_add_rows"] += 1
    return table


def scatter_add_rows_rowwise(table, idx, upd):
    """:func:`scatter_add_rows` with no sort and no run walk: one thread per
    column walks every position in order, each position linked to its
    row's previous one by an equality scan of the chunk's ids
    (:func:`plan_scatter_rowwise`). The reference the sorted scatter is
    held against bitwise. Arguments as there."""
    if table.device.type == "cpu":
        return scatter_add_rows_rowwise_plain(table, idx, upd)
    B, d, upd_f32 = _check_scatter_args("scatter_add_rows_rowwise", table,
                                        idx, upd)
    if B == 0:
        return table
    idx = idx.contiguous()
    P = plan_scatter_rowwise(table.element_size(), upd.element_size())
    rc = _launch(table.device,
                 build.library("scatter_rows").scatter_add_rows_rowwise,
                 _TABLE_DTYPES[table.dtype], upd_f32, table.data_ptr(),
                 idx.data_ptr(), upd.data_ptr(), B, d, P)
    build.check(rc, "scatter_add_rows_rowwise")
    LAUNCHES["scatter_add_rows_rowwise"] += 1
    return table
