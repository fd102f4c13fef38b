"""Exact MIPS top-k over one table shard: CUDA scans and their plain versions.

Counterpart of the JAX package's ``embed_serve/topk.py``. Two wrappers
launch one CUDA source, ``kernels/csrc/topk_scan.cu``:

* :func:`topk_mips` replaces the TPU kernel ``topk_mips`` (f32 or bf16
  table): approximate scores on the tensor cores filter the pairs, and
  only the survivors are scored exactly (:func:`plan_topk_filter`);
* :func:`topk_mips_quant` replaces ``topk_mips_quant`` (int8 table with
  per-row scales, the first pass of the two-tier scan in ``quant``): the
  same filter kernel on int8 rows, its bound times each row's scale.

and a third launches ``kernels/csrc/topk_rowwise.cu``:

* :func:`topk_mips_rowwise` replaces ``topk_mips_rowwise``, the
  independent reference of ``topk_mips``: every score of a chunk of
  rows into a scratch buffer, then an exact radix select per query that
  carries the k best from chunk to chunk (:func:`plan_topk_rowwise`); no
  per-split lists, no merge, no code shared with the scan.

Any width and depth: on the card the kernels read a table whose columns
are padded with zeros to a multiple of 8 (:func:`pad_columns`; the store
pads once at load, a wrapper pads what it is given), which scores every
pair as the real columns do up to the sign of a zero; the filter scores
rows past 256 columns in 256-column slices; past what shared memory holds
the merge's and #4's selection's lists live in device memory.

A tensor on the CPU takes the plain version (:func:`topk_mips_plain`,
:func:`topk_mips_quant_plain`, :func:`topk_mips_rowwise_plain`); a tensor
on the card goes to the kernel or the call raises. The plain versions scan
the rows in chunks and fold each chunk into the running result with
:func:`select_topk`, so they never hold the whole (Q, N) score matrix.

Exactness: scores are f32 (tables widened before the dot, queries kept in
f32), and selection follows one total order, score descending and then row
ascending, the order of the numpy oracle's stable argsort. Invalid
positions (rows >= ``valid``, unfilled slots) carry ``(-inf, int32 max)``.
The filter drops a pair only when its approximate score plus the error
bound of :func:`topk_filter_bounds_plain` (for int8 rows, that edge times
the row's scale: :func:`topk_filter_edges_plain`) is below the k-th exact
score found so far, so the result stays the exact one bit for bit.

Bound on an H100 (the kernel's own note has the design): 2*Q*N*d
operations against N*d*itemsize table bytes (int8: N*(d + 4)). At the
serving widths both scans are bound by the table's bytes (3.35 TB/s) or
one pass of their products on the bf16 tensor cores (989 TFLOP/s).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

NEG_INF = float("-inf")
IDX_SENTINEL = 2**31 - 1          # int32 max

# launches of each CUDA kernel of this module (counted where it launches)
LAUNCHES = {"topk_scan_exact": 0, "topk_scan_int8": 0, "topk_rowwise": 0}

SMEM_PER_BLOCK = 232_448          # H100: 227 KB of dynamic shared memory
FILTER_WARPS = 8                  # warps of a filter-scan block
FILTER_WIDTHS = (32, 64, 128, 256)   # compiled widths d is padded to
FILTER_SLICE = FILTER_WIDTHS[-1]     # past it: slices of this many columns
FILTER_QUEUE = 32                 # survivors a filter warp queues
FILTER_SEED = 16                  # lower bounds a warp seeds a query from
FILTER_SEED_INT8 = 40             # the same for int8 rows (m = 4k at k=10)
FILTER_GROUPS = 8                 # int8: split groups sharing thresholds
MERGE_WARPS = 4                   # queries per merge block
SMEM_STATIC = 49_152              # static shared memory of one block
ROWWISE_ROW_TILE = 128            # rows per rowwise score block
ROWWISE_QUERY_TILE = 64           # queries per rowwise score block
ROWWISE_K_TILE = 32               # depth per staged step of a score block
ROWWISE_SCRATCH_BYTES = 256 << 20 # cap on the (Q, chunk) f32 score scratch
ROWWISE_SELECT_CAP = 2048         # candidates a selection block sorts
ROWWISE_SELECT_BINS = 2048        # radix histogram bins (11-bit digits)
ROWWISE_K_MAX = ROWWISE_SELECT_CAP // 2   # past it: candidates in memory
PLAIN_CHUNK_ELEMS = 1 << 26       # (Q, chunk) scores per plain-scan step
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# --------------------------------------------------------------------------
# shared-memory planner (replaces the TPU's VMEM planner choose_block_n)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FilterPlan:
    """Launch geometry of one filter scan (:func:`topk_mips`): d padded to
    ``width``; ``query_tiles`` 8-query MMA tiles per warp; ``qw`` query
    groups per block of ``FILTER_WARPS`` warps (``bq`` queries a block,
    ``qblocks`` blocks across the queries); row tiles of ``tile_rows``;
    ``splits`` row ranges of ``rows_per_split`` rows; ``row_groups`` warps
    that see each query in a block (they share its list); whether the
    block's lists fit in shared memory (``lists_on_chip``, else they live
    in the partial output); the dynamic shared memory of a block; the
    largest k whose thresholds the first tile seeds (``seed``); whether the
    merge keeps its lists in shared memory (``merge_on_chip``, else in the
    output rows). ``width`` past ``FILTER_SLICE`` is d rounded up to a
    multiple of it: the kernel scores such rows slice by slice."""

    width: int
    query_tiles: int
    qw: int
    bq: int
    tile_rows: int
    qblocks: int
    splits: int
    rows_per_split: int
    row_groups: int
    lists_on_chip: bool
    smem_bytes: int
    seed: int
    merge_on_chip: bool = True


def plan_topk_filter(Q: int, d: int, k: int, valid: int, itemsize: int, *,
                     sm_count: int = 132) -> FilterPlan:
    """Geometry from the shapes alone.

    d, rounded up to a multiple of 8 (:func:`pad_columns`: the kernel's
    operands), is padded to the smallest compiled width, or past
    ``FILTER_SLICE`` scored in slices of it; a warp holds 8 * NT queries
    (NT = min(8, 32 / (slice / 16)), so their fragments take at most 64
    registers) and a block as few query groups (1, 2, 4, 8) as hold Q, the
    other warps splitting each tile's rows. One block per SM: the rows are
    cut into as many splits as leave one block per SM, each a whole number
    of tiles. ``itemsize`` 1 is an int8 table: its tiles stage as int8 and
    widen into one bf16 tile (beside the ring) with the rows' scales, and
    its seed is deeper. A wide table's block also keeps its tile's scores
    (tile rows x bq f32). Any d >= 1 and k >= 1.
    """
    if k < 1 or valid < 1 or Q < 1 or d < 1:
        raise ValueError(f"need k, valid, Q, d >= 1 (got {k}, {valid}, {Q}, "
                         f"{d})")
    d = -(-d // 8) * 8
    wide = d > FILTER_SLICE
    width = (-(-d // FILTER_SLICE) * FILTER_SLICE if wide
             else next(w for w in FILTER_WIDTHS if w >= d))
    cols = min(width, FILTER_SLICE)           # columns of a staged tile
    nt = min(8, 32 // (cols // 16))
    per_warp = 8 * nt
    qw = 1
    while qw < FILTER_WARPS and qw * per_warp < Q:
        qw *= 2
    bq = qw * per_warp
    tile = 64 if itemsize * cols > 512 else 128
    qblocks = -(-Q // bq)
    splits = max(1, min(-(-valid // tile), sm_count // qblocks))
    rows = -(-(-(-valid // splits)) // tile) * tile
    splits = -(-valid // rows)
    staging = 2 * tile * (cols + 16 // itemsize) * itemsize
    if itemsize == 1:           # the widened bf16 tile, two stages' scales
        staging += tile * (cols + 8) * 2 + 2 * tile * 4
    seed = FILTER_SEED_INT8 if itemsize == 1 else FILTER_SEED
    smem = (staging + 8 * bq
            + 4 * (3 * bq + FILTER_WARPS * per_warp * (seed + 1) + tile)
            + 8 * FILTER_WARPS * FILTER_QUEUE + 4 * FILTER_WARPS
            + 4 * tile * bq * wide)
    lists = 8 * bq * k
    on_chip = smem + lists <= SMEM_PER_BLOCK
    return FilterPlan(width=width, query_tiles=nt, qw=qw, bq=bq,
                      tile_rows=tile, qblocks=qblocks, splits=splits,
                      rows_per_split=rows, row_groups=FILTER_WARPS // qw,
                      lists_on_chip=on_chip,
                      smem_bytes=smem + lists * on_chip, seed=seed,
                      merge_on_chip=8 * MERGE_WARPS * k <= SMEM_PER_BLOCK)


# --------------------------------------------------------------------------
# selection and the cross-shard merge
# --------------------------------------------------------------------------
def select_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Exact top-k over (Q, M) candidate (value, index) pairs.

    Order: larger value first, and among equal values the smaller index;
    slots past the candidates are (-inf, int32 max). The same rule as the
    JAX package's ``select_topk``, computed by two stable sorts (index
    ascending, then value descending). Returns ((Q, k) f32, (Q, k) i32).
    """
    vals = vals.float()
    idx = idx.int()
    Q, M = vals.shape
    if M < k:
        vals = torch.cat([vals, vals.new_full((Q, k - M), NEG_INF)], 1)
        idx = torch.cat([idx, idx.new_full((Q, k - M), IDX_SENTINEL)], 1)
    order = torch.argsort(idx, dim=1, stable=True)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    # + 0.0 turns -0.0 into +0.0, so the two zeros tie as they compare
    order = torch.argsort(vals + 0.0, dim=1, descending=True,
                          stable=True)[:, :k]
    return vals.gather(1, order), idx.gather(1, order)


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Cross-shard reduce: (P, Q, kk) per-shard results (global ids) ->
    the global (Q, k), by one selection over the P*kk candidates."""
    P, Q, kk = vals.shape
    return select_topk(vals.transpose(0, 1).reshape(Q, P * kk),
                       idx.transpose(0, 1).reshape(Q, P * kk), k)


# --------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' reference on the card)
# --------------------------------------------------------------------------
def _scan_plain(score_chunk, n_valid: int, queries, k: int):
    """Fold row chunks [lo, hi) of the valid rows into a running top-k;
    ``score_chunk(lo, hi)`` gives their (Q, hi - lo) f32 scores."""
    Q = queries.shape[0]
    dev = queries.device
    best_v = torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), IDX_SENTINEL, dtype=torch.int32, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // max(Q, 1))
    for lo in range(0, n_valid, step):
        hi = min(lo + step, n_valid)
        rows = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        best_v, best_i = select_topk(
            torch.cat([best_v, score_chunk(lo, hi)], 1),
            torch.cat([best_i, rows.expand(Q, -1)], 1), k)
    return best_v, best_i


def topk_mips_plain(table, queries, k: int, valid: int | None = None):
    """Plain top-k of f32 scores ``queries @ table.T`` over rows < valid."""
    valid = table.shape[0] if valid is None else valid
    q = queries.float()
    return _scan_plain(lambda lo, hi: q @ table[lo:hi].float().T,
                       valid, q, k)


# the rowwise kernel computes the same function as the scan
topk_mips_rowwise_plain = topk_mips_plain

# the error allowance of the filter's bound (topk_scan.cu's note): the
# safety factor, the tensor cores' accumulation (d 2^-20) and the exact
# chain's (2 d 2^-24) per unit of d, and the floors of E'_q and n'_r
FILTER_SAFETY = 8.0
FILTER_ACC_PER_D = 2.0 ** -20 + 2.0 * 2.0 ** -24
FILTER_FLOOR = 2.0 ** -40


def topk_filter_bounds_plain(table, queries):
    """The filter's approximate scores and error bounds, plainly.

    Returns ``(a, eps)``, each (Q, N) f32: ``a`` the split-operand dot
    ``bf16(q) . bf16(row)`` (exact in f64, then rounded), ``eps`` the
    bound E'_q * n'_r of the kernel's note, with E_q = 8 (||q - bf16(q)||
    + ||q|| (rho_t + 2 d 2^-24 + d 2^-20)), rho_t = 0 for a bf16 or int8
    table (bf16 holds an int8 value exactly) and 2^-8 for an f32 one, n_r
    the norm of the row's bf16 values (of its f32 values for an f32 table)
    and 2^-40 added to both (E' = 0 for a zero query, whose scores are
    exactly 0). The exact score differs from ``a`` by at most ``eps`` (by
    at most ``eps / 4`` as the card checks it); for an int8 table both are
    unscaled (:func:`topk_filter_edges_plain` scales them)."""
    q = queries.double()
    qb = queries.float().bfloat16().double()
    tb = table.float().bfloat16().double()
    d = table.shape[1]
    rho_t = 0.0 if table.dtype in (torch.bfloat16, torch.int8) else 2.0 ** -8
    nq = torch.linalg.vector_norm(q, dim=1)
    e = FILTER_SAFETY * (torch.linalg.vector_norm(q - qb, dim=1)
                         + nq * (rho_t + d * FILTER_ACC_PER_D)) + FILTER_FLOOR
    # a zero query scores every finite row +0 exactly, both ways
    e = torch.where(nq > 0, e, 0.0)
    rows = tb if table.dtype == torch.bfloat16 else table.double()
    n = torch.linalg.vector_norm(rows, dim=1) + FILTER_FLOOR
    return (qb @ tb.T).float(), (e[:, None] * n[None, :]).float()


def topk_filter_edges_plain(qtable, scales, queries):
    """The int8 filter's test quantities, plainly: ``(lo, hi)``, each (Q, N)
    f32, ``hi = fl(fl(a + eps) * scale_r)`` and ``lo = fl(fl(a - eps) *
    scale_r)`` with ``a`` and ``eps`` of :func:`topk_filter_bounds_plain`
    on the int8 rows (``a -+ eps`` rounded once, as the kernel's fmaf
    rounds it). For every pair ``lo <= fl(s * scale_r) <= hi``, s the
    unscaled chain: the kernel skips a pair when ``hi`` is below the
    threshold and seeds thresholds from ``lo``."""
    a, eps = topk_filter_bounds_plain(qtable, queries)
    sc = scales.float()
    hi = (a.double() + eps.double()).float() * sc
    lo = (a.double() - eps.double()).float() * sc
    return lo, hi


def topk_mips_quant_plain(qtable, scales, queries, m: int,
                          valid: int | None = None):
    """Plain int8 first pass: top-m of ``(queries @ qtable.T) * scales``,
    the scale applied after the dot as in the kernel. A ``qtable`` padded
    by :func:`pad_columns` is read over the queries' real columns."""
    valid = qtable.shape[0] if valid is None else valid
    q = queries.float()
    sc = scales.float()
    dq = q.shape[1]
    return _scan_plain(
        lambda lo, hi: (q @ qtable[lo:hi, :dq].float().T) * sc[lo:hi],
        valid, q, m)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
def pad_columns(t: torch.Tensor) -> torch.Tensor:
    """``t`` with zero columns appended up to a multiple of 8 (itself when
    it has such a width): the width the scan kernels read whole rows of in
    16-byte copies. A zero column adds an exact 0 to every fmaf chain, so a
    score changes at most in the sign of a zero (-0 + 0 = +0), and -0 and
    +0 tie in every selection here (they compare equal; the smaller row
    goes first). The store pads each table once at load."""
    d = t.shape[1]
    dp = -(-d // 8) * 8
    if dp == d:
        return t
    out = t.new_zeros((t.shape[0], dp))
    out[:, :d] = t
    return out


def _scan_operands(table, queries):
    """The scan kernels' operands: a table of any width padded to a
    multiple of 8 columns (a copy, unless the caller padded it, as the store
    does), and queries padded to the table's width when they are the
    unpadded width of its real columns."""
    table = pad_columns(table)
    dq = queries.shape[1]
    if dq != table.shape[1] and -(-dq // 8) * 8 == table.shape[1]:
        queries = pad_columns(queries)
    return table, queries


def _check_cuda_scan(table, queries, scales, quant: bool) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("topk scan: table must be a contiguous (N, d) "
                         f"tensor, got {tuple(table.shape)}")
    want = (torch.int8,) if quant else (torch.float32, torch.bfloat16)
    if table.dtype not in want:
        raise ValueError(f"topk scan: table dtype {table.dtype} not in {want}")
    if table.data_ptr() % 16:
        raise ValueError("topk scan: table must be 16-byte aligned")
    d = table.shape[1]
    if (queries.device != table.device or queries.dtype != torch.float32
            or queries.dim() != 2 or queries.shape[1] != d
            or not queries.is_contiguous()):
        raise ValueError("topk scan: queries must be a contiguous (Q, d) "
                         f"float32 tensor on {table.device}, got "
                         f"{queries.dtype} {tuple(queries.shape)} on "
                         f"{queries.device}")
    if quant and scales is not None and (scales.device != table.device
                  or scales.dtype != torch.float32
                  or tuple(scales.shape) != (table.shape[0],)
                  or not scales.is_contiguous()):
        raise ValueError("topk scan: scales must be a contiguous (N,) "
                         f"float32 tensor on {table.device}")


def _filter_plan(table, queries, k: int, valid: int) -> FilterPlan:
    N, d = table.shape
    if not 0 < valid <= N:
        raise ValueError(f"valid={valid} outside (0, {N}]")
    if queries.data_ptr() % 16:
        raise ValueError("topk_mips: queries must be 16-byte aligned")
    return plan_topk_filter(
        queries.shape[0], d, k, valid, table.element_size(),
        sm_count=torch.cuda.get_device_properties(
            table.device).multi_processor_count)


def _launch_filter(name, table, scales, queries, k: int, valid: int,
                   survivors):
    """Run the filter kernel and the merge on a checked CUDA table (scales
    for an int8 one, else None); returns ((Q, k) f32, (Q, k) i32)."""
    Q, d = queries.shape
    dev = table.device
    out_v = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        if not 0 < valid <= table.shape[0]:
            raise ValueError(f"valid={valid} outside (0, {table.shape[0]}]")
        return out_v, out_i
    plan = _filter_plan(table, queries, k, valid)
    part_v = torch.empty((Q, plan.splits, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((Q, plan.splits, k), dtype=torch.int32, device=dev)
    # int32: the pairs each block rescored, then each query's threshold
    # (and for int8 its FILTER_GROUPS group words)
    words = Q * (1 + FILTER_GROUPS if scales is not None else 1)
    counts = torch.empty(plan.qblocks * plan.splits + words,
                         dtype=torch.int32, device=dev)
    gtau = counts[plan.qblocks * plan.splits:]
    lib = build.library("topk_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.topk_filter_partials(
            _DTYPE_CODES[table.dtype], plan.width, plan.qw, table.data_ptr(),
            None if scales is None else scales.data_ptr(),
            queries.data_ptr(), Q, d, valid, k, plan.rows_per_split,
            plan.splits, part_v.data_ptr(), part_i.data_ptr(),
            counts.data_ptr(), gtau.data_ptr(), stream)
        build.check(rc, f"{name} (filter)")
        rc = lib.topk_filter_merge(part_v.data_ptr(), part_i.data_ptr(),
                                   gtau.data_ptr(), Q, plan.splits, k,
                                   out_v.data_ptr(), out_i.data_ptr(), stream)
        build.check(rc, f"{name} (merge)")
    LAUNCHES[name] += 1
    if survivors is not None:
        survivors.copy_(counts[:plan.qblocks * plan.splits].sum(
            dtype=torch.int64).reshape(1))
    return out_v, out_i


def topk_mips(table, queries, k: int, valid: int | None = None, *,
              survivors: torch.Tensor | None = None):
    """Exact-MIPS top-k of ``queries`` against one table shard.

    table: (N, d) f32 or bf16 (scored in f32), any d; on the card it may
    also be the table padded by :func:`pad_columns`, queries keeping the
    real width; queries: (Q, d) f32 on the same device; rows >= ``valid``
    are never returned. Returns ((Q, k) f32 scores, (Q, k) i32 shard-local row ids),
    sorted by (score desc, row asc); when valid < k the tail is (-inf,
    int32 max). ``survivors``, a (1,) int64 tensor on the table's device,
    receives the number of (query, row) pairs scored exactly (on the card
    the filter's survivors, on the CPU every pair); it is for measurement,
    and nothing waits on it. Replaces the TPU kernel
    ``repro/embed_serve/topk.py::topk_mips``.
    """
    valid = table.shape[0] if valid is None else valid
    if table.device.type == "cpu":
        if survivors is not None:
            survivors.fill_(queries.shape[0] * valid)
        return topk_mips_plain(table, queries, k, valid)
    if table.device.type != "cuda":
        raise ValueError(f"topk_mips: unsupported device {table.device}")
    table, queries = _scan_operands(table, queries)
    _check_cuda_scan(table, queries, None, quant=False)
    return _launch_filter("topk_scan_exact", table, None, queries, k, valid,
                          survivors)


def topk_filter_bounds(table, queries, n: int | None = None):
    """The filter's approximate scores and error bounds of rows [0, n)
    against every query, as the kernel computes them: ((Q, n) f32 a,
    (Q, n) f32 eps; an int8 table's unscaled). For checking the bound on
    the card; a CPU table takes :func:`topk_filter_bounds_plain`. Not a
    serving path."""
    n = table.shape[0] if n is None else n
    if table.device.type == "cpu":
        return topk_filter_bounds_plain(table[:n], queries)
    table, queries = _scan_operands(table, queries)
    _check_cuda_scan(table, queries, None, quant=table.dtype == torch.int8)
    plan = _filter_plan(table, queries, 1, n)
    if -(-n // plan.tile_rows) > 65_535:
        raise ValueError(f"topk_filter_bounds: n={n} rows need more than "
                         f"65,535 row tiles of {plan.tile_rows}")
    Q, d = queries.shape
    a = torch.empty((Q, n), dtype=torch.float32, device=table.device)
    eps = torch.empty_like(a)
    lib = build.library("topk_scan")
    with torch.cuda.device(table.device):
        rc = lib.topk_filter_export(
            _DTYPE_CODES[table.dtype], plan.width, plan.qw, table.data_ptr(),
            queries.data_ptr(), Q, d, n, a.data_ptr(), eps.data_ptr(),
            torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "topk_filter_export")
    return a, eps


def topk_mips_quant(qtable, scales, queries, m: int,
                    valid: int | None = None, *,
                    survivors: torch.Tensor | None = None):
    """Int8 first pass: approximate top-``m`` candidates per query.

    qtable: (N, d) int8 (``quant.quantize_rows``); scales: (N,) f32,
    positive (as ``quantize_rows`` gives them: the filter's bound is
    monotone only in a positive scale); queries: (Q, d) f32. Scores are
    ``(q . row) * scale`` in f32. Returns ((Q, m) f32, (Q, m) i32
    shard-local ids) for ``quant.rescore_exact``. ``survivors`` as for
    :func:`topk_mips`. On the card the filter kernel of :func:`topk_mips`
    on int8 rows: bf16 tensor-core scores, their bound times the row's
    scale, the survivors' exact chains. Replaces the TPU kernel
    ``repro/embed_serve/topk.py::topk_mips_quant``.
    """
    valid = qtable.shape[0] if valid is None else valid
    if qtable.device.type == "cpu":
        if survivors is not None:
            survivors.fill_(queries.shape[0] * valid)
        return topk_mips_quant_plain(qtable, scales, queries, m, valid)
    if qtable.device.type != "cuda":
        raise ValueError(f"topk_mips_quant: unsupported device {qtable.device}")
    qtable, queries = _scan_operands(qtable, queries)
    _check_cuda_scan(qtable, queries, scales, quant=True)
    return _launch_filter("topk_scan_int8", qtable, scales, queries, m, valid,
                          survivors)


@dataclasses.dataclass(frozen=True)
class RowwisePlan:
    """Geometry of one rowwise top-k: ``chunk_rows`` rows scored per chunk
    (a whole number of row tiles), ``chunks`` chunks in order over the
    valid rows, the (Q, chunk_rows) f32 scratch, and the static shared
    memory of a score and of a selection block."""

    chunk_rows: int
    chunks: int
    scratch_bytes: int
    score_smem_bytes: int
    select_smem_bytes: int
    select_cap: int = ROWWISE_SELECT_CAP
    candidate_bytes: int = 0


def plan_topk_rowwise(Q: int, d: int, k: int, valid: int) -> RowwisePlan:
    """Chunks from the shapes alone: as many row tiles per chunk as keep
    the (Q, chunk) f32 scores under ``ROWWISE_SCRATCH_BYTES`` (at least one
    tile), and no more than the valid rows need. Any d >= 1 (the kernel
    reads the table padded to a multiple of 8 columns) and k >= 1: the
    selection sorts at most ``select_cap`` candidates, which holds the
    k - 1 better ones and the ties at the k-th key while 2k - 1 <= the
    cap: ``ROWWISE_SELECT_CAP`` in shared memory up to ``ROWWISE_K_MAX``,
    past it the power of two >= 2k in a device buffer of
    ``candidate_bytes`` ((Q, cap) 64-bit keys and f32 values)."""
    if k < 1 or valid < 1 or Q < 1 or d < 1:
        raise ValueError(f"need k, valid, Q, d >= 1 (got {k}, {valid}, {Q}, "
                         f"{d})")
    cap = (ROWWISE_SELECT_CAP if k <= ROWWISE_K_MAX
           else 1 << (2 * k - 1).bit_length())
    tile = ROWWISE_ROW_TILE
    tiles = max(1, ROWWISE_SCRATCH_BYTES // (4 * Q * tile))
    chunk = min(tiles, -(-valid // tile)) * tile
    return RowwisePlan(
        chunk_rows=chunk, chunks=-(-valid // chunk),
        scratch_bytes=4 * Q * chunk,
        score_smem_bytes=4 * ROWWISE_K_TILE * (tile + ROWWISE_QUERY_TILE),
        select_smem_bytes=(4 * ROWWISE_SELECT_BINS + 12 * ROWWISE_SELECT_CAP
                           * (k <= ROWWISE_K_MAX) + 4 * 16 + 16),
        select_cap=cap,
        candidate_bytes=0 if k <= ROWWISE_K_MAX else 12 * Q * cap)


def topk_mips_rowwise(table, queries, k: int, valid: int | None = None):
    """Exact-MIPS top-k by full scoring and radix selection: the same
    function as :func:`topk_mips`, computed with nothing of the scan's
    design (the reference the split-and-merge scan is held to). Rows are
    scored in chunks whose (Q, chunk) f32 scores fit
    ``ROWWISE_SCRATCH_BYTES``; each chunk's selection carries the k best
    into the next. Same arguments and results as :func:`topk_mips`; any d
    and k. Replaces the TPU kernel
    ``repro/embed_serve/topk.py::topk_mips_rowwise``.
    """
    N = table.shape[0]
    valid = N if valid is None else valid
    if table.device.type == "cpu":
        return topk_mips_rowwise_plain(table, queries, k, valid)
    if table.device.type != "cuda":
        raise ValueError(f"topk_mips_rowwise: unsupported device "
                         f"{table.device}")
    table, queries = _scan_operands(table, queries)
    _check_cuda_scan(table, queries, None, quant=False)
    d = table.shape[1]
    if not 0 < valid <= N:
        raise ValueError(f"valid={valid} outside (0, {N}]")
    if queries.data_ptr() % 16:
        raise ValueError("topk_mips_rowwise: queries must be 16-byte aligned")
    Q = queries.shape[0]
    dev = table.device
    plan = plan_topk_rowwise(max(Q, 1), d, k, valid)
    out_v = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_v, out_i
    scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                          device=dev)
    cand = (torch.empty(plan.candidate_bytes, dtype=torch.uint8, device=dev)
            if plan.candidate_bytes else None)
    lib = build.library("topk_rowwise")
    with torch.cuda.device(dev):
        rc = lib.topk_rowwise(
            _DTYPE_CODES[table.dtype], table.data_ptr(), queries.data_ptr(),
            Q, d, valid, k, plan.chunk_rows, scratch.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(),
            None if cand is None else cand.data_ptr(), plan.select_cap,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "topk_rowwise")
    LAUNCHES["topk_rowwise"] += 1
    return out_v, out_i
