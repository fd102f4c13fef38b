"""The tensor-core filter of the port's exact top-k scans (``topk_mips``
and, on int8 rows times per-row scales, ``topk_mips_quant`` on the card),
modelled on the CPU.

The filter kernel cannot run here, so three things are held instead:

* a numpy model of its control (splits, row groups sharing a block's
  list and threshold per query, tiles of 16-row m-tiles, the threshold
  seeded from each warp's first-tile approximate scores minus their
  bounds, then raised to the largest k-th score of any list and reaching a
  warp a tile late, a 32-entry survivor queue rescored only when full or
  at the split's end, the final merge that skips entries below the
  threshold), fed approximate scores pushed to the edge of the error
  bound, equals ``topk_mips_plain`` bit for bit; for int8 rows the edges
  are scaled (``fl(fl(a +- eps) * scale)``) and the model equals
  ``topk_mips_quant_plain``;
* the error bound of ``topk_filter_bounds_plain`` (the formula the kernel
  computes) holds with a factor 4 to spare on adversarial inputs: the
  split-operand dot, exact in f64, against the f32 fmaf chain; for int8
  rows its scaled edges (``topk_filter_edges_plain``) enclose the scaled
  exact score;
* the planner's geometry.

The kernel itself is held against the plain version, and its exported
approximate scores against the bound, on the card
(``tests/test_torch_card.py``)."""
import bisect

import numpy as np
import pytest
import torch

from repro_torch.embed_serve import topk as tk
from repro_torch.embed_serve.quant import quantize_rows


def _int(n, d, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _filter_model(s, a, eps, k, valid, plan, scales=None):
    """The filter kernel's control over exact scores ``s`` (Q, valid) and
    approximate scores ``a`` with bounds ``eps``; with int8 ``scales``,
    ``s`` is scaled and ``a``, ``eps`` are not, each edge is multiplied
    by its row's scale after its one rounding, and the splits' lists also
    publish their r-th score (r = ceil(k / FILTER_GROUPS)) to their group
    of splits (split % FILTER_GROUPS), the threshold taking the least of
    the groups' largest. Returns ((Q, k) f32, (Q, k) i32) and the number
    of pairs rescored."""
    Q = s.shape[0]
    per_warp = 8 * plan.query_tiles
    rws = plan.row_groups
    tr = plan.tile_rows
    sd = plan.seed // 8             # lower bounds a lane group keeps
    hi = (a + eps).astype(np.float32)
    lo = (a - eps).astype(np.float32)
    if scales is not None:
        hi = hi * scales[None, :valid]
        lo = lo * scales[None, :valid]
    final = {q: [] for q in range(Q)}
    gtau = {q: -np.inf for q in range(Q)}       # the grid's threshold
    ngrp = tk.FILTER_GROUPS if scales is not None else 0
    r_grp = -(-k // tk.FILTER_GROUPS)
    ggrp = [{q: -np.inf for q in range(Q)} for _ in range(ngrp)]
    rescored = 0

    def offer(lst, tau, q, v, r):
        key = (-v, r)
        if len(lst) == k and not key < lst[-1]:
            return
        pos = bisect.bisect_left(lst, key)
        lst.insert(pos, key)
        del lst[k:]
        if len(lst) == k:
            tau[q] = max(tau[q], -lst[-1][0])
            gtau[q] = max(gtau[q], -lst[-1][0])
        if ngrp and pos < r_grp and len(lst) >= r_grp:
            grp = ggrp[split % ngrp]
            grp[q] = max(grp[q], -lst[r_grp - 1][0])

    def grid_tau(q):
        """What a warp reads at a tile's end: gtau, and (int8) the least of
        the groups' words, an empty group's being -inf."""
        if not ngrp:
            return gtau[q]
        return max(gtau[q], min(grp[q] for grp in ggrp))

    def seed(qs, tau, r0, end, rw):
        """The kernel's seed: lane group g of the warp keeps the sd
        largest lower edges of rows 16 mt + g and 16 mt + g + 8 over the
        warp's m-tiles of the first tile; the k-th largest of a query's
        8 sd is a threshold."""
        for q in qs:
            vals = []
            for g in range(8):
                lb = [lo[q, r] for mt in range(rw, tr // 16, rws)
                      for r in (r0 + 16 * mt + g, r0 + 16 * mt + g + 8)
                      if r < end]
                vals += (sorted(lb, reverse=True) + [-np.inf] * sd)[:sd]
            kth = sorted(vals, reverse=True)[k - 1]
            if kth > -np.inf:
                tau[q] = max(tau[q], kth)
                gtau[q] = max(gtau[q], kth)

    for split in range(plan.splits):
        begin = split * plan.rows_per_split
        end = min(begin + plan.rows_per_split, valid)
        for qb in range(plan.qblocks):
            # the block's lists and thresholds, shared by its row groups
            lists = {q: [] for q in range(qb * plan.bq, (qb + 1) * plan.bq)
                     if q < Q}
            tau = {q: -np.inf for q in lists}
            for w in range(tk.FILTER_WARPS):
                qg, rw = w % plan.qw, w // plan.qw
                qw0 = qb * plan.bq + qg * per_warp
                qs = [q for q in range(qw0, qw0 + per_warp) if q < Q]
                queue = []
                gnext = {q: -np.inf for q in qs}

                def flush():
                    for q, r in queue:
                        offer(lists[q], tau, q, float(s[q, r]), r)
                    queue.clear()

                for r0 in range(begin, end, tr):
                    for q in qs:                # read a tile ago, folded in
                        tau[q] = max(tau[q], gnext[q])
                    if r0 == begin and k <= plan.seed:
                        seed(qs, tau, r0, end, rw)
                    for mt in range(rw, tr // 16, rws):
                        rows = [r for r in range(r0 + 16 * mt,
                                                 r0 + 16 * mt + 16)
                                if r < end]
                        # every pair of the m-tile is filtered against the
                        # thresholds and the lists' k-th entries as they
                        # stood before its flushes; a pair that only
                        # reaches the k-th score at a later row loses
                        seen = dict(tau)
                        kth = {q: (-lists[q][-1][0], lists[q][-1][1])
                               if len(lists[q]) == k
                               else (-np.inf, tk.IDX_SENTINEL) for q in qs}
                        for q in qs:
                            for r in rows:
                                edge = hi[q, r]
                                tie = edge <= kth[q][0] and r > kth[q][1]
                                if not edge < seen[q] and not tie:
                                    if len(queue) == tk.FILTER_QUEUE:
                                        rescored += len(queue)
                                        flush()
                                    queue.append((q, r))
                    gnext = {q: grid_tau(q) for q in qs}
                rescored += len(queue)
                flush()
            for q, lst in lists.items():
                final[q].extend(lst)
    out_v = np.full((Q, k), -np.inf, np.float32)
    out_i = np.full((Q, k), tk.IDX_SENTINEL, np.int32)
    for q, cand in final.items():
        best = sorted(c for c in cand if not -c[0] < gtau[q])[:k]
        out_v[q, :len(best)] = [-v for v, _ in best]
        out_i[q, :len(best)] = [i for _, i in best]
    return out_v, out_i, rescored


def _pushed(s, eps, how, seed):
    """Approximate scores within the bound: every score pushed down to
    s - eps (the true best rows must still pass), or each pushed to
    either edge at random."""
    frac = np.float32(0.999)
    if how == "down":
        return s - frac * eps
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], size=s.shape)
    return s + (sign * frac * eps).astype(np.float32)


@pytest.mark.parametrize("how", ["down", "either"])
@pytest.mark.parametrize("case,k,N,valid,Q,dtype", [
    ("ties", 10, 3000, 3000, 9, torch.float32),     # six distinct rows
    ("ties", 25, 2000, 1993, 70, torch.bfloat16),   # two query groups
    ("int", 50, 40, 40, 3, torch.float32),          # k > valid
    ("int", 7, 1500, 1211, 5, torch.bfloat16),      # valid < N
    ("normal", 10, 4000, 4000, 13, torch.float32),
    ("normal", 16, 3000, 2999, 130, torch.bfloat16),   # four query groups
    ("zero", 10, 2000, 2000, 40, torch.bfloat16),   # padded zero queries
])
def test_filter_model_equals_plain(case, k, N, valid, Q, dtype, how):
    rng = np.random.default_rng(N + k + Q)
    if case == "ties":
        tbl = _int(6, 64, 1)[rng.integers(0, 6, N)]
        q = _int(Q, 64, 2)
    elif case == "int":
        tbl, q = _int(N, 64, 3), _int(Q, 64, 4)
    elif case == "zero":
        # a serving batch padded with zero queries: every row ties at 0
        tbl, q = _int(N, 64, 3), _int(Q, 64, 4)
        q[5:] = 0.0
    else:
        tbl = rng.normal(0, 0.1, (N, 64)).astype(np.float32)
        tbl[N // 2:N // 2 + 40] = tbl[:40]        # exact ties on real data
        q = (tbl[rng.integers(0, N, Q)]
             + rng.normal(0, 0.05, (Q, 64))).astype(np.float32)
    table, queries = torch.from_numpy(tbl).to(dtype), torch.from_numpy(q)
    want = tk.topk_mips_plain(table, queries, k, valid)
    s = (queries @ table[:valid].float().T).numpy()
    _, eps = tk.topk_filter_bounds_plain(table[:valid], queries)
    eps = eps.numpy()
    a = _pushed(s, eps, how, seed=k)
    # few SMs, so there are several splits and row ranges
    plan = tk.plan_topk_filter(Q, 64, k, valid, table.element_size(),
                               sm_count=5)
    got_v, got_i, rescored = _filter_model(s, a, eps, k, valid, plan)
    np.testing.assert_array_equal(got_i, want[1].numpy())
    np.testing.assert_array_equal(got_v, want[0].numpy())
    if case in ("normal", "zero") and how == "down":
        # on continuous data, or on a zero query's ties, the filter drops
        # most pairs
        assert rescored < 0.5 * Q * valid


def _int8_case(case, N, Q, rng):
    """(int8 rows, positive f32 scales, f32 queries) for the int8 model."""
    if case == "ties":
        # six distinct rows and scales: heavy ties in the scaled scores
        pick = rng.integers(0, 6, N)
        q8 = rng.integers(-127, 128, (6, 64)).astype(np.int8)[pick]
        sc = (2.0 ** rng.uniform(-20, 10, 6)).astype(np.float32)[pick]
        q = _int(Q, 64, 2)
    elif case in ("int", "zero"):
        q8 = rng.integers(-127, 128, (N, 64)).astype(np.int8)
        sc = (2.0 ** rng.uniform(-20, 10, N)).astype(np.float32)
        q = _int(Q, 64, 4)
        if case == "zero":
            q[5:] = 0.0                 # a padded batch: every row ties at 0
    else:
        # the serving pipeline: continuous rows quantized, queries near rows
        tbl = rng.normal(0, 0.1, (N, 64)).astype(np.float32)
        tbl[N // 2:N // 2 + 40] = tbl[:40]
        q8, sc = (t.numpy() for t in quantize_rows(torch.from_numpy(tbl)))
        q = (tbl[rng.integers(0, N, Q)]
             + rng.normal(0, 0.05, (Q, 64))).astype(np.float32)
    return q8, sc, q


@pytest.mark.parametrize("how", ["down", "either"])
@pytest.mark.parametrize("case,m,N,valid,Q", [
    ("int", 40, 3000, 3000, 9),         # the two-tier m, seeded
    ("ties", 400, 2000, 1993, 9),       # heavy ties, valid < N, unseeded
    ("zero", 40, 2000, 2000, 40),       # padded zero queries
    ("normal", 1, 3000, 2999, 13),
    ("normal", 40, 6000, 5999, 70),     # two query groups
])
def test_quant_filter_model_equals_plain(case, m, N, valid, Q, how):
    """The int8 filter's control: edges fl(fl(a +- eps) * scale_r) against
    scaled thresholds, the seed 40 deep, the splits' groups sharing their
    lists' r-th scores, equals topk_mips_quant_plain bit for bit."""
    rng = np.random.default_rng(N + m + Q)
    q8, sc, q = _int8_case(case, N, Q, rng)
    qtable, scales = torch.from_numpy(q8), torch.from_numpy(sc)
    queries = torch.from_numpy(q)
    want = tk.topk_mips_quant_plain(qtable, scales, queries, m, valid)
    s_u = (queries @ qtable[:valid].float().T).numpy()
    s = (torch.from_numpy(s_u) * scales[:valid]).numpy()
    _, eps = tk.topk_filter_bounds_plain(qtable[:valid], queries)
    eps = eps.numpy()
    a = _pushed(s_u, eps, how, seed=m)
    # enough SMs for more splits than groups, so every group has splits
    plan = tk.plan_topk_filter(Q, 64, m, valid, 1, sm_count=16)
    assert plan.seed == tk.FILTER_SEED_INT8 >= 40
    assert plan.splits >= tk.FILTER_GROUPS
    got_v, got_i, rescored = _filter_model(s, a, eps, m, valid, plan, sc)
    np.testing.assert_array_equal(got_i, want[1].numpy())
    np.testing.assert_array_equal(got_v, want[0].numpy())
    if case in ("normal", "zero") and how == "down" and m < 400:
        assert rescored < 0.5 * Q * valid


def _chain(q, t):
    """The f32 fmaf chain q . t from 0.0 in index order, for every row of
    t: each step's product exact in f64, its sum rounded to f32."""
    s = np.zeros(t.shape[0], np.float32)
    for j in range(t.shape[1]):
        s = (s.astype(np.float64) + np.float64(q[j]) * t[:, j].astype(
            np.float64)).astype(np.float32)
    return s


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16()


def _adversarial_rows(q, rng):
    """Rows that stress each term of the bound against query q."""
    d = q.shape[0]
    qb = _bf16(q).float().numpy()
    err = q - qb
    alt = np.where(np.arange(d) % 2 == 0, 1.0, -1.0)
    # at the midpoint of two bf16 values (the largest rounding error)
    mid = (2.0 ** rng.integers(-6, 6, d)) * (1 + 2.0 ** -8 - 2.0 ** -22)
    rows = [
        alt * 3e3 + rng.normal(0, 1e-3, d),             # cancellation
        alt * 1e4 * np.sign(q),                         # cancellation vs q
        rng.choice([-1, 1], d) * 2.0 ** rng.uniform(-30, 30, d),   # range
        np.sign(err) * 7.0,                             # along q - bf16(q)
        err / max(np.linalg.norm(err), 1e-30) * 5.0,    # Cauchy-Schwarz
        mid * rng.choice([-1, 1], d),                   # f32 -> bf16 worst
        mid * np.sign(q),
        np.sign(q) * np.abs(q),                         # q itself
        np.zeros(d),
        rng.normal(0, 0.1, d),
    ]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_error_bound_holds_on_adversarial_inputs(dtype, d):
    """The split-operand dot in f64 (what the tensor cores approximate)
    stays within eps / 4 of the f32 chain, for queries with the largest
    bf16 rounding error, huge and tiny entries, and rows built against each
    term of the bound."""
    rng = np.random.default_rng(d)
    queries = [
        (2.0 ** rng.integers(-4, 4, d)) * (1 + 2.0 ** -8 - 2.0 ** -20)
        * rng.choice([-1, 1], d),                       # worst split
        rng.normal(0, 1, d) * 2.0 ** rng.uniform(-20, 20, d),
        rng.normal(0, 1, d),
        np.ones(d),
    ]
    for qi, q in enumerate(queries):
        q = q.astype(np.float32)
        rows = _adversarial_rows(q, rng)
        table = torch.from_numpy(rows).to(dtype)
        exact_rows = table.float().numpy()              # what the chain reads
        s = _chain(q, exact_rows)
        A = (_bf16(q).double() @ table.float().bfloat16().double().T).numpy()
        _, eps = tk.topk_filter_bounds_plain(table, torch.from_numpy(q[None]))
        eps = eps.numpy()[0].astype(np.float64)
        gap = np.abs(A - s)
        assert np.all(gap <= eps / 4), (qi, gap / eps)
    # the bound is not vacuous: the aligned row uses a good share of it
    q = queries[0].astype(np.float32)
    row = _adversarial_rows(q, rng)[4:5]
    table = torch.from_numpy(row).to(dtype)
    s = _chain(q, table.float().numpy())
    A = (_bf16(q).double() @ table.float().bfloat16().double().T).numpy()
    _, eps = tk.topk_filter_bounds_plain(table, torch.from_numpy(q[None]))
    assert np.abs(A - s)[0] >= eps.numpy()[0, 0] / 64


@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_quant_error_bound_holds_on_adversarial_int8_rows(d):
    """int8 rows (rho_t = 0): the split-operand dot stays within eps / 4 of
    the f32 chain over the widened row, and the scaled edges enclose the
    scaled exact score, for rows of +-127 along q - bf16(q), against the
    query's signs and alternating (cancellation), all-zero rows (scale 1.0)
    and random rows, with scales from 2^-20 to 2^10."""
    rng = np.random.default_rng(100 + d)
    queries = [
        (2.0 ** rng.integers(-4, 4, d)) * (1 + 2.0 ** -8 - 2.0 ** -20)
        * rng.choice([-1, 1], d),                       # worst split
        rng.normal(0, 1, d) * 2.0 ** rng.uniform(-20, 20, d),
        rng.normal(0, 1, d),
        np.ones(d),
    ]
    for qi, q in enumerate(queries):
        q = q.astype(np.float32)
        err = q - _bf16(q).float().numpy()
        alt = np.where(np.arange(d) % 2 == 0, 1, -1)
        rows = np.stack([
            127 * np.sign(err), -127 * np.sign(err),    # along q - bf16(q)
            127 * alt, 127 * np.sign(q), 127 * alt * np.sign(q),
            np.zeros(d), np.zeros(d),
            *rng.integers(-127, 128, (9, d)),
        ]).astype(np.int8)
        scales = (2.0 ** rng.uniform(-20, 10, len(rows))).astype(np.float32)
        scales[5:7] = 1.0                               # quantize_rows' zeros
        scales[0], scales[1] = 2.0 ** -20, 2.0 ** 10
        qt, sc = torch.from_numpy(rows), torch.from_numpy(scales)
        s = _chain(q, rows.astype(np.float32))
        A = (_bf16(q).double() @ qt.double().T).numpy()
        _, eps = tk.topk_filter_bounds_plain(qt, torch.from_numpy(q[None]))
        eps64 = eps.numpy()[0].astype(np.float64)
        assert np.all(np.abs(A - s) <= eps64 / 4), (qi, np.abs(A - s) / eps64)
        assert np.all(eps64[5:7] > 0)                    # the floors
        lo, hi = tk.topk_filter_edges_plain(qt, sc, torch.from_numpy(q[None]))
        exact = s * scales                               # f32: one rounding
        assert np.all(lo.numpy()[0] <= exact), qi
        assert np.all(exact <= hi.numpy()[0]), qi
    # not vacuous: the row along q - bf16(q) uses a good share of the bound
    q = queries[0].astype(np.float32)
    row = (127 * np.sign(q - _bf16(q).float().numpy())).astype(np.int8)[None]
    s = _chain(q, row.astype(np.float32))
    A = (_bf16(q).double() @ torch.from_numpy(row).double().T).numpy()
    _, eps = tk.topk_filter_bounds_plain(torch.from_numpy(row),
                                         torch.from_numpy(q[None]))
    assert np.abs(A - s)[0] >= eps.numpy()[0, 0] / 64


def test_error_bound_floors():
    """Zero rows keep a positive bound (the 2^-40 floors of E'_q and n'_r),
    far below any score gap that matters; a zero query, whose scores are
    exactly 0 both ways, gets none."""
    q = torch.zeros((2, 8))
    q[1, 0] = 1.0
    _, eps = tk.topk_filter_bounds_plain(torch.zeros((1, 8)), q)
    assert eps[0, 0].item() == 0.0
    assert 0 < eps[1, 0].item() < 1e-10


def test_filter_plan_geometry():
    for Q in (1, 8, 37, 64, 65, 256, 300, 513, 2000):
        for d in (8, 32, 40, 128, 200, 256):
            for itemsize in (2, 4):
                for valid in (1, 300, 1 << 20, 26_250_000):
                    p = tk.plan_topk_filter(Q, d, 10, valid, itemsize)
                    assert p.width == min(w for w in tk.FILTER_WIDTHS
                                          if w >= d)
                    assert p.query_tiles * (p.width // 16) * 2 <= 64
                    assert p.bq == p.qw * 8 * p.query_tiles
                    assert p.qw in (1, 2, 4, 8)
                    # as few query groups as hold Q, up to eight
                    assert p.qw == 8 or p.bq >= Q
                    assert p.qw == 1 or p.bq // 2 < Q
                    assert p.qblocks * p.bq >= Q
                    assert p.row_groups * p.qw == tk.FILTER_WARPS
                    assert p.smem_bytes <= tk.SMEM_PER_BLOCK
                    assert p.rows_per_split % p.tile_rows == 0
                    assert ((p.splits - 1) * p.rows_per_split < valid
                            <= p.splits * p.rows_per_split)
                    # one block per SM where the queries leave room
                    assert p.qblocks * p.splits <= max(132, p.qblocks)
    # the per-card serving shape: 256 queries read the table once
    p = tk.plan_topk_filter(256, 128, 10, 26_250_000, 2)
    assert (p.qw, p.qblocks, p.row_groups, p.splits) == (8, 1, 1, 132)
    # the launcher's batches: one query group, eight row groups
    p = tk.plan_topk_filter(8, 128, 10, 1 << 20, 2)
    assert (p.qw, p.bq, p.row_groups) == (1, 32, 8)
    # an f32 table at the widest width takes half tiles
    assert tk.plan_topk_filter(8, 256, 10, 1000, 4).tile_rows == 64
    # the warps' lists stay on chip at serving k, not at k in the hundreds
    assert tk.plan_topk_filter(256, 128, 10, 1 << 20, 4).lists_on_chip
    assert not tk.plan_topk_filter(256, 128, 100, 1 << 20, 2).lists_on_chip


def test_filter_plan_refuses_what_the_kernel_cannot_take():
    """Only empty shapes are refused: past what the merge's shared memory
    holds its lists go to the output rows, past 256 columns the rows are
    scored in 256-column slices, and d is padded to a multiple of 8."""
    kmax = tk.SMEM_PER_BLOCK // (8 * tk.MERGE_WARPS)
    assert tk.plan_topk_filter(16, 128, kmax, 10_000, 2).merge_on_chip
    assert not tk.plan_topk_filter(16, 128, kmax + 1, 10_000, 2).merge_on_chip
    for d, width in ((264, 512), (300, 512), (1000, 1024), (16384, 16384)):
        for itemsize in (1, 2, 4):
            p = tk.plan_topk_filter(256, d, 10, 10_000, itemsize)
            assert p.width == width and p.query_tiles == 2
            assert p.smem_bytes <= tk.SMEM_PER_BLOCK
    assert tk.plan_topk_filter(16, 30, 10, 10_000, 2).width == 32
    assert tk.plan_topk_filter(16, 1, 10, 10_000, 2).width == 32
    with pytest.raises(ValueError, match=">= 1"):
        tk.plan_topk_filter(0, 32, 10, 10_000, 2)


def test_survivor_count_on_the_cpu_is_every_pair():
    tbl = torch.from_numpy(_int(50, 16, 5))
    q = torch.from_numpy(_int(3, 16, 6))
    n = torch.zeros(1, dtype=torch.int64)
    got = tk.topk_mips(tbl, q, 4, 47, survivors=n)
    want = tk.topk_mips_plain(tbl, q, 4, 47)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert n.item() == 3 * 47
    a, eps = tk.topk_filter_bounds(tbl, q, 20)
    assert a.shape == eps.shape == (3, 20)
    assert torch.equal(a, (q @ tbl[:20].T))             # integers: exact
