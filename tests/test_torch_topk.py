"""The port's top-k scans against the JAX package's Pallas kernels
(interpret mode) and its jnp path.

On the CPU the wrappers run their plain versions. Tables and queries are
small integers, so every f32 dot is exact whatever the summation order and
the results must agree bitwise; the frequent ties exercise the
smaller-index rule. Continuous data is held to equal ids and scores within
rtol 1e-6 (summation order differs from BLAS). The kernels themselves are
held against these plain versions on the card in ``test_torch_card.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embed_serve import topk as jtk
from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import ref as tref


def _int(n, d, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _pair(arr, bf16):
    """The same table for both packages (bf16 rounded identically)."""
    j, t = jnp.asarray(arr), torch.from_numpy(arr)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def _assert_same(port, jax_out):
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(jax_out[1]))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(jax_out[0]))


@pytest.mark.parametrize("k,bf16,N,Q", [
    (1, False, 230, 17),
    (10, False, 230, 17),
    (10, True, 230, 17),
    (100, True, 130, 5),      # k a large share of an odd N
])
def test_topk_matches_jax_kernel(k, bf16, N, Q):
    jt, tt = _pair(_int(N, 32, 1), bf16)
    q = _int(Q, 32, 2)
    want = jtk.topk_mips(jt, jnp.asarray(q), k=k, valid=N, block_q=8,
                         block_n=64, interpret=True)
    _assert_same(tk.topk_mips(tt, torch.from_numpy(q), k, N), want)


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_topk_matches_jax_xla(k, bf16):
    N = 317                                    # odd, not a tile multiple
    jt, tt = _pair(_int(N, 32, 3), bf16)
    q = _int(9, 32, 4)
    want = jtk.topk_mips_xla(jt, jnp.asarray(q), k=k, valid=N)
    _assert_same(tk.topk_mips_plain(tt, torch.from_numpy(q), k, N), want)
    rv, ri = tref.topk_mips_ref(np.asarray(jt.astype(jnp.float32)), q, k)
    np.testing.assert_array_equal(np.asarray(want[1]), ri)


def test_topk_heavy_ties():
    """Six distinct rows: ties at every rank, inside and across chunks."""
    rng = np.random.default_rng(3)
    tbl = _int(6, 16, 4)[rng.integers(0, 6, size=200)]
    q = _int(9, 16, 5)
    want = jtk.topk_mips(jnp.asarray(tbl), jnp.asarray(q), k=25, valid=200,
                         block_q=4, block_n=32, interpret=True)
    got = tk.topk_mips(torch.from_numpy(tbl), torch.from_numpy(q), 25, 200)
    _assert_same(got, want)


def test_topk_chunked_plain_scan(monkeypatch):
    """Folding chunk by chunk gives the one-shot answer, ties included."""
    rng = np.random.default_rng(6)
    tbl = _int(5, 8, 7)[rng.integers(0, 5, size=301)]
    q = _int(4, 8, 8)
    whole = tk.topk_mips_plain(torch.from_numpy(tbl), torch.from_numpy(q), 30)
    monkeypatch.setattr(tk, "PLAIN_CHUNK_ELEMS", 4 * 7)   # 7-row chunks
    chunked = tk.topk_mips_plain(torch.from_numpy(tbl), torch.from_numpy(q),
                                 30)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])
    want = jtk.topk_mips_xla(jnp.asarray(tbl), jnp.asarray(q), k=30)
    _assert_same(chunked, want)


@pytest.mark.parametrize("k", [5, 50])
def test_topk_padded_shard_masked(k):
    """Rows >= valid never surface, even where their zero rows would beat
    real (negative) rows; k > valid leaves (-inf, int32 max) slots."""
    tbl = np.full((64, 8), -2.0, np.float32)
    tbl[40:] = 0.0
    q = np.ones((3, 8), np.float32)
    want = jtk.topk_mips_xla(jnp.asarray(tbl), jnp.asarray(q), k=k, valid=40)
    got = tk.topk_mips(torch.from_numpy(tbl), torch.from_numpy(q), k, 40)
    _assert_same(got, want)
    real = got[1][got[1] != tk.IDX_SENTINEL]
    assert int(real.max()) < 40
    if k > 40:
        assert (got[1][:, 40:] == tk.IDX_SENTINEL).all()
        assert torch.isneginf(got[0][:, 40:]).all()


def test_topk_continuous_matches_jax():
    rng = np.random.default_rng(9)
    tbl = rng.normal(0, 0.1, size=(400, 32)).astype(np.float32)
    q = rng.normal(0, 1, size=(13, 32)).astype(np.float32)
    jv, ji = jtk.topk_mips_xla(jnp.asarray(tbl), jnp.asarray(q), k=10)
    v, i = tk.topk_mips(torch.from_numpy(tbl), torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("k,bf16,N,valid,ties", [
    (1, False, 40, 40, False),
    (10, True, 64, 64, False),
    (10, False, 64, 57, False),       # valid < N: rows past it never ranked
    (12, True, 48, 48, True),         # six distinct rows: ties everywhere
    (30, False, 24, 19, True),        # k > valid: sentinel slots
])
def test_rowwise_matches_jax_kernel(k, bf16, N, valid, ties):
    """The row-sequential route's CPU path against the JAX kernel in
    interpret mode (one grid step per row), bit for bit."""
    tbl = _int(N, 32, N + k)
    if ties:
        tbl = _int(6, 32, 1)[np.random.default_rng(2).integers(0, 6, N)]
    jt, tt = _pair(tbl, bf16)
    q = _int(7, 32, k)
    want = jtk.topk_mips_rowwise(jt, jnp.asarray(q), k=k, valid=valid,
                                 interpret=True)
    got = tk.topk_mips_rowwise(tt, torch.from_numpy(q), k, valid)
    _assert_same(got, want)
    if k > valid:
        assert (got[1][:, valid:] == tk.IDX_SENTINEL).all()


def test_select_and_merge_match_jax():
    """Unsorted candidate ids, duplicated values, -inf and sentinels."""
    rng = np.random.default_rng(10)
    vals = rng.integers(-3, 4, size=(7, 40)).astype(np.float32)
    vals[:, :5] = -np.inf
    idx = np.stack([rng.permutation(1000)[:40] for _ in range(7)]
                   ).astype(np.int32)
    idx[:, 3] = tk.IDX_SENTINEL
    for k in (1, 12, 40, 45):
        want = jtk.select_topk(jnp.asarray(vals), jnp.asarray(idx), k)
        got = tk.select_topk(torch.from_numpy(vals), torch.from_numpy(idx), k)
        _assert_same(got, want)
    pv = vals[:, :36].reshape(7, 3, 12).transpose(1, 0, 2).copy()
    pi = idx[:, :36].reshape(7, 3, 12).transpose(1, 0, 2).copy()
    want = jtk.merge_topk(jnp.asarray(pv), jnp.asarray(pi), k=12)
    got = tk.merge_topk(torch.from_numpy(pv), torch.from_numpy(pi), 12)
    _assert_same(got, want)


def test_plan_fits_shared_memory():
    """The int8 first pass's plan (the filter kernel on int8 rows): its
    staging (int8 ring, the widened bf16 tile, the scales) and seed fit a
    block, the splits cover every valid row, and m = 40 keeps the lists on
    chip at the serving shape."""
    for Q, d, k in [(256, 128, 10), (256, 128, 400), (5, 32, 100),
                    (1, 256, 512), (300, 128, 100)]:
        for valid in (1, 255, 257, 26_250_000):
            p = tk.plan_topk_filter(Q, d, k, valid, 1)
            assert p.smem_bytes <= tk.SMEM_PER_BLOCK
            assert p.tile_rows == 128 and p.seed == tk.FILTER_SEED_INT8
            assert p.rows_per_split % p.tile_rows == 0
            # the splits cover every valid row, and none is empty
            assert (p.splits - 1) * p.rows_per_split < valid
            assert p.splits * p.rows_per_split >= valid
    p = tk.plan_topk_filter(256, 128, 40, 26_250_000, 1)
    assert (p.qw, p.qblocks, p.splits, p.lists_on_chip) == (8, 1, 132, True)
    assert not tk.plan_topk_filter(256, 128, 400, 26_250_000, 1).lists_on_chip
    # any width: past 256 in 256-column slices (the tile's scores kept on
    # chip beside the staging), and d padded to a multiple of 8
    p = tk.plan_topk_filter(16, 1024, 10, 10_000, 1)
    assert p.width == 1024 and p.smem_bytes <= tk.SMEM_PER_BLOCK
    assert tk.plan_topk_filter(16, 30, 10, 10_000, 1).width == 32


@pytest.mark.parametrize("Q,d,k", [(256, 128, 10), (256, 128, 400),
                                   (5, 32, 100), (1, 1024, 512),
                                   (300, 128, 100)])
def test_rowwise_plan_chunks_cover_valid(Q, d, k, monkeypatch):
    """#4's plan: tiles and scratch under their caps, whole row tiles per
    chunk, and the chunks cover the valid rows exactly."""
    for valid in (1, 255, 257, 1 << 20, 26_250_000):
        p = tk.plan_topk_rowwise(Q, d, k, valid)
        assert p.score_smem_bytes <= tk.SMEM_STATIC
        assert p.select_smem_bytes <= tk.SMEM_STATIC
        assert p.chunk_rows % tk.ROWWISE_ROW_TILE == 0
        assert p.scratch_bytes == 4 * Q * p.chunk_rows
        assert p.scratch_bytes <= tk.ROWWISE_SCRATCH_BYTES
        assert (p.chunks - 1) * p.chunk_rows < valid <= p.chunks * p.chunk_rows
        assert p.chunk_rows < valid + tk.ROWWISE_ROW_TILE   # no idle tile
    # the serving main path: four chunks of 262,144 rows
    p = tk.plan_topk_rowwise(256, 128, 10, 1 << 20)
    assert (p.chunk_rows, p.chunks) == (1 << 18, 4)
    monkeypatch.setattr(tk, "ROWWISE_SCRATCH_BYTES", 4 * Q * 300)
    p = tk.plan_topk_rowwise(Q, d, k, 10_000)
    assert p.chunk_rows == 256 and p.chunks == 40


def test_rowwise_plan_refuses_k_past_its_limit():
    """Past ROWWISE_K_MAX the selection keeps its candidates in a device
    buffer of a power of two >= 2k slots a query, instead of refusing; d
    of any width plans (the kernel reads the padded table)."""
    p = tk.plan_topk_rowwise(16, 128, tk.ROWWISE_K_MAX, 10_000)
    assert (p.select_cap, p.candidate_bytes) == (tk.ROWWISE_SELECT_CAP, 0)
    p = tk.plan_topk_rowwise(16, 128, tk.ROWWISE_K_MAX + 1, 10_000)
    assert p.select_cap == 4096 and p.candidate_bytes == 12 * 16 * 4096
    p = tk.plan_topk_rowwise(16, 16, 5000, 10_000)
    assert p.select_cap == 16384 >= 2 * 5000
    assert p.select_smem_bytes <= tk.SMEM_STATIC
    assert tk.plan_topk_rowwise(16, 30, 10, 10_000).chunks == 1


# --------------------------------------------------------------------------
# an emulation of the rowwise kernel's selection (topk_rowwise.cu), held
# against the order that topk_scan.cu's better() and the plain scan use
# --------------------------------------------------------------------------
_U = np.uint64


def _sort_keys(scores, rows):
    """select_kernel's sort_key: (~order-preserving bits) << 32 | row."""
    b = np.asarray(scores, np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0                        # -0.0 ties +0.0
    asc = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return ((~asc).astype(_U) << _U(32)) | np.asarray(rows).astype(
        np.uint32).astype(_U)


def _select(keys, vals, k, limit, cap):
    """select_kernel's radix select: 11-bit digits from the top until at
    most ``cap`` entries can still be among the k best, then a sort of
    those. Returns the k smallest keys and their values."""
    bits = int(np.log2(tk.ROWWISE_SELECT_BINS))
    keep = keys <= limit
    prefix = mask = _U(0)
    below, shift, first = 0, 64 - bits, True
    while True:
        m = keep & ((keys & mask) == prefix)
        hist = np.bincount(((keys[m] >> _U(shift)) & _U(2**bits - 1)
                            ).astype(np.int64), minlength=2**bits)
        if first and hist.sum() <= cap:
            break
        first = False
        cum = np.cumsum(hist)
        digit = int(np.searchsorted(cum, k - below))   # first cum >= need
        below += int(cum[digit] - hist[digit])
        prefix |= _U(digit) << _U(shift)
        mask |= _U(2**bits - 1) << _U(shift)
        if below + hist[digit] <= cap or shift == 0:
            break
        shift = max(shift - bits, 0)
    sel = keep & ((keys & mask) <= prefix)
    assert k <= sel.sum() <= cap
    order = np.argsort(keys[sel], kind="stable")[:k]
    return keys[sel][order], vals[sel][order]


def _rowwise_emulated(scores, k, chunk_rows, cap=tk.ROWWISE_SELECT_CAP):
    """The kernel's chunk loop over a (Q, valid) score matrix: each chunk's
    selection takes the chunk and the k best carried from before."""
    Q, valid = scores.shape
    sentinel = _sort_keys([-np.inf], [tk.IDX_SENTINEL])[0]
    best_v = np.full((Q, k), -np.inf, np.float32)
    best_i = np.full((Q, k), tk.IDX_SENTINEL, np.int64)
    for base in range(0, valid, chunk_rows):
        hi = min(base + chunk_rows, valid)
        for q in range(Q):
            ck = (np.full(k, sentinel) if base == 0
                  else _sort_keys(best_v[q], best_i[q]))
            keys = np.concatenate([_sort_keys(scores[q, base:hi],
                                              np.arange(base, hi)), ck])
            vals = np.concatenate([scores[q, base:hi], best_v[q]])
            kk, vv = _select(keys, vals, k, ck.max(), cap)
            best_v[q], best_i[q] = vv, (kk & _U(0xffffffff)).astype(np.int64)
    return best_v, best_i.astype(np.int32)


def _better_order(scores, k):
    """The k best of each row of scores by better(): score descending
    (-0.0 == +0.0), then row ascending; (-inf, int32 max) past the end."""
    out_v = np.full((scores.shape[0], k), -np.inf, np.float32)
    out_i = np.full((scores.shape[0], k), tk.IDX_SENTINEL, np.int32)
    for q, row in enumerate(scores):
        best = sorted(range(len(row)), key=lambda r: (-row[r], r))[:k]
        out_v[q, :len(best)], out_i[q, :len(best)] = row[best], best
    return out_v, out_i


@pytest.mark.parametrize("k,chunk,cap", [
    (10, 64, tk.ROWWISE_SELECT_CAP), (25, 64, tk.ROWWISE_SELECT_CAP),
    (4, 16, 8), (1, 7, 2), (8, 50, 16), (30, 8, 64)])
def test_rowwise_selection_emulated_keeps_the_order(k, chunk, cap):
    """Ties at every rank and across chunk edges, -0.0 beside +0.0, fewer
    rows than k in the first chunk: the emulated selection equals
    better()'s order and the plain scan bitwise. A small ``cap`` forces
    every radix digit, the row bits included."""
    rng = np.random.default_rng(k + chunk)
    tbl = _int(6, 16, 4)[rng.integers(0, 6, size=300)]
    tbl[::11] = 0.0                                 # rows that score 0
    q = _int(9, 16, 5)
    scores = q @ tbl.T                              # exact: small integers
    scores[0] = -np.abs(scores[0])                  # zeros are its best
    scores[:, 5::13] = -0.0
    scores[:, 6::13] = 0.0
    got = _rowwise_emulated(scores, k, chunk, cap)
    want = _better_order(scores, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    plain = tk.topk_mips_plain(torch.from_numpy(tbl), torch.from_numpy(q), k)
    np.testing.assert_array_equal(
        _rowwise_emulated(q @ tbl.T, k, chunk, cap)[1], plain[1].numpy())


def test_rowwise_selection_emulated_on_continuous_scores():
    """Distinct continuous scores and a query whose best rows sit at the
    chunk edges; valid < k leaves sentinel slots."""
    rng = np.random.default_rng(12)
    scores = rng.normal(0, 0.1, (5, 700)).astype(np.float32)
    scores[0, [127, 128, 255, 256]] = 3.0
    got = _rowwise_emulated(scores, 10, 128)
    want = _better_order(scores, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1][0, :4]) == [127, 128, 255, 256]
    short = _rowwise_emulated(scores[:, :6], 10, 4)
    np.testing.assert_array_equal(short[1],
                                  _better_order(scores[:, :6], 10)[1])
    assert (short[1][:, 6:] == tk.IDX_SENTINEL).all()


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version: anything else goes to
    the kernel or raises."""
    tbl = torch.zeros((16, 8), device="meta")
    q = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.topk_mips(tbl, q, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.topk_mips_quant(tbl.to(torch.int8), torch.ones(16, device="meta"),
                           q, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.topk_mips_rowwise(tbl, q, 3)
