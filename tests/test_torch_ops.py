"""The trainer's unfused routes, port against the JAX package: the plain
versions of ``sgns_grads``, ``scatter_add_rows`` and the row-wise
references against the JAX Pallas kernels in interpret mode, ``ops.sgns_step``
route by route against the JAX op, one bf16 trainer episode on the
``pallas`` route against the JAX trainer's, and the launcher's ``--impl``
on the CPU. Inputs come from numpy seeds and reach both packages bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sgns as jsgns
from repro_torch.core import HybridConfig
from repro_torch.kernels import ops, sgns
from repro_torch.launch import train as ttrain
from test_torch_train import CFG, _episode_pair

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """One f32 numpy array as (jax array, torch tensor) of ``dtype``, with
    the same bits on both sides (one round-to-nearest-even cast each)."""
    j = jnp.asarray(a).astype(JDT[dtype])
    t = torch.tensor(a).to(TDT[dtype])
    np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                  t.float().numpy())
    return j, t


def _bits(x):
    """The bit pattern of an f32 or bf16 array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(
            torch.int32)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_step(x):
    """The spacing of bf16 values at the magnitude of each element of x."""
    s = np.ldexp(np.ones_like(x), np.frexp(x)[1] - 8)
    return np.where(x == 0, 0.0, s)


def _within_bf16_steps(got, want, before):
    """A bf16 table against the reference's: the two compute each update in
    f32 in another summation order, so an update may round one bf16 step
    apart and the new row one step apart (two across a power of two); a
    dropped or doubled update moves a row by more."""
    got, want, before = _f32(got), _f32(want), _f32(before)
    tol = 2 * _bf16_step(want) + _bf16_step(want - before)
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{int(bad.sum())} elements beyond two bf16 steps"


# --------------------------------------------------------------------------
# sgns_grads (TPU kernel #5)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,d", [(37, 5, 32), (64, 8, 128)])
def test_sgns_grads_plain_matches_jax_kernel(dtype, B, S, d):
    """Against the JAX op on its Pallas route with a 16-row tile, so B = 37
    is padded by the op; test_kernels.py's tolerances (bf16 results also
    one bf16 rounding: each side rounds its own f32 sum)."""
    rng = np.random.default_rng(B + S + d)
    (jv, v), (jc, c), (jn, n) = (_pair(rng.normal(0, 0.3, shape).astype(
        np.float32), dtype) for shape in ((B, d), (B, d), (S, d)))
    jm, m = _pair((rng.random(B) > 0.2).astype(np.float32), dtype)
    got = sgns.sgns_grads_plain(v, c, n, m)
    want = jops.sgns_grads(jv, jc, jn, jm, impl="pallas", block_b=16)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=3e-5,
                               atol=3e-5)
    rtol = 1e-4 if dtype == "float32" else 1e-4 + 2.0 ** -8
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == TDT[dtype] and g.shape == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=rtol, atol=1e-5)


# --------------------------------------------------------------------------
# scatter_add_rows (#9) and scatter_add_rows_rowwise (#10)
# --------------------------------------------------------------------------
def _scatter_ids(case, B, N, rng):
    if case == "nodup":
        return rng.permutation(N)[:B]
    if case == "same":
        return np.full(B, 3)
    # duplicates within blocks of 8 (runs of 3) and across them (row 5)
    idx = rng.integers(0, N, B)
    idx[::7] = 5
    idx[1:24:8] = idx[2:25:8] = idx[3:26:8] = 11
    return idx


@pytest.mark.parametrize("dtype,upd_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("case", ["nodup", "same", "dup"])
def test_scatter_add_rows_plain_matches_jax_kernels_bitwise(dtype, upd_dtype,
                                                            case):
    """``table[idx[p]] += upd[p]`` one position at a time: bitwise the JAX
    blocked kernel (8-row blocks, B not a multiple) and its row-wise
    reference. The small updates on rows of magnitude 1 make the per
    position bf16 rounding visible: combining a run in f32 first would
    differ."""
    rng = np.random.default_rng(len(case))
    N, d, B = 40, 64, 30
    idx = _scatter_ids(case, B, N, rng).astype(np.int32)
    jt, tt = _pair(rng.normal(0, 1, (N, d)).astype(np.float32), dtype)
    ju, tu = _pair(rng.normal(0, 3e-3, (B, d)).astype(np.float32), upd_dtype)
    out = sgns.scatter_add_rows_plain(tt, torch.from_numpy(idx), tu)
    assert out is tt                               # in place
    for want in (jsgns.scatter_add_rows(jt, jnp.asarray(idx), ju,
                                        rows_per_block=8, interpret=True),
                 jsgns.scatter_add_rows_rowwise(jt, jnp.asarray(idx), ju,
                                                interpret=True)):
        np.testing.assert_array_equal(_bits(out), _bits(want))


def _itemsize(dtype):
    return torch.empty(0, dtype=TDT[dtype]).element_size()


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,upd_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_scatter_plan_covers_each_position_once_and_fits(d, dtype,
                                                         upd_dtype):
    """#9's chunks: every position once and in order, each chunk's block
    within shared memory, and one chunk (one launch) at the trainer's
    B = 256 + 5 context positions."""
    ti, ui = _itemsize(dtype), _itemsize(upd_dtype)
    for B in (1, 261, 876, 877, 1024, 1025, 5000):
        p = sgns.plan_scatter(B, d, ti, ui)
        assert p.smem_bytes <= sgns.SMEM_PER_BLOCK
        assert p.positions <= sgns.SCATTER_MAX_POSITIONS
        assert [i for lo, hi in p.chunks for i in range(lo, hi)] == list(
            range(B))
        for lo, hi in p.chunks:
            assert 0 < hi - lo <= p.positions
            assert sgns.scatter_smem_bytes(hi - lo, ti,
                                           ui) <= sgns.SMEM_PER_BLOCK
        assert (p.blocks - 1) * sgns.SCATTER_COLS < d <= (
            p.blocks * sgns.SCATTER_COLS)
    assert len(sgns.plan_scatter(261, d, ti, ui).chunks) == 1


@pytest.mark.parametrize("dtype,upd_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("cuts", ["plan", "inside_runs"])
def test_scatter_chunked_matches_jax_kernels_bitwise(dtype, upd_dtype, cuts,
                                                     monkeypatch):
    """Consecutive position chunks applied one after another, as the
    kernel launches them, are the JAX blocked and row-wise kernels' result
    bit for bit: with the plan's cuts (8-position chunks) and with cuts
    that split the runs of rows 5 and 11."""
    rng = np.random.default_rng(17)
    N, d, B = 40, 64, 30
    idx = _scatter_ids("dup", B, N, rng).astype(np.int32)
    jt, tt = _pair(rng.normal(0, 1, (N, d)).astype(np.float32), dtype)
    ju, tu = _pair(rng.normal(0, 3e-3, (B, d)).astype(np.float32), upd_dtype)
    if cuts == "plan":
        monkeypatch.setattr(sgns, "SCATTER_MAX_POSITIONS", 8)
        chunks = sgns.plan_scatter(B, d, _itemsize(dtype),
                                   _itemsize(upd_dtype)).chunks
        assert chunks == ((0, 8), (8, 16), (16, 24), (24, 30))
    else:     # row 11 at 1-3, 9-11, 17-19 and row 5 at 0, 7, 14, 21, 28
        chunks = ((0, 2), (2, 10), (10, 18), (18, 19), (19, 30))
    for lo, hi in chunks:
        sgns.scatter_add_rows_plain(tt, torch.from_numpy(idx[lo:hi]),
                                    tu[lo:hi])
    for want in (jsgns.scatter_add_rows(jt, jnp.asarray(idx), ju,
                                        rows_per_block=8, interpret=True),
                 jsgns.scatter_add_rows_rowwise(jt, jnp.asarray(idx), ju,
                                                interpret=True)):
        np.testing.assert_array_equal(_bits(tt), _bits(want))


def _bf16_round(x):
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7fff) + ((u >> 16) & np.uint32(1))) & np.uint32(
        0xffff0000)
    return u.view(np.float32)


def _rowwise_feed_model(table, idx, upd, P, bf16):
    """#10's kernel on numpy f32 arrays (bf16 values held as f32): per chunk
    of P positions, every row slice staged before any write, ``prev[p]``
    (the latest earlier position with the same id, or -1) from an equality
    scan of the chunk's ids, the walk ``r[p] = add(prev[p] < 0 ? staged[p]
    : r[prev[p]], u[p])`` in position order with one rounding to the
    table's dtype per position, and each row written back once, from its
    last position."""
    rnd = _bf16_round if bf16 else (lambda x: x)
    t = table.copy()
    for lo in range(0, len(idx), P):
        ids, u = idx[lo:lo + P], rnd(upd[lo:lo + P])
        n = len(ids)
        earlier = np.tril(ids[:, None] == ids[None, :], -1)   # q < p, same id
        prev = np.where(earlier.any(axis=1),
                        n - 1 - np.argmax(earlier[:, ::-1], axis=1), -1)
        r = t[ids]                                 # staged: a copy
        for p in range(n):
            r[p] = rnd((r[p] if prev[p] < 0 else r[prev[p]]) + u[p])
        last = np.ones(n, bool)
        last[prev[prev >= 0]] = False
        t[ids[last]] = r[last]
    return t


def _plain_scatter_case(dtype, upd_dtype, idx, N, d, seed):
    """(numpy f32 table, numpy f32 updates, the plain version's result as
    f32): one numpy-seeded case in the given dtypes."""
    rng = np.random.default_rng(seed)
    tt = torch.from_numpy(rng.normal(0, 1, (N, d)).astype(np.float32)).to(
        TDT[dtype])
    tu = torch.from_numpy(rng.normal(0, 3e-3, (len(idx), d)).astype(
        np.float32)).to(TDT[upd_dtype])
    table, upd = tt.float().numpy().copy(), tu.float().numpy().copy()
    want = sgns.scatter_add_rows_plain(tt, torch.from_numpy(idx), tu)
    return table, upd, want.float().numpy()


@pytest.mark.parametrize("dtype,upd_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("case", ["nodup", "same", "dup", "hub", "plan"])
def test_rowwise_feed_model_matches_plain_bitwise(dtype, upd_dtype, case):
    """#10's new feed (chunks, ``prev`` links, the in-order walk over staged
    rows, last-occurrence write-back) is the plain version bit for bit: the
    route cases in 8-position chunks; a 100-position hub run across the
    edges of 64-position chunks (B = 3 * 64 + 7); and B = 3 P + 7 at the
    chunk the plan gives for these dtypes, with a hub run of 100."""
    rng = np.random.default_rng(23)
    if case in ("nodup", "same", "dup"):
        N, d, P = 40, 64, 8
        idx = _scatter_ids(case, 30, N, rng)
    else:
        N, d = 500, 16
        P = 64 if case == "hub" else sgns.plan_scatter_rowwise(
            _itemsize(dtype), _itemsize(upd_dtype))
        B = 3 * P + 7
        idx = rng.integers(0, N, B)
        idx[rng.choice(B, 100, replace=False)] = 7
    idx = idx.astype(np.int32)
    table, upd, want = _plain_scatter_case(dtype, upd_dtype, idx, N, d,
                                           seed=len(case))
    got = _rowwise_feed_model(table, idx, upd, P, bf16=dtype == "bfloat16")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, table)


@pytest.mark.parametrize("dtype,upd_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_scatter_rowwise_plan_covers_each_position_once_and_fits(dtype,
                                                                 upd_dtype):
    """#10's chunk of P positions: a multiple of 32 within the kernel's
    position limit, a full chunk's block (P rows of 8 update and 8 table
    columns, three ints a position) within its shared-memory budget and
    the next multiple of 32 over it, and one chunk (one launch) at the
    trainer's B = 256 + 5. The chunks the kernel cuts from it cover each
    position once, in order: ``test_rowwise_feed_model_matches_plain_bitwise``
    walks them."""
    ti, ui = _itemsize(dtype), _itemsize(upd_dtype)
    P = sgns.plan_scatter_rowwise(ti, ui)
    per = sgns.SCATTER_COLS * (ti + ui) + 12
    assert P % 32 == 0
    assert 261 <= P <= sgns.SCATTER_ROWWISE_MAX_POSITIONS
    assert P * per <= sgns.SCATTER_ROWWISE_SMEM
    assert (P == sgns.SCATTER_ROWWISE_MAX_POSITIONS
            or (P + 32) * per > sgns.SCATTER_ROWWISE_SMEM)
    assert P == {(4, 4): 1280, (2, 4): 1632, (2, 2): 2048}[ti, ui]


def test_scatter_add_rows_plain_rounds_each_position():
    """Two bf16 adds of half a step each leave the row where it was (each
    rounds back to even); one add of their f32 sum would move it."""
    table = torch.ones((1, 1), dtype=torch.bfloat16)
    half = 2.0 ** -8                              # bf16 step at 1.0 is 2^-7
    out = sgns.scatter_add_rows_plain(table, torch.zeros(2, dtype=torch.int32),
                                      torch.full((2, 1), half))
    assert out.item() == 1.0
    assert sgns.scatter_add_rows_rowwise_plain(
        torch.zeros((2, 3)), torch.tensor([1, 1, 0], dtype=torch.int32),
        torch.ones((3, 3))).tolist() == [[1.0] * 3, [2.0] * 3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_rowwise_plain_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(5)
    jt, tt = _pair(rng.normal(0, 1, (50, 64)).astype(np.float32), dtype)
    idx = rng.integers(0, 50, 33).astype(np.int32)
    got = sgns.gather_rows_rowwise_plain(tt, torch.from_numpy(idx))
    want = jsgns.gather_rows_rowwise(jt, jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(sgns.gather_rows(tt, torch.from_numpy(idx))), _bits(want))


# --------------------------------------------------------------------------
# ops.sgns_step, route by route
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["ref", "pallas", "pallas_fused"])
def test_sgns_step_route_matches_jax(impl, dtype, reduction):
    """One minibatch with duplicates (vertex 3, context 5, a negative on
    context 5) and an odd B, each route against the same JAX route: f32 at
    test_kernels.py's tolerances, bf16 tables within two bf16 steps."""
    rng = np.random.default_rng(17)
    Nv, Nc, B, S, d = 40, 50, 37, 5, 32
    iv, ic = rng.integers(0, Nv, B), rng.integers(0, Nc, B)
    inn = rng.integers(0, Nc, S)
    iv[::3], ic[::4], inn[0] = 3, 5, 5
    jvert, vert = _pair(rng.normal(0, 0.3, (Nv, d)).astype(np.float32), dtype)
    jctx, ctx = _pair(rng.normal(0, 0.3, (Nc, d)).astype(np.float32), dtype)
    jm, m = _pair((rng.random(B) > 0.15).astype(np.float32), dtype)
    idx = [a.astype(np.int32) for a in (iv, ic, inn)]
    lr = 0.5 if reduction == "mean" else 0.05
    before = (vert.clone(), ctx.clone())
    got = ops.sgns_step(vert, ctx, *map(torch.from_numpy, idx), m, lr,
                        impl=impl, reduction=reduction)
    assert got[0] is vert and got[1] is ctx
    want = jops.sgns_step(jvert, jctx, *map(jnp.asarray, idx), jm,
                          jnp.float32(lr), impl=impl, reduction=reduction)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    for g, w, b in zip(got[:2], want[:2], before):
        assert not torch.equal(g, b)              # the update happened
        if dtype == "float32":
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=2e-4,
                                       atol=1e-6)
        else:
            _within_bf16_steps(g, w, b)


def test_unknown_impl_raises():
    x = (torch.zeros((4, 8)), torch.zeros((4, 8)),
         *(torch.zeros(n, dtype=torch.int32) for n in (2, 2, 1)),
         torch.ones(2))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.sgns_step(*x, 0.1, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.scatter_add_rows(x[0], x[2], torch.zeros((2, 8)),
                             impl="pallas_fused")
    with pytest.raises(ValueError, match="unknown impl"):
        HybridConfig(impl="triton")
    assert HybridConfig().impl == "pallas_fused2"


# --------------------------------------------------------------------------
# the trainer and the launcher
# --------------------------------------------------------------------------
def test_pallas_episode_matches_jax_trainer_bf16():
    """A bf16 episode (4 minibatches) on the port's ``pallas`` route
    against the JAX trainer's ``pallas`` route in interpret mode: every
    element within two bf16 steps (on these inputs the two agree bit for
    bit; another f32 summation order may flip a rounding)."""
    loss, jloss, tt, jt = _episode_pair(dict(CFG, dtype="bfloat16"), 120, 100,
                                        9, "pallas", impl="pallas")
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for got, want in ((tt.embeddings(), jt.embeddings()),
                      (tt.context_embeddings(), jt.context_embeddings())):
        _within_bf16_steps(got, want, want)


CI_GATE = ["--graph-kind", "sbm", "--nodes", "1200", "--epochs", "12",
           "--episodes", "3", "--dim", "128", "--subparts", "2",
           "--minibatch", "32", "--negatives", "8", "--neg-pool", "2048",
           "--walk-workers", "1", "--min-auc", "0.62"]


def test_launcher_pallas_route_passes_the_ci_gate(tmp_path, capsys):
    """``--impl pallas`` on the CI gate schedule at d = 128, on the CPU."""
    stats = ttrain.main([*CI_GATE, "--impl", "pallas", "--out-dir",
                         str(tmp_path), "--device", "cpu"])
    assert stats["auc"] >= 0.62
    assert "(impl pallas)" in capsys.readouterr().out


def test_launcher_runs_every_route(tmp_path):
    """Every route trains through the launcher on the CPU; there the
    unfused routes are one function, so ref and pallas_fused write the
    checkpoint bit for bit."""
    small = ["--nodes", "300", "--epochs", "1", "--episodes", "2", "--dim",
             "16", "--walk-workers", "1", "--device", "cpu"]
    ckpt = {}
    for impl in ops.STEP_IMPLS:
        stats = ttrain.main([*small, "--impl", impl, "--out-dir",
                             str(tmp_path / impl)])
        assert stats["episodes"] == 2 and np.isfinite(float(stats["loss"]))
        ckpt[impl] = np.load(stats["checkpoint"])["vertex"]
    np.testing.assert_array_equal(ckpt["ref"], ckpt["pallas_fused"])
    assert not np.array_equal(ckpt["ref"], ckpt["pallas_fused2"])
