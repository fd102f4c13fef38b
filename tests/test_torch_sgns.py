"""The port's plain SGNS versions against the JAX package's Pallas kernels
(interpret mode) and its ``sgns_step_ref`` oracle, on the shapes and at the
tolerances of ``tests/test_kernels.py``. Inputs come from numpy seeds and
reach both packages bitwise (bf16 through one round-to-nearest-even cast on
each side)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sgns as jsgns
from repro_torch.kernels import ops, sgns

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(Nv, Nc, B, S, d, dtype="float32", seed=0, dup=False):
    """numpy-seeded tables, indices and mask, as (jax arrays, torch tensors).
    ``dup`` forces the heavy duplication of test_kernels.py: vertex 3 and
    context 5 repeat across the batch, and a negative hits context row 5."""
    rng = np.random.default_rng(seed)
    vert = rng.normal(0, 0.1, (Nv, d)).astype(np.float32)
    ctx = rng.normal(0, 0.1, (Nc, d)).astype(np.float32)
    iv = rng.integers(0, Nv, B).astype(np.int32)
    ic = rng.integers(0, Nc, B).astype(np.int32)
    inn = rng.integers(0, Nc, S).astype(np.int32)
    if dup:
        iv[::3] = 3
        ic[::4] = 5
        inn[0] = 5
    mask = (rng.random(B) > 0.15).astype(np.float32)
    jx = (jnp.asarray(vert).astype(JDT[dtype]), jnp.asarray(ctx).astype(JDT[dtype]),
          jnp.asarray(iv), jnp.asarray(ic), jnp.asarray(inn), jnp.asarray(mask))
    # torch.tensor copies: the port updates its tables in place, and the JAX
    # arrays may share the numpy buffers
    tx = (torch.tensor(vert).to(TDT[dtype]), torch.tensor(ctx).to(TDT[dtype]),
          torch.tensor(iv), torch.tensor(ic), torch.tensor(inn),
          torch.tensor(mask))
    if dtype == "bfloat16":     # the same bits on both sides
        np.testing.assert_array_equal(
            np.asarray(jx[0]).view(np.uint16),
            tx[0].view(torch.int16).numpy().view(np.uint16))
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


def _check_update(jx, tx, lr, rtol, atol, *, loss_rtol=1e-4, block_b=16):
    """Port plain update against the JAX segsum kernel and the oracle."""
    v2, c2, l2 = sgns.sgns_fused_update(*tx, lr)
    assert v2 is tx[0] and c2 is tx[1]            # in place
    want_k = jsgns.sgns_fused_update(*jx, jnp.float32(lr), block_b=block_b,
                                     combine="segsum", interpret=True)
    want_r = jref.sgns_step_ref(*jx, jnp.float32(lr))
    for want in (want_k, want_r):
        np.testing.assert_allclose(float(l2), float(want[2]), rtol=loss_rtol)
        _close(v2, want[0], rtol, atol)
        _close(c2, want[1], rtol, atol)


@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float32", 2e-4, 1e-6),
    # the oracle applies duplicates in bf16 one after another; the kernel
    # and the port combine them in f32 and round once
    ("bfloat16", 3e-2, 3e-3),
])
@pytest.mark.parametrize("dup", [False, True], ids=["nodup", "dup"])
def test_fused_update_plain_matches_jax(dtype, rtol, atol, dup):
    jx, tx = _inputs(70, 90, 64, 8, 64, dtype, seed=60, dup=dup)
    _check_update(jx, tx, 0.05, rtol, atol)


@pytest.mark.parametrize("B", [37])
def test_fused_update_plain_odd_batch(B):
    """An odd B in one launch (the port pads nothing; the JAX kernel runs it
    as a single B-row tile), with row 0 a real target."""
    jx, tx = _inputs(40, 50, B, 4, 32, seed=70)
    tx[2][0] = 0
    jx = (jx[0], jx[1], jx[2].at[0].set(0), *jx[3:])
    _check_update(jx, tx, 0.05, 2e-4, 1e-6, block_b=B)


def test_fused_update_plain_all_same_index():
    """One B-long run per table, the negatives in the context run too."""
    jx, tx = _inputs(40, 50, 128, 8, 32, seed=110)
    B, S = 128, 8
    iv, ic, inn = (np.full(B, 7, np.int32), np.full(B, 9, np.int32),
                   np.full(S, 9, np.int32))
    ones = np.ones(B, np.float32)
    jx = (*jx[:2], jnp.asarray(iv), jnp.asarray(ic), jnp.asarray(inn),
          jnp.asarray(ones))
    tx = (*tx[:2], torch.from_numpy(iv), torch.from_numpy(ic),
          torch.from_numpy(inn), torch.from_numpy(ones))
    # a 128-term f32 sum reassociated: test_kernels.py's tolerance
    _check_update(jx, tx, 0.05, 1e-3, 1e-5, block_b=32)


# the fused gradients' tolerances: f32 as test_kernels.py; bf16 as the
# card's SGNS_TOL (each side rounds its own f32 sums to bf16)
GRADS_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (3e-2, 3e-3)}


@pytest.mark.parametrize("B,S,dtype,dup", [
    pytest.param(64, 8, "float32", False, id="nodup"),
    pytest.param(64, 8, "float32", True, id="dup"),
    *(pytest.param(B, S, dtype, dup,
                   id=f"B{B}-S{S}-{dtype}-{'dup' if dup else 'nodup'}")
      for B in (8, 37, 256) for S in (1, 5)
      for dtype in ("float32", "bfloat16") for dup in (False, True)),
])
def test_fused_grads_plain_matches_jax(B, S, dtype, dup):
    """The plain fused gradients against the JAX kernel in interpret mode
    (one tile where B is ragged): one and five negatives, bf16 tables and
    mask, duplicate rows."""
    jx, tx = _inputs(70, 90, B, S, 64, dtype, seed=40 if B == 64 else B + S,
                     dup=dup)
    if dtype == "bfloat16":     # the mask in the tables' dtype, as trained
        jx = (*jx[:5], jx[5].astype(jnp.bfloat16))
        tx = (*tx[:5], tx[5].bfloat16())
    got = sgns.sgns_fused_grads(*tx)
    want = jsgns.sgns_fused_grads(*jx, block_b={64: 16, 256: 64}.get(B, B),
                                  interpret=True)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    rtol, atol = GRADS_TOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == TDT[dtype] and g.shape == w.shape
        _close(g, w, rtol, atol)


def test_tile_grads_plain_matches_ref_grads():
    """The shared tile math against the JAX oracle's sgns_grads_ref."""
    rng = np.random.default_rng(3)
    v, c = rng.normal(0, 0.1, (2, 48, 32)).astype(np.float32)
    n = rng.normal(0, 0.1, (6, 32)).astype(np.float32)
    m = (rng.random(48) > 0.2).astype(np.float32)
    dv, dc, dn, loss = sgns.tile_grads_plain(
        torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(n),
        torch.from_numpy(m)[:, None])
    wl, wdv, wdc, wdn = jref.sgns_grads_ref(jnp.asarray(v), jnp.asarray(c),
                                            jnp.asarray(n), jnp.asarray(m))
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    for g, w in ((dv, wdv), (dc, wdc), (dn, wdn)):
        _close(g, w, 1e-4, 1e-6)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_sgns_step_matches_jax_ops(reduction):
    """``ops.sgns_step`` routes a CPU tensor to the plain version with the
    JAX op's semantics ("mean" divides lr by B)."""
    jx, tx = _inputs(40, 50, 32, 4, 32, seed=52)
    v, c, loss = ops.sgns_step(*tx, 0.05, reduction=reduction)
    wv, wc, wl = jops.sgns_step(*jx, jnp.float32(0.05), impl="ref",
                                reduction=reduction)
    np.testing.assert_allclose(float(loss), float(wl), rtol=3e-5)
    _close(v, wv, 2e-4, 1e-6)
    _close(c, wc, 2e-4, 1e-6)
    with pytest.raises(ValueError, match="reduction"):
        ops.sgns_step(*tx, 0.05, reduction="max")


def test_plain_update_uses_pre_update_rows_and_one_cast():
    """Duplicates combine before the apply: a row hit twice moves by the
    sum of both gradients, each computed from the row as it was."""
    vert = torch.tensor([[1.0, 0.0]])
    ctx = torch.tensor([[0.5, 0.5], [0.0, 1.0]])
    iv = torch.tensor([0, 0], dtype=torch.int32)
    ic = torch.tensor([0, 1], dtype=torch.int32)
    inn = torch.tensor([1], dtype=torch.int32)
    mask = torch.ones(2)
    before = vert.clone()
    dv, dc, dn, _ = sgns.tile_grads_plain(before[[0, 0]], ctx[[0, 1]],
                                          ctx[[1]], mask[:, None])
    sgns.sgns_fused_update(vert, ctx.clone(), iv, ic, inn, mask, 0.5)
    torch.testing.assert_close(vert[0], before[0] - 0.5 * dv.sum(0),
                               rtol=0, atol=1e-7)


def test_grads_tile_plan():
    bb, smem = sgns.plan_grads_tile(256, 5, 128)
    assert bb == sgns.GRAD_TILE_ROWS
    assert smem == sgns.grads_tile_smem_bytes(bb, 5, 128) <= sgns.SMEM_PER_BLOCK
    assert sgns.plan_grads_tile(5, 5, 128)[0] == 5          # B < one tile
    bb, smem = sgns.plan_grads_tile(256, 32, 1024)           # wide rows
    assert bb < sgns.GRAD_TILE_ROWS and smem <= sgns.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        sgns.plan_grads_tile(256, 100, 1024)


def test_sgns_grads_plan():
    """#5's and #6's one cooperative launch: tiles of 8 rows (fewer when
    the S negatives leave no room), a block a tile up to one block an SM
    (32 blocks at the trainer's B = 256), past that each block takes
    several tiles, so any B plans; a ValueError when one row and the S
    negatives do not fit a block."""
    p = sgns.plan_sgns_grads(256, 5, 128)
    assert (p.bb, p.tiles, p.blocks) == (sgns.GRADS_ROWS, 32, 32)
    assert p.smem_bytes == sgns.grads_tile_smem_bytes(8, 5, 128)
    for B in (1, 5, 37, 256, 1000, 1056, 1057, 5000, 256 * 132 + 1):
        for S, d in ((1, 8), (5, 128), (32, 256), (300, 128), (400, 128)):
            p = sgns.plan_sgns_grads(B, S, d, sm_count=132)
            assert (p.bb, p.smem_bytes) == sgns.plan_grads_tile(
                B, S, d, sgns.GRADS_ROWS)
            assert (p.tiles - 1) * p.bb < B <= p.tiles * p.bb
            assert p.blocks == min(p.tiles, 132)
            assert p.smem_bytes <= sgns.SMEM_PER_BLOCK
    assert sgns.plan_sgns_grads(37, 5, 128).blocks == 5     # a ragged tail
    assert sgns.plan_sgns_grads(400, 400, 128).bb < sgns.GRADS_ROWS
    with pytest.raises(ValueError, match="negatives of width"):
        sgns.plan_sgns_grads(256, 100, 1024)


@pytest.mark.parametrize("B,S,d,dtype,block_b", [
    (37, 5, 32, "float32", 37),       # B not a multiple of 8 rows a block
    (64, 1, 64, "float32", 16),       # one negative
    (29, 4, 64, "bfloat16", 29),      # bf16 rows and mask, ragged
])
def test_sgns_grads_plain_matches_jax_pallas(B, S, d, dtype, block_b):
    """The plain version #5's kernel is held to, against the JAX Pallas
    kernel in interpret mode (one tile of B rows where B is ragged), the
    mask in the rows' dtype; test_kernels.py's tolerances."""
    rng = np.random.default_rng(B + S + d)
    v, c = rng.normal(0, 0.3, (2, B, d)).astype(np.float32)
    n = rng.normal(0, 0.3, (S, d)).astype(np.float32)
    m = (rng.random(B) > 0.2).astype(np.float32)
    jx = [jnp.asarray(x).astype(JDT[dtype]) for x in (v, c, n, m)]
    tx = [torch.tensor(x).to(TDT[dtype]) for x in (v, c, n, m)]
    got = sgns.sgns_grads(*tx)
    want = jsgns.sgns_grads(*jx, block_b=block_b, interpret=True)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=3e-5,
                               atol=3e-5)
    rtol = 1e-4 if dtype == "float32" else 1e-4 + 2.0 ** -8
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == TDT[dtype] and g.shape == w.shape
        _close(g, w, rtol, 1e-5)
