"""The row gather's launch plan (``sgns.plan_gather``) and its plain version.

The CUDA kernel runs only on the card (``tests/test_torch_card.py`` holds it
bitwise against plain there). Here a Python model of its index arithmetic,
the loops of ``gather_kernel`` in ``csrc/gather_rows.cu`` written out, checks
that every planned grid writes each (row, vector) of the output exactly once
and starts no block after the first wave; and the plain version the kernel
is held to against the JAX package's gather (interpret mode) at the row
widths that take each vector width.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sgns as jsgns
from repro_torch.kernels import sgns


def rows_written(plan, B):
    """How often the kernel's loops write each of the B output rows: the
    lanes of a row are ``lanes`` consecutive threads, so thread t of the
    grid takes row t // lanes and strides by the grid's threads // lanes
    rows while its row is below B."""
    per_grid = plan.blocks * sgns.GATHER_THREADS // plan.lanes
    counts = np.zeros(B, np.int64)
    b = np.arange(per_grid, dtype=np.int64)
    while (b < B).any():
        np.add.at(counts, b[b < B], 1)
        b = b + per_grid
    return counts


def vectors_written(plan):
    """How often a row's group of lanes writes each of its vectors: lane j
    writes vectors j, j + L, ... below the row's units."""
    counts = np.zeros(plan.units, np.int64)
    for j in range(plan.lanes):
        u = np.arange(j, plan.units, plan.lanes)
        np.add.at(counts, u, 1)
    return counts


@pytest.mark.parametrize("row_bytes", [2, 12, 256, 512, 1024, 4104])
@pytest.mark.parametrize("B", [1, 7, 256, 10_240, 100_000])
def test_plan_covers_every_row_and_vector_once_in_one_wave(B, row_bytes):
    plan = sgns.plan_gather(B, row_bytes, 132)
    assert plan.vec_bytes * plan.units == row_bytes
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.units <= plan.lanes or plan.lanes == 32
    # no block starts after the first wave
    assert 1 <= plan.blocks <= 132 * sgns.GATHER_BLOCKS_PER_SM
    # the (row, vector) pairs are the product of these: each exactly once
    assert (rows_written(plan, B) == 1).all()
    assert (vectors_written(plan) == 1).all()
    # no block is planned with no row to write
    assert (plan.blocks - 1) * sgns.GATHER_THREADS // plan.lanes < B


@pytest.mark.parametrize("row_bytes,align,vec", [
    (256, 16, 16),       # bf16 d = 128: 16-byte vectors
    (512, 16, 16),       # f32 d = 128
    (256, 4, 4),         # a table viewed from a 4-byte offset
    (24, 16, 8),         # f32 d = 6
    (12, 16, 4),         # f32 d = 3, int8 d = 12
    (14, 16, 2),         # bf16 d = 7: 2-byte vectors, not bytes
    (20, 2, 2),          # int8 d = 20 from a 2-byte offset
    (7, 16, 1),          # int8 d = 7
    (256, 1, 1),         # bytes from an odd base
])
def test_plan_takes_the_widest_vector_rows_and_bases_allow(row_bytes, align,
                                                           vec):
    plan = sgns.plan_gather(10_240, row_bytes, 132, align)
    assert plan.vec_bytes == vec
    assert plan.lanes == min(32, 1 << (row_bytes // vec - 1).bit_length())


def test_plan_at_the_main_paths_shapes():
    """The serving survivors (256 x 40 bf16 rows of d = 128): two rows a
    warp step, 640 blocks, under one 1,056-block wave; the trainer's
    minibatch (256 f32 rows): a warp a row, 32 blocks; past a wave the
    grid strides."""
    p = sgns.plan_gather(10_240, 256, 132)
    assert (p.vec_bytes, p.lanes, p.blocks) == (16, 16, 640)
    p = sgns.plan_gather(256, 512, 132)
    assert (p.vec_bytes, p.lanes, p.blocks) == (16, 32, 32)
    p = sgns.plan_gather(10_000_000, 256, 132)
    assert p.blocks == 132 * sgns.GATHER_BLOCKS_PER_SM


@pytest.mark.parametrize("dtype,d", [(np.float32, 128), (np.float32, 3),
                                     ("bfloat16", 7), (np.int8, 12),
                                     (np.int8, 7)])
def test_gather_plain_matches_jax_kernel(dtype, d):
    """The plain version, bitwise the JAX blocked gather (interpret mode),
    at widths that take 16-, 4-, 2- and 1-byte vectors on the card; a
    ragged last block of rows and repeated ids."""
    rng = np.random.default_rng(d)
    N, B = 50, 37
    idx = rng.integers(0, N, B).astype(np.int32)
    idx[::5] = 3
    if dtype == "bfloat16":
        base = rng.normal(0, 1, (N, d)).astype(np.float32)
        jt = jnp.asarray(base).astype(jnp.bfloat16)
        tt = torch.from_numpy(base).bfloat16()
    else:
        base = rng.integers(-100, 100, (N, d)).astype(dtype)
        jt, tt = jnp.asarray(base), torch.from_numpy(base)
    want = np.asarray(jsgns.gather_rows(jt, jnp.asarray(idx), interpret=True))
    got = sgns.gather_rows(tt, torch.from_numpy(idx))
    if dtype == "bfloat16":
        got = got.view(torch.int16).numpy().view(np.uint16)
        want = want.view(np.uint16)
    else:
        got = got.numpy()
    np.testing.assert_array_equal(got, want)
