"""The serving scans at any width and depth, on the CPU: the layout the
card's kernels read against the JAX package's scans.

On the card a table whose width is not a multiple of 8 is scanned with its
columns padded with zeros (``topk.pad_columns``, once at store load) and
each query batch padded to match. A zero column adds an exact 0 to every
score's fmaf chain, so the padded layout scores every pair as the real
columns do, up to the sign of a zero; -0 and +0 tie in every selection
(the smaller row first). These tests hold the plain scans on padded
operands against ``repro.embed_serve.topk`` on the real ones (small
integer tables: every dot is exact), at d = 1, 100 and 300 and at depths
past the kernels' old limits (k = 1,500 for the rowwise scan, 8,000 for
the exact scan); the kernels themselves are held bitwise against these
plain versions on the card (``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embed_serve import quant as jqz
from repro.embed_serve import topk as jtk
from repro.kernels import ref as jref
from repro_torch.embed_serve import quant as qz
from repro_torch.embed_serve import store as tstore
from repro_torch.embed_serve import topk as tk


def _int(n, d, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _same(port, jax_out):
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(jax_out[1]))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(jax_out[0]))


@pytest.mark.parametrize("d", [1, 100, 300])
def test_padded_columns_scan_as_the_real_ones(d):
    """The exact and rowwise scans on a padded table and padded queries,
    and the int8 first pass on a padded int8 copy, equal JAX's scans of the
    real columns; the padding is zeros to the next multiple of 8."""
    tbl, q = _int(230, d, 1), _int(9, d, 2)
    tbl[5] = 0.0                              # a row that scores 0 for all
    q[3] = 0.0                                # a query that ties every row
    pt, pq = (tk.pad_columns(torch.from_numpy(a)) for a in (tbl, q))
    assert pt.shape[1] == -(-d // 8) * 8 and pt.shape[1] % 8 == 0
    assert torch.equal(pt[:, :d], torch.from_numpy(tbl))
    assert not pt[:, d:].any()
    want = jtk.topk_mips_xla(jnp.asarray(tbl), jnp.asarray(q), k=10)
    _same(tk.topk_mips_plain(pt, pq, 10), want)
    _same(tk.topk_mips_rowwise_plain(pt, pq, 10), want)
    # the int8 first pass: its copy quantized from the real columns
    q8, sc = qz.quantize_rows(torch.from_numpy(tbl))
    jq8, jsc = jqz.quantize_rows(tbl)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    wantq = jtk.topk_mips_quant_xla(jnp.asarray(jq8), jnp.asarray(jsc),
                                    jnp.asarray(q), m=40)
    _same(tk.topk_mips_quant_plain(tk.pad_columns(q8), sc, pq, 40), wantq)
    # a padded int8 copy read over the queries' real columns (quant_xla)
    _same(tk.topk_mips_quant_plain(tk.pad_columns(q8), sc,
                                   torch.from_numpy(q), 40), wantq)


def test_scan_operands_pad_once():
    """The kernel wrappers' operands: a table of a width not a multiple of
    8 is padded (a copy), one already padded is kept as it is, and queries
    of the real width are padded to the table's."""
    t = torch.ones((4, 12))
    q = torch.ones((2, 12))
    pt, pq = tk._scan_operands(t, q)
    assert pt.shape == (4, 16) and pq.shape == (2, 16)
    pt2, pq2 = tk._scan_operands(pt, q)
    assert pt2 is pt and pq2.shape == (2, 16)
    t8 = torch.ones((4, 16))
    assert tk._scan_operands(t8, torch.ones((2, 16)))[0] is t8
    # the store pads only what a card's kernels read
    assert tstore._scan_layout(t) is t


@pytest.mark.parametrize("k", [1500, 8000])
def test_deep_k_matches_jax(k):
    """Past the rowwise kernel's shared selection (k = 1,500) and the
    exact scan's merge (k = 8,000, a small table): the plain scans equal
    the JAX package's numpy oracle (``kernels/ref.py::topk_mips_ref``, its
    serving ground truth; its jnp selection unrolls k passes, too many to
    trace at these depths), heavy ties included."""
    rng = np.random.default_rng(4)
    tbl = _int(40, 8, 5)[rng.integers(0, 40, size=9000)]
    q = _int(3, 8, 6)
    want = jref.topk_mips_ref(tbl, q, k)
    for scan in (tk.topk_mips_plain, tk.topk_mips_rowwise_plain):
        _same(scan(torch.from_numpy(tbl), torch.from_numpy(q), k), want)


def test_zero_scores_tie_by_row_whatever_their_sign():
    """-0.0 and +0.0 compare equal, so they tie and the smaller row goes
    first, in the port's selection as in the JAX package's: the padded
    layout's only possible difference in a score cannot reorder a list."""
    vals = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0]], np.float32)
    idx = np.array([[7, 2, 9, 4, 0, 1]], np.int32)
    got = tk.select_topk(torch.from_numpy(vals), torch.from_numpy(idx), 6)
    want = jtk.select_topk(jnp.asarray(vals), jnp.asarray(idx), 6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy()[0], [9, 0, 2, 4, 7, 1])
    flipped = tk.select_topk(torch.from_numpy(-vals * 0 + vals * (vals != 0)),
                             torch.from_numpy(idx), 6)
    assert torch.equal(flipped[1], got[1])


@pytest.mark.parametrize("d", [1, 100, 300, 1000])
def test_wide_plans_fit_a_block(d):
    """The kernels' plans at any width: the filter scan's (256-column
    slices past 256, the tile's scores kept beside the staging) and the
    rowwise scan's fit the card's shared memory for every table dtype and
    the serving batch."""
    for itemsize in (1, 2, 4):
        for Q in (1, 8, 256):
            p = tk.plan_topk_filter(Q, d, 10, 1 << 20, itemsize)
            assert p.smem_bytes <= tk.SMEM_PER_BLOCK
            assert p.width >= -(-d // 8) * 8
            assert p.width % (256 if p.width > 256 else 32) == 0
    p = tk.plan_topk_rowwise(256, d, 10, 1 << 20)
    assert p.scratch_bytes <= tk.ROWWISE_SCRATCH_BYTES
