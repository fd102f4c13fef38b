"""The on-chip sort of the port's fused SGNS update (``sgns_fused_update``
on the card), modelled on the CPU, and its planner.

The kernel sorts each side's positions in a block of its own: the B
vertex positions (``idx_v``) and the B + S context positions (``idx_c ++
idx_n``), as keys id << 32 | position with a bitonic network in shared
memory, then finds the runs of equal ids. The model below runs the same
network, stage by stage, and is held against ``torch.sort(stable=True)``,
which the update's semantics (and the JAX wrapper's argsort) ask for. The
update's plain version keeps its parity tests against JAX in
``tests/test_torch_sgns.py``; the kernel is held against the plain version
on the card (``tests/test_torch_card.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import sgns

def _keys(idx):
    """A sorting block's keys, one per position of its side."""
    return idx.astype(np.uint64) << np.uint64(32) | np.arange(
        idx.size, dtype=np.uint64)


def _bitonic(keys, n2):
    """sort_runs' network: for each (size, stride), the pair (lo, lo +
    stride) of every i < n2 / 2 is ordered ascending where lo & size == 0,
    descending elsewhere; the pairs of a stage are disjoint. The kernel
    finds lo without a division, stride being a power of two."""
    x = np.full(n2, np.uint64(2**64 - 1), np.uint64)
    x[:keys.size] = keys
    i = np.arange(n2 // 2)
    size = 2
    while size <= n2:
        stride = size // 2
        while stride:
            lo = 2 * i - (i & (stride - 1))
            assert (lo == (i // stride) * 2 * stride + i % stride).all()
            hi = lo + stride
            a, b = x[lo], x[hi]
            swap = (a > b) == ((lo & size) == 0)
            x[lo], x[hi] = np.where(swap, b, a), np.where(swap, a, b)
            stride //= 2
        size *= 2
    return x[:keys.size]


def _runs(sorted_keys):
    """Run starts of equal ids, and the end."""
    hi = sorted_keys >> np.uint64(32)
    head = np.ones(hi.size, bool)
    head[1:] = hi[1:] != hi[:-1]
    return np.append(np.flatnonzero(head), hi.size)


def _zipf_ids(rng, n, rows):
    """The trainer's skew: Zipf(1.1) ranks through a permutation of ids."""
    perm = rng.permutation(rows)
    return perm[(rng.zipf(1.1, n) - 1) % rows].astype(np.int32)


def _case(case, B, S, seed):
    rng = np.random.default_rng(seed)
    if case == "zipf":
        ids = _zipf_ids(rng, 2 * B + S, 26_250_000)
    elif case == "same":
        ids = np.full(2 * B + S, 7, np.int32)
    else:
        ids = rng.integers(0, max(4, B // 3), 2 * B + S).astype(np.int32)
    return ids[:B], ids[B:2 * B], ids[2 * B:]


@pytest.mark.parametrize("case,B,S", [
    ("zipf", 256, 5), ("zipf", 32, 8), ("same", 256, 5), ("same", 1, 1),
    ("dup", 1, 1), ("dup", 37, 4), ("dup", 255, 3), ("zipf", 1023, 7),
])
def test_on_chip_sort_is_torch_stable_sort(case, B, S):
    idx_v, idx_c, idx_n = _case(case, B, S, seed=B + S)
    plan = sgns.plan_fused_update(B, S, 128)
    assert plan.sort_keys >= B + S > plan.sort_keys // 2
    for idx in (idx_v, np.concatenate([idx_c, idx_n])):
        n2 = 1 << max(idx.size - 1, 0).bit_length()   # the kernel's, per side
        assert n2 <= plan.sort_keys
        got = _bitonic(_keys(idx), n2)
        want_v, want_p = torch.sort(torch.from_numpy(idx), stable=True)
        np.testing.assert_array_equal(
            (got >> np.uint64(32)).astype(np.int64), want_v.numpy())
        np.testing.assert_array_equal(
            (got & np.uint64(0xffffffff)).astype(np.int64), want_p.numpy())
        # one run per unique id, in id order
        starts = _runs(got)
        np.testing.assert_array_equal(
            (got[starts[:-1]] >> np.uint64(32)).astype(np.int64),
            np.unique(idx))


def test_fused_plan():
    p = sgns.plan_fused_update(256, 5, 128)          # the per-card minibatch
    # 32 gradient blocks, two sorting blocks, and a warp per position
    assert (p.bb, p.grad_blocks, p.blocks, p.sort_keys) == (8, 32, 65, 512)
    assert p.smem_bytes == max(sgns.grads_tile_smem_bytes(8, 5, 128),
                               12 * 512 + 4)
    for B, S, d in ((1, 1, 8), (37, 4, 32), (32, 8, 128), (1000, 40, 128)):
        p = sgns.plan_fused_update(B, S, d)
        assert p.grad_blocks == -(-B // p.bb)
        assert p.grad_blocks + 2 <= p.blocks <= 132
        assert p.blocks == 132 or p.blocks * 8 >= 2 * B + S
        assert 12 * p.sort_keys + 4 <= p.smem_bytes <= sgns.SMEM_PER_BLOCK
    assert 12 * sgns.FUSED_SORT_CAP + 4 <= sgns.SMEM_PER_BLOCK


def test_fused_plan_refuses_past_its_limits():
    cap = sgns.FUSED_SORT_CAP
    # a sorting block's shared memory: B + S context positions at most (on
    # a card with enough SMs for the grid)
    sgns.plan_fused_update(cap - 5, 5, 8, sm_count=4000)
    with pytest.raises(ValueError, match=f"memory holds {cap}"):
        sgns.plan_fused_update(cap - 4, 5, 8, sm_count=4000)
    # more blocks than SMs: the cooperative launch could not keep them all
    sgns.plan_fused_update(130 * 8, 5, 128)
    with pytest.raises(ValueError, match="resident at once"):
        sgns.plan_fused_update(130 * 8 + 1, 5, 128)
    with pytest.raises(ValueError, match="resident at once"):
        sgns.plan_fused_update(256, 5, 128, sm_count=33)
    with pytest.raises(ValueError, match="do not fit"):
        sgns.plan_fused_update(16, 1000, 128)
