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


def test_fused_plan_takes_any_B_and_S():
    """Up to one tile a block beside the two sorting blocks and B + S <=
    FUSED_SORT_CAP: today's layout, unchanged (every minibatch the trainer
    and the CI gate issue). Past either: one block an SM striding over the
    tiles, and the grid-wide sort of all 2B + S positions in
    FUSED_SORT_CHUNK-key chunks. Negatives too wide for a tile go in
    chunks."""
    cap = sgns.FUSED_SORT_CAP
    # a sorting block's shared memory: B + S context positions at most (on
    # a card with enough SMs for the grid)
    p = sgns.plan_fused_update(cap - 5, 5, 8, sm_count=4000)
    assert p.sort_chunk == 0 and p.sort_keys == cap
    p = sgns.plan_fused_update(cap - 4, 5, 8, sm_count=4000)
    assert p.sort_chunk == sgns.FUSED_SORT_CHUNK
    assert p.sort_keys == 1 << (2 * (cap - 4) + 5 - 1).bit_length()
    assert p.blocks == 4000 and p.grad_blocks == -(-(cap - 4) // p.bb)
    # more tiles than SMs beside the sorting blocks: one block an SM
    p = sgns.plan_fused_update(130 * 8, 5, 128)
    assert (p.sort_chunk, p.grad_blocks, p.blocks) == (0, 130, 132)
    for B in (130 * 8 + 1, 2048, 8192, 16400, 100_000):
        p = sgns.plan_fused_update(B, 16, 64)
        tiles = -(-B // p.bb)
        assert p.sort_chunk == min(p.sort_keys, sgns.FUSED_SORT_CHUNK)
        assert p.sort_keys >= 2 * B + 16 > p.sort_keys // 2
        assert p.sort_keys % p.sort_chunk == 0
        assert p.blocks == 132 and p.grad_blocks == min(132, tiles)
        assert 8 * p.sort_chunk <= p.smem_bytes <= sgns.SMEM_PER_BLOCK
    p = sgns.plan_fused_update(256, 5, 128, sm_count=33)
    assert p.sort_chunk and p.blocks == 33 and p.grad_blocks == 32
    # negatives that do not fit beside a tile: staged in chunks
    for B, S, d in ((16, 1000, 128), (256, 128, 512), (256, 500, 128),
                    (2048, 500, 128)):
        p = sgns.plan_fused_update(B, S, d)
        assert 0 < p.chunk < S and p.smem_bytes <= sgns.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match=">= 1"):
        sgns.plan_fused_update(0, 5, 8)


def _position_keys(idx_v, idx_c, idx_n):
    """sgns_update_sorted's keys: side << 63 | id << 32 | position over the
    2B + S positions (vertex positions first, then idx_c ++ idx_n)."""
    ids = np.concatenate([idx_v, idx_c, idx_n]).astype(np.uint64)
    p = np.arange(ids.size, dtype=np.uint64)
    side = (p >= idx_v.size).astype(np.uint64)
    return side << np.uint64(63) | ids << np.uint64(32) | p


def _grid_sort(keys, C):
    """The grid-wide sort as the kernel runs it: the keys padded with ~0 to
    n2, every C-key chunk sorted on its own (sizes 2..C, each pair's
    direction from its index in the whole array); then for each size past
    C the strides >= C across the array and the strides < C chunk by
    chunk. A stride below C never pairs keys of two chunks."""
    n2 = 1 << max(keys.size - 1, 0).bit_length()
    C = min(C, n2)
    x = np.full(n2, np.uint64(2**64 - 1), np.uint64)
    x[:keys.size] = keys

    def step(size, stride):
        i = np.arange(n2 // 2)
        lo = 2 * i - (i & (stride - 1))
        hi = lo + stride
        if stride < C:
            assert (lo // C == hi // C).all()
        a, b = x[lo], x[hi]
        swap = (a > b) == ((lo & size) == 0)
        x[lo], x[hi] = np.where(swap, b, a), np.where(swap, a, b)

    size = 2
    while size <= C:                            # the chunks in shared memory
        stride = size // 2
        while stride:
            step(size, stride)
            stride //= 2
        size *= 2
    while size <= n2:
        stride = size // 2
        while stride >= C:                      # grid-wide, a barrier each
            step(size, stride)
            stride //= 2
        while stride:                           # chunk by chunk again
            step(size, stride)
            stride //= 2
        size *= 2
    return x[:keys.size]


@pytest.mark.parametrize("case,B,S,C", [
    ("zipf", 1041, 5, 1024), ("zipf", 2048, 5, 512), ("same", 300, 7, 64),
    ("dup", 8192, 16, 8192), ("dup", 1000, 1000, 256), ("zipf", 1, 1, 8),
])
def test_grid_wide_sort_is_each_sides_stable_sort(case, B, S, C):
    """The grid-wide sort's keys, network and run heads give, for each
    side, the positions of torch's stable sort and one run per unique id
    (the vertex side's first, in the first B slots, as sort_runs lays them
    out), with the positions the combine reads."""
    idx_v, idx_c, idx_n = _case(case, B, S, seed=B + S + C)
    got = _grid_sort(_position_keys(idx_v, idx_c, idx_n), C)
    p = (got & np.uint64(0xffffffff)).astype(np.int64)
    pos = np.where(p < B, p, p - B)            # what the kernel writes
    for lo, hi, idx in ((0, B, idx_v),
                        (B, 2 * B + S, np.concatenate([idx_c, idx_n]))):
        want_v, want_p = torch.sort(torch.from_numpy(idx), stable=True)
        np.testing.assert_array_equal(pos[lo:hi], want_p.numpy())
        ids = ((got[lo:hi] >> np.uint64(32)) & np.uint64(0x7fffffff))
        np.testing.assert_array_equal(ids.astype(np.int64), want_v.numpy())
    # heads by comparing each key's side and id with the one before it
    starts = _runs(got)
    assert starts[0] == 0 and B in starts
    assert len(starts) - 1 == (np.unique(idx_v).size + np.unique(
        np.concatenate([idx_c, idx_n])).size)
