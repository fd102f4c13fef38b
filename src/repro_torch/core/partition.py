"""Hierarchical data partitioning (paper §III-B), a numpy copy of the JAX
package's ``core/partition.py``.

Two cooperating partitions:

* **Node partition** — both embedding matrices are row-partitioned into
  P = Q·D·M contiguous shards (one per device). The vertex shard on each
  device is further split into ``k`` sub-parts. Nodes are block-assigned:
  node n → shard n // rows, local row n % rows. The serving store uses
  ``subparts=1``, so a global id is ``local + s * rows``.

* **2D edge partition** — an episode's edge samples (u, v) are bucketed by
  (vertex sub-shard of u, context shard of v) and laid out *by the rotation
  schedule*: ``blocks[dev, u, t, r, j]`` holds exactly the samples device
  ``dev`` can train at round (u, t, r) on sub-part j, with both endpoints
  resident. This is the paper's "orthogonal vertex usage" guarantee.

Everything here is host-side numpy; the trainer stages the arrays it emits
to the card (``core.hybrid.HybridEmbeddingTrainer.stage_blocks``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NodePartition:
    """Row partition of the (padded) node id space."""

    num_nodes: int
    dims: tuple[int, ...]        # ring dims, e.g. (D, M) or (Q, D, M)
    subparts: int = 4            # paper's k

    @property
    def num_shards(self) -> int:
        return int(np.prod(self.dims))

    @property
    def rows_per_shard(self) -> int:
        return -(-self.num_nodes // self.num_shards)  # ceil

    @property
    def rows_per_subpart(self) -> int:
        return -(-self.rows_per_shard // self.subparts)

    @property
    def padded_rows_per_shard(self) -> int:
        return self.rows_per_subpart * self.subparts

    @property
    def padded_num_nodes(self) -> int:
        return self.padded_rows_per_shard * self.num_shards

    # node id -> (shard, subpart, row-within-subpart); vectorized
    def locate(self, nodes: np.ndarray):
        rows = self.padded_rows_per_shard
        shard = nodes // rows
        local = nodes % rows
        sub = local // self.rows_per_subpart
        subrow = local % self.rows_per_subpart
        return shard, sub, subrow

    def subpart_global_rows(self, sub: int, subrows: np.ndarray,
                            shard: int = 0) -> np.ndarray:
        """Inverse of :meth:`locate` for one (shard, subpart): row-within-
        subpart indices -> rows into the padded global table."""
        return (shard * self.padded_rows_per_shard
                + sub * self.rows_per_subpart + subrows)

    def shard_coord(self, shard: np.ndarray):
        """Flat shard id -> mesh coordinate arrays."""
        coords = []
        rem = shard
        for n in self.dims[::-1]:
            coords.append(rem % n)
            rem = rem // n
        return tuple(coords[::-1])

    def pad_table(self, table: np.ndarray) -> np.ndarray:
        """(N, d) -> (padded_N, d) so shards/subparts divide evenly."""
        pad = self.padded_num_nodes - table.shape[0]
        if pad == 0:
            return table
        return np.concatenate([table, np.zeros((pad, table.shape[1]), table.dtype)])

    def unpad_table(self, table: np.ndarray) -> np.ndarray:
        return table[: self.num_nodes]


@dataclasses.dataclass
class EpisodeBlocks:
    """Device-major block layout for one episode.

    blocks: (P, Q, D, M, k, Bmax, 2) int32 — (vertex subrow, context row).
    counts: (P, Q, D, M, k) int32 — valid samples per cell.
    dropped: samples discarded because a cell overflowed Bmax (0 unless capped).
    """

    blocks: np.ndarray
    counts: np.ndarray
    dropped: int

    @property
    def block_cap(self) -> int:
        return int(self.blocks.shape[-2])


def _pair_cells(pairs: np.ndarray, part: NodePartition):
    """(u, v) pairs -> (flat cell id, vertex subrow, context row) arrays."""
    dims = part.dims
    P = part.num_shards
    k = part.subparts
    u, v = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    v_shard, v_sub, v_subrow = part.locate(u)           # u indexes vertex table
    c_shard, _, _ = part.locate(v)  # context side: shard id then local row
    c_row = v % part.padded_rows_per_shard

    # the device that trains a pair is the context owner (contexts are pinned)
    dev = c_shard
    # the round at which that device holds the pair's vertex shard
    dev_coords = part.shard_coord(dev)
    vs_coords = part.shard_coord(v_shard)
    rnd_coords = [(d - vv) % n for d, vv, n in zip(dev_coords, vs_coords, dims)]
    rnd_flat = rnd_coords[0]
    for c, n in zip(rnd_coords[1:], dims[1:]):
        rnd_flat = rnd_flat * n + c

    cell = (dev * P + rnd_flat) * k + v_sub              # flat cell id
    return cell, v_subrow, c_row


# pairs per chunk of the two-pass builder: bounds the transient per-chunk
# index arrays (~6 int64 vectors) to ~50 MB regardless of episode size
BUILD_CHUNK_PAIRS = 1 << 20


def build_episode_blocks(pairs: np.ndarray, part: NodePartition, *,
                         block_cap: int | None = None,
                         pad_multiple: int = 64,
                         chunk: int | None = None) -> EpisodeBlocks:
    """Bucket (u, v) pairs into the rotation-schedule block layout.

    Two streaming passes over ``chunk``-sized pair slices (default
    ``BUILD_CHUNK_PAIRS``): a counting pass fixes per-cell counts and the
    block capacity, then a scatter pass writes each slice straight into the
    preallocated block tensor — peak transient memory is O(chunk), not
    O(episode), and the output is bitwise identical for any chunk size
    (a pair's slot is its occurrence index within its cell in pair order).

    ``block_cap`` both caps AND pins the per-cell capacity: when set, every
    episode gets the same (cap rounded up to ``pad_multiple``) block shape
    even if its cells are emptier.
    """
    P = part.num_shards
    k = part.subparts
    n = pairs.shape[0]
    n_cells = P * P * k
    chunk = BUILD_CHUNK_PAIRS if chunk is None else max(1, chunk)
    # common case: the episode fits in one chunk — compute the cell ids once
    # and share them between the two passes instead of re-deriving
    one_shot = _pair_cells(pairs, part) if n <= chunk else None

    # pass 1: count pairs per cell
    counts_flat = np.zeros(n_cells, dtype=np.int64)
    if one_shot is not None:
        counts_flat += np.bincount(one_shot[0], minlength=n_cells)
    else:
        for lo in range(0, n, chunk):
            cell, _, _ = _pair_cells(pairs[lo: lo + chunk], part)
            counts_flat += np.bincount(cell, minlength=n_cells)

    if block_cap is not None:
        bmax = block_cap          # pinned: static shape across episodes
    else:
        bmax = int(counts_flat.max(initial=0))
    bmax = max(pad_multiple, -(-bmax // pad_multiple) * pad_multiple)

    # pass 2: chunked scatter. `fill` carries per-cell occupancy across
    # chunks so a pair's rank equals its rank in the one-shot sorted build.
    blocks = np.zeros((n_cells, bmax, 2), dtype=np.int32)
    fill = np.zeros(n_cells, dtype=np.int64)
    dropped = 0
    lstarts = np.zeros(n_cells + 1, dtype=np.int64)
    for lo in range(0, n, chunk):
        cell, v_subrow, c_row = (one_shot if one_shot is not None
                                 else _pair_cells(pairs[lo: lo + chunk], part))
        order = np.argsort(cell, kind="stable")
        cs = cell[order]
        local_counts = np.bincount(cs, minlength=n_cells)
        np.cumsum(local_counts, out=lstarts[1:])
        rank = fill[cs] + (np.arange(cs.size, dtype=np.int64) - lstarts[cs])
        keep = rank < bmax
        dropped += int((~keep).sum())
        sel = order[keep]
        blocks[cs[keep], rank[keep], 0] = v_subrow[sel]
        blocks[cs[keep], rank[keep], 1] = c_row[sel]
        fill += local_counts
    counts = np.minimum(counts_flat, bmax).astype(np.int32)

    Q_D_M = tuple(part.dims)
    blocks = blocks.reshape(P, *Q_D_M, k, bmax, 2)
    counts = counts.reshape(P, *Q_D_M, k)
    return EpisodeBlocks(blocks=blocks, counts=counts, dropped=dropped)
