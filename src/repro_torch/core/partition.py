"""Row partition of the node id space (paper §III-B), serving's part.

A copy of ``NodePartition`` from ``repro/core/partition.py``: both
embedding matrices are row-partitioned into P contiguous shards, one per
device, and node n lives in shard n // rows at local row n % rows. The
serving store uses ``subparts=1``, so a global id is ``local + s * rows``
exactly as in the JAX store. The 2D edge partition joins this module with
the training slice.
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
