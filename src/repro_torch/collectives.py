"""What this rank sends into collectives: calls, bytes, seconds and bytes
by kind and by group.

Both the sharded LM steps (``sharding/shard.py``) and the embedding
trainer's rings (``core/ring.py``) count here, so the one counter reads
either. The kinds carry the JAX package's HLO names
(``launch/hlo_cost.py``): ``all-gather``, ``all-reduce``, ``all-to-all``,
``reduce-scatter`` (the all-gather's adjoint, which runs as an all-reduce
then this rank's block: its bytes are that all-reduce's) and
``collective-permute`` (the rings' shifts). :data:`GROUP_BYTES` keeps the
same bytes by (kind, the group's ranks), which the dry-run's roofline
reads to pick a link.
"""
from __future__ import annotations

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
COLLECTIVES = {"calls": 0, "bytes": 0, "s": 0.0,
               "by_kind": dict.fromkeys(KINDS, 0)}
# (kind, the group's ranks in the default group) -> bytes
GROUP_BYTES: dict = {}


def reset_counts() -> None:
    COLLECTIVES.update(calls=0, bytes=0, s=0.0,
                       by_kind=dict.fromkeys(KINDS, 0))
    GROUP_BYTES.clear()


def counts() -> dict:
    """A copy of :data:`COLLECTIVES`, its bytes by kind included."""
    return {**COLLECTIVES, "by_kind": dict(COLLECTIVES["by_kind"])}


def count(kind: str, nbytes: int, ranks: tuple) -> None:
    """One collective call of ``kind`` into which this rank sends
    ``nbytes``, over the group of ``ranks``."""
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += nbytes
    COLLECTIVES["by_kind"][kind] += nbytes
    GROUP_BYTES[kind, ranks] = GROUP_BYTES.get((kind, ranks), 0) + nbytes
