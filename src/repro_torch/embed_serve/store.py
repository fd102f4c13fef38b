"""Device-sharded embedding store: trained tables -> servable shards.

Counterpart of the JAX package's ``embed_serve/store.py``. Tables are
row-partitioned with the trainer's ``NodePartition`` rule at
``subparts=1`` (node n -> shard n // rows, local row n % rows), one shard
per entry of an explicit device list (a device may repeat), so a trainer
checkpoint loads without re-indexing and global ids are ``local + s*rows``
as in the JAX store. Queries fan out to every shard and the per-shard
top-k lists meet in ``topk.merge_topk``.

Whether a shard runs the CUDA kernels or their plain versions follows the
shard's device and nothing else. Shards are not padded: the kernels mask
their ragged edge themselves.

``quant="int8"`` also builds a per-row int8 copy of every shard for the
two-tier scan (``impl="quant"``). The hot tier, degraded mode and the
rowwise reference path of the JAX store are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.partition import NodePartition
from repro_torch.device import resolve_device
from repro_torch.embed_serve import quant as qz
from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import ref as kref
from repro_torch.train.checkpoint import load_arrays, numpy_to_tensor

QUERY_IMPLS = ("auto", "exact", "quant")
QUANT_TIERS = (None, "int8")


class ShardedEmbeddingStore:
    """Row-sharded embedding table + exact top-k retrieval over it."""

    def __init__(self, shards, part: NodePartition, valid, devices, *,
                 host_table, step: int = -1, qshards=None, quant=None,
                 overfetch: float = qz.DEFAULT_OVERFETCH):
        self.shards = shards                  # per-device (valid_s, d) tensors
        self.part = part
        self.valid = tuple(valid)             # real rows per shard
        self.devices = tuple(devices)
        self.host_table = host_table          # (num_nodes, d) CPU tensor,
        self.step = step                      # or None (keep_host_table off)
        self.qshards = qshards                # per-device (int8, scales) or
        self.quant = quant                    # None (no quantized tier)
        self.overfetch = overfetch            # default tier-one margin

    # ------------------------------------------------------------- loading
    @classmethod
    def from_array(cls, table, *, devices=("cuda",),
                   normalize: bool = False, keep_host_table: bool = True,
                   quant: str | None = None,
                   overfetch: float = qz.DEFAULT_OVERFETCH,
                   step: int = -1) -> "ShardedEmbeddingStore":
        """Shard a (num_nodes, d) table (tensor, or numpy array) across
        ``devices``, one shard each; a CUDA device must exist if named.

        The table keeps its dtype. ``normalize`` rescales rows to unit
        norm (cosine retrieval through the same MIPS scan).
        keep_host_table=False keeps no CPU copy (serving never reads it;
        only ``oracle_topk`` and ``score_ids`` do). quant="int8" builds the
        int8 copies on each shard's device.
        """
        devices = [resolve_device(d) for d in devices]
        if quant not in QUANT_TIERS:
            raise ValueError(f"unknown quant tier {quant!r}; "
                             f"one of {QUANT_TIERS}")
        if not isinstance(table, torch.Tensor):
            table = numpy_to_tensor(np.asarray(table))
        if normalize:                         # cosine via the MIPS kernel
            f32 = table.float()
            f32 /= torch.linalg.vector_norm(f32, dim=1, keepdim=True) + 1e-12
            table = f32.to(table.dtype)
        num_nodes, d = table.shape
        part = NodePartition(num_nodes, dims=(len(devices),), subparts=1)
        rows = part.padded_rows_per_shard
        shards, qshards, valid = [], [], []
        for s, dev in enumerate(devices):
            sh = table[s * rows:min((s + 1) * rows, num_nodes)]
            sh = sh.to(dev).contiguous()
            shards.append(sh)
            valid.append(sh.shape[0])
            if quant == "int8":
                qshards.append(qz.quantize_rows(sh))
        host = table.cpu() if keep_host_table else None
        return cls(shards, part, valid, devices, host_table=host, step=step,
                   qshards=qshards if quant else None, quant=quant,
                   overfetch=overfetch)

    @classmethod
    def load(cls, path: str, *, table: str = "vertex",
             **kwargs) -> "ShardedEmbeddingStore":
        """Load one embedding table from a trainer checkpoint
        (``{"vertex": ..., "context": ...}`` layout)."""
        arrays, step = load_arrays(path)
        if table not in arrays:
            raise KeyError(f"checkpoint {path!r} has no table {table!r}; "
                           f"keys: {sorted(arrays)}")
        return cls.from_array(arrays[table], step=step, **kwargs)

    # ------------------------------------------------------------ querying
    @property
    def num_nodes(self) -> int:
        return self.part.num_nodes

    @property
    def dim(self) -> int:
        return self.shards[0].shape[1]

    def _scan_shard(self, s: int, q, k: int, impl: str, ov: float):
        """Shard s's top-k on its own device -> (scores, GLOBAL ids).
        Slots a short shard cannot fill keep the sentinel."""
        shard = self.shards[s]
        if impl == "quant":
            q8, sc = self.qshards[s]
            v, i = qz.topk_mips_quant_rescored(shard, q8, sc, q, k,
                                               overfetch=ov,
                                               valid=self.valid[s])
        else:
            v, i = tk.topk_mips(shard, q, k, self.valid[s])
        rows = self.part.padded_rows_per_shard
        gi = torch.where(i == tk.IDX_SENTINEL, i, i + s * rows)
        return v, gi

    def _resolve_impl(self, impl: str) -> str:
        if impl not in QUERY_IMPLS:
            raise ValueError(f"unknown impl {impl!r}; one of {QUERY_IMPLS}")
        if impl == "auto":
            impl = "exact"
        if impl == "quant" and self.qshards is None:
            raise RuntimeError("store has no quantized tier; build it with "
                               "quant='int8'")
        return impl

    def topk(self, queries, k: int, *, impl: str = "auto",
             overfetch: float | None = None):
        """Exact MIPS top-k over all shards.

        queries: (Q, d). Returns numpy ((Q, k) f32 scores, (Q, k) i32
        global node ids), k clamped to num_nodes. impl: "exact" (the scan
        over the served rows), "quant" (int8 first pass + exact rescore;
        needs ``quant="int8"`` at load), "auto" (= "exact"). ``overfetch``
        overrides the store's tier-one margin.
        """
        impl = self._resolve_impl(impl)
        ov = self.overfetch if overfetch is None else overfetch
        k = min(k, self.num_nodes)
        q = torch.as_tensor(queries).float()
        on_dev = {}
        launched = []
        # every shard is launched before any result is read back, so shards
        # on different cards scan at the same time
        for s in range(len(self.shards)):
            if self.valid[s] == 0:
                continue
            dev = self.devices[s]
            if dev not in on_dev:
                on_dev[dev] = q.to(dev).contiguous()
            launched.append(self._scan_shard(s, on_dev[dev], k, impl, ov))
        staged = [(v.cpu(), i.cpu()) for v, i in launched]
        if len(staged) == 1:
            gv, gi = staged[0]
        else:
            gv, gi = tk.merge_topk(torch.stack([v for v, _ in staged]),
                                   torch.stack([i for _, i in staged]), k)
        return gv.numpy(), gi.numpy()

    def _host_f32(self) -> np.ndarray:
        if self.host_table is None:
            raise RuntimeError("store was built with keep_host_table=False; "
                               "the oracle needs the host copy")
        return self.host_table.float().numpy()

    def oracle_topk(self, queries, k: int):
        """Numpy ground truth over the full (unsharded) table."""
        return kref.topk_mips_ref(self._host_f32(), np.asarray(queries),
                                  min(k, self.num_nodes))

    def score_ids(self, queries, ids) -> np.ndarray:
        """Ground-truth numpy f32 scores of specific (Q, k) candidate ids:
        what ``recall_at_k``'s tie tolerance is fed, never a kernel's own
        reported values."""
        if self.host_table is None:
            raise RuntimeError("store was built with keep_host_table=False; "
                               "rescoring needs the host copy")
        q = np.asarray(queries, dtype=np.float32)
        rows = self.host_table[torch.as_tensor(np.asarray(ids)).long()]
        return np.einsum("qd,qkd->qk", q, rows.float().numpy())


def recall_at_k(got_ids, oracle_ids, *, got_vals=None, oracle_vals=None,
                rtol: float = 1e-6) -> float:
    """Mean |top-k ∩ oracle top-k| / k over queries.

    With scores supplied, an id outside the oracle's list still counts if
    its score reaches the oracle's k-th score within rtol (an exact tie at
    the rank-k boundary can flip by an ulp between two summation orders).
    ``got_vals`` must be GROUND-TRUTH scores of the returned ids
    (``ShardedEmbeddingStore.score_ids``), not the kernel's own claims.
    Duplicate returned ids count once.
    """
    got_ids = np.asarray(got_ids)
    oracle_ids = np.asarray(oracle_ids)
    hits = 0
    for qi in range(oracle_ids.shape[0]):
        o = set(oracle_ids[qi].tolist())
        seen = set()
        for j, g in enumerate(got_ids[qi].tolist()):
            if g in seen:                # duplicates can't double-count
                continue
            seen.add(g)
            if g in o:
                hits += 1
            elif got_vals is not None and oracle_vals is not None:
                kth = float(oracle_vals[qi][-1])
                if float(got_vals[qi][j]) >= kth - rtol * max(1.0, abs(kth)):
                    hits += 1
    return hits / oracle_ids.size
