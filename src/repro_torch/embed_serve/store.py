"""Device-sharded embedding store: trained tables -> servable shards.

Counterpart of the JAX package's ``embed_serve/store.py``. Tables are
row-partitioned with the trainer's ``NodePartition`` rule at
``subparts=1`` (node n -> shard n // rows, local row n % rows), one shard
per entry of an explicit device list (a device may repeat), so a trainer
checkpoint loads without re-indexing and global ids are ``local + s*rows``
as in the JAX store. Queries fan out to every shard and the per-shard
top-k lists meet in ``topk.merge_topk``.

Routes (``impl``) take the JAX store's names. ``pallas`` is the CUDA scan,
``rowwise`` the CUDA kernel ``topk_rowwise``, ``quant_pallas`` the int8 scan
with the CUDA gather and an exact rescore; on a CPU shard each of them
runs its plain version. ``xla`` and ``quant_xla`` run the plain versions
on the shard's own device, because the caller asked for them by name.
``auto`` and ``quant`` pick the kernel routes on a CUDA shard and the plain
ones on a CPU shard. Shards' rows are not padded: the kernels mask their
ragged edge themselves. On a card, the copies the scan kernels read (the
exact shard and the int8 one) have their columns padded with zeros to a
multiple of 8 once, at load (``topk.pad_columns``), when the width is not
one already; the rescore and the plain routes read the real columns.

``quant="int8"`` also builds a per-row int8 copy of every shard for the
two-tier scan. ``enable_hot_tier(budget, counts=...)`` splits every shard
into an exact hot tier (the budget's hottest rows) and a compacted int8
cold remainder; ``impl="tiered"`` scans the hot rows exactly (the CUDA
scan) and the cold rows through the two-tier scan, and merges the two
lists under the one tie rule.

Degraded mode: ``topk(shard_timeout_s=...)`` runs each shard's scan as a
pool task behind ``fault_point("serve.shard", (s,))``; shards that miss
the deadline or crash are left out of the merge, and ``return_meta=True``
tags the answer with a :class:`TopKMeta`. On a card each task runs on its
own CUDA stream, so a fast shard's wait covers only its own scan and not
a slow shard's work queued before it. The answer over the surviving
shards stays exact (``oracle_topk(exclude_shards=...)``).
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _fut_wait

import numpy as np
import torch

from repro_torch.core.partition import NodePartition
from repro_torch.device import resolve_device, shard_devices
from repro_torch.embed_serve import quant as qz
from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import ref as kref
from repro_torch.obs import counter_add, gauge_set
from repro_torch.runtime import fault_point
from repro_torch.train.checkpoint import load_arrays, numpy_to_tensor

QUERY_IMPLS = ("auto", "pallas", "rowwise", "xla",
               "quant", "quant_pallas", "quant_xla", "tiered")
QUANT_TIERS = (None, "int8")

_UNSET = object()   # "use the store's shard_timeout_s" vs an explicit None


def _scan_layout(t: torch.Tensor) -> torch.Tensor:
    """A table as the scan kernels read it: on a card, its columns padded
    to a multiple of 8 (``topk.pad_columns``); on the CPU as it is."""
    return tk.pad_columns(t) if t.device.type == "cuda" else t


@dataclasses.dataclass(frozen=True)
class TopKMeta:
    """Per-query-batch serving outcome (``topk(return_meta=True)``)."""

    degraded: bool = False
    failed_shards: tuple = ()
    timeout_s: float | None = None


@dataclasses.dataclass(frozen=True)
class _HotShard:
    """One shard's hot/cold physical split (``enable_hot_tier``): the hot
    rows exactly (served dtype), the compacted cold rows (the rescore
    source) and their int8 scan copy, and each tier's compact-row ->
    global-id map, all on the shard's device. On a card the hot rows and
    the int8 copy are in the scan layout (:func:`_scan_layout`)."""

    hot_shard: torch.Tensor
    hot_map: torch.Tensor
    cold_shard: torch.Tensor
    cold_q8: torch.Tensor
    cold_sc: torch.Tensor
    cold_map: torch.Tensor

    @property
    def hot_valid(self) -> int:
        return self.hot_shard.shape[0]

    @property
    def cold_valid(self) -> int:
        return self.cold_shard.shape[0]


class ShardedEmbeddingStore:
    """Row-sharded embedding table + exact top-k retrieval over it."""

    def __init__(self, shards, part: NodePartition, valid, devices, *,
                 host_table, step: int = -1, qshards=None, quant=None,
                 overfetch: float = qz.DEFAULT_OVERFETCH,
                 shard_timeout_s: float | None = None):
        self.shards = shards                  # per-device (valid_s, d) tensors
        self.scan_shards = [_scan_layout(sh) for sh in shards]
        self.part = part
        self.valid = tuple(valid)             # real rows per shard
        self.devices = tuple(devices)
        self.host_table = host_table          # (num_nodes, d) CPU tensor,
        self.step = step                      # or None (keep_host_table off)
        self.qshards = qshards                # per-device (int8, scales) or
        self.quant = quant                    # None (no quantized tier)
        self.overfetch = overfetch            # default tier-one margin
        self.shard_timeout_s = shard_timeout_s  # None = never degrade
        self._pool = None                     # lazy shard-scan executor
        self._busy = {}                       # shard -> its running scans
        self._stale = set()                   # scans a call stopped awaiting
        self._streams = {}                    # CUDA shard -> its stream
        self._pool_mu = threading.Lock()
        self.hot_tiers = None                 # per-shard _HotShard or None
        self._hot_mask = None                 # (num_nodes,) bool, host
        self._hot_stats = {"queries": 0, "returned": 0, "returned_hot": 0}

    # ------------------------------------------------------------- loading
    @classmethod
    def from_array(cls, table, *, devices=None,
                   normalize: bool = False, keep_host_table: bool = True,
                   quant: str | None = None,
                   overfetch: float = qz.DEFAULT_OVERFETCH,
                   shard_timeout_s: float | None = None,
                   step: int = -1) -> "ShardedEmbeddingStore":
        """Shard a (num_nodes, d) table (tensor, or numpy array) across
        ``devices``, one shard each (default: one a visible card, as the
        JAX store takes ``jax.devices()``); a CUDA device must exist if
        named.

        The table keeps its dtype. ``normalize`` rescales rows to unit
        norm (cosine retrieval through the same MIPS scan).
        keep_host_table=False keeps no CPU copy (serving never reads it;
        only ``oracle_topk`` and ``score_ids`` do). quant="int8" builds the
        int8 copies on each shard's device. ``shard_timeout_s`` is the
        default per-shard deadline of degraded-mode queries (None = wait
        forever).
        """
        devices = [resolve_device(d) for d in (
            shard_devices() if devices is None else devices)]
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
                q8, sc = qz.quantize_rows(sh)
                qshards.append((_scan_layout(q8), sc))
        host = table.cpu() if keep_host_table else None
        return cls(shards, part, valid, devices, host_table=host, step=step,
                   qshards=qshards if quant else None, quant=quant,
                   overfetch=overfetch, shard_timeout_s=shard_timeout_s)

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
        if impl == "tiered":
            # the hot and cold tiers carry their own global-id maps
            return self._scan_shard_tiered(s, q, k, ov)
        shard, valid = self.shards[s], self.valid[s]
        if impl == "pallas":
            v, i = tk.topk_mips(self.scan_shards[s], q, k, valid)
        elif impl == "rowwise":
            v, i = tk.topk_mips_rowwise(self.scan_shards[s], q, k, valid)
        elif impl == "xla":
            v, i = tk.topk_mips_plain(shard, q, k, valid)
        else:
            q8, sc = self.qshards[s]
            v, i = qz.topk_mips_quant_rescored(
                shard, q8, sc, q, k, overfetch=ov, valid=valid,
                plain=impl == "quant_xla")
        rows = self.part.padded_rows_per_shard
        gi = torch.where(i == tk.IDX_SENTINEL, i, i + s * rows)
        return v, gi

    # ------------------------------------------------------------ hot tier
    def enable_hot_tier(self, budget: int, *, ids=None, counts=None) -> int:
        """Split every shard into an exact hot tier + compacted int8 cold
        remainder for ``impl="tiered"`` queries.

        The hot set is the ``budget`` hottest rows by ``counts`` (observed
        access counts; rows never accessed are never hot; ties break toward
        the smaller id, the JAX store's lexsort rule), or an explicit
        ``ids`` list (deduplicated, out-of-range ids dropped, then cut to
        the budget). Cold rows get a fresh compacted int8 copy. Returns the
        realized hot row count.
        """
        n = self.num_nodes
        if ids is None:
            if counts is None:
                raise ValueError("enable_hot_tier needs ids or counts")
            counts = np.asarray(counts, np.float64)
            if counts.shape != (n,):
                raise ValueError(f"counts shape {counts.shape} != ({n},)")
            order = np.lexsort((np.arange(n), -counts))
            order = order[counts[order] > 0]
            ids = np.sort(order[: budget])
        else:
            ids = np.unique(np.asarray(ids, np.int64))
            ids = ids[(ids >= 0) & (ids < n)][: budget]
        mask = np.zeros(n, bool)
        mask[ids] = True
        rows = self.part.padded_rows_per_shard
        tiers = []
        for s, dev in enumerate(self.devices):
            loc_mask = mask[s * rows: s * rows + self.valid[s]]

            def _compact(loc):
                tbl = self.shards[s].index_select(
                    0, torch.as_tensor(loc, device=dev)).contiguous()
                gmap = torch.as_tensor((s * rows + loc).astype(np.int32),
                                       device=dev)
                return tbl, gmap

            hot_tbl, hot_map = _compact(np.flatnonzero(loc_mask))
            cold_tbl, cold_map = _compact(np.flatnonzero(~loc_mask))
            q8, sc = qz.quantize_rows(cold_tbl)
            tiers.append(_HotShard(hot_shard=_scan_layout(hot_tbl),
                                   hot_map=hot_map, cold_shard=cold_tbl,
                                   cold_q8=_scan_layout(q8),
                                   cold_sc=sc, cold_map=cold_map))
        self.hot_tiers = tiers
        self._hot_mask = mask
        self._hot_stats = {"queries": 0, "returned": 0, "returned_hot": 0}
        gauge_set("serve.hot_tier.rows", int(ids.size))
        return int(ids.size)

    def hot_tier_stats(self) -> dict:
        """Serving-side cache telemetry: realized hot rows, the fraction of
        returned results served from the exact tier, and the modeled scan
        bytes per query of the tiered vs full-quant layouts."""
        st = dict(self._hot_stats)
        d = self.dim
        item = self.shards[0].element_size()
        n_cold = sum(t.cold_valid for t in (self.hot_tiers or []))
        n_hot = sum(t.hot_valid for t in (self.hot_tiers or []))
        return {
            **st,
            "hot_rows": n_hot,
            "cold_rows": n_cold,
            "returned_hot_frac": st["returned_hot"] / max(st["returned"], 1),
            # per-query scan bytes: exact hot rows + int8 cold (value + f32
            # scale) vs the untiered int8 scan of every row
            "scan_bytes_tiered": n_hot * d * item + n_cold * (d + 4),
            "scan_bytes_quant": (n_hot + n_cold) * (d + 4),
        }

    @staticmethod
    def _to_global(v, i, gmap, k: int):
        """Compact-row ids -> global ids through ``gmap``, the (Q, kk)
        lists padded with sentinels to k slots."""
        gi = torch.where(i == tk.IDX_SENTINEL, i,
                         gmap[i.clamp(max=gmap.shape[0] - 1).long()])
        pad = k - v.shape[1]
        if pad > 0:
            v = torch.cat([v, v.new_full((v.shape[0], pad), tk.NEG_INF)], 1)
            gi = torch.cat([gi, gi.new_full((gi.shape[0], pad),
                                            tk.IDX_SENTINEL)], 1)
        return v, gi

    def _scan_shard_tiered(self, s: int, q, k: int, ov: float):
        """Shard s under the two-tier layout: the exact scan of the hot
        rows and the two-tier scan of the cold rows, each at most as deep
        as its rows, merged under the global tie rule."""
        ht = self.hot_tiers[s]
        outs = []
        if ht.hot_valid > 0:
            hv, hi = tk.topk_mips(ht.hot_shard, q, min(k, ht.hot_valid))
            outs.append(self._to_global(hv, hi, ht.hot_map, k))
        if ht.cold_valid > 0:
            cv, ci = qz.topk_mips_quant_rescored(
                ht.cold_shard, ht.cold_q8, ht.cold_sc, q,
                min(k, ht.cold_valid), overfetch=ov)
            outs.append(self._to_global(cv, ci, ht.cold_map, k))
        if not outs:
            raise RuntimeError(f"shard {s} has no valid rows")
        if len(outs) == 1:
            return outs[0]
        return tk.merge_topk(torch.stack([v for v, _ in outs]),
                             torch.stack([i for _, i in outs]), k)

    def _note_tiered_result(self, gi) -> None:
        real = gi[gi != tk.IDX_SENTINEL]
        n_hot = int(self._hot_mask[real].sum())
        self._hot_stats["queries"] += int(gi.shape[0])
        self._hot_stats["returned"] += int(real.size)
        self._hot_stats["returned_hot"] += n_hot
        counter_add("serve.hot_tier.hits", n_hot)
        counter_add("serve.hot_tier.misses", int(real.size) - n_hot)

    def _resolve_impl(self, impl: str) -> str:
        if impl not in QUERY_IMPLS:
            raise ValueError(f"unknown impl {impl!r}; one of {QUERY_IMPLS}")
        on_card = self.devices[0].type == "cuda"
        if impl == "auto":
            impl = "pallas" if on_card else "xla"
        elif impl == "quant":
            impl = "quant_pallas" if on_card else "quant_xla"
        if impl.startswith("quant") and self.qshards is None:
            raise RuntimeError("store has no quantized tier; build it with "
                               "quant='int8'")
        if impl == "tiered" and self.hot_tiers is None:
            raise RuntimeError("store has no hot tier; call "
                               "enable_hot_tier(budget, counts=...) first")
        return impl

    def _scan_pool(self) -> ThreadPoolExecutor:
        with self._pool_mu:
            if self._pool is None:
                # two workers a shard: one may hold a scan past its
                # deadline while a fresh one runs (see topk)
                self._pool = ThreadPoolExecutor(
                    max_workers=max(1, 2 * len(self.shards)),
                    thread_name_prefix="shard-scan")
                # made here, before any deadline runs: a process's first
                # stream sets up the device's stream pool, a cost that
                # must not fall inside a shard's deadline
                self._streams = {s: torch.cuda.Stream(dev)
                                 for s, dev in enumerate(self.devices)
                                 if dev.type == "cuda"}
            return self._pool

    def _scan_task(self, s: int, q, ready, k: int, impl: str, ov: float):
        """Shard s's scan as a pool task, its result on the host. On a
        card it runs on the shard's own stream, after ``ready`` (the
        queries' copy to the card)."""
        fault_point("serve.shard", (s,))
        if ready is None:
            return self._scan_shard(s, q, k, impl, ov)
        stream = self._streams[s]
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            q.record_stream(stream)   # the allocator keeps q for this stream
            v, i = self._scan_shard(s, q, k, impl, ov)
            return v.cpu(), i.cpu()

    def _merge(self, staged, k: int):
        if len(staged) == 1:
            gv, gi = staged[0]
        else:
            gv, gi = tk.merge_topk(torch.stack([v for v, _ in staged]),
                                   torch.stack([i for _, i in staged]), k)
        return gv.numpy(), gi.numpy()

    def topk(self, queries, k: int, *, impl: str = "auto",
             overfetch: float | None = None, shard_timeout_s=_UNSET,
             return_meta: bool = False):
        """Exact MIPS top-k over all shards.

        queries: (Q, d). Returns numpy ((Q, k) f32 scores, (Q, k) i32
        global node ids), k clamped to num_nodes. ``impl`` is one of
        ``QUERY_IMPLS`` (see the module's note); ``overfetch`` overrides
        the store's tier-one margin for the quant routes.

        shard_timeout_s (unset: the store's ``shard_timeout_s``; an
        explicit None = wait forever, e.g. for warm-up) runs each shard's
        scan as its own task and merges only the shards that answered in
        time: exact over the survivors, degraded over the failed shards'
        rows. All shards failing raises. return_meta=True appends a
        :class:`TopKMeta` to the return tuple.
        """
        impl = self._resolve_impl(impl)
        ov = self.overfetch if overfetch is None else overfetch
        k = min(k, self.num_nodes)
        q = torch.as_tensor(queries).float()
        timeout = (self.shard_timeout_s if shard_timeout_s is _UNSET
                   else shard_timeout_s)
        live = [s for s in range(len(self.shards)) if self.valid[s] > 0]
        on_dev = {}
        for s in live:
            dev = self.devices[s]
            if dev not in on_dev:
                qd = q.to(dev).contiguous()
                ready = None
                if dev.type == "cuda" and timeout is not None:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(dev))
                on_dev[dev] = (qd, ready)

        if timeout is None:
            # every shard is launched before any result is read back, so
            # shards on different cards scan at the same time
            launched = [self._scan_shard(s, on_dev[self.devices[s]][0], k,
                                         impl, ov) for s in live]
            gv, gi = self._merge([(v.cpu(), i.cpu()) for v, i in launched], k)
            if impl == "tiered":
                self._note_tiered_result(gi)
            return (gv, gi, TopKMeta()) if return_meta else (gv, gi)

        pool = self._scan_pool()
        futs = {}
        with self._pool_mu:
            self._stale = {f for f in self._stale if not f.done()}
            for s in live:
                busy = self._busy[s] = [f for f in self._busy.get(s, ())
                                        if not f.done()]
                # every call gives every shard a fresh scan, except a shard
                # still running one that an earlier call stopped waiting
                # for and another besides: it is out of this answer. A
                # stuck shard so holds two workers at most (the pool has
                # two a shard), and the others always find theirs.
                if len(busy) >= 2 and not self._stale.isdisjoint(busy):
                    continue
                futs[s] = pool.submit(self._scan_task, s,
                                      *on_dev[self.devices[s]], k, impl, ov)
                busy.append(futs[s])
        # wait for ALL to complete (a crashed shard completes immediately
        # with its exception; healthy shards keep their full deadline)
        _fut_wait(list(futs.values()), timeout=timeout)
        with self._pool_mu:
            self._stale.update(f for f in futs.values() if not f.done())
        staged, failed = [], []
        for s in live:
            f = futs.get(s)
            if f is not None and f.done() and f.exception() is None:
                staged.append(f.result())
            else:
                # timed out (its result, if it ever lands, is discarded),
                # crashed or still stuck: the shard is out of this answer
                failed.append(s)
        if not staged:
            raise RuntimeError(
                f"all {len(live)} shard scans failed or timed out "
                f"({timeout}s); shards: {failed}")
        gv, gi = self._merge(staged, k)
        if impl == "tiered":
            self._note_tiered_result(gi)
        if return_meta:
            return gv, gi, TopKMeta(degraded=bool(failed),
                                    failed_shards=tuple(sorted(failed)),
                                    timeout_s=timeout)
        return gv, gi

    def _host_f32(self) -> np.ndarray:
        if self.host_table is None:
            raise RuntimeError("store was built with keep_host_table=False; "
                               "the oracle needs the host copy")
        return self.host_table.float().numpy()

    def oracle_topk(self, queries, k: int, *, exclude_shards=()):
        """Numpy ground truth over the full (unsharded) table.

        ``exclude_shards`` drops those shards' rows first: the surviving-
        shards oracle a degraded response must match exactly. The id remap
        is monotone, so the smaller-index tie rule is preserved."""
        host = self._host_f32()
        queries = np.asarray(queries)
        if not exclude_shards:
            return kref.topk_mips_ref(host, queries, min(k, self.num_nodes))
        rows = self.part.padded_rows_per_shard
        keep = np.ones(self.num_nodes, dtype=bool)
        for s in exclude_shards:
            keep[s * rows: min((s + 1) * rows, self.num_nodes)] = False
        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            raise ValueError("exclude_shards leaves no rows to rank")
        v, i = kref.topk_mips_ref(host[idx], queries, min(k, idx.size))
        return v, idx[i].astype(i.dtype)

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
