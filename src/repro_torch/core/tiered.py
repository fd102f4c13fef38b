"""Tiered embedding tables: a host-RAM master and a fixed-budget device
cache of hot rows.

The port of the JAX package's ``core/tiered.py``. A table far larger than
one card's memory trains through a small cache of hot (hub) rows, while
the full table lives in host RAM or, with a spill file, on disk: the
power-law skew of walk samples lets the cache absorb most of the row
traffic (GraphVite's CPU–GPU hybrid and PyTorch-BigGraph's partition swap
are the same trade).

* :class:`TieredTable` — one logical (rows, d) table split into a host
  **master** holding every row (a numpy array, or a ``np.memmap`` for the
  disk tier; bf16 is held as its 16-bit words, viewed as
  ``torch.bfloat16``) and a fixed-budget device **cache** of hot rows,
  with ``slot_of: row id -> cache slot`` (−1 = cold). A frequency or LRU
  policy, fed by each episode's access counts, decides residency at
  episode boundaries: evicted rows write back to the master, promoted rows
  are copied up. Hit/miss/eviction counters and byte totals feed the
  ``repro_torch.obs`` registry.

* :class:`TieredEmbeddingTrainer` — the hybrid trainer (one shard) whose
  tables are tiered. Each block trains on a **compact working-set table**:
  its unique rows, hot ones gathered from the cache and cold ones copied
  up as one staged miss block (through pinned memory); the unchanged
  minibatch loop of ``kernels.ops.sgns_step`` updates the compact tables
  in place; then hot rows scatter back to their cache slots and cold rows
  write back to the master (one device-to-host copy a table a block).
  The compact remap is **monotone** (rows keep their relative order), so
  every duplicate-combine path sees the same sort and equality structure,
  and training is bitwise the resident trainer's for ANY cache budget.

The host prep that needs no residency — each block's unique rows and
remap, the negative draws, the access counts and the copy of the block
indices — is :meth:`TieredEmbeddingTrainer.stage_blocks`, which the
episode pipeline runs one stage ahead on a worker: it promotes nothing and
reads no master row. Promotion runs at the head of ``train_episode``.

The working sets keep the JAX package's geometric caps (``128·2^k`` rows):
there they bound XLA recompiles; here they only keep each plan's shapes
the reference's. The TPU VMEM models that the JAX trainer consults for
the staging block have no counterpart; the ``cache.staging_rows`` gauge
(Wv + Wc) stays.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.hybrid import (_DTYPES, HybridConfig,
                                     HybridEmbeddingTrainer,
                                     init_vertex_rows)
from repro_torch.core.partition import EpisodeBlocks
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import counter_add, gauge_set, span
from repro_torch.train.checkpoint import numpy_to_tensor

CACHE_POLICIES = ("freq", "lru")

# working-set caps round up geometrically (128·2^k), as the JAX trainer's
_CAP_MULTIPLE = 128

# the master's numpy words for each table dtype: bf16 as its raw 16 bits
_MASTER_WORDS = {torch.float32: np.float32, torch.bfloat16: np.uint16}


def _cap_for(n: int) -> int:
    cap = _CAP_MULTIPLE
    while cap < n:
        cap *= 2
    return cap


def _ids(ids: np.ndarray) -> torch.Tensor:
    """Host row ids as a CPU index tensor."""
    return torch.from_numpy(np.ascontiguousarray(ids, np.int64))


def _table_dtype(dtype) -> torch.dtype:
    """A torch table dtype from a torch dtype, a name or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        got = dtype
    else:
        got = _DTYPES.get(dtype if isinstance(dtype, str)
                          else np.dtype(dtype).name)
    if got not in _MASTER_WORDS:
        raise ValueError(f"unsupported table dtype {dtype!r}; expected one "
                         f"of {sorted(_DTYPES)}")
    return got


@dataclasses.dataclass
class CacheStats:
    """Traffic and byte accounting for one tiered table.

    hits/misses are position-level (traffic-weighted) row accesses, the
    skew-sensitive headline rate; row_hits/row_misses count unique-per-block
    row gathers, which is what moves bytes. hbm_bytes_moved is cache-tier
    traffic (hot gather + scatter-back), host_bytes_moved master-tier
    traffic (miss copy-up + write-back + promotion/eviction).
    """

    hits: int = 0
    misses: int = 0
    row_hits: int = 0
    row_misses: int = 0
    evictions: int = 0
    promotions: int = 0
    hbm_bytes_moved: int = 0
    host_bytes_moved: int = 0

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


@dataclasses.dataclass(frozen=True)
class TierPlan:
    """The gather/scatter plan of one block's unique rows against one tiered
    table, the device arrays padded to the cap ``W``.

    For compact position p (the block's p-th unique row, ascending row id —
    the monotone remap): ``hot[p]`` selects between ``cache[slot[p]]`` and
    ``staged_cold[rank[p]]``; ``wslot[p]`` is the cache scatter-back target
    (the scratch row for cold and pad positions); ``coldpos[:C]`` lists
    the compact positions whose final rows write back to the master.
    """

    uids: np.ndarray          # (U,) unique row ids, sorted
    cold_ids: np.ndarray      # (C,) the uids not cache-resident
    hot: torch.Tensor         # (W,) bool
    slot: torch.Tensor        # (W,) cache slot (0 for cold/pad)
    rank: torch.Tensor        # (W,) rank into the staged miss block
    wslot: torch.Tensor       # (W,) scatter-back slot (scratch if cold)
    coldpos: torch.Tensor     # (W,) compact positions of cold rows
    n_hot_traffic: int        # position-level accesses that hit
    n_traffic: int            # position-level accesses in all


class TieredTable:
    """Host master + fixed-budget device cache for one (rows, d) table.

    The cache carries one extra scratch row (index ``budget``): the block
    step scatters cold and pad working-set rows there, so its write-back is
    one dense scatter with no masking. ``spill_path`` backs the master with
    a ``np.memmap`` instead of RAM, the disk tier for tables beyond host
    memory; its file holds the table's raw words, the JAX package's bytes.
    ``device``: ``"cuda"`` by default (host copies through pinned memory),
    ``"cpu"`` for the plain versions.
    """

    def __init__(self, rows: int, dim: int, dtype, budget: int, *,
                 policy: str = "freq", name: str = "table",
                 spill_path: str | None = None, device="cuda"):
        if policy not in CACHE_POLICIES:
            raise ValueError(
                f"unknown cache policy {policy!r}; expected {CACHE_POLICIES}")
        self.device = resolve_device(device)
        self.rows = int(rows)
        self.dim = int(dim)
        self.dtype = _table_dtype(dtype)
        self.budget = int(min(max(budget, 0), rows))
        self.policy = policy
        self.name = name
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        words = _MASTER_WORDS[self.dtype]
        if spill_path is not None:
            self.master = np.memmap(spill_path, dtype=words, mode="w+",
                                    shape=(self.rows, self.dim))
        else:
            self.master = np.zeros((self.rows, self.dim), words)
        # the master as a tensor of the table dtype, sharing its memory
        self._master = torch.from_numpy(self.master).view(self.dtype)
        self._pinned = self.device.type == "cuda"
        self.cache = torch.zeros((self.budget + 1, self.dim),
                                 dtype=self.dtype, device=self.device)
        self.slot_of = np.full(self.rows, -1, np.int64)
        self.row_of = np.full(self.budget, -1, np.int64)
        self.counts = np.zeros(self.rows, np.float64)   # freq policy state
        self.last_used = np.full(self.rows, -1, np.int64)  # lru policy state
        self._clock = 0
        self.stats = CacheStats()

    # -------------------------------------------------------- host copies
    def _host(self, shape) -> torch.Tensor:
        """A host buffer of rows, pinned on the card's side."""
        return torch.empty(shape, dtype=self.dtype, pin_memory=self._pinned)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        """Host ids as an index tensor on the device."""
        return _ids(idx).to(self.device)

    def _read_master(self, ids: np.ndarray, n_rows: int) -> torch.Tensor:
        """Master rows ``ids`` on the device, in an (n_rows, d) buffer (rows
        past ``len(ids)`` unset): gathered into pinned memory and copied up
        on the current stream."""
        host = self._host((len(ids), self.dim))
        torch.index_select(self._master, 0, _ids(ids), out=host)
        out = torch.empty((n_rows, self.dim), dtype=self.dtype,
                          device=self.device)
        out[: len(ids)].copy_(host, non_blocking=self._pinned)
        return out

    def _write_master(self, ids: np.ndarray, rows: torch.Tensor) -> None:
        """``master[ids] = rows`` (device rows; one synchronous copy down)."""
        host = self._host(tuple(rows.shape))
        host.copy_(rows)
        self._master.index_copy_(0, _ids(ids), host)

    # ------------------------------------------------------------- policy
    def note_access(self, ids: np.ndarray, weights: np.ndarray) -> None:
        """Fold one episode's observed accesses into the policy state."""
        ids = np.asarray(ids, np.int64)
        np.add.at(self.counts, ids, np.asarray(weights, np.float64))
        self.last_used[ids] = self._clock
        self._clock += 1

    def desired_hot(self) -> np.ndarray:
        """The rows the policy wants resident, sorted ascending (row id is
        the deterministic tie-break). Only rows that have been accessed are
        candidates: an undersubscribed cache stays partial."""
        if self.budget == 0:
            return np.empty(0, np.int64)
        if self.policy == "freq":
            score, seen = self.counts, self.counts > 0
        else:
            score = self.last_used.astype(np.float64)
            seen = self.last_used >= 0
        order = np.lexsort((np.arange(self.rows), -score))
        order = order[seen[order]]
        return np.sort(order[: self.budget])

    def promote(self) -> tuple[int, int]:
        """Reconcile residency with :meth:`desired_hot`: evicted rows write
        back to the master, promoted rows are copied up into the freed
        slots (ascending row id into ascending free slots). Returns
        (n_promoted, n_evicted)."""
        desired = self.desired_hot()
        want = np.zeros(self.rows, bool)
        want[desired] = True
        cur = self.row_of[self.row_of >= 0]
        evict_ids = np.sort(cur[~want[cur]])
        new_ids = desired[self.slot_of[desired] < 0]
        row_bytes = self.dim * self.itemsize
        if evict_ids.size:
            slots = self.slot_of[evict_ids]
            self._write_master(evict_ids, self.cache[self._index(slots)])
            self.slot_of[evict_ids] = -1
            self.row_of[slots] = -1
        if new_ids.size:
            free = np.flatnonzero(self.row_of < 0)[: new_ids.size]
            self.cache.index_copy_(0, self._index(free),
                                   self._read_master(new_ids, new_ids.size))
            self.slot_of[new_ids] = free
            self.row_of[free] = new_ids
        self.stats.evictions += int(evict_ids.size)
        self.stats.promotions += int(new_ids.size)
        self.stats.host_bytes_moved += (evict_ids.size
                                        + new_ids.size) * row_bytes
        counter_add(f"cache.{self.name}.evictions", int(evict_ids.size))
        counter_add(f"cache.{self.name}.promotions", int(new_ids.size))
        gauge_set(f"cache.{self.name}.resident_rows",
                  int((self.row_of >= 0).sum()))
        return int(new_ids.size), int(evict_ids.size)

    # ------------------------------------------------------------ gathers
    def plan(self, uids: np.ndarray, cap: int,
             traffic_ids: np.ndarray) -> TierPlan:
        """The gather/scatter plan of a block's unique rows (sorted
        ``uids``) padded to ``cap``, and the hit/miss accounting of its
        position-level accesses ``traffic_ids`` (with multiplicity)."""
        U = uids.size
        slots = self.slot_of[uids]
        is_hot = slots >= 0
        cold_ids = uids[~is_hot]
        rank = np.cumsum(~is_hot) - 1
        pad = cap - U
        packed = np.zeros((5, cap), np.int64)
        packed[0, :U] = is_hot
        packed[1, :U] = np.where(is_hot, slots, 0)
        packed[2, :U] = np.where(is_hot, 0, rank)
        packed[3] = np.pad(np.where(is_hot, slots, self.budget), (0, pad),
                           constant_values=self.budget)
        cp = np.flatnonzero(~is_hot)
        packed[4, : cp.size] = cp
        # one copy up for the five index rows
        dev = torch.from_numpy(packed)
        if self._pinned:
            dev = dev.pin_memory()
        dev = dev.to(self.device, non_blocking=self._pinned)
        n_hot_traffic = int((self.slot_of[traffic_ids] >= 0).sum())
        n_traffic = int(traffic_ids.size)
        row_bytes = self.dim * self.itemsize
        n_hot_rows = int(is_hot.sum())
        self.stats.hits += n_hot_traffic
        self.stats.misses += n_traffic - n_hot_traffic
        self.stats.row_hits += n_hot_rows
        self.stats.row_misses += int(cold_ids.size)
        # each unique row moves twice (gather + write-back) on its tier
        self.stats.hbm_bytes_moved += 2 * n_hot_rows * row_bytes
        self.stats.host_bytes_moved += 2 * int(cold_ids.size) * row_bytes
        counter_add(f"cache.{self.name}.hits", n_hot_traffic)
        counter_add(f"cache.{self.name}.misses", n_traffic - n_hot_traffic)
        return TierPlan(
            uids=uids, cold_ids=cold_ids, hot=dev[0].bool(), slot=dev[1],
            rank=dev[2], wslot=dev[3], coldpos=dev[4],
            n_hot_traffic=n_hot_traffic, n_traffic=n_traffic)

    def stage_misses(self, plan: TierPlan, cap: int) -> torch.Tensor:
        """The plan's miss set on the device, one batched copy up through
        pinned memory, in a (cap, d) block (rows past the misses unset)."""
        return self._read_master(plan.cold_ids, cap)

    def write_back(self, plan: TierPlan, cold_out: torch.Tensor) -> None:
        """Master update for a trained block's miss set (its first C rows;
        the cache side was updated in place by the block's scatter)."""
        C = plan.cold_ids.size
        if C:
            self._write_master(plan.cold_ids, cold_out[:C])

    # ------------------------------------------------------------- export
    def flush(self) -> None:
        """Write every cache-resident row back to the master (residency and
        policy state untouched), so the master is a complete snapshot."""
        slots = np.flatnonzero(self.row_of >= 0)
        if slots.size:
            self._write_master(self.row_of[slots],
                               self.cache[self._index(slots)])

    def set_master(self, table) -> None:
        """Install a whole (rows, d) table (the resume path; a tensor, or a
        numpy array of f32 or bf16 words) and drop all cache residency —
        policy state survives, so promotion resumes from the access
        history."""
        if not isinstance(table, torch.Tensor):
            table = numpy_to_tensor(np.asarray(table))
        self._master.copy_(table.to(self.dtype))
        self.slot_of[:] = -1
        self.row_of[:] = -1
        self.cache.zero_()

    def snapshot(self) -> torch.Tensor:
        """The whole table as a CPU tensor (a copy), cache rows flushed."""
        self.flush()
        return self._master.clone()


# ------------------------------------------------------------------ trainer
@dataclasses.dataclass(frozen=True)
class BlockPrep:
    """Residency-independent prep of one (round, sub-part) block, done at
    stage time: the monotone compact remap, the negative draws and the
    unique and traffic id sets of each table."""

    v_uids: np.ndarray        # unique global vertex rows (sorted)
    c_uids: np.ndarray        # unique global ctx rows incl. negatives (sorted)
    v_traffic: np.ndarray     # position-level vertex accesses (real samples)
    c_traffic: np.ndarray     # position-level ctx accesses (real + negatives)
    idx_v: torch.Tensor       # (nmb, mb) compact vertex rows, staged
    idx_c: torch.Tensor       # (nmb, mb) compact context rows, staged
    negs: torch.Tensor        # (nmb, S) compact negative rows, staged
    mask: torch.Tensor        # (nmb, mb) in the table dtype, staged
    cnt: int                  # valid samples in the block
    Wv: int                   # working-set caps (geometric, 128·2^k)
    Wc: int
    nmb: int


@dataclasses.dataclass(frozen=True)
class StagedTieredEpisode:
    """stage_blocks output: every block's prep and the episode's access
    counts (what promotion will consume), ready for train_episode.
    ``ready`` is the side stream's event after the copy (None on the
    CPU)."""

    blocks: tuple            # BlockPrep, schedule order
    v_ids: np.ndarray        # episode access counts, vertex table
    v_counts: np.ndarray
    c_ids: np.ndarray        # episode access counts, ctx table
    c_counts: np.ndarray
    num_samples: int
    dropped: int = 0
    ready: object = None


class TieredEmbeddingTrainer(HybridEmbeddingTrainer):
    """Hybrid trainer whose tables are tiered (host master + device cache).

    For one-shard meshes: the resident trainer's partition, negative pool
    and draws, and its surface (stage_blocks / train_episode / embeddings /
    set_embeddings), bitwise its training for any cache budget.
    Multi-shard tiering (ring rotation over partial shards) is not built,
    in the JAX package either; ``dims`` other than (1, 1) raise.

    hbm_rows: cache budget in rows, per table (the vertex and context
    caches are sized apart, with the same budget). policy: "freq" promotes
    by cumulative access count, "lru" by the most recent episode's touch;
    both break ties toward the smaller row id. spill_dir: back the masters
    with ``vertex.master`` and ``context.master`` memmap files there.
    """

    def __init__(self, num_nodes: int, cfg: HybridConfig,
                 degrees: np.ndarray | None = None, *, hbm_rows: int,
                 policy: str = "freq", spill_dir: str | None = None,
                 dims=(1, 1), device="cuda"):
        dims = tuple(int(n) for n in dims)
        if int(np.prod(dims)) != 1:
            raise ValueError(
                "TieredEmbeddingTrainer supports single-shard meshes; "
                f"got dims {dims} (multi-shard tiering is a follow-on)")
        super().__init__(num_nodes, cfg, degrees=degrees, dims=dims,
                         device=device)
        rows = self.part.padded_num_nodes
        paths = (None, None)
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            paths = (os.path.join(spill_dir, "vertex.master"),
                     os.path.join(spill_dir, "context.master"))
        self.hbm_rows = int(hbm_rows)
        self.vert_t, self.ctx_t = (
            TieredTable(rows, cfg.dim, self.dtype, hbm_rows, policy=policy,
                        name=name, spill_path=path, device=self.device)
            for name, path in zip(("vertex", "context"), paths))
        self._neg_cache: dict = {}

    # ---------------------------------------------------------------- setup
    def init_embeddings(self):
        """The resident trainer's init, landing in the masters."""
        self.vert_t.set_master(torch.from_numpy(
            init_vertex_rows(self.part, self.cfg)))
        self.ctx_t.set_master(torch.zeros((self.part.padded_num_nodes,
                                           self.cfg.dim)))

    def set_embeddings(self, vert, ctx) -> None:
        """Install (num_nodes, d) tables (the resume path): numpy arrays
        (f32 or bf16 words) or tensors, padded to the partition."""
        self.vert_t.set_master(self._padded(vert, "cpu"))
        self.ctx_t.set_master(self._padded(ctx, "cpu"))

    def embeddings(self) -> torch.Tensor:
        """The vertex table, unpadded, as a CPU tensor (a copy)."""
        return self.vert_t.snapshot()[: self.num_nodes]

    def context_embeddings(self) -> torch.Tensor:
        """The context table, unpadded, as a CPU tensor (a copy)."""
        return self.ctx_t.snapshot()[: self.num_nodes]

    def cache_stats(self) -> dict:
        v, c = self.vert_t.stats, self.ctx_t.stats
        hits, misses = v.hits + c.hits, v.misses + c.misses
        return {
            "hbm_rows": self.hbm_rows,
            "policy": self.vert_t.policy,
            "hit_rate": hits / max(hits + misses, 1),
            "hbm_bytes_moved": v.hbm_bytes_moved + c.hbm_bytes_moved,
            "host_bytes_moved": v.host_bytes_moved + c.host_bytes_moved,
            "vertex": v.as_dict(),
            "context": c.as_dict(),
        }

    # ---------------------------------------------------------------- train
    def _negatives(self, R: int, k: int, nmb: int, neg_draws) -> np.ndarray:
        """(R, k, nmb, S) global context rows: the resident trainer's pool
        positions (JAX's stream from ``fold_in(PRNGKey(seed), 0)``, or
        ``neg_draws``) through the pool. The stream restarts every
        episode, so its rows are kept per shape."""
        key = (R, k, nmb)
        got = None if neg_draws is not None else self._neg_cache.get(key)
        if got is None:
            pos = self._negative_positions(R, k, nmb, neg_draws).cpu().numpy()
            got = self.pool[0][pos].astype(np.int64)
            if neg_draws is None:
                self._neg_cache[key] = got
        return got

    def stage_blocks(self, eb: EpisodeBlocks, *,
                     neg_draws=None) -> StagedTieredEpisode:
        """The residency-independent prep of an episode, safe on a pipeline
        worker (it promotes nothing and reads no master row): compact
        remaps, negatives, access counts, and the copy of the block indices
        to the device (on the side stream on the card, with a ``ready``
        event). ``neg_draws`` as for the resident ``train_episode``."""
        part, cfg = self.part, self.cfg
        mb, k, bmax = cfg.minibatch, part.subparts, eb.block_cap
        if bmax % mb:
            raise ValueError(f"block capacity {bmax} is not a multiple of the "
                             f"minibatch {mb} (build the blocks with "
                             f"pad_multiple=minibatch)")
        nmb = bmax // mb
        blocks = eb.blocks[0].reshape(-1, k, bmax, 2)
        counts = eb.counts[0].reshape(-1, k)
        R = blocks.shape[0]
        negs_all = self._negatives(R, k, nmb, neg_draws)
        # every block's compact (v, c) rows and negatives, copied up at once
        idx = np.empty((R * k, 2, bmax), np.int32)
        negs_c = np.empty((R * k, nmb, cfg.negatives), np.int32)
        metas, v_acc, c_acc = [], [], []
        for r in range(R):
            for j in range(k):
                t = r * k + j
                blk = blocks[r, j].astype(np.int64)
                cnt = int(counts[r, j])
                v_glob = part.subpart_global_rows(j, blk[:, 0])
                c_glob = blk[:, 1]
                negs = negs_all[r, j]
                v_uids = np.unique(v_glob)
                c_uids = np.unique(np.concatenate([c_glob, negs.ravel()]))
                # monotone compact remap: the sorted-unique rank keeps the
                # relative order (and ties) of every index vector, so the
                # kernels' duplicate combine sees the same structure
                idx[t, 0] = np.searchsorted(v_uids, v_glob)
                idx[t, 1] = np.searchsorted(c_uids, c_glob)
                negs_c[t] = np.searchsorted(c_uids, negs)
                v_traffic = v_glob[:cnt]
                c_traffic = np.concatenate([c_glob[:cnt], negs.ravel()])
                v_acc.append(v_traffic)
                c_acc.append(c_traffic)
                metas.append((v_uids, c_uids, v_traffic, c_traffic, cnt))
        host = [torch.from_numpy(a) for a in (
            idx, negs_c, counts.reshape(-1).astype(np.int32))]
        ready = None
        if self._h2d is None:
            dev_idx, dev_negs, mask = self._stage(*host)
        else:
            with torch.cuda.stream(self._h2d):
                dev_idx, dev_negs, mask = self._stage(*(
                    t.pin_memory().to(self.device, non_blocking=True)
                    for t in host))
                ready = torch.cuda.Event()
                ready.record(self._h2d)
        preps = tuple(
            BlockPrep(v_uids=vu, c_uids=cu, v_traffic=vt, c_traffic=ct,
                      idx_v=dev_idx[t, 0].view(nmb, mb),
                      idx_c=dev_idx[t, 1].view(nmb, mb), negs=dev_negs[t],
                      mask=mask[t].view(nmb, mb), cnt=cnt,
                      Wv=_cap_for(vu.size), Wc=_cap_for(cu.size), nmb=nmb)
            for t, (vu, cu, vt, ct, cnt) in enumerate(metas))
        v_ids, v_counts = np.unique(np.concatenate(v_acc), return_counts=True)
        c_ids, c_counts = np.unique(np.concatenate(c_acc), return_counts=True)
        return StagedTieredEpisode(
            blocks=preps, v_ids=v_ids, v_counts=v_counts, c_ids=c_ids,
            c_counts=c_counts, num_samples=int(eb.counts.sum()),
            dropped=eb.dropped, ready=ready)

    def _stage(self, idx, negs, counts):
        """The staged index tensors and the blocks' masks, as the resident
        trainer builds its mask."""
        bmax = idx.shape[-1]
        mask = (torch.arange(bmax, device=idx.device)
                < counts[:, None]).to(self.dtype)
        return idx, negs, mask

    def train_episode(self, eb: EpisodeBlocks | StagedTieredEpisode, *,
                      lr: float | None = None, neg_draws=None) -> float:
        """Train one episode; returns its loss per valid sample, summed as
        the resident trainer sums it. ``neg_draws`` (with unstaged blocks
        only: the draws shape the staged remap) as for the resident
        trainer."""
        if not isinstance(eb, StagedTieredEpisode):
            eb = self.stage_blocks(eb, neg_draws=neg_draws)
        elif neg_draws is not None:
            raise ValueError("neg_draws shape the staged remap: pass them to "
                             "stage_blocks")
        cfg = self.cfg
        mb = cfg.minibatch
        lr = cfg.lr if lr is None else lr
        if eb.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(eb.ready)
            for bp in eb.blocks:
                for t in (bp.idx_v, bp.idx_c, bp.negs, bp.mask):
                    t.record_stream(stream)
        # promotion first: the access counts came a pipeline stage ahead
        # (stage_blocks), so this episode's hot set is resident before its
        # first block trains
        with span("cache_promote", "train",
                  {"vertex_rows": int(self.vert_t.budget),
                   "context_rows": int(self.ctx_t.budget)}):
            self.vert_t.note_access(eb.v_ids, eb.v_counts)
            self.ctx_t.note_access(eb.c_ids, eb.c_counts)
            self.vert_t.promote()
            self.ctx_t.promote()
        # the loss summed as the resident trainer sums it (a running f32
        # sum a block, added to the episode's block by block)
        zeros = torch.zeros(len(eb.blocks) + 1, dtype=torch.float32,
                            device=self.device)
        lacc, total = zeros[-1], 0
        for lj, bp in zip(zeros[:-1].unbind(0), eb.blocks):
            tabs = (self.vert_t, self.ctx_t)
            plans = (self.vert_t.plan(bp.v_uids, bp.Wv, bp.v_traffic),
                     self.ctx_t.plan(bp.c_uids, bp.Wc, bp.c_traffic))
            # the compact working sets: hot rows from the cache, cold rows
            # from the staged miss block
            vcomp, ccomp = comps = [
                torch.where(plan.hot[:, None], tab.cache[plan.slot],
                            tab.stage_misses(plan, cap)[plan.rank])
                for tab, plan, cap in zip(tabs, plans, (bp.Wv, bp.Wc))]
            gauge_set("cache.staging_rows", bp.Wv + bp.Wc)
            # minibatches past the block's count are all padding (mask 0):
            # their updates are zero, so they are not launched
            for i in range(-(-bp.cnt // mb)):
                ops.sgns_step(vcomp, ccomp, bp.idx_v[i], bp.idx_c[i],
                              bp.negs[i], bp.mask[i], lr, impl=cfg.impl,
                              reduction=cfg.reduction, loss_into=lj)
            lacc.add_(lj)
            for tab, plan, comp in zip(tabs, plans, comps):
                # hot rows back to their slots in place; cold and pad
                # positions land on the scratch row
                tab.cache.index_copy_(0, plan.wslot, comp)
                tab.write_back(plan, comp[plan.coldpos[: plan.cold_ids.size]])
            total += bp.cnt
        return float(lacc / max(total, 1))
