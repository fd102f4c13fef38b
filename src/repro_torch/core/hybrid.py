"""Hybrid model–data parallel embedding training (paper §III).

The port of the JAX package's ``core/hybrid.py``. Data parallelism: each
episode's edge samples are 2D-partitioned into blocks (``core.partition``)
and a rank trains only blocks whose endpoints are resident. Model
parallelism: the context table is pinned; the vertex table is split into
``k`` sub-parts and rotates through the rank rings (``core.rotation``) so
each vertex shard meets each context shard once per episode.

One process per rank (``torch.distributed``; one rank needs no process
group). Rank p holds context rows ``[p rows, (p + 1) rows)`` of the padded
table, pinned, vertex shard p split into k sub-parts, and its own negative
pool ``pool[p]``. An episode runs ``build_episode_fn``'s nested rings in its
scan order, pod, then data, then model, then sub-part, then minibatch:

    for each round (pod u, data t, model r):
        for each sub-part j:
            for each minibatch of block (u, t, r, j):
                kernels.ops.sgns_step(impl=cfg.impl)
            send sub-part j to the next rank of the model ring and receive
            the previous rank's (``core.ring``): the transfer runs while
            sub-part j + 1 trains (the paper's ping-pong)
        then the received sub-parts are the held shard; after the model
        ring's last round, one shift of the whole shard along the data
        ring; after the data ring's last, along the pod ring

``HybridConfig.fuse_subpart_permute=False`` starts a round's transfers only
after every sub-part has trained. On a (1, 1) mesh nothing moves, and the
sub-parts are views of the vertex table. The shard held at each round is
checked against ``rotation.vertex_shard_at``, and the shard must be home
again at the end of the episode.

Negatives: each minibatch draws S positions into the rank's pool (sampled
∝ deg^0.75). The positions come from a ``torch.Generator`` on the device,
seeded anew at every episode from ``(cfg.seed, rank)`` — the JAX trainer
likewise folds the device's flat index into ``PRNGKey(cfg.seed)`` at every
episode, so both draw the same positions each episode. The generators
differ, so ``train_episode(neg_draws=...)`` takes explicit positions, which
is how the tests replay the JAX stream.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import rotation
from repro_torch.core.partition import EpisodeBlocks, NodePartition
from repro_torch.core.ring import VertexRing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.train.checkpoint import numpy_to_tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    dim: int = 128
    lr: float = 0.025
    negatives: int = 16           # shared negatives per minibatch
    minibatch: int = 64           # shared-negative group size (Ji et al. [19])
    reduction: str = "sum"        # word2vec-faithful; see kernels.ops.sgns_step
    subparts: int = 4             # paper's k (ping-pong sub-parts)
    neg_pool: int = 8192          # deg^0.75-sampled per-device negative pool
    # kernels.ops route: "ref" | "pallas" | "pallas_fused" | "pallas_fused2".
    # The default is the fused CUDA update, the port's main path; the JAX
    # config defaults to "ref" because its container has no TPU. There is
    # no block_b: it pins the TPU's tile, and each CUDA wrapper plans its
    # own geometry.
    impl: str = "pallas_fused2"
    seed: int = 0
    # bf16 tables halve the HBM footprint; grads are computed in f32 inside
    # the kernel. dtype="float32" keeps the paper-faithful tables.
    dtype: str = "bfloat16"
    # False: a round's sub-parts all train before any is sent (one bulk
    # shift), the JAX step's ablation switch
    fuse_subpart_permute: bool = True

    def __post_init__(self):
        ops.check_impl(self.impl)


@dataclasses.dataclass(frozen=True)
class StagedEpisodeBlocks:
    """This rank's share of an episode's blocks on its device, the output of
    :meth:`HybridEmbeddingTrainer.stage_blocks`: the (R, k, Bmax) vertex
    sub-rows, context rows and mask (in the table dtype) of its R rounds,
    split from the (R, k, Bmax, 2) layout once per episode so every
    minibatch slice is contiguous. ``num_samples`` counts every rank's
    samples. ``ready`` is the side stream's event after the copy (None on
    the CPU)."""

    idx_v: torch.Tensor
    idx_c: torch.Tensor
    mask: torch.Tensor
    counts: np.ndarray             # (R, k) valid samples per block, host-side
    num_samples: int
    dropped: int = 0
    ready: object = None


class HybridEmbeddingTrainer:
    """Driver tying partition + rotation + episode step together, for one
    rank of a ``dims`` mesh (``device``: ``"cuda"`` by default, ``"cpu"``
    for the plain versions). More than one shard needs a started process
    group (``group``, or the default one) of that many ranks; this rank's
    place in it is its shard."""

    def __init__(self, num_nodes: int, cfg: HybridConfig,
                 degrees: np.ndarray | None = None, *, dims=(1, 1),
                 device="cuda", group=None):
        dims = tuple(int(n) for n in dims)
        shards = int(np.prod(dims))
        if shards > 1 and not (dist.is_available() and dist.is_initialized()):
            raise ValueError(f"dims={dims} asks for {shards} ranks; start a "
                             f"process group of {shards} first "
                             f"(torch.distributed.init_process_group)")
        if shards > 1 and dist.get_world_size(group) != shards:
            raise ValueError(f"dims={dims} asks for {shards} ranks; the "
                             f"process group has "
                             f"{dist.get_world_size(group)}")
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unsupported table dtype {cfg.dtype!r}; "
                             f"expected one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.part = NodePartition(num_nodes, dims=dims,
                                  subparts=cfg.subparts)
        rotation.check_schedule(self.part.dims)
        self.num_nodes = num_nodes
        self.rank = dist.get_rank(group) if shards > 1 else 0
        rows = self.part.padded_rows_per_shard
        self._rows = slice(self.rank * rows, (self.rank + 1) * rows)
        self.ring = (VertexRing(dims, self.rank, self.device, group)
                     if shards > 1 else None)
        self.vert = None               # this rank's (rows, d) shards
        self.ctx = None
        self._spare = None             # the vertex shard's other buffer
        self.pool = self._build_neg_pool(degrees)
        self._pool_dev = torch.from_numpy(self.pool[self.rank]).to(
            self.device)
        # negative-draw seed: (cfg.seed, this rank's flat index)
        self._neg_seed = int(np.random.SeedSequence(
            [cfg.seed & 0x7FFFFFFF, self.rank]).generate_state(1)[0])
        self._h2d = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)

    # ---------------------------------------------------------------- setup
    def _build_neg_pool(self, degrees: np.ndarray | None) -> np.ndarray:
        """Per-device pool of local context rows, sampled ∝ deg^0.75."""
        part, cfg = self.part, self.cfg
        P_shards, rows = part.num_shards, part.padded_rows_per_shard
        rng = np.random.default_rng(cfg.seed + 17)
        pool = np.zeros((P_shards, cfg.neg_pool), dtype=np.int32)
        for s in range(P_shards):
            lo = s * rows
            hi = min((s + 1) * rows, self.num_nodes)
            if hi <= lo:
                continue
            local_n = hi - lo
            if degrees is None:
                pool[s] = rng.integers(0, local_n, cfg.neg_pool)
            else:
                w = degrees[lo:hi].astype(np.float64) ** 0.75
                w = np.maximum(w, 1e-12)
                w /= w.sum()
                pool[s] = rng.choice(local_n, size=cfg.neg_pool, p=w)
        return pool

    def init_embeddings(self):
        """word2vec-style init: vertex ~ U(-0.5/d, 0.5/d), context = 0
        (the JAX trainer's numpy draw of the whole padded table, then one
        cast to the table dtype; a rank keeps its own rows)."""
        part, cfg = self.part, self.cfg
        d = cfg.dim
        rng = np.random.default_rng(cfg.seed)
        vert = (rng.random((part.padded_num_nodes, d), dtype=np.float32)
                - 0.5) / d
        self.vert = torch.from_numpy(vert[self._rows]).to(self.device,
                                                          self.dtype)
        self.ctx = torch.zeros((part.padded_rows_per_shard, d),
                               dtype=self.dtype, device=self.device)
        self._spare = None

    def _install(self, table) -> torch.Tensor:
        """This rank's rows of one whole table, as the trainer holds them:
        on its device, in the config's dtype, padded to the partition's
        rows. A numpy table (f32, or bf16 words) is converted bitwise first;
        a tensor that already is all that is kept as it is, without a copy,
        and trained in place (one rank)."""
        if not isinstance(table, torch.Tensor):
            table = numpy_to_tensor(np.asarray(table))
        n_pad, d = self.part.padded_num_nodes, self.cfg.dim
        if (table.dim() != 2 or table.shape[1] != d
                or table.shape[0] not in (self.num_nodes, n_pad)):
            raise ValueError(f"table of shape {tuple(table.shape)}; expected "
                             f"({self.num_nodes} or {n_pad}, {d})")
        table = table.to(self.device, self.dtype)
        if table.shape[0] != n_pad:
            padded = torch.zeros((n_pad, d), dtype=self.dtype,
                                 device=self.device)
            padded[: table.shape[0]] = table
            table = padded
        return table[self._rows].contiguous()

    def set_embeddings(self, vert, ctx) -> None:
        """Install externally-provided (num_nodes, d) tables — the resume
        path, and how weights cross from the JAX package. Takes numpy arrays
        (the JAX trainer's f32 or bf16 tables) or tensors; pads to the
        partition geometry (padded rows never enter training math, so
        zero-padding restored tables is exact). Every rank installs its own
        rows of the whole tables."""
        self.vert = self._install(vert)
        self.ctx = self._install(ctx)
        self._spare = None

    # ---------------------------------------------------------------- train
    def _split(self, blocks: torch.Tensor, counts: torch.Tensor):
        bmax = blocks.shape[-2]
        mask = (torch.arange(bmax, device=blocks.device)
                < counts[..., None]).to(self.dtype)
        return blocks[..., 0].contiguous(), blocks[..., 1].contiguous(), mask

    def stage_blocks(self, eb: EpisodeBlocks) -> StagedEpisodeBlocks:
        """Copy this rank's row of an episode's blocks to the device. On the
        card the copy runs from pinned host memory on a side stream and
        records an event, so a pipeline worker can stage episode e+1 while
        episode e trains."""
        k, R = self.part.subparts, self.part.num_shards
        blocks = torch.from_numpy(np.ascontiguousarray(
            eb.blocks[self.rank]).reshape(R, k, eb.block_cap, 2))
        counts_np = np.asarray(eb.counts[self.rank]).reshape(R, k)
        counts = torch.from_numpy(counts_np.astype(np.int32))
        kw = dict(counts=counts_np, num_samples=int(np.sum(eb.counts)),
                  dropped=eb.dropped)
        if self._h2d is None:
            return StagedEpisodeBlocks(*self._split(blocks, counts), **kw)
        blocks, counts = blocks.pin_memory(), counts.pin_memory()
        with torch.cuda.stream(self._h2d):
            idx_v, idx_c, mask = self._split(
                blocks.to(self.device, non_blocking=True),
                counts.to(self.device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(self._h2d)
        return StagedEpisodeBlocks(idx_v, idx_c, mask, ready=ready, **kw)

    def _negative_positions(self, R: int, k: int, nmb: int, neg_draws):
        S = self.cfg.negatives
        if neg_draws is not None:
            draws = torch.as_tensor(np.asarray(neg_draws), dtype=torch.int64)
            if R == 1 and tuple(draws.shape) == (k, nmb, S):
                draws = draws[None]
            if tuple(draws.shape) != (R, k, nmb, S):
                raise ValueError(f"neg_draws of shape {tuple(draws.shape)}; "
                                 f"expected {(R, k, nmb, S)}")
            return draws.to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._neg_seed)
        return torch.randint(0, self.pool.shape[1], (R, k, nmb, S),
                             generator=gen, device=self.device)

    def _subparts(self) -> torch.Tensor:
        """The held vertex shard as (k, rows per sub-part, d) views."""
        return self.vert.view(self.part.subparts, self.part.rows_per_subpart,
                              self.cfg.dim)

    def _start(self, js, axis: int):
        """Start sending sub-parts ``js`` of the held shard along ring
        ``axis`` into the same sub-parts of the spare buffer (tags: their
        indices)."""
        if self._spare is None:
            self._spare = torch.empty_like(self.vert)
        subs = self._subparts()
        recv = self._spare.view(subs.shape)
        return self.ring.start([subs[j] for j in js], [recv[j] for j in js],
                               axis, js[0])

    def _arrive(self, pending, held: list, axis: int) -> None:
        """Finish the shifts ``pending`` along ring ``axis``: the spare
        buffer, which received the previous rank's shard, becomes the held
        one, whose coordinate on that axis steps back one."""
        self.ring.finish(pending)
        self.vert, self._spare = self._spare, self.vert
        held[axis] = (held[axis] - 1) % self.part.dims[axis]

    def train_episode(self, eb: EpisodeBlocks | StagedEpisodeBlocks, *,
                      lr: float | None = None, neg_draws=None) -> float:
        """Train one episode; returns its loss per valid sample over every
        rank (the ranks' loss sums and sample counts each summed, as the JAX
        step's psums). With more than one rank, every rank calls it.

        ``neg_draws``: optional (R rounds, k, minibatches per block, S)
        positions into this rank's negative pool, in (round, sub-part,
        minibatch) order, in place of the device generator's draws; one
        rank also takes (k, minibatches per block, S).
        """
        if not isinstance(eb, StagedEpisodeBlocks):
            eb = self.stage_blocks(eb)
        cfg = self.cfg
        R, k, bmax = eb.idx_v.shape
        mb = cfg.minibatch
        if bmax % mb:
            raise ValueError(f"block capacity {bmax} is not a multiple of the "
                             f"minibatch {mb} (build the blocks with "
                             f"pad_multiple=minibatch)")
        nmb = bmax // mb
        if eb.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(eb.ready)
            for t in (eb.idx_v, eb.idx_c, eb.mask):
                t.record_stream(stream)
        # every minibatch's negatives in one gather from the pool
        idx_n = self._pool_dev[
            self._negative_positions(R, k, nmb, neg_draws)]
        lr = cfg.lr if lr is None else lr
        dims, ring = self.part.dims, self.ring
        home = ring.coord if ring is not None else (0,) * len(dims)
        held = list(home)              # the coordinate of the shard held
        model = len(dims) - 1
        move = ring is not None and dims[model] > 1
        losses = []
        for r, rnd in enumerate(itertools.product(*map(range, dims))):
            want = rotation.vertex_shard_at(home, rnd, dims)
            if rotation.flatten_coord(tuple(held), dims) != want:
                raise AssertionError(f"rank {self.rank} holds vertex shard "
                                     f"{tuple(held)} at round {rnd}; the "
                                     f"schedule says {want}")
            subs = self._subparts()
            pending = []
            for j in range(k):
                # minibatches past the block's count are all padding (mask
                # 0): their updates are zero, so they are not launched
                n_run = -(-int(eb.counts[r, j]) // mb)
                rows = zip(*(t[r, j, : n_run * mb].view(n_run, mb).unbind(0)
                             for t in (eb.idx_v, eb.idx_c, eb.mask)),
                           idx_n[r, j, :n_run].unbind(0))
                for iv, ic, m, inn in rows:
                    _, _, loss = ops.sgns_step(subs[j], self.ctx, iv, ic,
                                               inn, m, lr, impl=cfg.impl,
                                               reduction=cfg.reduction)
                    losses.append(loss)
                if move and cfg.fuse_subpart_permute:
                    # the ping-pong: sub-part j travels while j + 1 trains
                    pending.append(self._start([j], model))
            if move:
                if not cfg.fuse_subpart_permute:
                    pending = [self._start(list(range(k)), model)]
                self._arrive(pending, held, model)
            # after the last round of each inner ring, one shift of the
            # whole shard along the ring outside it
            for axis in range(model - 1, -1, -1):
                if any(rnd[b] != dims[b] - 1
                       for b in range(axis + 1, model + 1)):
                    break
                if ring is not None and dims[axis] > 1:
                    self._arrive([self._start(list(range(k)), axis)], held,
                                 axis)
        if tuple(held) != tuple(home):
            raise AssertionError(f"rank {self.rank}'s vertex shard is not "
                                 f"home after the episode: {tuple(held)}")
        total = max(int(eb.counts.sum()), 1)
        loss_sum = torch.stack(losses).sum() if losses else None
        if ring is None:
            return float(loss_sum / total) if losses else 0.0
        loss_sum, total = ring.all_sum(
            [0.0 if loss_sum is None else float(loss_sum), total])
        return loss_sum / total

    def _gather(self, table: torch.Tensor) -> torch.Tensor:
        if self.ring is None:
            return table[: self.num_nodes].to("cpu", copy=True)
        return self.ring.all_gather(table)[: self.num_nodes]

    def embeddings(self) -> torch.Tensor:
        """The vertex table, unpadded, as a CPU tensor (a copy); with more
        than one rank, every rank's shard gathered (every rank calls it)."""
        return self._gather(self.vert)

    def context_embeddings(self) -> torch.Tensor:
        """The context table, unpadded, as a CPU tensor (a copy); with more
        than one rank, every rank's shard gathered (every rank calls it)."""
        return self._gather(self.ctx)
