"""Hybrid model–data parallel embedding training (paper §III), on one card.

The port of the JAX package's ``core/hybrid.py``. Data parallelism: each
episode's edge samples are 2D-partitioned into blocks (``core.partition``)
and a device trains only blocks whose endpoints are resident. Model
parallelism: the context table is pinned; the vertex table is split into
``k`` sub-parts and rotates through the device rings (``core.rotation``) so
each vertex shard meets each context shard once per episode.

This slice runs the (1, 1) mesh: one card holds both tables whole, the
rotation is the identity, and an episode is

    for each sub-part j (a view of the vertex table, no copy):
        for each minibatch of block j:
            kernels.ops.sgns_step(impl=cfg.impl)

The multi-card rings (``torch.distributed`` P2P in place of the JAX
``ppermute``) come with a later slice; asking for more than one shard
raises.

Negatives: each minibatch draws S positions into the per-device pool
(sampled ∝ deg^0.75). The positions come from a ``torch.Generator`` on the
device, seeded anew at every episode from ``(cfg.seed, device flat
index)`` — the JAX trainer likewise folds the device index into
``PRNGKey(cfg.seed)`` at every episode, so both draw the same positions
each episode. The generators differ, so ``train_episode(neg_draws=...)``
takes explicit positions, which is how the tests replay the JAX stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rotation
from repro_torch.core.partition import EpisodeBlocks, NodePartition
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

    def __post_init__(self):
        ops.check_impl(self.impl)


@dataclasses.dataclass(frozen=True)
class StagedEpisodeBlocks:
    """An episode's blocks on the trainer's device, the output of
    :meth:`HybridEmbeddingTrainer.stage_blocks`: the (k, Bmax) vertex
    sub-rows, context rows and mask (in the table dtype), split from the
    (k, Bmax, 2) layout once per episode so every minibatch slice is
    contiguous. ``ready`` is the side stream's event after the copy (None
    on the CPU)."""

    idx_v: torch.Tensor
    idx_c: torch.Tensor
    mask: torch.Tensor
    counts: np.ndarray             # (k,) valid samples per block, host-side
    num_samples: int
    dropped: int = 0
    ready: object = None


class HybridEmbeddingTrainer:
    """Driver tying partition + rotation + episode step together, on one
    device (``device``: ``"cuda"`` by default, ``"cpu"`` for the plain
    versions)."""

    def __init__(self, num_nodes: int, cfg: HybridConfig,
                 degrees: np.ndarray | None = None, *, dims=(1, 1),
                 device="cuda"):
        if int(np.prod(dims)) != 1:
            raise ValueError(f"this trainer runs one device; dims={dims} "
                             f"asks for {int(np.prod(dims))} shards")
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unsupported table dtype {cfg.dtype!r}; "
                             f"expected one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.part = NodePartition(num_nodes, dims=tuple(dims),
                                  subparts=cfg.subparts)
        rotation.check_schedule(self.part.dims)
        self.num_nodes = num_nodes
        self.vert = None
        self.ctx = None
        self.pool = self._build_neg_pool(degrees)
        self._pool_dev = torch.from_numpy(self.pool[0]).to(self.device)
        # negative-draw seed: (cfg.seed, flat index of this device)
        self._neg_seed = int(np.random.SeedSequence(
            [cfg.seed & 0x7FFFFFFF, 0]).generate_state(1)[0])
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
        (the JAX trainer's numpy draw, then one cast to the table dtype)."""
        part, cfg = self.part, self.cfg
        d = cfg.dim
        rng = np.random.default_rng(cfg.seed)
        vert = (rng.random((part.padded_num_nodes, d), dtype=np.float32)
                - 0.5) / d
        self.vert = torch.from_numpy(vert).to(self.device, self.dtype)
        self.ctx = torch.zeros((part.padded_num_nodes, d), dtype=self.dtype,
                               device=self.device)

    def _install(self, table) -> torch.Tensor:
        """One table as the trainer holds it: on its device, in the config's
        dtype, padded to the partition's rows. A numpy table (f32, or bf16
        words) is converted bitwise first; a tensor that already is all
        that is kept as it is, without a copy, and trained in place."""
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
        return table.contiguous()

    def set_embeddings(self, vert, ctx) -> None:
        """Install externally-provided (num_nodes, d) tables — the resume
        path, and how weights cross from the JAX package. Takes numpy arrays
        (the JAX trainer's f32 or bf16 tables) or tensors; pads to the
        partition geometry (padded rows never enter training math, so
        zero-padding restored tables is exact)."""
        self.vert = self._install(vert)
        self.ctx = self._install(ctx)

    # ---------------------------------------------------------------- train
    def _split(self, blocks: torch.Tensor, counts: torch.Tensor):
        bmax = blocks.shape[1]
        mask = (torch.arange(bmax, device=blocks.device)[None, :]
                < counts[:, None]).to(self.dtype)
        return blocks[..., 0].contiguous(), blocks[..., 1].contiguous(), mask

    def stage_blocks(self, eb: EpisodeBlocks) -> StagedEpisodeBlocks:
        """Copy an episode's blocks to the device. On the card the copy runs
        from pinned host memory on a side stream and records an event, so a
        pipeline worker can stage episode e+1 while episode e trains."""
        k = self.part.subparts
        blocks = torch.from_numpy(
            np.ascontiguousarray(eb.blocks).reshape(k, eb.block_cap, 2))
        counts_np = np.asarray(eb.counts).reshape(k)
        counts = torch.from_numpy(counts_np.astype(np.int32))
        kw = dict(counts=counts_np, num_samples=int(counts_np.sum()),
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

    def _negative_positions(self, k: int, nmb: int, neg_draws):
        S = self.cfg.negatives
        if neg_draws is not None:
            draws = torch.as_tensor(np.asarray(neg_draws), dtype=torch.int64)
            if tuple(draws.shape) != (k, nmb, S):
                raise ValueError(f"neg_draws of shape {tuple(draws.shape)}; "
                                 f"expected {(k, nmb, S)}")
            return draws.to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._neg_seed)
        return torch.randint(0, self.pool.shape[1], (k, nmb, S),
                             generator=gen, device=self.device)

    def train_episode(self, eb: EpisodeBlocks | StagedEpisodeBlocks, *,
                      lr: float | None = None, neg_draws=None) -> float:
        """Train one episode; returns its loss per valid sample.

        ``neg_draws``: optional (k, minibatches per block, S) positions into
        the negative pool, in (sub-part, minibatch) order, in place of the
        device generator's draws.
        """
        if not isinstance(eb, StagedEpisodeBlocks):
            eb = self.stage_blocks(eb)
        cfg = self.cfg
        k, bmax = eb.idx_v.shape
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
        idx_n = self._pool_dev[self._negative_positions(k, nmb, neg_draws)]
        lr = cfg.lr if lr is None else lr
        vert = self.vert.view(k, self.part.rows_per_subpart, cfg.dim)
        losses = []
        for j in range(k):
            # minibatches past the block's count are all padding (mask 0):
            # their updates are zero, so they are not launched
            n_run = -(-int(eb.counts[j]) // mb)
            vj = vert[j]
            rows = zip(*(t[j, : n_run * mb].view(n_run, mb).unbind(0)
                         for t in (eb.idx_v, eb.idx_c, eb.mask)),
                       idx_n[j, :n_run].unbind(0))
            for iv, ic, m, inn in rows:
                _, _, loss = ops.sgns_step(vj, self.ctx, iv, ic, inn, m, lr,
                                           impl=cfg.impl,
                                           reduction=cfg.reduction)
                losses.append(loss)
        if not losses:
            return 0.0
        total = max(int(eb.counts.sum()), 1)
        return float(torch.stack(losses).sum() / total)

    def embeddings(self) -> torch.Tensor:
        """The vertex table, unpadded, as a CPU tensor (a copy)."""
        return self.vert[: self.num_nodes].to("cpu", copy=True)

    def context_embeddings(self) -> torch.Tensor:
        """The context table, unpadded, as a CPU tensor (a copy)."""
        return self.ctx[: self.num_nodes].to("cpu", copy=True)
