"""GraphVite-style parameter-server baseline (paper §VI-C, Tables III/VI).

The port of the JAX package's ``core/baseline_ps.py``. The paper's
speedups are measured against GraphVite: a single-node system whose CPU
acts as a parameter server — the tables live in host memory, each round
every vertex block is copied host → device, trained and copied back, with
**no pipeline overlap** and **all inter-device exchange bouncing through
the host**. The same execution structure, so the comparison is
structural:

  * the same SGNS math (the same ``kernels.ops.sgns_step`` on the route
    ``cfg.impl`` names, the fused CUDA update by default),
  * the same 2D orthogonal-block schedule,
  * but synchronous host round trips for every vertex block of every
    round, no ring, no overlap, and one dispatch a block from Python.

Devices follow ``repro_torch.device.shard_devices`` (one card each, or
every device on one named device, serially). Negatives: JAX's stream.
Each non-empty block draws its (minibatches, S) pool positions from
``PRNGKey(cfg.seed + 131·step)`` (``step`` counts the non-empty blocks
trained, in (round, device, sub-part) order), one ``split`` a minibatch,
as the JAX baseline keys each block (``prng.negative_positions``, kept per
(step, minibatches) on the device: a later episode of the same blocks
draws nothing); ``train_episode(neg_draws=...)`` takes explicit
positions.
Given the resident trainer's draws on one device, it trains the same
blocks in the same order on the same sub-part tables, so its tables are
the resident trainer's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.hybrid import (_DTYPES, HybridConfig, build_neg_pool,
                                     init_vertex_rows)
from repro_torch.core.partition import EpisodeBlocks, NodePartition
from repro_torch.device import resolve_device, shard_devices
from repro_torch.kernels import ops
from repro_torch.obs import register_source


@dataclasses.dataclass
class PSCounters:
    host_syncs: int = 0
    bytes_through_host: int = 0


class ParameterServerTrainer:
    """Single-node multi-device trainer with the host as parameter server
    (``device``: ``"cuda"`` by default, ``"cpu"`` for the plain
    versions)."""

    def __init__(self, num_nodes: int, num_devices: int, cfg: HybridConfig,
                 degrees: np.ndarray | None = None, *, device="cuda"):
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unsupported table dtype {cfg.dtype!r}; "
                             f"expected one of {sorted(_DTYPES)}")
        self.cfg = cfg
        self.num_nodes = num_nodes
        self.devices = [resolve_device(d)
                        for d in shard_devices(device, num_devices)]
        self.n = num_devices
        # the hybrid trainer's partition geometry on a (1, n) mesh
        self.part = NodePartition(num_nodes, dims=(1, num_devices),
                                  subparts=cfg.subparts)
        self.counters = PSCounters()
        # the structural counters through the telemetry registry (a no-op
        # unless obs is enabled)
        register_source("baseline_ps",
                        lambda: dataclasses.asdict(self.counters))
        dtype = _DTYPES[cfg.dtype]   # the hybrid trainer's table dtype
        self.vert = torch.from_numpy(init_vertex_rows(self.part, cfg)).to(
            dtype)
        self.ctx = torch.zeros((self.part.padded_num_nodes, cfg.dim),
                               dtype=dtype)
        if any(d.type == "cuda" for d in self.devices):
            # host tables in pinned memory: the copies are plain DMA
            self.vert, self.ctx = self.vert.pin_memory(), self.ctx.pin_memory()
        self.pool = build_neg_pool(self.part, cfg, num_nodes, degrees)
        self._positions: dict = {}     # (step, nmb, device) -> positions

    def _block_positions(self, step: int, nmb: int, dev) -> torch.Tensor:
        """The (nmb, S) pool positions of the ``step``-th non-empty block:
        JAX's chain from ``PRNGKey(cfg.seed + 131 step)``, drawn once on
        ``dev`` and kept."""
        key = (step, nmb, str(dev))
        pos = self._positions.get(key)
        if pos is None:
            cfg = self.cfg
            pos = prng.negative_positions(
                prng.key(cfg.seed + 131 * step), nmb, cfg.negatives,
                cfg.neg_pool, device=dev)
            self._positions[key] = pos
        return pos

    def _draws(self, neg_draws, k: int, nmb: int):
        """``neg_draws`` as a (devices, rounds, k, nmb, S) tensor, or None."""
        if neg_draws is None:
            return None
        n, S = self.n, self.cfg.negatives
        draws = torch.as_tensor(np.asarray(neg_draws), dtype=torch.int64)
        if (tuple(draws.shape[-3:]) != (k, nmb, S)
                or int(np.prod(draws.shape[:-3])) != n * n):
            raise ValueError(f"neg_draws of shape {tuple(draws.shape)}; "
                             f"expected {(n, n, k, nmb, S)}")
        return draws.reshape(n, n, k, nmb, S)

    # ------------------------------------------------------------------ train
    def train_episode(self, eb: EpisodeBlocks, *, lr: float | None = None,
                      neg_draws=None) -> float:
        """Orthogonal-block rounds; every vertex block round-trips the host.
        Returns the loss per valid sample (per-block sums added on the host,
        as the JAX baseline adds them).

        ``neg_draws``: optional (devices, rounds, k, minibatches per block,
        S) positions into each device's pool, indexed as ``eb.blocks``
        (device i's block at round r, sub-part j), in place of JAX's
        per-block stream.
        """
        cfg, part = self.cfg, self.part
        n, k = self.n, part.subparts
        rows, rows_sub = part.padded_rows_per_shard, part.rows_per_subpart
        mb, bmax = cfg.minibatch, eb.block_cap
        if bmax % mb:
            raise ValueError(f"block capacity {bmax} is not a multiple of the "
                             f"minibatch {mb} (build the blocks with "
                             f"pad_multiple=minibatch)")
        nmb = bmax // mb
        draws = self._draws(neg_draws, k, nmb)
        lr = cfg.lr if lr is None else lr
        # blocks layout: (P, 1, n, k, Bmax, 2) on the (1, n) ring
        blocks, counts = eb.blocks, eb.counts
        loss_sum, samples = 0.0, max(int(counts.sum()), 1)
        # context shards stay on their device for the episode (GraphVite
        # keeps them there), but vertex shards bounce through the host
        ctx_dev = [self.ctx[i * rows:(i + 1) * rows].to(dev)
                   for i, dev in enumerate(self.devices)]
        pool_dev = [torch.from_numpy(self.pool[i]).to(dev)
                    for i, dev in enumerate(self.devices)]
        step = 0
        for r in range(n):                          # ring rounds
            for i, dev in enumerate(self.devices):  # serial, one by one
                vs = (i - r) % n    # the vertex shard at device i this round
                for j in range(k):
                    cnt = int(counts[i, 0, r, j])
                    if cnt == 0:
                        continue
                    lo = vs * rows + j * rows_sub
                    # host -> device (the PS fetch)
                    v_dev = self.vert[lo:lo + rows_sub].to(dev)
                    blk = torch.from_numpy(np.ascontiguousarray(
                        blocks[i, 0, r, j])).to(dev)
                    idx_v = blk[:, 0].contiguous()
                    idx_c = blk[:, 1].contiguous()
                    mask = (torch.arange(bmax, device=dev) < cnt).to(
                        v_dev.dtype)
                    if draws is None:
                        pos = self._block_positions(step, nmb, dev)
                    else:
                        pos = draws[i, r, j].to(dev)
                    step += 1
                    idx_n = pool_dev[i][pos]
                    lj = torch.zeros((), dtype=torch.float32, device=dev)
                    # minibatches past the count are all padding: skipped,
                    # as the hybrid trainer skips them
                    for t in range(-(-cnt // mb)):
                        sl = slice(t * mb, (t + 1) * mb)
                        ops.sgns_step(v_dev, ctx_dev[i], idx_v[sl],
                                      idx_c[sl], idx_n[t], mask[sl], lr,
                                      impl=cfg.impl, reduction=cfg.reduction,
                                      loss_into=lj)
                    # device -> host (the PS write-back), synchronous
                    self.vert[lo:lo + rows_sub].copy_(v_dev)
                    loss_sum += float(lj)
                    self.counters.host_syncs += 2
                    self.counters.bytes_through_host += (
                        2 * v_dev.numel() * v_dev.element_size())
        for i in range(n):
            self.ctx[i * rows:(i + 1) * rows].copy_(ctx_dev[i])
            self.counters.host_syncs += 1
            self.counters.bytes_through_host += (
                ctx_dev[i].numel() * ctx_dev[i].element_size())
        return loss_sum / samples

    def embeddings(self) -> torch.Tensor:
        """The vertex table, unpadded, as a CPU tensor (a copy)."""
        return self.vert[: self.num_nodes].clone()

    def context_embeddings(self) -> torch.Tensor:
        """The context table, unpadded, as a CPU tensor (a copy)."""
        return self.ctx[: self.num_nodes].clone()
