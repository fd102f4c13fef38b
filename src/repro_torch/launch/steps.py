"""Step builders: for an (arch, shape, mesh) triple, one rank's step
function, its arguments as tensors without storage and their specs.

The port of the JAX package's ``launch/steps.py``. Call the builders on a
mesh over a default group that :func:`sharding.mesh.fake_world` started
(the dry-run does): each argument is made directly as this rank's shard of
it, a tensor on the ``meta`` device (a shape and a dtype, nothing
allocated), from the specs of ``sharding/specs.py``, so the whole tree is
never made (deepseek-v3's weights cost nothing). The step is the
launchers' own: ``make_train_step``, ``make_prefill_step``,
``make_decode_step`` on the mesh, and the embedding trainer's
``HybridEmbeddingTrainer.episode_sums``. The routes are the card's: the
CUDA kernels' wrappers take their shape-only path for a tensor without
storage (``kernels/build.py::traced``), and the collectives take the
unstaged path of ranks on distinct cards.

``arg_bytes`` holds this rank's bytes of each argument by its spec, as
JAX's compiled step takes them: the parameters' and optimizer state's are
the shards the step takes; the batch's is its shard by
``batch_shardings``. The port's steps take the global batch on every rank
and keep their rows of it, so a rank also holds the rest of the batch:
``replicated_bytes``, which the record's peak counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs as cfgs
from repro_torch.configs.shapes import InputShape
from repro_torch.core.hybrid import (HybridConfig, HybridEmbeddingTrainer,
                                     StagedEpisodeBlocks)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard
from repro_torch.sharding.specs import (batch_shardings, cache_shardings,
                                        param_shardings)
from repro_torch.train.serve_step import (cache_len_for, cache_specs,
                                          make_decode_step,
                                          make_prefill_step)
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class BuiltStep:
    fn: object                 # the step: fn(*args)
    args: tuple                # this rank's arguments (meta tensors)
    arg_bytes: dict            # argument -> this rank's bytes by its spec
    held: tuple = ()           # other state the step reads (the trainer's)
    replicated_bytes: int = 0  # the global batch beyond this rank's shard


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def _shards(whole, specs, mesh):
    """This rank's shard of every leaf of ``whole``: ``meta`` tensors of
    ``shard.local_shape``."""
    return tree_map(lambda t, s: torch.empty(
        shard.local_shape(t.shape, s, mesh), dtype=t.dtype, device="meta"),
        whole, specs)


def _shard_bytes(whole, specs, mesh) -> int:
    return sum(int(np.prod(shard.local_shape(t.shape, s, mesh)))
               * t.element_size()
               for t, s in zip(tree_leaves(whole), tree_leaves(specs)))


def _batch(cfg, shape, mesh):
    """The global batch (``meta`` tensors), the bytes of this rank's shard
    of it (``batch_shardings``) and the bytes of the rest."""
    specs = cfgs.input_specs(cfg, shape)
    b_sh = batch_shardings(specs, shape.global_batch, mesh)
    own = _shard_bytes(specs, b_sh, mesh)
    return specs, own, _nbytes(specs) - own


def build_lm_step(cfg: ModelConfig, shape: InputShape, mesh, *,
                  dtype: str = "bfloat16",
                  cache_len: int | None = None) -> BuiltStep:
    """One LM step of ``shape.kind`` on ``mesh``: ``for_shape(cfg, shape,
    dtype=dtype)`` with ``tp_size`` the "model" axis, as JAX builds it.
    Serving steps take caches of ``cache_len`` (default
    ``cache_len_for(cfg, shape.seq_len)``)."""
    cfg = cfgs.for_shape(cfg, shape, dtype=dtype)
    cfg = dataclasses.replace(cfg, tp_size=int(mesh.shape.get("model", 1)))
    whole = tfm.abstract_params(cfg)
    p_sh = param_shardings(whole, mesh, cfg)
    params = _shards(whole, p_sh, mesh)

    if shape.kind == "train":
        step_fn, opt = make_train_step(cfg, mesh=mesh, specs=p_sh)
        opt_state = opt.init(params)
        batch, b_bytes, rest = _batch(cfg, shape, mesh)
        return BuiltStep(
            fn=step_fn, args=(params, opt_state, 0, batch),
            arg_bytes={"params": _nbytes(params),
                       "opt_state": _nbytes(opt_state), "batch": b_bytes},
            replicated_bytes=rest)

    clen = cache_len or cache_len_for(cfg, shape.seq_len)
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, clen, mesh=mesh, specs=p_sh)
        batch, b_bytes, rest = _batch(cfg, shape, mesh)
        return BuiltStep(fn=fn, args=(params, batch),
                         arg_bytes={"params": _nbytes(params),
                                    "batch": b_bytes},
                         replicated_bytes=rest)

    # decode: one token against a full cache of clen (the ring's last
    # slot next)
    B = shape.global_batch
    fn = make_decode_step(cfg, mesh=mesh, specs=p_sh)
    wcaches = cache_specs(cfg, B, clen, whole)
    c_sh = cache_shardings(wcaches, B, mesh)
    caches = tfm.ShardedCaches(
        [{n: (torch.empty(shard.local_shape(v.shape, cs[n], mesh),
                          dtype=v.dtype, device="meta")
              if torch.is_tensor(v) else clen - 1)
          for n, v in c.items()} for c, cs in zip(wcaches, c_sh)], c_sh)
    token, t_bytes, rest = _batch(cfg, shape, mesh)
    return BuiltStep(fn=fn, args=(params, token["token"], caches),
                     arg_bytes={"params": _nbytes(params), "batch": t_bytes,
                                "caches": _nbytes(caches)},
                     replicated_bytes=rest)


def build_embedding_step(arch_cfg, shape: InputShape, mesh) -> BuiltStep:
    """The paper's own arch: one hybrid-parallel training episode of this
    rank (``HybridEmbeddingTrainer.episode_sums``) at JAX's geometry:
    ``P_dev`` rounds x ``subparts`` blocks of ``block_cap`` samples, every
    block full, on tables of ``padded_rows_per_shard`` rows. The tables,
    the staged blocks and the negative draws are given to the trainer as
    ``meta`` tensors (its own init draws the whole table on the host, and its
    staging pins host memory). ``shape`` has no analogue here, as in JAX."""
    dims = tuple(mesh.dims)
    P_dev = int(np.prod(dims))
    hcfg = HybridConfig(dim=arch_cfg.dim, negatives=arch_cfg.negatives,
                        minibatch=arch_cfg.minibatch,
                        subparts=arch_cfg.subparts,
                        neg_pool=arch_cfg.neg_pool, lr=arch_cfg.lr,
                        dtype=getattr(arch_cfg, "dtype", "float32"))
    tr = HybridEmbeddingTrainer(arch_cfg.num_nodes, hcfg, dims=dims,
                                device="meta")
    rows, d, k = tr.part.padded_rows_per_shard, hcfg.dim, hcfg.subparts
    bcap = arch_cfg.block_cap
    tr.vert = torch.empty((rows, d), dtype=tr.dtype, device=tr.device)
    tr.ctx = torch.empty((rows, d), dtype=tr.dtype, device=tr.device)
    R = tr.part.num_shards

    def blocks(dtype):
        return torch.empty((R, k, bcap), dtype=dtype, device=tr.device)

    eb = StagedEpisodeBlocks(
        blocks(torch.int32), blocks(torch.int32), blocks(tr.dtype),
        counts=np.full((R, k), bcap), num_samples=P_dev * R * k * bcap)
    draws = torch.empty((R, k, bcap // hcfg.minibatch, hcfg.negatives),
                        dtype=torch.int64, device=tr.device)
    return BuiltStep(
        fn=lambda eb, draws: tr.episode_sums(eb, neg_draws=draws),
        args=(eb, draws),
        arg_bytes={"tables": _nbytes([tr.vert, tr.ctx]),
                   "blocks": _nbytes([eb.idx_v, eb.idx_c, eb.mask]),
                   "negatives": _nbytes([draws, tr._pool_dev])},
        held=(tr.vert, tr.ctx, tr._pool_dev, eb.idx_v, eb.idx_c, eb.mask))


def build_step(arch: str, shape_name: str, mesh) -> BuiltStep:
    shape = cfgs.SHAPES[shape_name]
    cfg = cfgs.get_config(arch)
    if getattr(cfg, "arch_type", None) == "embedding":
        return build_embedding_step(cfg, shape, mesh)
    return build_lm_step(cfg, shape, mesh)
