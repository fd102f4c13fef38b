"""Serving steps: chunked prefill and one-token decode, on one card or on
a mesh of ranks.

The port of the JAX package's ``train/serve_step.py``: ``make_prefill_step``,
``make_decode_step``, ``cache_len_for``, ``cache_specs`` (the dry-run's
caches on the ``meta`` device) and ``cache_shardings`` (kept with the
rule engine in ``sharding/specs.py``, re-exported here). With ``mesh``
(``sharding.mesh.Mesh``) and ``specs`` (``param_shardings`` of the whole
parameters), ``params`` are this rank's shards; the steps take the global
batch (every rank the same), compute this rank's rows (``batch_spec``)
with the kv heads split over "model" where the weights are (the prefill's
first chunk runs the flash kernel on the rank's local heads), hold the
caches as this rank's shards by ``cache_shardings`` (kv heads over
"model", batch over the data axes), run MoE layers through the
expert-parallel dispatch (decode: its quota mode) and return the global
logits on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard
from repro_torch.sharding.specs import cache_shardings

__all__ = ["make_prefill_step", "make_decode_step", "cache_len_for",
           "cache_specs", "cache_shardings"]


def _rows(batch: dict, mesh):
    B = batch["tokens"].shape[0]
    rows = mesh.batch_slice(B)
    return {k: v[rows] for k, v in batch.items()}, mesh.for_batch(B)


@torch.no_grad()
def _all_rows(logits, view):
    """The global batch's logits from every rank's rows."""
    if not view.b_axes:
        return logits
    return shard.all_gather(logits, view, view.b_axes, 0)


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, flash: bool = True,
                      mesh=None, specs=None):
    def prefill_step(params, batch):
        if mesh is None:
            return tfm.prefill(params, batch, cfg, cache_len, flash=flash)
        local, view = _rows(batch, mesh)
        logits, caches = tfm.prefill(params, local, cfg, cache_len,
                                     flash=flash, mesh=view, specs=specs)
        return _all_rows(logits, view), caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None, specs=None):
    def decode(params, token, caches):
        if mesh is None:
            return tfm.decode_step(params, token, caches, cfg)
        local, view = _rows({"tokens": token}, mesh)
        logits, caches = tfm.decode_step(params, local["tokens"], caches,
                                         cfg, mesh=view, specs=specs)
        return _all_rows(logits, view), caches
    return decode


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: the sliding window if set, else the full context."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int, params=None):
    """The caches of a ``batch`` x ``cache_len`` decode on the ``meta``
    device (``init_caches`` of ``params``, by default
    ``tfm.abstract_params(cfg)``): one dict per layer, nothing allocated.
    Enc-dec archs decode against a cross-attention memory of
    ``frontend_len_cap`` frames."""
    if params is None:
        params = tfm.abstract_params(cfg)
    enc_out = None
    if cfg.is_encdec:
        enc_out = torch.empty((batch, cfg.frontend_len_cap, cfg.d_model),
                              dtype=getattr(torch, cfg.compute_dtype),
                              device="meta")
    return tfm.init_caches(params, cfg, batch, cache_len, enc_out=enc_out)
