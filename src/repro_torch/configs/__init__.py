"""Architecture registry: ``--arch <id>`` selection.

The port's counterpart of the JAX package's ``configs/__init__.py``. It
holds copies of every config of the JAX registry, so a JAX command line
parses unchanged: the dense LMs, the MoE LMs phi3.5-moe and deepseek-v3
(MLA, MTP), the SSM mamba2, the hybrid jamba, the VLM llava-next, the
enc-dec seamless-m4t and the paper's embedding workload. Every family
runs; an arch too large for one device at full depth (deepseek-v3,
jamba, phi3.5-moe) needs a sharded init (``sharding/`` shards a tree each
rank first makes whole; ``ROADMAP.md``, Queue 1 item 5), which the
launchers say before they allocate. :func:`for_shape` derives the
dry-run's config of an arch for one of the four input shapes
(``configs/shapes.py``) and :func:`input_specs` its inputs as tensors on
the ``meta`` device (shapes and dtypes; nothing is allocated).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import (deepseek_v3_671b, granite_3_2b,
                                 jamba_v0_1_52b, llava_next_mistral_7b,
                                 mamba2_1_3b, phi3_5_moe_42b, qwen1_5_0_5b,
                                 qwen1_5_4b, qwen2_5_32b,
                                 seamless_m4t_large_v2, tencent_embedding)
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.models.config import ModelConfig

ARCHS = {
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "qwen2.5-32b": qwen2_5_32b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "granite-3-2b": granite_3_2b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "tencent-embedding": tencent_embedding.CONFIG,
}

# archs of the JAX registry whose family the port does not run yet: none
NOT_PORTED: dict[str, str] = {}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted([*ARCHS, *NOT_PORTED])


# --------------------------------------------------------------------------
# per-shape config adjustment
# --------------------------------------------------------------------------
def for_shape(cfg: ModelConfig, shape: InputShape, *,
              dtype: str = "bfloat16") -> ModelConfig:
    """Adjust a full config for one input shape (dry-run numerics: bf16).

    long_500k policy: SSM/hybrid/MLA archs decode the full 524k context
    natively (O(1) state / few attention layers / compressed cache);
    plain-GQA archs switch to an 8,192-key sliding window, the explicitly
    implemented sub-quadratic variant.
    """
    changes: dict = dict(param_dtype=dtype, compute_dtype=dtype)
    if shape.kind == "decode":
        changes["remat"] = False
        changes["train_microbatches"] = 1
    if shape.name == "long_500k":
        native_long = (cfg.arch_type in ("ssm", "hybrid")) or cfg.mla
        if not native_long:
            changes["sliding_window"] = 8192
    if shape.kind == "prefill" and cfg.prefill_chunk:
        # the chunk must divide the (possibly prefix-extended) prefill length
        changes["prefill_chunk"] = cfg.prefill_chunk
    return dataclasses.replace(cfg, **changes)


# --------------------------------------------------------------------------
# input specs (meta tensors; nothing is allocated)
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Model inputs for (arch, shape) as tensors on the ``meta`` device.

    Train/prefill: the token budget per sequence is ``seq_len``; a VLM
    spends ``frontend_len_cap`` of it on stub patch embeddings, audio splits
    it half frames, half tokens. Decode: one new token against a cache of
    length ``seq_len`` (built separately, ``train/serve_step.py``).
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.compute_dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.modality == "vision":
            P = cfg.frontend_len_cap
            return {"tokens": spec((B, S - P), i32),
                    "positions": spec((B, S - P), i32),
                    "patch_embeds": spec((B, P, cfg.d_model), dt)}
        if cfg.modality == "audio":
            return {"frames": spec((B, S // 2, cfg.d_model), dt),
                    "tokens": spec((B, S // 2), i32),
                    "positions": spec((B, S // 2), i32)}
        return {"tokens": spec((B, S), i32), "positions": spec((B, S), i32)}
    return {"token": spec((B, 1), i32)}
