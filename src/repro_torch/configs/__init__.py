"""Architecture registry: ``--arch <id>`` selection.

The port's counterpart of the JAX package's ``configs/__init__.py``. It
holds copies of every config of the JAX registry, so a JAX command line
parses unchanged: the dense LMs, the MoE LMs phi3.5-moe and deepseek-v3
(MLA, MTP), the SSM mamba2, the hybrid jamba, the VLM llava-next, the
enc-dec seamless-m4t and the paper's embedding workload. Every family
runs; an arch too large for one device at full depth (deepseek-v3,
jamba, phi3.5-moe) needs a sharded init (``sharding/`` shards a tree each
rank first makes whole; ``ROADMAP.md``, Queue 1 item 5), which the
launchers say before they allocate.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, granite_3_2b,
                                 jamba_v0_1_52b, llava_next_mistral_7b,
                                 mamba2_1_3b, phi3_5_moe_42b, qwen1_5_0_5b,
                                 qwen1_5_4b, qwen2_5_32b,
                                 seamless_m4t_large_v2, tencent_embedding)

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
