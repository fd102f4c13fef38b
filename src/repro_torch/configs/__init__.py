"""Architecture registry: ``--arch <id>`` selection.

The port's counterpart of the JAX package's ``configs/__init__.py``. It
names every arch of the JAX registry, so a JAX command line parses
unchanged, and holds copies of the configs of the families the port runs:
the dense LMs, the MoE LM phi3.5-moe, the SSM mamba2, the hybrid jamba,
the VLM llava-next and the paper's embedding workload.
:func:`get_config` on an arch of a family not ported yet (MLA, enc-dec)
raises ``NotImplementedError``; ``ROADMAP.md`` Queue 1 item 1 lists
them.
"""
from __future__ import annotations

from repro_torch.configs import (granite_3_2b, jamba_v0_1_52b,
                                 llava_next_mistral_7b, mamba2_1_3b,
                                 phi3_5_moe_42b, qwen1_5_0_5b, qwen1_5_4b,
                                 qwen2_5_32b, tencent_embedding)

ARCHS = {
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "qwen2.5-32b": qwen2_5_32b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "granite-3-2b": granite_3_2b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "tencent-embedding": tencent_embedding.CONFIG,
}

# archs of the JAX registry whose family the port does not run yet
NOT_PORTED = {
    "deepseek-v3-671b": "MoE with MLA",
    "seamless-m4t-large-v2": "enc-dec (audio)",
}


def get_config(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r}: the {NOT_PORTED[name]} family is not ported to "
            f"PyTorch yet (ROADMAP.md, Queue 1 item 1)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted([*ARCHS, *NOT_PORTED])
