"""Architecture registry: ``--arch <id>`` selection.

The port's counterpart of the JAX package's ``configs/__init__.py``. It
names every arch of the JAX registry, so a JAX command line parses
unchanged, and holds copies of the configs of the families the port runs:
the dense LMs and the paper's embedding workload. :func:`get_config` on an
arch of a family not ported yet (MoE, MLA, SSM, hybrid, enc-dec, VLM)
raises ``NotImplementedError``; ``ROADMAP.md`` Queue 1 item 8 lists them.
"""
from __future__ import annotations

from repro_torch.configs import (granite_3_2b, qwen1_5_0_5b, qwen1_5_4b,
                                 qwen2_5_32b, tencent_embedding)

ARCHS = {
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "qwen2.5-32b": qwen2_5_32b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "granite-3-2b": granite_3_2b.CONFIG,
    "tencent-embedding": tencent_embedding.CONFIG,
}

# archs of the JAX registry whose family the port does not run yet
NOT_PORTED = {
    "jamba-v0.1-52b": "hybrid (attention + Mamba, MoE)",
    "deepseek-v3-671b": "MoE with MLA",
    "llava-next-mistral-7b": "VLM",
    "mamba2-1.3b": "SSM",
    "seamless-m4t-large-v2": "enc-dec (audio)",
    "phi3.5-moe-42b-a6.6b": "MoE",
}


def get_config(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r}: the {NOT_PORTED[name]} family is not ported to "
            f"PyTorch yet (ROADMAP.md, Queue 1 item 8)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted([*ARCHS, *NOT_PORTED])
