"""Dense gated FFN (SwiGLU): the port of ``init_ffn_params`` and
``ffn_forward`` of the JAX package's ``models/mlp.py``. The MoE layer waits
for its family (``ROADMAP.md``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


def init_ffn_params(gen: torch.Generator, d_model: int, d_ff: int, dtype, *,
                    device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), **kw),
        "w_up": dense_init(gen, (d_model, d_ff), **kw),
        "w_down": dense_init(gen, (d_ff, d_model), in_axis=0, **kw),
    }


def ffn_forward(params, x):
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
