#!/usr/bin/env python3
"""How far one f32 rounding of seamless-m4t-large-v2's weights moves its
logits, on one CUDA card.

At full width cut to 2 encoder and 2 decoder layers, on ``chip_smoke.py``'s
batch (4 rows of 1,024 frames and 1,024 tokens, seed 0), the full forward's
last-token logits are taken over the prompt and over the prompt extended
by its greedy next token. Every weight is then moved by seeded normal
noise of relative size 1e-7 (seeds 1 and 2) and the forward is run again.
Prints the largest absolute change of the logits over each, the numbers
``chip_smoke.py``'s ``SEAMLESS_LOGIT_ATOL`` holds the routes to, and the
largest |score| of layer 0's encoder self-attention.

    python3 tools/seamless_spread.py
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import attention as lm_attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import rms_norm, tree_map
    from repro_torch.train.train_step import synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print("card:", cs.card_line())
    cfg = dataclasses.replace(get_config(cs.SEAMLESS_ARCH), num_layers=2,
                              encoder_layers=2)
    params = tfm.init_params(cfg, seed=cs.SEED, device=dev)
    batch = synthetic_batch(cfg, cs.SEAMLESS_B, cs.SEAMLESS_S, seed=cs.SEED)
    frames = torch.as_tensor(batch["frames"], device=dev)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    full_p = cs.encdec_last_logits(torch, tfm, params, frames, toks, cfg)
    ext = torch.cat([toks, full_p[:, 0].argmax(-1)[:, None]], 1)
    full_d = cs.encdec_last_logits(torch, tfm, params, frames, ext, cfg)
    spread = {"prompt": 0.0, "extended": 0.0}
    for seed in (1, 2):
        g = torch.Generator(device=dev).manual_seed(seed)
        nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=g, device=dev)), params)
        for name, tokens, base in (("prompt", toks, full_p),
                                   ("extended", ext, full_d)):
            moved = (cs.encdec_last_logits(torch, tfm, nudged, frames,
                                           tokens, cfg) - base).abs().max()
            spread[name] = max(spread[name], moved.item())
        del nudged
    pe = params["enc_layers"][0]
    S = frames.shape[1]
    pos = torch.arange(S, device=dev).expand(frames.shape[0], S)
    with torch.no_grad():
        q, k, _ = lm_attn._qkv(pe["attn"], rms_norm(frames, pe["ln1"],
                                                     cfg.norm_eps), pos, cfg)
        score = torch.einsum("qhd,khd->hqk", q[0], k[0]) / q.shape[-1] ** 0.5
    print(f"{cs.SEAMLESS_ARCH} full width, 2 + 2 layers: one rounding of "
          f"the weights moves the last logits by {spread['prompt']:.4g} "
          f"(prompt) and {spread['extended']:.4g} (extended prompt); layer "
          f"0's encoder scores: "
          f"std {score.std().item():.4g}, max |score| "
          f"{score.abs().max().item():.4g}")


if __name__ == "__main__":
    main()
