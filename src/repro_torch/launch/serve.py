"""LM serving launcher, on the card by default: batched prefill, then a
token-decode loop for the whole batch.

The port of the JAX package's ``launch/serve.py`` (an LM demo, not the
paper's embedding workload; embedding retrieval serving is
``launch/embed_serve.py``). It takes the JAX launcher's flags and prints
its two lines. Prefill builds the ring-buffer caches with its attention
on the flash kernel (``kernels/csrc/flash_attention.cu``) wherever that
computes the JAX prefill's function (``models/attention.py`` says when:
self-attention, an encoder's attention, cross-attention, MLA's 192/128
heads); decode then serves one token per step.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --batch 2 --prompt-len 64 --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --batch 4 --prompt-len 2048 --tokens 32          # full width, card

``--reduced`` (the default, as in JAX, whose ``store_true`` flag with
``default=True`` cannot be switched off) cuts the arch to 2 layers of
width 256 (4 experts for a MoE arch); ``--no-reduced`` runs it at its full
width and depth, which must fit one device: the launcher raises before
allocating when the f32 weights alone exceed the device's memory
(deepseek-v3-671b: 2,687 GB, jamba-v0.1-52b: 206 GB, phi3.5-moe-42b-a6.6b:
167 GB, qwen2.5-32b: 131 GB), as those archs need a sharded init
(``sharding/`` shards a whole tree; ``ROADMAP.md``, Queue 1 item 5).
``serve.run`` takes any weights, so a
caller can serve such an arch at full width and a cut depth. MoE layers
take the dense oracle, as the JAX launcher serves without a mesh. A VLM's
prompt is ``synthetic_batch``'s patch embeddings, then its tokens; an
enc-dec arch's (seamless-m4t-large-v2) is its encoder frames and its
decoder tokens (``--prompt-len`` counts both, half each).
``--temperature 0`` is greedy decoding; a positive temperature samples as
the JAX launcher does, ``jax.random.categorical`` over ``PRNGKey(seed +
1)`` for the prompt's token, then over ``fold_in(key, i)`` after decode
step i (``repro_torch.prng``), so both packages sample the same tokens
from the same logits. The weights are random, from ``--seed``: JAX's
for the same seed. Every family runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_memory(dev: torch.device) -> int:
    """Bytes of memory of ``dev``: the card's, or the host's for the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def require_fit(arch: str, cfg, dev: torch.device) -> None:
    """Exit before allocating when ``cfg``'s f32 weights alone exceed
    ``dev``'s memory: such an arch needs a sharded init, which
    ``sharding/`` does not do yet (each rank makes the whole tree)."""
    from repro_torch.models import transformer as tfm

    need = 4 * tfm.param_count(cfg)
    have = device_memory(dev)
    if need > have:
        raise SystemExit(
            f"{arch}: {need / 1e9:.0f} GB of f32 weights exceed one "
            f"{dev.type} device ({have / 1e9:.0f} GB); running it at full "
            f"depth needs a sharded init (sharding/ shards a tree each rank "
            f"makes whole; ROADMAP.md, Queue 1 item 5): use --reduced")


def run(params, cfg, tokens, *, new_tokens: int, cache_len: int,
        temperature: float = 0.0, seed: int = 0, flash: bool = True,
        patch_embeds=None, frames=None) -> dict:
    """Prefill ``tokens`` (B, S), after a VLM's ``patch_embeds`` (B, P, d)
    when given, with an enc-dec arch's encoder ``frames`` (B, Se, d), and
    decode ``new_tokens`` tokens (the first from the prefill's logits).
    The entry the tests and ``chip_smoke.py`` call with their own weights;
    ``flash=False`` keeps the prefill on the masked attention route.

    Returns ``{"logits": prefill logits (B, 1, V) f32, "tokens": (B,
    new_tokens) int64 numpy, "prefill_s", "decode_s", "tok_per_s"}``.
    """
    from repro_torch import prng
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    dev = params["embed"].device
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if patch_embeds is not None:
        batch["patch_embeds"] = torch.as_tensor(patch_embeds, device=dev)
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames, device=dev)
    B = batch["tokens"].shape[0]
    prefill = make_prefill_step(cfg, cache_len, flash=flash)
    decode = make_decode_step(cfg)
    key = prng.key(seed + 1)

    def sample(logits, key):
        if temperature <= 0:
            return logits[:, 0].argmax(dim=-1)[:, None]
        t = torch.tensor(temperature, dtype=torch.float32, device=dev)
        return prng.categorical(key, logits[:, 0] / t)[:, None]

    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = sample(logits, key)
    outs = [tok.cpu()]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        step_logits, caches = decode(params, tok, caches)
        key = prng.fold_in(key, i)
        tok = sample(step_logits, key)
        outs.append(tok.cpu())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"logits": logits, "tokens": torch.cat(outs, 1).numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": (new_tokens - 1) * B / max(t_decode, 1e-9)}


def main(argv=None) -> dict:
    """Serve once; prints the JAX launcher's two lines and returns
    :func:`run`'s summary with ``arch`` and ``cache_len``."""
    from repro_torch import configs as cfgs
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.serve_step import cache_len_for
    from repro_torch.train.train_step import synthetic_batch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=cfgs.list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="2 layers of width 256, 4 experts (default); "
                         "--no-reduced runs the arch at full width and "
                         "depth, which must fit one device: an arch whose "
                         "f32 weights exceed it (deepseek-v3-671b 2,687 "
                         "GB, jamba-v0.1-52b 206 GB, phi3.5-moe-42b-a6.6b "
                         "167 GB, qwen2.5-32b 131 GB) needs a sharded "
                         "init (sharding/ shards a whole tree), and raises")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = cfgs.get_config(args.arch)
    if not isinstance(cfg, ModelConfig):
        ap.error(f"--arch {args.arch} is not an LM (see launch/train.py)")
    if args.reduced:
        cfg = cfg.reduced(layers=2, d_model=256, experts=4)
    if args.window:
        cfg = dataclasses.replace(cfg, sliding_window=args.window)
    tfm.check_family(cfg)
    dev = resolve_device(args.device)
    require_fit(args.arch, cfg, dev)

    params = tfm.init_params(cfg, seed=args.seed, device=dev)
    batch = synthetic_batch(cfg, args.batch, args.prompt_len, seed=args.seed)
    cache_len = cache_len_for(cfg, args.prompt_len + args.tokens + 8)
    r = run(params, cfg, batch["tokens"], new_tokens=args.tokens,
            cache_len=cache_len, temperature=args.temperature,
            seed=args.seed, patch_embeds=batch.get("patch_embeds"),
            frames=batch.get("frames"))
    print(f"{args.arch}: prefill {args.batch}x{args.prompt_len} "
          f"{r['prefill_s']*1e3:.1f}ms (first call) | decode "
          f"{r['tok_per_s']:.1f} tok/s")
    print("request 0:", r["tokens"][0][:24].tolist())
    return {**r, "arch": args.arch, "cache_len": cache_len}


if __name__ == "__main__":
    main(sys.argv[1:])
