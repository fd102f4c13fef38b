"""LM serving launcher, on the card by default: batched prefill, then a
token-decode loop for the whole batch.

The port of the JAX package's ``launch/serve.py`` (an LM demo, not the
paper's embedding workload; embedding retrieval serving is
``launch/embed_serve.py``). It takes the JAX launcher's flags and prints
its two lines. Prefill builds the ring-buffer caches with its attention
on the flash kernel (``kernels/csrc/flash_attention.cu``) wherever that
computes the JAX prefill's function (``models/attention.py`` says when);
decode then serves one token per step.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --batch 2 --prompt-len 64 --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --batch 4 --prompt-len 2048 --tokens 32          # full width, card

``--reduced`` (the default, as in JAX, whose ``store_true`` flag with
``default=True`` cannot be switched off) cuts the arch to 2 layers of
width 256; ``--no-reduced`` runs it at its full width. ``--temperature 0``
is greedy decoding, the parity path; a positive temperature samples from
a ``torch.Generator``, which cannot give ``jax.random``'s numbers. The
weights are random, from ``--seed``. Families other than dense raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(params, cfg, tokens, *, new_tokens: int, cache_len: int,
        temperature: float = 0.0, seed: int = 0, flash: bool = True) -> dict:
    """Prefill ``tokens`` (B, S) and decode ``new_tokens`` tokens (the first
    from the prefill's logits). The entry the tests and ``chip_smoke.py``
    call with their own weights; ``flash=False`` keeps the prefill on the
    masked attention route.

    Returns ``{"logits": prefill logits (B, 1, V) f32, "tokens": (B,
    new_tokens) int64 numpy, "prefill_s", "decode_s", "tok_per_s"}``.
    """
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    prefill = make_prefill_step(cfg, cache_len, flash=flash)
    decode = make_decode_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def sample(logits):
        if temperature <= 0:
            return logits[:, 0].argmax(dim=-1)[:, None]
        probs = torch.softmax(logits[:, 0] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = sample(logits)
    outs = [tok.cpu()]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        step_logits, caches = decode(params, tok, caches)
        tok = sample(step_logits)
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
                    help="2 layers of width 256 (default); --no-reduced "
                         "runs the arch at full width")
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

    params = tfm.init_params(cfg, seed=args.seed, device=dev)
    batch = synthetic_batch(cfg, args.batch, args.prompt_len, seed=args.seed)
    cache_len = cache_len_for(cfg, args.prompt_len + args.tokens + 8)
    r = run(params, cfg, batch["tokens"], new_tokens=args.tokens,
            cache_len=cache_len, temperature=args.temperature,
            seed=args.seed)
    print(f"{args.arch}: prefill {args.batch}x{args.prompt_len} "
          f"{r['prefill_s']*1e3:.1f}ms (first call) | decode "
          f"{r['tok_per_s']:.1f} tok/s")
    print("request 0:", r["tokens"][0][:24].tolist())
    return {**r, "arch": args.arch, "cache_len": cache_len}


if __name__ == "__main__":
    main(sys.argv[1:])
