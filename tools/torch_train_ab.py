#!/usr/bin/env python3
"""Training rates of one source tree of the PyTorch port, on one CUDA card.

Prints one line: the per-card training edges/s of ``chip_smoke.py``'s
per-card shape (two 26,250,000 x 128 f32 tables, Zipf(1.1) ids, minibatch
256, 5 negatives) on each route named after the tree (default: the
default route ``pallas_fused2``), as five windows of three episodes after
a warm-up episode, and the edges/s and AUC of the training launcher on
``chip_smoke.py``'s CI-gate schedule. The tree's ``src`` directory is the
first argument, so two commits can be compared in one call, in turns:

    git archive <parent> src | tar -x -C tmp_parent   # a git-ignored dir
    for t in tmp_parent/src src src tmp_parent/src; do
        python3 tools/torch_train_ab.py $t [pallas pallas_fused ...]
    done

Run it from the root of the checkout (it reads ``chip_smoke.py``'s shapes).
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(src: str, routes=("pallas_fused2",)) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs.tencent_embedding import CONFIG
    from repro_torch.core import HybridConfig, HybridEmbeddingTrainer
    from repro_torch.core.partition import build_episode_blocks
    from repro_torch.launch import train as train_launcher

    dev = torch.device("cuda:0")
    rows, dim = cs.SERVE_ROWS, cs.DIM
    cfg = HybridConfig(dim=CONFIG.dim, lr=CONFIG.lr,
                       negatives=CONFIG.negatives,
                       minibatch=CONFIG.minibatch, subparts=CONFIG.subparts,
                       neg_pool=CONFIG.neg_pool, seed=cs.SEED,
                       dtype=CONFIG.dtype)
    gd = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    tables = []
    for _ in range(2):
        t = torch.empty((rows, dim), dtype=torch.float32, device=dev)
        for lo in range(0, rows, 1 << 22):
            hi = min(lo + (1 << 22), rows)
            t[lo:hi] = torch.randn((hi - lo, dim), generator=gd,
                                   device=dev).mul_(0.1)
        tables.append(t)
    trainer = HybridEmbeddingTrainer(rows, cfg, device=dev)
    trainer.set_embeddings(*tables)
    del tables
    rng = np.random.default_rng(cs.SEED + 3)
    perm = rng.permutation(rows).astype(np.int64)
    ranks = (rng.zipf(1.1, size=(2 * cfg.subparts * CONFIG.block_cap, 2))
             - 1) % rows
    staged = trainer.stage_blocks(build_episode_blocks(
        perm[ranks], trainer.part, block_cap=CONFIG.block_cap,
        pad_multiple=cfg.minibatch))
    medians = {}
    for impl in routes:
        trainer.cfg = dataclasses.replace(cfg, impl=impl)
        trainer.train_episode(staged)
        rates = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_episode(staged)
            rates.append(staged.num_samples * 3 / (time.perf_counter() - t0))
        medians[impl] = (f"{impl} {[round(x) for x in rates]}, median "
                         f"{np.median(rates):.0f}")
    del trainer, staged
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        r = train_launcher.main([*cs.CI_GATE, "--out-dir", tmp,
                                 "--device", "cuda"])
    print(f"{repro_torch.__file__}: per-card edges/s "
          f"{'; '.join(medians.values())} | "
          f"CI gate {r['edges_per_s']:.0f} edges/s, AUC {r['auc']:.4f}",
          flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1], tuple(sys.argv[2:]) or ("pallas_fused2",))
