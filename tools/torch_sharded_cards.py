#!/usr/bin/env python3
"""``chip_smoke.py``'s sharded phases (12b, 12c) on N cards, a rank a card.

    python3 tools/torch_sharded_cards.py 4

Builds the flash kernel, then runs phase 12b (phi3.5-moe at full width
and 2 layers through the training launcher, one Adafactor step against
the one-process plan of the same (1, N) mesh) and 12c (granite-3-2b's
sharded serve steps against one rank) with ``--device cuda``: each rank
on its own card, ``nccl``. Needs N cards of one host.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(ranks: int) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if torch.cuda.device_count() < ranks:
        raise SystemExit(f"{ranks} ranks need {ranks} cards; "
                         f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(f"card: {cs.card_line()} x {torch.cuda.device_count()}",
          flush=True)
    print(f"built flash_attention in {build.build(('flash_attention',)):.1f}"
          f" s", flush=True)
    t = time.perf_counter()
    cs.sharded_train(torch, dev, ranks=ranks, device="cuda")
    print(f"12b on {ranks} cards: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    cs.sharded_serve(torch, dev, {"flash_attention": {}}, ranks=ranks,
                     device="cuda")
    print(f"12c on {ranks} cards: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
