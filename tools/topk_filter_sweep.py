#!/usr/bin/env python3
"""Time the filter scans at the per-card serving shape against list length.

Prints, for the int8 first pass (``topk_mips_quant``, TPU kernel #2) at
m in {10, 20, 40} and the exact scan (``topk_mips``, #1) at k in {10, 40},
the device ms of one call and the (query, row) pairs its filter passed on
to the exact chain, on ``chip_smoke.py``'s per-card table (26,250,000 x
128 bf16 from its seed, quantized as the store does) and a batch of 256
queries near its rows; then the card's name and power limit. Each result
is checked bitwise against the plain version once. The times are CUDA
events around three calls after a warm-up (L2 warm), so they read below
``chip_smoke.py``'s cold-L2 profiler times. Needs one CUDA card:

    python3 tools/topk_filter_sweep.py
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.embed_serve import topk as tk
    from repro_torch.embed_serve.quant import quantize_rows

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    rows, dim = cs.SERVE_ROWS, cs.DIM
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    table = torch.empty((rows, dim), dtype=torch.bfloat16, device=dev)
    for lo in range(0, rows, 1 << 22):
        hi = min(lo + (1 << 22), rows)
        table[lo:hi] = torch.randn((hi - lo, dim), generator=g,
                                   device=dev).mul_(0.1)
    q8, sc = quantize_rows(table)
    pick = torch.randint(0, rows, (cs.BATCH,), generator=g, device=dev)
    q = table[pick].float() + 0.05 * torch.randn((cs.BATCH, dim),
                                                 generator=g, device=dev)

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    n = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [("topk_scan_int8", m,
             lambda m=m: tk.topk_mips_quant(q8, sc, q, m, survivors=n),
             lambda m=m: tk.topk_mips_quant_plain(q8, sc, q, m))
            for m in (10, 20, 40)]
    runs += [("topk_scan_exact", k,
              lambda k=k: tk.topk_mips(table, q, k, survivors=n),
              lambda k=k: tk.topk_mips_plain(table, q, k))
             for k in (10, 40)]
    for name, k, kernel, plain in runs:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name} k={k}: kernel != plain")
        print(f"{name} at {rows} x {dim}, Q={cs.BATCH}, k={k}: "
              f"{ms(kernel):.3f} ms (warm), {n.item()} pairs rescored "
              f"({100 * n.item() / (cs.BATCH * rows):.4f} %)")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
