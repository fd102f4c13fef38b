#!/usr/bin/env python3
"""``kernels/csrc/threefry.cu`` alone on one CUDA card: its build report,
both entry points against their plain versions at ``chip_smoke.py``'s
shapes (``check_threefry``), and their times with CUDA events
(``time_threefry``'s records and bounds), then ``negative_positions`` at
longer chains. A short first call after editing the kernel:

    python3 tools/threefry_card.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch.kernels import build

    print(cs.card_line())
    print(f"built in {build.build(('threefry',)):.1f}s")
    log = build.library_path("threefry").with_suffix(".log").read_text()
    for fn, regs, st, ld in cs.ptxas_report(log):
        print(f"  ptxas {fn[:70]}: {regs} registers, {st} + {ld} bytes "
              f"spilled")
    dev = torch.device("cuda:0")
    err = {"fill_random": 0.0, "negative_positions": 0.0}
    t0 = time.perf_counter()
    cases = cs.check_threefry(torch, prng, dev, err)
    print(f"{cases} cases == plain in {time.perf_counter() - t0:.1f}s; max "
          f"|kernel - plain| {err}")

    def event_ms(fn, reps):
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

    cs.time_threefry(torch, prng, dev, event_ms, event_ms)
    _, S, pool_n = cs.episode_stream_shape()
    for T in (1024, 8192):
        ms = event_ms(lambda: prng.negative_positions(
            prng.key(1), T, S, pool_n, device=dev), 10)
        print(f"negative_positions T={T}: {ms:.4f} ms")


if __name__ == "__main__":
    main()
