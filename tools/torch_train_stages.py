#!/usr/bin/env python3
"""The training launcher's host stages at the config geometry, on one card.

Runs ``repro_torch.launch.train`` on ``chip_smoke.py``'s ``CONFIG_RUN``
(a 262,144-node power-law graph, d = 128, minibatch 256, 5 negatives, 4
sub-parts, f32, one epoch of 4 episodes) once per leg named on the command
line, in that order, after building the kernels, and prints one line per run: the leg, its edges/s and
mean episode seconds, and with telemetry on the p50 and p99 of each host
stage from ``metrics_summary.json`` (``chip_smoke.HOST_STAGES``). Legs:

    memory      --store memory, telemetry off (phase 7's run)
    memory+obs  --store memory with --metrics-dir and --trace
    disk        --store disk, telemetry off
    disk+obs    --store disk with --metrics-dir and --trace (phase 7b's)
    tiered      --store memory with --hbm-rows (chip_smoke.CONFIG_HBM_ROWS,
                phase 7c's), telemetry off
    tiered+obs  the same with --metrics-dir and --trace

Give the legs in turns, so that drift from run to run shows, e.g.

    python3 tools/torch_train_stages.py memory disk+obs disk+obs memory \\
        memory+obs disk

Run it from the root of the checkout (it reads ``chip_smoke.py``'s shapes).
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LEGS = ("memory", "memory+obs", "disk", "disk+obs", "tiered",
        "tiered+obs")


def run_leg(leg: str, tmp: str) -> str:
    import chip_smoke as cs
    from repro_torch.launch import train as train_launcher

    store, _, obs = leg.partition("+")
    tiered = store == "tiered"
    argv = [*cs.CONFIG_RUN, "--out-dir", tmp, "--device", "cuda",
            "--store", "memory" if tiered else store]
    if tiered:
        argv += ["--hbm-rows", str(cs.CONFIG_HBM_ROWS)]
    mdir = Path(tmp) / "metrics"
    if obs:
        argv += ["--metrics-dir", str(mdir), "--trace",
                 str(Path(tmp) / "trace.json")]
    r = train_launcher.main(argv)
    line = (f"{leg}: {r['edges_per_s']:.1f} edges/s, mean episode "
            f"{r['episode_s']:.4f} s")
    if tiered:
        line += f"; {cs._cache_line(r['cache'])}"
    if obs:
        hists = json.loads((mdir / "metrics_summary.json")
                           .read_text())["histograms"]
        line += "; " + "; ".join(
            f"{name} n {hists[name]['count']} p50 "
            f"{1e3 * hists[name]['p50']:.3f} p99 "
            f"{1e3 * hists[name]['p99']:.3f} ms"
            for name in cs.HOST_STAGES)
    return line


def main(legs) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    bad = [leg for leg in legs if leg not in LEGS]
    if bad:
        sys.exit(f"unknown legs {bad}; one of {LEGS}")
    print(f"card: {cs.card_line()}", flush=True)
    # the kernels build at their first launch: build them first, or the
    # first leg's episodes hold the compile
    print(f"built the kernels in {build.build():.1f}s", flush=True)
    lines = []
    for leg in legs:
        with tempfile.TemporaryDirectory() as tmp:
            lines.append(run_leg(leg, tmp))
    for line in lines:
        print(line, flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
