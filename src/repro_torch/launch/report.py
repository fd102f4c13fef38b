"""Render the dry-run's records as markdown tables.

A copy of the JAX package's ``launch/report.py`` for the port's records
(``launch/dryrun.py``; JAX's records render too: their ``lower_s +
compile_s`` stand in the time column). The port's numbers are counted on
``meta`` tensors, not measured; the roofline is the H100 SXM5 model of
``launch/roofline.py`` (spec, not measured).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR]
[--section all|dryrun|roofline|combined] reads DIR/dryrun_single.json and
DIR/dryrun_multipod.json and prints markdown to stdout; ``combined`` puts
both meshes in one table, one row a pair (as ``PERF.md`` holds them).
"""
from __future__ import annotations

import argparse
import json
import os

GB = 1 << 30


def _fmt_bytes(b):
    return f"{b / GB:.2f}"


def _seconds(r) -> float:
    if "trace_s" in r:
        return r["trace_s"]
    return r.get("lower_s", 0.0) + r.get("compile_s", 0.0)


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | trace s | args GiB/dev | temp GiB/dev | "
        "peak GiB/dev | flops/dev | bytes/dev | coll B/dev | top collective |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | "
                         f"{'x'.join(map(str, r['mesh']))} | FAIL ||||||| "
                         f"{r['error'][:40]} |")
            continue
        coll = r["collectives"]
        top = max((k for k in coll if k != "total"), key=lambda k: coll[k])
        lines.append(
            f"| {r['arch']} | {r['shape']} | {'x'.join(map(str, r['mesh']))} "
            f"| {_seconds(r):.0f} "
            f"| {_fmt_bytes(r['memory']['argument_bytes'])} "
            f"| {_fmt_bytes(r['memory']['temp_bytes'])} "
            f"| {_fmt_bytes(r['memory']['peak_bytes'])} "
            f"| {r['cost']['flops_per_device']:.2e} "
            f"| {r['cost']['bytes_per_device']:.2e} "
            f"| {coll['total']:.2e} | {top} ({coll[top]:.1e}) |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | compute ms | memory ms | collective ms (links) "
        "| dominant | MODEL_FLOPS | useful ratio | what would move the "
        "dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if "error" in r:
            continue
        t = r["roofline"]
        links = f" ({t['links']})" if "links" in t else ""
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s'] * 1e3:.2f} "
            f"| {t['memory_s'] * 1e3:.2f} | {t['collective_s'] * 1e3:.2f}"
            f"{links} | **{t['dominant']}** | {r['model_flops']:.2e} "
            f"| {r['useful_flops_ratio']:.2f} | {_hint(r)} |")
    return "\n".join(lines)


def combined_table(single, multi) -> str:
    """One row a pair: the dry-run's numbers on 16 x 16 / 2 x 16 x 16 side
    by side, then the 16 x 16 roofline."""
    other = {(r["arch"], r["shape"]): r for r in multi}
    lines = [
        "| arch | shape | trace s | args GiB/dev | temp GiB/dev | peak GiB/dev "
        "| flops/dev | coll B/dev (top at 16x16) | compute / memory / "
        "collective ms (links) | dominant | useful |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def both(a, b, fmt):
        return " / ".join("FAIL" if "error" in x else fmt(x) for x in (a, b))

    cells = (lambda x: f"{_seconds(x):.0f}",
             lambda x: _fmt_bytes(x["memory"]["argument_bytes"]),
             lambda x: _fmt_bytes(x["memory"]["temp_bytes"]),
             lambda x: _fmt_bytes(x["memory"]["peak_bytes"]),
             lambda x: f"{x['cost']['flops_per_device']:.2e}",
             lambda x: f"{x['collectives']['total']:.2e}")
    for r in sorted(single, key=lambda r: (r["arch"], r["shape"])):
        m = other.get((r["arch"], r["shape"]), {"error": "missing"})
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | FAIL ||||||||| ")
            continue
        coll, t = r["collectives"], r["roofline"]
        top = max((k for k in coll if k != "total"), key=lambda k: coll[k])
        lines.append(
            f"| {r['arch']} | {r['shape']} | "
            + " | ".join(both(r, m, fmt) for fmt in cells)
            + f" ({top}) | {t['compute_s'] * 1e3:.2f} / "
            f"{t['memory_s'] * 1e3:.2f} / {t['collective_s'] * 1e3:.2f} "
            f"({t['links']}) | **{t['dominant']}** "
            f"| {r['useful_flops_ratio']:.2f} |")
    return "\n".join(lines)


def _hint(r) -> str:
    dom = r["roofline"]["dominant"]
    shape = r["shape"]
    if dom == "memory":
        if shape in ("train_4k", "prefill_32k"):
            return ("avoid materialized f32 masks/activations; bf16 "
                    "end-to-end; fuse softmax path")
        return "shard the KV cache wider; reduce f32 staging"
    if dom == "collective":
        return ("resharding between layers — tighten param/activation "
                "specs; overlap a2a with expert compute")
    return "tensor-core-align tile shapes; raise arithmetic intensity"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "combined"])
    args = ap.parse_args(argv)
    if args.section == "combined":
        recs = []
        for fname in ("dryrun_single.json", "dryrun_multipod.json"):
            with open(os.path.join(args.dir, fname)) as f:
                recs.append(json.load(f))
        ok = [sum("error" not in r for r in rs) for rs in recs]
        print(f"\n### Dry-run — 16x16 (256 ranks) / 2x16x16 (512 ranks): "
              f"{ok[0]}/{len(recs[0])} / {ok[1]}/{len(recs[1])} pass\n")
        print(combined_table(*recs))
        return
    for fname, tag in (("dryrun_single.json", "single-pod 16x16 (256 ranks)"),
                       ("dryrun_multipod.json",
                        "multi-pod 2x16x16 (512 ranks)")):
        path = os.path.join(args.dir, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            recs = json.load(f)
        ok = sum("error" not in r for r in recs)
        if args.section in ("all", "dryrun"):
            print(f"\n### Dry-run — {tag}: {ok}/{len(recs)} pass\n")
            print(dryrun_table(recs))
        if args.section in ("all", "roofline") and "single" in fname:
            print(f"\n### Roofline — {tag}\n")
            print(roofline_table(recs))


if __name__ == "__main__":
    main()
