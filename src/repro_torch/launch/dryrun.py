"""Multi-pod dry-run: trace every (arch x shape) as rank 0 of the
production meshes and record its memory, cost, collectives and roofline.

The port's counterpart of the JAX package's ``launch/dryrun.py``. JAX
lowers and compiles each step on 512 placeholder XLA devices; the port
runs each step once as rank 0 of a default group of 256 (16 x 16) or 512
(2 x 16 x 16) ranks on ``torch.distributed``'s ``fake`` backend
(``sharding/mesh.py::fake_world``), on tensors without storage (the
``meta`` device), under the op counter (``launch/op_cost.py``). It needs
no card and allocates and launches nothing; it is not a CPU fallback:
the steps take the card's routes (``launch/steps.py``). Its
numbers are counted, not measured. JAX's ``lower_s`` and ``compile_s``
are one ``trace_s`` here.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out FILE
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np

from repro_torch import configs as cfgs
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.steps import build_lm_step, build_step
from repro_torch.sharding.mesh import (PRODUCTION, Mesh, fake_world,
                                       make_production_mesh)


def trace_step(build, world_size: int, make_mesh):
    """Build a step with ``build(mesh)`` (a ``launch/steps.py`` builder)
    as rank 0 of a fake world of ``world_size`` ranks over the mesh
    ``make_mesh()`` makes, and count one run of it: ``(built, counts)``,
    counts as ``op_cost.analyze`` returns them with ``build_s``."""
    t0 = time.perf_counter()
    with fake_world(world_size):
        built = build(make_mesh())
        build_s = time.perf_counter() - t0
        counts = op_cost.analyze(built.fn, built.args, held=built.held)
    counts["build_s"] = build_s
    return built, counts


def record(arch, shape_name, mesh_shape, built, counts, mflops) -> dict:
    """One dry-run record, JAX's keys."""
    n_chips = int(np.prod(mesh_shape))
    flops, nbytes = counts["flops"], counts["bytes"]
    coll = counts["collectives"]
    terms = rl.roofline_terms(flops, nbytes, counts["groups"])
    arg = sum(built.arg_bytes.values())
    held = arg + built.replicated_bytes
    useful = mflops / (flops * n_chips) if flops else 0.0
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh_shape),
        "chips": n_chips,
        "trace_s": round(counts["build_s"] + counts["trace_s"], 1),
        "memory": {
            "argument_bytes": int(arg),
            "output_bytes": int(counts["output_bytes"]),
            "temp_bytes": int(counts["temp_bytes"]),
            # the global batch a port rank holds beyond its shard
            "replicated_batch_bytes": int(built.replicated_bytes),
            "peak_bytes": int(held + counts["temp_bytes"]),
            "argument_parts": dict(built.arg_bytes),
        },
        "cost": {"flops_per_device": flops,
                 "bytes_per_device": nbytes,
                 "bytes_are": "unfused upper bound",
                 "kernels": counts["kernels"]},
        "collectives": coll,
        "roofline": terms,
        "hardware": rl.HARDWARE,
        "model_flops": mflops,
        "useful_flops_ratio": round(useful, 4),
    }


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True) -> dict:
    mesh_shape = PRODUCTION[multi_pod][0]
    built, counts = trace_step(
        lambda mesh: build_step(arch, shape_name, mesh),
        int(np.prod(mesh_shape)),
        lambda: make_production_mesh(multi_pod=multi_pod))
    shape = SHAPES[shape_name]
    cfg = cfgs.get_config(arch)
    rec = record(arch, shape_name, mesh_shape, built, counts,
                 rl.model_flops(cfg, shape))
    if verbose:
        gb = 1 << 30
        t, m, c = rec["roofline"], rec["memory"], rec["collectives"]
        print(f"[{arch} x {shape_name} @ {'x'.join(map(str, mesh_shape))}] "
              f"trace {rec['trace_s']:.0f}s | "
              f"args {m['argument_bytes'] / gb:.2f}GiB "
              f"temp {m['temp_bytes'] / gb:.2f}GiB | "
              f"flops/dev {rec['cost']['flops_per_device']:.3e} "
              f"bytes/dev {rec['cost']['bytes_per_device']:.3e} "
              f"coll/dev {c['total']:.3e} over {t['links']} | dominant "
              f"{t['dominant']} (c={t['compute_s'] * 1e3:.2f}ms "
              f"m={t['memory_s'] * 1e3:.2f}ms "
              f"x={t['collective_s'] * 1e3:.2f}ms) "
              f"useful={rec['useful_flops_ratio']:.2%}", flush=True)
    return rec


def lm_record(cfg, shape: InputShape, mesh_shape, axes, *,
              dtype: str = "bfloat16", cache_len=None) -> dict:
    """The record of any LM config and shape on any mesh (``for_shape``
    at ``dtype``): the check that holds the dry-run against a step run on
    the card takes this."""
    built, counts = trace_step(
        lambda mesh: build_lm_step(cfg, shape, mesh, dtype=dtype,
                                   cache_len=cache_len),
        int(np.prod(mesh_shape)), lambda: Mesh(mesh_shape, axes))
    return record(cfg.name, shape.name, mesh_shape, built, counts,
                  rl.model_flops(cfg, shape))


LM_ARCHS = [a for a in cfgs.list_archs() if a != "tencent-embedding"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", default=None,
                    help="json file with records to skip")
    args = ap.parse_args(argv)

    pairs: list[tuple[str, str]] = []
    if args.all:
        pairs = [(a, s) for a in LM_ARCHS for s in SHAPES]
        pairs.append(("tencent-embedding", "train_4k"))
    else:
        pairs = [(args.arch, args.shape)]

    done = set()
    records = []
    if args.skip_existing and os.path.exists(args.skip_existing):
        with open(args.skip_existing) as f:
            records = json.load(f)
        done = {(r["arch"], r["shape"], tuple(r["mesh"])) for r in records}

    t0 = time.perf_counter()
    for arch, shape in pairs:
        mesh_shape = PRODUCTION[args.multi_pod][0]
        if (arch, shape, mesh_shape) in done:
            continue
        try:
            records.append(dryrun_one(arch, shape, multi_pod=args.multi_pod))
        except Exception:
            print(f"FAILED: {arch} x {shape}")
            traceback.print_exc()
            records.append({"arch": arch, "shape": shape,
                            "mesh": list(mesh_shape), "error":
                            traceback.format_exc().splitlines()[-1]})
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)

    failures = [r for r in records if "error" in r]
    print(f"\n{len(records) - len(failures)}/{len(records)} combinations "
          f"traced successfully in {time.perf_counter() - t0:.0f} s")
    if failures:
        for r in failures:
            print("  FAIL:", r["arch"], r["shape"], r["error"])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
