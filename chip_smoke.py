#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each printing its own lines; any
failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (all sources compiled in parallel);
2. every kernel against its plain PyTorch version on the card: integer
   tables (bitwise) at the JAX tests' shapes and at the full width
   d = 128, then a seeded continuous 26,250,000 x 128 bf16 table (one
   card's share of the paper's 1.05 B nodes over 40 GPUs) served through
   ``ShardedEmbeddingStore.topk``, exact and int8, checked at recall 1.0
   against the plain scan; kernel, plain and library times beside the
   bound;
3. the main path: a seeded 1,048,576 x 128 bf16 checkpoint written with
   the port's ``save_checkpoint`` and served by
   ``repro_torch.launch.embed_serve.main`` at recall 1.0, exact and int8,
   with every kernel's launch count read around the two runs; then every
   kernel against its plain version on that table and the launcher's own
   queries, at the shapes the launcher gives it;
4. a JSON line of per-kernel results, the card's line, and as the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
SERVE_ROWS = 26_250_000            # 1.05 B nodes over 40 GPUs, per card
CKPT_ROWS = 1 << 20
DIM = 128                          # configs/tencent_embedding.py
BATCH, K, BATCHES = 256, 10, 4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.embed_serve import topk as tk
    from repro_torch.embed_serve.quant import (DEFAULT_OVERFETCH,
                                               overfetch_m, quantize_rows,
                                               rescore_exact)
    from repro_torch.embed_serve.store import (ShardedEmbeddingStore,
                                               recall_at_k)
    from repro_torch.kernels import build
    from repro_torch.kernels import sgns
    from repro_torch.launch import embed_serve
    from repro_torch.train.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # ---------------------------------------------------------- phase 1
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()}")
    secs = build.build()
    print(f"built {sorted(build.SIGNATURES)} in {secs:.1f}s")
    for name in sorted(build.SIGNATURES):
        log = build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- phase 2
    g = torch.Generator(device="cpu").manual_seed(SEED)
    err = {"topk_scan_exact": 0.0, "topk_scan_int8": 0.0, "gather_rows": 0.0}

    def int_table(n, d, lo=-4, hi=5):
        return torch.randint(lo, hi, (n, d), generator=g).float().to(dev)

    def check_pair(kind, got, want, what):
        torch.cuda.synchronize()
        (gv, gi), (wv, wi) = got, want
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            bad = (gi != wi).any(dim=1).nonzero()[:3].flatten().tolist()
            raise AssertionError(f"{kind} {what}: kernel != plain "
                                 f"(first rows {bad})")
        diff = (gv - wv)[torch.isfinite(wv)]
        if diff.numel():
            err[kind] = max(err[kind], diff.abs().max().item())

    def check_exact(tbl, q, k, valid, what):
        check_pair("topk_scan_exact", tk.topk_mips(tbl, q, k, valid),
                   tk.topk_mips_plain(tbl, q, k, valid), what)

    def check_quant(tbl, q, m, valid, what):
        q8, sc = quantize_rows(tbl)
        check_pair("topk_scan_int8", tk.topk_mips_quant(q8, sc, q, m, valid),
                   tk.topk_mips_quant_plain(q8, sc, q, m, valid), what)

    def check_gather(tbl, idx, what):
        got = sgns.gather_rows(tbl, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, sgns.gather_rows_plain(tbl, idx)):
            raise AssertionError(f"gather_rows {what}: kernel != plain")

    def check_serving_shape(tbl, q8, sc, q, exact_plain, what):
        """Every kernel against its plain version at the shapes the serving
        path gives it: the exact scan, the int8 first pass (m survivors)
        and the gather of those survivors. Returns the gather's ids."""
        m = overfetch_m(K, DEFAULT_OVERFETCH, tbl.shape[0])
        check_pair("topk_scan_exact", tk.topk_mips(tbl, q, K), exact_plain,
                   f"{what} k={K}")
        cand = tk.topk_mips_quant(q8, sc, q, m)
        check_pair("topk_scan_int8", cand,
                   tk.topk_mips_quant_plain(q8, sc, q, m), f"{what} m={m}")
        gidx = cand[1].reshape(-1).contiguous()
        check_gather(tbl, gidx, f"{what} B={gidx.numel()}")
        return m, gidx

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for k, n, nq, d in ((1, 230, 17, 32), (10, 230, 17, 32),
                            (100, 130, 5, 32), (10, 1001, 37, DIM),
                            (100, 4099, 300, DIM)):
            tbl = int_table(n, d).to(dtype)
            q = int_table(nq, d)
            check_exact(tbl, q, k, n, f"{dtype} k={k} N={n} Q={nq} d={d}")
            check_exact(tbl, q, k, n - 3, f"{dtype} k={k} valid=N-3")
            cases += 2
        # heavy ties within tiles and across splits: 6 distinct rows
        base = int_table(6, DIM)
        pick = torch.randint(0, 6, (300_000,), generator=g).to(dev)
        tbl = base[pick].to(dtype)
        q = int_table(19, DIM)
        check_exact(tbl, q, 100, tbl.shape[0], f"{dtype} heavy ties")
        check_quant(tbl, q, 400, tbl.shape[0], f"{dtype} heavy ties m=400")
        cases += 2
    # rows >= valid never surface, even when their scores would win
    tbl = torch.full((64, 8), -2.0, device=dev)
    tbl[40:] = 0.0
    q = torch.ones((3, 8), device=dev)
    v, i = tk.topk_mips(tbl, q, 5, 40)
    torch.cuda.synchronize()
    assert int(i.max()) < 40, "padded rows returned"
    check_exact(tbl, q, 50, 40, "k > valid")
    cases += 2
    for m in (40, 400):
        for n, nq in ((5000, 37), (130, 5)):
            tbl = int_table(n, DIM)
            q = int_table(nq, DIM)
            check_quant(tbl, q, min(m, n), n, f"m={m} N={n} Q={nq}")
            check_quant(tbl, q, min(m, n - 7), n - 7, f"m={m} valid=N-7")
            cases += 2
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b in ((1000, DIM, 1001), (77, 20, 333), (5, 24, 7)):
            tbl = int_table(n, d).to(dtype)
            idx = torch.randint(0, n, (b,), generator=g).int().to(dev)
            check_gather(tbl, idx, f"{dtype} N={n} d={d} B={b}")
            cases += 1
    # the two-tier scan on the card equals the exact scan (integer data)
    tbl = int_table(4099, DIM).bfloat16()
    q = int_table(64, DIM)
    q8, sc = quantize_rows(tbl)
    _, ci = tk.topk_mips_quant(q8, sc, q, 40)
    got = rescore_exact(tbl, q, ci, 10)
    want = tk.topk_mips_plain(tbl, q, 10)
    check_pair("topk_scan_exact", got, want, "two-tier == exact")
    cases += 1
    print(f"kernels == plain on {cases} integer cases (bitwise)")

    # the per-card serving table, made on the card from a seed
    gd = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.empty((SERVE_ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for lo in range(0, SERVE_ROWS, 1 << 22):
        hi = min(lo + (1 << 22), SERVE_ROWS)
        table[lo:hi] = torch.randn((hi - lo, DIM), generator=gd,
                                   device=dev).mul_(0.1)
    t0 = time.perf_counter()
    store = ShardedEmbeddingStore.from_array(table, devices=[dev],
                                             keep_host_table=False,
                                             quant="int8")
    torch.cuda.synchronize()
    print(f"store: {SERVE_ROWS} x {DIM} bf16 + int8 tier on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    shard = store.shards[0]
    q8, sc = store.qshards[0]
    recalls = []
    for b in range(BATCHES):
        rows = torch.randint(0, SERVE_ROWS, (BATCH,), generator=gd,
                             device=dev)
        q = shard[rows].float() + 0.05 * torch.randn(
            (BATCH, DIM), generator=gd, device=dev)
        pv, pi = tk.topk_mips_plain(shard, q, K)
        for impl in ("exact", "quant"):
            gv, gi = store.topk(q, K, impl=impl)
            gi_t = torch.as_tensor(gi).to(dev).long()
            truth = (shard[gi_t].float() * q[:, None, :]).sum(2)
            r = recall_at_k(gi, pi.cpu().numpy(),
                            got_vals=truth.cpu().numpy(),
                            oracle_vals=pv.cpu().numpy())
            recalls.append(r)
            if impl == "exact":
                err["topk_scan_exact"] = max(
                    err["topk_scan_exact"],
                    (torch.as_tensor(gv).to(dev) - pv).abs().max().item())
            if r < 1.0:
                raise AssertionError(f"batch {b} {impl}: recall {r} < 1.0 "
                                     f"against the plain scan")
    print(f"{SERVE_ROWS}-row serving: recall@{K} vs plain on the card "
          f"{min(recalls)} (min of {len(recalls)} batch results)")

    # the last batch's inputs, checked kernel == plain and then timed
    m, gidx = check_serving_shape(shard, q8, sc, q, (pv, pi),
                                  f"{SERVE_ROWS} rows Q={BATCH}")
    print(f"{SERVE_ROWS}-row serving shape: exact scan, int8 scan (m={m}) "
          f"and gather (B={gidx.numel()}) == plain (bitwise)")

    # CUDA events around each launch, after a warm-up; L2 (50 MB) is
    # flushed before every launch, since the serving path finds the rows
    # the gather reads cold, just after a scan of gigabytes
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps):
        fn()
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps

    n_rows, Qn, d = SERVE_ROWS, BATCH, DIM
    results = []
    rec = {
        "topk_scan_exact": dict(
            source="src/repro_torch/kernels/csrc/topk_scan.cu",
            replaces="src/repro/embed_serve/topk.py:264",
            ms=time_ms(lambda: tk.topk_mips(shard, q, K), 5),
            plain_ms=time_ms(lambda: tk.topk_mips_plain(shard, q, K), 1),
            bound=bound_ms(n_rows * d * 2 + Qn * d * 4 + Qn * K * 8,
                           2.0 * Qn * n_rows * d)),
        "topk_scan_int8": dict(
            source="src/repro_torch/kernels/csrc/topk_scan.cu",
            replaces="src/repro/embed_serve/topk.py:300",
            ms=time_ms(lambda: tk.topk_mips_quant(q8, sc, q, m), 5),
            plain_ms=time_ms(
                lambda: tk.topk_mips_quant_plain(q8, sc, q, m), 1),
            bound=bound_ms(n_rows * (d + 4) + Qn * d * 4 + Qn * m * 8,
                           2.0 * Qn * n_rows * d + Qn * n_rows)),
        "gather_rows": dict(
            source="src/repro_torch/kernels/csrc/gather_rows.cu",
            replaces="src/repro/kernels/sgns.py:687",
            ms=time_ms(lambda: sgns.gather_rows(shard, gidx), 50),
            plain_ms=time_ms(lambda: sgns.gather_rows_plain(shard, gidx), 50),
            library_ms=time_ms(lambda: shard.index_select(0, gidx), 50),
            bound=bound_ms(gidx.numel() * (2 * d * 2 + 4), 0.0)),
    }
    tf = shard.float()
    rec["topk_scan_exact"]["library_ms"] = time_ms(
        lambda: torch.topk(q @ tf.T, K), 2)
    del tf
    torch.cuda.empty_cache()
    qf = q8.float()
    rec["topk_scan_int8"]["library_ms"] = time_ms(
        lambda: torch.topk((q @ qf.T) * sc, m), 2)
    del qf, table, store, shard, q8, sc
    torch.cuda.empty_cache()
    for name, r in rec.items():
        print(f"{name}: {r['ms']:.3f} ms/launch, bound {r['bound'][0]:.3f} "
              f"ms ({r['bound'][1]}), plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, max |kernel - plain| "
              f"{err[name]:.3g}")

    # ---------------------------------------------------------- phase 3
    gc = torch.Generator(device="cpu").manual_seed(SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "embeddings.npz")
        tables = {name: (0.1 * torch.randn((CKPT_ROWS, DIM), generator=gc)
                         ).bfloat16() for name in ("vertex", "context")}
        save_checkpoint(ckpt, tables, step=1)
        for counts in (tk.LAUNCHES, sgns.LAUNCHES):
            for name in counts:
                counts[name] = 0
        served = {}
        for extra in ([], ["--quant", "int8"]):
            served["int8" if extra else "exact"] = embed_serve.main(
                ["--ckpt", ckpt, "--k", str(K), "--queries", str(BATCH),
                 "--check-recall", "1.0", "--device", "cuda", *extra])
        launches = {**tk.LAUNCHES, **sgns.LAUNCHES}
        # the kernels against their plain versions on the main path's own
        # table and queries (the launcher's seed), at its padded batch
        main_store = ShardedEmbeddingStore.load(ckpt, devices=[dev],
                                                quant="int8")
        rows = np.random.default_rng(SEED).integers(0, CKPT_ROWS, BATCH)
        q = main_store.host_table[rows].float().to(dev)
        shard = main_store.shards[0]
        q8, sc = main_store.qshards[0]
        check_serving_shape(shard, q8, sc, q, tk.topk_mips_plain(shard, q, K),
                            f"{CKPT_ROWS} rows (main path) Q={BATCH}")
        del main_store, shard, q8, sc
    print(f"{CKPT_ROWS}-row main-path shape: exact scan, int8 scan and "
          f"gather == plain (bitwise)")
    for mode, s in served.items():
        print(f"main path {mode}: {s['qps']:.1f} QPS, p50 {s['p50_ms']:.2f} "
              f"ms, p99 {s['p99_ms']:.2f} ms, recall {s['recall']:.4f}, "
              f"{s['batches']} batches")
    print(f"main-path launches: {launches}")
    missing = [n for n in rec if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # ---------------------------------------------------------- phase 4
    for name, r in rec.items():
        results.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(f"kernels: {', '.join(rec)} (total run "
          f"{time.perf_counter() - t_start:.1f}s)")
    print(json.dumps({"kernels": results}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
