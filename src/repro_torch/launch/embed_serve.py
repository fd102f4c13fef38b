"""Embedding retrieval serving launcher, on the card by default.

The port of the JAX package's ``launch/embed_serve.py``, with every one of
its flags: loads one table of a trainer checkpoint into the sharded store,
stands up the micro-batcher, drives a seeded open-loop query stream at
``--qps``, and reports achieved QPS, request-latency percentiles and
recall@k against the numpy oracle.

    PYTHONPATH=src python -m repro_torch.launch.embed_serve \\
        --ckpt embeddings.npz --k 10 --queries 256 --qps 1000 \\
        --check-recall 1.0

``--device cuda`` (the default) serves through the CUDA kernels and fails
if there is no card; ``--device cpu`` serves through their plain versions.
``--check-recall`` makes the run a gate (exit 1 below the threshold).
``--impl`` takes the JAX store's route names (``rowwise`` is the
scan's reference kernel, ``topk_rowwise``). ``--quant int8`` builds the int8 tier and (with
``--impl auto``) serves through the two-tier scan; ``--hot-rows N`` puts an
exact hot tier of the stream's N most requested rows in front of a
compacted int8 cold remainder (``impl="tiered"``).

Shards: ``--device cuda`` (no index) puts one shard on each visible card,
as the JAX launcher spreads them over every device it sees; ``--shards N``
cycles N shards over the cards (``cuda:(i % count)``); an explicit
``cuda:N`` or ``cpu`` holds every shard. Degraded mode: ``--shards N`` on
one card, ``--shard-timeout-ms`` bounds each shard's scan, and ``--inject
"serve.shard:delay:key=1:..."`` makes a shard miss it; the recall gate then
scores against the surviving-shards oracle, and ``--expect-degraded``
fails the run unless some response was degraded. ``--metrics-dir`` and
``--trace`` switch the telemetry on.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> dict:
    """Run the server once; returns ``{"qps", "p50_ms", "p99_ms",
    "recall", "batches", "wall_s", "degraded", "failed_shards"}``."""
    from repro_torch.embed_serve import (QUERY_IMPLS, MicroBatcher,
                                         ShardedEmbeddingStore,
                                         drive_open_loop, recall_at_k)
    from repro_torch.embed_serve import quant as qz

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="trainer embedding checkpoint (.npz)")
    ap.add_argument("--table", default="vertex", choices=["vertex", "context"])
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=256,
                    help="number of requests in the seeded stream")
    ap.add_argument("--qps", type=float, default=1000.0,
                    help="open-loop request rate (0 = submit all at once)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=256,
                    help="backend batch rows; every call is padded to this "
                         "(one shape, warmed up before the clock)")
    ap.add_argument("--impl", default="auto", choices=list(QUERY_IMPLS),
                    help="shard top-k route (auto: the CUDA scan on a card, "
                         "the plain scan on the CPU; rowwise: the "
                         "scan's reference kernel; xla / quant_xla: the plain "
                         "versions on the shard's device; quant* need "
                         "--quant int8; tiered needs --hot-rows)")
    ap.add_argument("--hot-rows", type=int, default=None,
                    help="exact hot-tier budget per store (rows); ranks the "
                         "request stream's query log, requires --quant int8 "
                         "and routes --impl auto to the tiered scan")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="build the int8 tier at load; with --impl auto "
                         "this also routes queries through the two-tier "
                         "scan (int8 first pass + exact rescore)")
    ap.add_argument("--overfetch", type=float, default=None,
                    help="tier-one candidate margin m = ceil(k * overfetch) "
                         "for the quant path (default "
                         f"{qz.DEFAULT_OVERFETCH:g})")
    ap.add_argument("--metric", default="dot", choices=["dot", "cosine"],
                    help="cosine normalizes table rows at load and query "
                         "vectors at submit; same MIPS scan either way")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="N(0, noise) perturbation of the sampled query rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-recall", type=float, default=None,
                    help="exit 1 if recall@k vs the oracle is below this "
                         "(the surviving-shards oracle when shards failed)")
    ap.add_argument("--shards", type=int, default=None,
                    help="lay the table out over N shards, cycling the "
                         "visible cards for --device cuda, else all on "
                         "--device (default: one a card; degraded-mode "
                         "testing on one card)")
    ap.add_argument("--shard-timeout-ms", type=float, default=None,
                    help="per-shard scan deadline; shards that miss it are "
                         "dropped from the merge and the response is tagged "
                         "degraded (default: wait forever)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request admission deadline in the batcher; an "
                         "expired request fails with DeadlineExceeded "
                         "instead of being served late")
    ap.add_argument("--inject", action="append", default=[], metavar="SPEC",
                    help="deterministic fault spec, repeatable, e.g. "
                         "serve.shard:delay:key=1:delay=1.0:times=inf "
                         "(see repro_torch.runtime.faults)")
    ap.add_argument("--expect-degraded", action="store_true",
                    help="exit 1 unless at least one response was actually "
                         "degraded (guards the chaos leg against a fault "
                         "plan that silently never fired)")
    ap.add_argument("--metrics-dir", default=None,
                    help="enable the telemetry registry and append periodic "
                         "snapshots to DIR/metrics.jsonl (+ final "
                         "metrics_summary.json at exit)")
    ap.add_argument("--metrics-interval-s", type=float, default=5.0,
                    help="seconds between metrics.jsonl snapshots")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record serve_batch spans + queue-depth counter "
                         "track as Chrome trace-event JSON (ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="shard devices: cuda (every visible card), cuda:N "
                         "or cpu")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.device import shard_devices
    from repro_torch.runtime import FaultPlan, clear_plan, install_plan

    quant = None if args.quant == "none" else args.quant
    impl = args.impl
    if quant and impl == "auto":
        impl = "quant"            # the tier was built to be used
    if args.hot_rows is not None:
        if not quant:
            ap.error("--hot-rows requires --quant int8 (the cold tier)")
        if impl in ("auto", "quant"):
            impl = "tiered"       # ditto for the hot tier
    if impl == "tiered" and args.hot_rows is None:
        ap.error("--impl tiered requires --hot-rows")
    if impl.startswith("quant") and not quant:
        ap.error(f"--impl {impl} requires --quant int8")
    if args.overfetch is not None and not quant:
        # silently serving the exact path would let a recall-gate run
        # "validate" an overfetch margin that was never exercised
        ap.error("--overfetch requires --quant int8")

    writer = obs_tracer = None
    if args.metrics_dir or args.trace:
        reg = obs.enable()
        if args.trace:
            obs_tracer = obs.Tracer()
            obs.set_tracer(obs_tracer)
        if args.metrics_dir:
            writer = obs.MetricsWriter(reg, args.metrics_dir,
                                       interval_s=args.metrics_interval_s)
            print(f"metrics -> {writer.path}")

    shard_timeout_s = (None if args.shard_timeout_ms is None
                       else args.shard_timeout_ms / 1e3)
    store = ShardedEmbeddingStore.load(
        args.ckpt, table=args.table, normalize=args.metric == "cosine",
        quant=quant, devices=shard_devices(args.device, args.shards),
        shard_timeout_s=shard_timeout_s,
        overfetch=(qz.DEFAULT_OVERFETCH if args.overfetch is None
                   else args.overfetch))
    tier = f", int8 tier (overfetch {store.overfetch:g})" if quant else ""
    print(f"loaded {args.table} table: {store.num_nodes} x {store.dim} "
          f"{store.host_table.dtype} over {len(store.shards)} shard(s) on "
          f"{', '.join(sorted({str(d) for d in store.devices}))} (step "
          f"{store.step}){tier}")

    plan = None
    if args.inject:
        plan = FaultPlan(args.inject)
        install_plan(plan)
        print(f"fault plan: {args.inject}")

    rng = np.random.default_rng(args.seed)
    rows = rng.integers(0, store.num_nodes, size=args.queries)
    if args.hot_rows is not None:
        # the request stream IS the query log: rank the hot set by it
        n_hot = store.enable_hot_tier(
            args.hot_rows,
            counts=np.bincount(rows, minlength=store.num_nodes)
                     .astype(np.float64))
        print(f"hot tier: {n_hot} exact rows + compacted int8 cold "
              f"remainder per shard")
    queries = store.host_table[rows].float().numpy()
    if args.noise:
        queries = queries + rng.normal(0, args.noise, queries.shape)
    if args.metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12
    queries = queries.astype(np.float32)

    degraded_meta = args.shard_timeout_ms is not None

    def serve_fn(q):
        # with a shard deadline, request the TopKMeta so the batcher can tag
        # every response of a degraded batch
        return store.topk(q, args.k, impl=impl, return_meta=degraded_meta)

    # every backend call is padded to max_batch rows (fixed_batch); the
    # first call builds the kernels, so it runs here, before the clock
    # starts, with the fault layer suppressed (a times-bounded spec must not
    # be spent on it) and no shard deadline (the build outlasts any sane
    # timeout; a healthy store must not warm up degraded)
    if plan is not None:
        clear_plan()
    store.topk(np.zeros((args.max_batch, store.dim), np.float32), args.k,
               impl=impl, shard_timeout_s=None, return_meta=degraded_meta)
    if plan is not None:
        install_plan(plan)
    batcher = MicroBatcher(serve_fn, store.dim, max_batch=args.max_batch,
                           window_ms=args.batch_window_ms, fixed_batch=True,
                           deadline_ms=args.deadline_ms)
    try:
        results, lat, wall = drive_open_loop(batcher, queries, qps=args.qps,
                                             timeout=120)
    finally:
        batcher.close()
        if plan is not None:
            clear_plan()
        if writer is not None:
            writer.close()
            print(f"metrics summary -> {writer.summary_path}")
        if obs_tracer is not None:
            obs.set_tracer(None)
            obs_tracer.save(args.trace)
            print(f"trace -> {args.trace} ({obs_tracer.event_count()} "
                  f"events)")
        if writer is not None or obs_tracer is not None:
            obs.disable()

    # results are (vals, ids) or (vals, ids, meta); union the failed shards
    # so the gate scores against what was actually answerable
    got_ids = np.stack([r[1] for r in results])
    failed = sorted({s for r in results if len(r) == 3
                     for s in r[2].failed_shards})
    n_degraded = sum(1 for r in results if len(r) == 3 and r[2].degraded)
    oracle_vals, oracle_ids = store.oracle_topk(queries, args.k,
                                                exclude_shards=failed)
    # tie tolerance uses ground-truth rescoring of the returned ids, never
    # the kernel's own reported values
    recall = recall_at_k(got_ids, oracle_ids,
                         got_vals=store.score_ids(queries, got_ids),
                         oracle_vals=oracle_vals)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    st = batcher.stats_snapshot()
    deg = (f" | DEGRADED {n_degraded}/{args.queries} req "
           f"(shards {failed} failed)" if failed else "")
    print(f"served {args.queries} requests in {wall:.3f}s "
          f"({args.queries / wall:.1f} QPS achieved, target "
          f"{args.qps or 'inf'}) | latency p50 {p50:.2f}ms p99 {p99:.2f}ms "
          f"| {st.batches} batches, mean {st.mean_batch:.1f} req/batch "
          f"| recall@{args.k} {recall:.4f}{deg}")
    if args.hot_rows is not None:
        ht = store.hot_tier_stats()
        print(f"hot tier: {ht['hot_rows']} rows, "
              f"{ht['returned_hot_frac']*100:.1f}% of returned ids exact-hot, "
              f"scan bytes {ht['scan_bytes_tiered']} tiered vs "
              f"{ht['scan_bytes_quant']} full-quant")
    if args.expect_degraded and not n_degraded:
        print("FAIL: --expect-degraded but every response was full-fidelity "
              "(did the fault plan fire?)")
        sys.exit(1)
    if args.check_recall is not None and recall < args.check_recall:
        which = f"surviving-shards ({failed} excluded)" if failed else "full"
        print(f"FAIL: recall {recall:.4f} < required {args.check_recall} "
              f"vs the {which} oracle")
        sys.exit(1)
    return {"qps": args.queries / wall, "p50_ms": p50, "p99_ms": p99,
            "recall": recall, "batches": st.batches, "wall_s": wall,
            "degraded": n_degraded, "failed_shards": failed}


if __name__ == "__main__":
    main()
