"""Embedding retrieval serving launcher, on the card by default.

The port of the JAX package's ``launch/embed_serve.py``: loads one table of
a trainer checkpoint into the sharded store, stands up the micro-batcher,
drives a seeded open-loop query stream at ``--qps``, and reports achieved
QPS, request-latency percentiles and recall@k against the numpy oracle.

    PYTHONPATH=src python -m repro_torch.launch.embed_serve \\
        --ckpt embeddings.npz --k 10 --queries 256 --qps 1000 \\
        --check-recall 1.0                       # add --quant int8 for the
                                                 # two-tier scan

``--device cuda`` (the default) serves through the CUDA kernels and fails
if there is no card; ``--device cpu`` serves through their plain versions.
``--check-recall`` makes the run a gate (exit 1 below the threshold).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> dict:
    """Run the server once; returns ``{"qps", "p50_ms", "p99_ms",
    "recall", "batches", "wall_s"}``."""
    from repro_torch.embed_serve import (MicroBatcher, ShardedEmbeddingStore,
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
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "exact", "quant"],
                    help="shard top-k path (auto: quant when --quant int8, "
                         "else exact)")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="build the int8 tier at load (two-tier scan)")
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
                    help="exit 1 if recall@k vs the oracle is below this")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request admission deadline in the batcher; an "
                         "expired request fails with DeadlineExceeded "
                         "instead of being served late")
    ap.add_argument("--device", default="cuda",
                    help="device of the single shard (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    quant = None if args.quant == "none" else args.quant
    impl = args.impl
    if quant and impl == "auto":
        impl = "quant"            # the tier was built to be used
    if impl == "quant" and not quant:
        ap.error("--impl quant requires --quant int8")
    if args.overfetch is not None and not quant:
        ap.error("--overfetch requires --quant int8")
    store = ShardedEmbeddingStore.load(
        args.ckpt, table=args.table, normalize=args.metric == "cosine",
        quant=quant, devices=[args.device],
        overfetch=(qz.DEFAULT_OVERFETCH if args.overfetch is None
                   else args.overfetch))
    tier = f", int8 tier (overfetch {store.overfetch:g})" if quant else ""
    print(f"loaded {args.table} table: {store.num_nodes} x {store.dim} "
          f"{store.host_table.dtype} over {len(store.shards)} shard(s) on "
          f"{store.devices[0]} (step {store.step}){tier}")

    rng = np.random.default_rng(args.seed)
    rows = rng.integers(0, store.num_nodes, size=args.queries)
    queries = store.host_table[rows].float().numpy()
    if args.noise:
        queries = queries + rng.normal(0, args.noise, queries.shape)
    if args.metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12
    queries = queries.astype(np.float32)

    def serve_fn(q):
        return store.topk(q, args.k, impl=impl)

    # every backend call is padded to max_batch rows; the first call builds
    # the kernels, so it runs here, before the clock starts
    store.topk(np.zeros((args.max_batch, store.dim), np.float32), args.k,
               impl=impl)
    batcher = MicroBatcher(serve_fn, store.dim, max_batch=args.max_batch,
                           window_ms=args.batch_window_ms,
                           deadline_ms=args.deadline_ms)
    try:
        results, lat, wall = drive_open_loop(batcher, queries, qps=args.qps,
                                             timeout=120)
    finally:
        batcher.close()

    got_ids = np.stack([r[1] for r in results])
    oracle_vals, oracle_ids = store.oracle_topk(queries, args.k)
    # tie tolerance uses ground-truth rescoring of the returned ids, never
    # the kernel's own reported values
    recall = recall_at_k(got_ids, oracle_ids,
                         got_vals=store.score_ids(queries, got_ids),
                         oracle_vals=oracle_vals)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    st = batcher.stats_snapshot()
    print(f"served {args.queries} requests in {wall:.3f}s "
          f"({args.queries / wall:.1f} QPS achieved, target "
          f"{args.qps or 'inf'}) | latency p50 {p50:.2f}ms p99 {p99:.2f}ms "
          f"| {st.batches} batches, mean {st.mean_batch:.1f} req/batch "
          f"| recall@{args.k} {recall:.4f}")
    if args.check_recall is not None and recall < args.check_recall:
        print(f"FAIL: recall {recall:.4f} < required {args.check_recall} "
              f"vs the oracle")
        sys.exit(1)
    return {"qps": args.queries / wall, "p50_ms": p50, "p99_ms": p99,
            "recall": recall, "batches": st.batches, "wall_s": wall}


if __name__ == "__main__":
    main()
