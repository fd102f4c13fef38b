"""The serving routes, the hot tier, degraded mode, fault injection,
admission control and the launcher's legs, port against the JAX package.

On the CPU every route of the port runs its plain versions; the JAX side
runs the same route by name, its Pallas kernels in interpret mode, so the
tables stay at most 64 rows wherever a JAX kernel runs. Tables and queries
are small integers, so every f32 dot is exact and the two packages must
agree bitwise, ties included."""
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embed_serve import MicroBatcher as JaxBatcher
from repro.embed_serve import ShardedEmbeddingStore as JaxStore
from repro.embed_serve import TopKMeta as JaxMeta
from repro.launch import embed_serve as jax_launcher
from repro.runtime import FaultPlan as JaxPlan
from repro.runtime import FaultSpec as JaxSpec
from repro.runtime import InjectedFault as JaxInjected
from repro.runtime import inject as jax_inject
from repro.train.checkpoint import save_checkpoint as jax_save
from repro_torch.embed_serve import (MicroBatcher, ShardedEmbeddingStore,
                                     TopKMeta)
from repro_torch.launch import embed_serve as launcher
from repro_torch.runtime import FaultPlan, FaultSpec, InjectedFault, inject
from repro_torch.runtime.errors import Overloaded

CPU = jax.devices("cpu")[0]


def _int(n, d, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _stores(tbl, shards, bf16=False, **kw):
    """The same table in both packages' stores, ``shards`` shards on the
    CPU (bf16 rounded identically)."""
    jt = jnp.asarray(tbl)
    if bf16:
        jt = jt.astype(jnp.bfloat16)
    jstore = JaxStore.from_array(np.asarray(jt), devices=[CPU] * shards, **kw)
    tt = torch.from_numpy(tbl)
    store = ShardedEmbeddingStore.from_array(
        tt.bfloat16() if bf16 else tt, devices=["cpu"] * shards, **kw)
    assert store.valid == jstore.valid
    return store, jstore


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# (rows, shards, bf16, k): ragged shards, an empty tail shard (9 over 4:
# 3, 3, 3, 0), a short and an empty one (5 over 4: 2, 2, 1, 0); k past a
# shard's rows (sentinel slots) and past the table (clamped)
LAYOUTS = [(50, 3, False, 5), (61, 2, True, 12), (9, 4, True, 12),
           (5, 4, False, 12)]


@pytest.mark.parametrize("impl", ["pallas", "rowwise", "xla",
                                  "quant_pallas", "quant_xla"])
@pytest.mark.parametrize("n,shards,bf16,k", LAYOUTS,
                         ids=[f"{n}x{p}{'bf16' if b else 'f32'}"
                              for n, p, b, _ in LAYOUTS])
def test_store_routes_match_jax(n, shards, bf16, k, impl):
    """Each route against the JAX store's route of the same name."""
    store, jstore = _stores(_int(n, 32, n), shards, bf16, quant="int8")
    q = _int(5, 32, n + 1)
    got = store.topk(q, k, impl=impl)
    _same(got, jstore.topk(q, k, impl=impl))
    assert got[1].shape == (5, min(k, n))
    # on a CPU shard the unnamed routes are the plain ones
    _same(store.topk(q, 3, impl="auto"), store.topk(q, 3, impl="xla"))
    _same(store.topk(q, 3, impl="quant"), store.topk(q, 3, impl="quant_xla"))


def test_store_route_errors_match_jax():
    store, jstore = _stores(_int(20, 8, 0), 2)
    q = _int(2, 8, 1)
    for s in (store, jstore):
        with pytest.raises(ValueError, match="unknown impl"):
            s.topk(q, 3, impl="exact")
        with pytest.raises(RuntimeError, match="no quantized tier"):
            s.topk(q, 3, impl="quant_pallas")
        with pytest.raises(RuntimeError, match="no hot tier"):
            s.topk(q, 3, impl="tiered")
        with pytest.raises(ValueError, match="needs ids or counts"):
            s.enable_hot_tier(4)
        with pytest.raises(ValueError, match="counts shape"):
            s.enable_hot_tier(4, counts=np.ones(3))


def _hot_stats(s):
    return {k: v for k, v in s.hot_tier_stats().items()}


@pytest.mark.parametrize("shards,how,budget", [
    (1, "counts", 50), (2, "ids", 16), (3, "counts", 0), (3, "counts", 200),
    (3, "ids", 300)])
def test_hot_tier_matches_jax(shards, how, budget):
    """The same hot ids (the lexsort rule: counts with many ties, never a
    zero-count row; or explicit ids, deduplicated and cut to the budget),
    the same stats, and the tiered top-k bitwise JAX's at k = 10 (each
    JAX call compiles anew), bitwise the oracle's at every k."""
    n = 200
    store, jstore = _stores(_int(n, 32, 7), shards, bf16=True, quant="int8")
    rng = np.random.default_rng(8)
    if how == "counts":
        counts = rng.integers(0, 4, size=n).astype(np.float64)
        kw = {"counts": counts}
    else:
        kw = {"ids": np.concatenate([rng.integers(-5, n + 5, size=40),
                                     [3, 3, 3]])}
    assert store.enable_hot_tier(budget, **kw) == jstore.enable_hot_tier(
        budget, **kw)
    np.testing.assert_array_equal(store._hot_mask, jstore._hot_mask)
    q = _int(6, 32, 10)
    _same(store.topk(q, 10, impl="tiered"), jstore.topk(q, 10, impl="tiered"))
    assert _hot_stats(store) == _hot_stats(jstore)
    for k in (1, 75):
        _same(store.topk(q, k, impl="tiered"), store.oracle_topk(q, k))


def test_tiered_degraded_path_matches_jax():
    """The tiered route through the shard-task pool, healthy and with a
    crashed shard."""
    store, jstore = _stores(_int(120, 32, 9), 2, quant="int8")
    for s in (store, jstore):
        s.enable_hot_tier(16, ids=np.arange(0, 120, 8))
    q = _int(4, 32, 10)
    got = store.topk(q, 6, impl="tiered", shard_timeout_s=60.0,
                     return_meta=True)
    want = jstore.topk(q, 6, impl="tiered", shard_timeout_s=60.0,
                       return_meta=True)
    _same(got[:2], want[:2])
    assert not got[2].degraded and not want[2].degraded
    with inject("serve.shard:crash:key=0"):
        got = store.topk(q, 6, impl="tiered", shard_timeout_s=60.0,
                         return_meta=True)
    with jax_inject("serve.shard:crash:key=0"):
        want = jstore.topk(q, 6, impl="tiered", shard_timeout_s=60.0,
                           return_meta=True)
    _same(got[:2], want[:2])
    assert got[2].failed_shards == want[2].failed_shards == (0,)
    assert _hot_stats(store) == _hot_stats(jstore)


def _meta(m):
    return (m.degraded, m.failed_shards, m.timeout_s)


@pytest.mark.parametrize("spec,timeout", [
    ("serve.shard:delay:key=1:delay=1.0:times=inf", 0.4),
    ("serve.shard:crash:key=1:times=inf", 5.0),
    ("serve.shard:crash:at=0", 5.0),
])
@pytest.mark.parametrize("impl", ["pallas", "quant_pallas"])
def test_degraded_matches_jax(spec, timeout, impl):
    """The same failed shards, the same TopKMeta, and the answer equal to
    JAX's over the surviving shards and to the surviving-shards oracle."""
    store, jstore = _stores(_int(60, 16, 11), 3, quant="int8")
    q = _int(8, 16, 12)
    jimpl = "quant_xla" if impl.startswith("quant") else "xla"
    jstore.topk(q, 5, impl=jimpl, shard_timeout_s=None)   # JAX compiles
    healthy = store.topk(q, 5, impl=impl, shard_timeout_s=10.0,
                         return_meta=True)
    assert _meta(healthy[2]) == (False, (), 10.0)
    _same(healthy[:2], store.topk(q, 5, impl=impl))
    with inject(spec) as plan:
        got = store.topk(q, 5, impl=impl, shard_timeout_s=timeout,
                         return_meta=True)
    with jax_inject(spec) as jplan:
        want = jstore.topk(q, 5, impl=jimpl, shard_timeout_s=timeout,
                           return_meta=True)
    assert isinstance(got[2], TopKMeta) and isinstance(want[2], JaxMeta)
    assert _meta(got[2]) == _meta(want[2])
    assert got[2].degraded and got[2].failed_shards
    assert [f[:2] for f in plan.fired] == [f[:2] for f in jplan.fired]
    _same(got[:2], want[:2])
    rv, ri = store.oracle_topk(q, 5, exclude_shards=got[2].failed_shards)
    _same(got[:2], (rv, ri))
    _same((rv, ri), jstore.oracle_topk(q, 5,
                                       exclude_shards=got[2].failed_shards))


def test_all_shards_failed_and_default_timeout_like_jax():
    specs = [f"serve.shard:crash:key={s}:times=inf" for s in range(3)]
    for make, ctx in ((ShardedEmbeddingStore, inject),
                      (JaxStore, jax_inject)):
        dev = "cpu" if make is ShardedEmbeddingStore else CPU
        s = make.from_array(_int(30, 8, 13), devices=[dev] * 3,
                            shard_timeout_s=0.4)
        q = np.zeros((2, 8), np.float32)
        s.topk(q, 5, impl="xla", shard_timeout_s=None)   # JAX compiles
        with ctx(*specs):
            with pytest.raises(RuntimeError, match="all 3 shard scans"):
                s.topk(q, 5, impl="xla")
        with ctx("serve.shard:delay:key=0:delay=1.0:times=inf"):
            _, _, meta = s.topk(q, 5, impl="xla", return_meta=True)
        assert _meta(meta) == (True, (0,), 0.4)


def test_a_stuck_shard_does_not_starve_the_others():
    """A shard whose every scan outlasts the deadline holds two scan workers
    at most; the healthy shards answer every call (degraded). Queuing a
    scan a call on it took every worker of a pool of one a shard by the
    fourth call, which raised "all 3 shard scans failed" (the 3-shard chaos
    leg on the card)."""
    s = ShardedEmbeddingStore.from_array(_int(30, 8, 14), devices=["cpu"] * 3,
                                         shard_timeout_s=0.05)
    q = np.zeros((2, 8), np.float32)
    with inject("serve.shard:delay:key=1:delay=0.4:times=inf"):
        metas = [s.topk(q, 5, impl="xla", return_meta=True)[2]
                 for _ in range(6)]
    assert [_meta(m) for m in metas] == [(True, (1,), 0.05)] * 6


def test_a_one_off_stall_leaves_later_calls_exact():
    """A shard stalled once past the deadline is out of that call alone:
    the next calls give it a fresh scan beside the stalled one and are
    exact while the stall still runs."""
    s = ShardedEmbeddingStore.from_array(_int(30, 8, 15), devices=["cpu"] * 3,
                                         shard_timeout_s=0.3)
    q = _int(2, 8, 16)
    want = s.topk(q, 5, impl="xla", shard_timeout_s=None)
    with inject("serve.shard:delay:key=1:delay=2.0:times=1"):
        got = [s.topk(q, 5, impl="xla", return_meta=True) for _ in range(5)]
    assert [_meta(m) for *_, m in got] == ([(True, (1,), 0.3)]
                                           + [(False, (), 0.3)] * 4)
    for gv, gi, _ in got[1:]:
        _same((gv, gi), want)


def test_two_threads_calling_at_once_are_both_exact():
    """Calls from two threads at once each scan every shard: one call's
    scans in flight are not the other's failures."""
    s = ShardedEmbeddingStore.from_array(_int(30, 8, 17), devices=["cpu"] * 3,
                                         shard_timeout_s=5.0)
    q = _int(2, 8, 18)
    want = s.topk(q, 5, impl="xla", shard_timeout_s=None)
    go, got = threading.Barrier(2), [None, None]

    def call(i):
        go.wait()
        got[i] = s.topk(q, 5, impl="xla", return_meta=True)

    with inject("serve.shard:delay:delay=0.2:times=inf"):
        threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for gv, gi, meta in got:
        assert _meta(meta) == (False, (), 5.0)
        _same((gv, gi), want)


# the same call sequence through both fault plans
FAULT_SPECS = ["s:crash:at=1", "s:corrupt:key=0/2", "s:fire:key=walker-0/*",
               "t:delay:at=0:delay=0.01", "s:crash:key=3:times=2", "u:fire",
               "v:fire:times=inf", "w:corrupt:key=1:times=inf:at=2"]
FAULT_CALLS = [("s", (0, 1)), ("s", (0, 1)), ("s", (0, 2)), ("s", (0, 2)),
               ("s", "walker-0/3/1"), ("s", "walker-0/4"), ("s", 3),
               ("s", 3), ("s", 3), ("t", None), ("t", None), ("u", None),
               ("u", None), ("v", 9), ("v", None), ("w", 1), ("w", 1),
               ("w", 1), ("w", 2), ("x", None)]


def _replay(plan_cls, crash_cls):
    plan = plan_cls(FAULT_SPECS)
    out = []
    for site, key in FAULT_CALLS:
        try:
            out.append(plan.check(site, key))
        except crash_cls as e:
            out.append(("crash", e.site, e.key))
    return out, plan.fired, {s: plan.count(s) for s in "stuvwx"}


def test_fault_plan_fires_like_jax():
    got = _replay(FaultPlan, InjectedFault)
    assert got == _replay(JaxPlan, JaxInjected)
    assert ("crash", "s", (0, 1)) in got[0] and True in got[0]


@pytest.mark.parametrize("spec", [
    "serve.shard:delay:key=1:delay=1.0:times=inf", "a:crash", "a:fire:at=3",
    "a:corrupt:times=inf", "a:boom", "a", "a:crash:at", "a:crash:foo=1"])
def test_fault_spec_parse_like_jax(spec):
    def parse(cls):
        try:
            return vars(cls.parse(spec))
        except ValueError as e:
            return str(e)
    assert parse(FaultSpec) == parse(JaxSpec)


# ----------------------------------------------------------- the batcher
def _shapes_seen(batcher_cls, n, **kw):
    seen = []

    def serve(q):
        seen.append(q.shape[0])
        return np.zeros((q.shape[0], 2), np.float32), np.zeros(
            (q.shape[0], 2), np.int32)

    gate, held = threading.Event(), threading.Event()

    def gated(q):
        if not held.is_set():
            held.set()
            gate.wait(10)
        return serve(q)

    b = batcher_cls(gated, 4, max_batch=16, window_ms=20.0, **kw)
    futs = [b.submit(np.zeros(4, np.float32))]
    assert held.wait(10)                     # the worker holds request 0
    futs += [b.submit(np.zeros(4, np.float32)) for _ in range(n)]
    gate.set()
    for f in futs:
        f.result(timeout=10)
    b.close()
    st = b.stats_snapshot()
    return seen, (st.requests, st.batches, st.padded_rows)


@pytest.mark.parametrize("kw", [{}, {"pad_multiple": 1},
                                {"pad_multiple": 5}, {"fixed_batch": True}])
def test_batcher_pad_shapes_like_jax(kw):
    """One request held, then 19 queued: batches of 1, 16 and 3 requests,
    padded to pad_multiple (8 by default) or to max_batch."""
    got = _shapes_seen(MicroBatcher, 19, **kw)
    assert got == _shapes_seen(JaxBatcher, 19, **kw)
    pad = 16 if kw.get("fixed_batch") else kw.get("pad_multiple", 8)
    assert got[0] == [-(-b // pad) * pad for b in (1, 16, 3)]


def test_batcher_sheds_on_full_queue():
    release = threading.Event()

    def gated(q):
        release.wait(5.0)
        return np.zeros((q.shape[0], 1), np.float32), np.zeros(
            (q.shape[0], 1), np.int32)

    b = MicroBatcher(gated, 2, max_batch=1, window_ms=0.1, pad_multiple=1,
                     queue_cap=1, shed_on_full=True)
    try:
        shed = 0
        for _ in range(20):
            try:
                b.submit(np.zeros(2, np.float32))
            except Overloaded:
                shed += 1
        assert shed >= 18            # one in the worker, one queued
        assert b.stats_snapshot().shed == shed
    finally:
        release.set()
        b.close()


def test_batcher_tags_every_request_of_a_degraded_batch():
    meta = TopKMeta(degraded=True, failed_shards=(1,), timeout_s=0.1)
    gate = threading.Event()

    def serve(q):
        gate.wait(10)
        return (np.zeros((q.shape[0], 2), np.float32),
                np.zeros((q.shape[0], 2), np.int32), meta)

    with MicroBatcher(serve, 2, max_batch=8, window_ms=50.0) as b:
        futs = [b.submit(np.zeros(2, np.float32)) for _ in range(5)]
        gate.set()
        outs = [f.result(timeout=10) for f in futs]
    assert all(len(o) == 3 and o[2] is meta for o in outs)
    st = b.stats_snapshot()
    assert st.degraded == st.requests == 5


# ---------------------------------------------------- the launchers' legs
@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """JAX-written bf16 checkpoints of integer rows: 301 rows for the
    store's legs, 48 for the row-sequential route (the JAX kernel runs in
    interpret mode, one step per row)."""
    out = {}
    for name, n in (("big", 301), ("small", 48)):
        tbl = jnp.asarray(_int(n, 32, n), jnp.float32).astype(jnp.bfloat16)
        path = str(tmp_path_factory.mktemp(name) / "embeddings.npz")
        jax_save(path, {"vertex": np.asarray(tbl),
                        "context": np.asarray(tbl)}, step=3)
        out[name] = path
    return out


def _summary(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("served "))
    recall = float(re.search(r"recall@\d+ ([0-9.]+)", line).group(1))
    failed = re.search(r"\(shards (\[[0-9, ]*\]) failed\)", line)
    hot = [ln for ln in text.splitlines() if ln.startswith("hot tier: ")]
    return recall, failed and failed.group(1), hot


LEGS = {
    "hot_rows": ("big", ["--quant", "int8", "--hot-rows", "120"]),
    "chaos": ("big", ["--shards", "3", "--shard-timeout-ms", "150",
                      "--inject",
                      "serve.shard:delay:key=1:delay=1.0:times=inf",
                      "--expect-degraded"]),
    "rowwise": ("small", ["--impl", "rowwise", "--max-batch", "16",
                          "--queries", "16"]),
}


@pytest.mark.parametrize("leg", list(LEGS))
def test_launcher_legs_match_jax(ckpts, leg, capsys):
    """The reference CI's serving legs through both launchers: the same
    recall (1.0), the same failed shards, the same hot-tier line."""
    ckpt, extra = LEGS[leg]
    argv = ["--ckpt", ckpts[ckpt], "--k", "10", "--queries", "48", "--qps",
            "0", "--check-recall", "1.0", *extra]
    out = launcher.main([*argv, "--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    jax_launcher.main(argv)
    want = _summary(capsys.readouterr().out)
    assert got == want
    assert got[0] == out["recall"] == 1.0
    if leg == "chaos":
        assert got[1] == "[1]" and out["failed_shards"] == [1]
        assert out["degraded"] > 0
    if leg == "hot_rows":
        assert len(got[2]) == 2


def test_launcher_telemetry_like_jax(ckpts, tmp_path, capsys):
    """--metrics-dir and --trace: the files exist, the trace holds the
    batcher's serve_batch spans, and the metrics carry JAX's keys."""
    import json

    summaries = []
    for name, run in (("port", lambda a: launcher.main([*a, "--device",
                                                        "cpu"])),
                      ("jax", jax_launcher.main)):
        d = tmp_path / name
        run(["--ckpt", ckpts["big"], "--queries", "32", "--qps", "0",
             "--check-recall", "1.0", "--metrics-dir", str(d / "m"),
             "--trace", str(d / "trace.json")])
        trace = json.loads((d / "trace.json").read_text())
        spans = [e for e in trace["traceEvents"] if e.get("name") ==
                 "serve_batch"]
        assert spans and all(e["ph"] == "X" for e in spans)
        lines = (d / "m" / "metrics.jsonl").read_text().splitlines()
        assert lines
        summaries.append(json.loads((d / "m" /
                                     "metrics_summary.json").read_text()))
    capsys.readouterr()
    port, ref = summaries
    assert set(port) == set(ref)
    for key in ("counters", "gauges", "histograms"):
        assert set(port[key]) == set(ref[key])
    assert port["histograms"]["serve.request_s"]["count"] == 32
    assert port["sources"] == {} == ref["sources"]      # batcher closed
    from repro_torch import obs
    assert not obs.enabled() and obs.tracer() is None


@pytest.mark.parametrize("count", [1, 2, 4])
@pytest.mark.parametrize("shards", [None, 1, 3, 8])
def test_launcher_shard_devices_follow_jax(monkeypatch, count, shards):
    """The devices the serving launcher gives its shards, by JAX's rule:
    no --shards, one shard a device (the store's jax.devices()); --shards
    N, devices[i % len(devs)]. With --device cuda the devices are the
    visible cards; an explicit cuda:N or cpu holds every shard."""
    from repro_torch.device import shard_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    devs = [f"cuda:{i}" for i in range(count)]        # JAX's device list
    want = devs if shards is None else [devs[i % len(devs)]
                                        for i in range(shards)]
    assert shard_devices("cuda", shards) == want
    assert shard_devices(f"cuda:{count - 1}", shards) == \
        [f"cuda:{count - 1}"] * (shards or 1)
    assert shard_devices("cpu", shards) == ["cpu"] * (shards or 1)
    # the launcher hands exactly this list to the store
    seen = {}

    def load(path, **kw):
        seen.update(kw)
        raise RuntimeError("stop after the device list")

    monkeypatch.setattr(ShardedEmbeddingStore, "load", load)
    argv = ["--ckpt", "unused.npz"] + ([] if shards is None
                                       else ["--shards", str(shards)])
    with pytest.raises(RuntimeError, match="stop after"):
        launcher.main(argv)
    assert seen["devices"] == want


def test_shard_devices_raise_without_cuda(monkeypatch):
    from repro_torch.device import shard_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_devices("cuda", 3)
    assert shard_devices("cpu", 3) == ["cpu"] * 3
