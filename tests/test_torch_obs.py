"""The port's telemetry copies (``repro_torch.obs``) against the JAX
package's ``repro.obs``: the same histogram summaries on the same samples,
the same trace events, phases and tracks (timestamps left out), the same
snapshot and sink keys, the port's hooks through their real bodies, and
nothing allocated while disabled."""
import json
import os
import tracemalloc

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs
from repro_torch.obs import trace as obs_trace


@pytest.fixture(autouse=True)
def _reset_obs():
    """Telemetry is process-global state; never leak it across tests."""
    for o in (obs, jobs):
        o.disable()
        o.set_tracer(None)
    yield
    for o in (obs, jobs):
        o.disable()
        o.set_tracer(None)


def test_exports_match_jax():
    assert sorted(obs.__all__) == sorted(jobs.__all__)
    assert obs.PIPELINE_TRACKS == jobs.PIPELINE_TRACKS


@pytest.mark.parametrize("n,cap", [(1, 4096), (17, 4096), (999, 4096),
                                   (4096, 4096), (20_000, 256)])
def test_histogram_matches_jax(n, cap):
    """Exact percentiles within the reservoir, the same sampled ones past
    it (one seeded replacement stream in both)."""
    vals = np.random.default_rng(n).normal(size=n)
    hs = [obs.Histogram(cap=cap), jobs.Histogram(cap=cap)]
    for v in vals:
        for h in hs:
            h.observe(v)
    assert hs[0].summary() == hs[1].summary()
    for q in (0, 1, 50, 95, 99, 100):
        assert hs[0].percentile(q) == hs[1].percentile(q)
        if n <= cap:
            assert hs[0].percentile(q) == np.percentile(
                vals, q, method="inverted_cdf")


def _drive(o, trace_mod):
    """One fixed sequence of spans, instants and counters, as the serving
    and training paths emit them."""
    tr = o.Tracer(max_events=9)
    o.set_tracer(tr)
    with trace_mod.span("serve_batch", "serve", {"batch": 3, "padded": 8}):
        pass
    with trace_mod.span("train_episode", "train"):
        pass
    trace_mod.instant("epoch_end", "train", {"epoch": 1})
    trace_mod.trace_counter("serve.queue_depth", 4)
    tr.add_span("recv_episode", "host:w1", 10.0, 250.0, {"chunks": 3})
    for i in range(6):                      # past max_events: dropped
        trace_mod.trace_counter("store.resident", i)
    o.set_tracer(None)
    return tr.to_json()


def _untimed(j):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in j["traceEvents"]]


def test_trace_json_matches_jax(tmp_path):
    from repro.obs import trace as jtrace

    got, want = _drive(obs, obs_trace), _drive(jobs, jtrace)
    assert _untimed(got) == _untimed(want)
    assert got["otherData"] == want["otherData"] == {"dropped_events": 2}
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    tr = obs.Tracer()
    path = str(tmp_path / "t.json")
    tr.save(path)
    with open(path) as f:
        assert json.load(f) == tr.to_json()


def test_registry_snapshot_and_sink_match_jax(tmp_path):
    snaps = []
    for o, name in ((obs, "port"), (jobs, "jax")):
        reg = o.enable()
        o.counter_add("serve.hot_tier.hits", 3)
        o.counter_add("serve.hot_tier.hits")
        o.gauge_set("serve.hot_tier.rows", 120)
        for v in (0.5, 0.25, 2.0):
            o.observe("serve.request_s", v)
        o.register_source("good", lambda: {"leases": 2})
        o.register_source("bad", lambda: 1 / 0)
        w = o.MetricsWriter(reg, str(tmp_path / name), interval_s=60.0)
        w.close()
        assert w.last_error is None and w.lines_written == 1
        with open(w.summary_path) as f:
            summary = json.load(f)
        with open(w.path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        for s in [summary, *lines]:
            s.pop("ts"), s.pop("elapsed_s")
        snaps.append((summary, lines[-1]))
        o.disable()
    assert snaps[0] == snaps[1]
    summary = snaps[0][0]
    assert summary["counters"] == {"serve.hot_tier.hits": 4}
    assert summary["histograms"]["serve.request_s"]["p50"] == 0.5
    assert "ZeroDivisionError" in summary["sources"]["bad"]["error"]


def test_kind_collision_raises_like_jax():
    for o in (obs, jobs):
        reg = o.Registry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.histogram("x")


def test_port_hooks_record_when_enabled():
    """The store's hot-tier counters and gauge and the batcher's source
    flow through the registry once it is on."""
    from repro_torch.embed_serve import MicroBatcher, ShardedEmbeddingStore

    reg = obs.enable()
    tbl = np.random.default_rng(0).integers(-4, 5, (40, 8)).astype(
        np.float32)
    store = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"] * 2,
                                             quant="int8")
    store.enable_hot_tier(10, ids=np.arange(10))
    b = MicroBatcher(lambda q: store.topk(q, 4, impl="tiered"), 8,
                     max_batch=8, window_ms=1.0)
    try:
        assert "serve.batcher" in reg.snapshot()["sources"]
        for f in [b.submit(tbl[i]) for i in range(5)]:
            f.result(timeout=30)
    finally:
        b.close()
    snap = reg.snapshot()
    assert "serve.batcher" not in snap["sources"]
    assert snap["gauges"]["serve.hot_tier.rows"] == 10
    c = snap["counters"]
    assert c["serve.hot_tier.hits"] + c["serve.hot_tier.misses"] == 8 * 4
    assert snap["histograms"]["serve.request_s"]["count"] == 5


def test_disabled_helpers_allocate_nothing():
    """With no registry or tracer installed every helper is one module
    -level None check: nothing allocated in repro_torch.obs, and one shared
    no-op span."""
    assert obs_trace.span("a", "walk") is obs_trace.span("b", "serve")
    obs_dir = os.path.dirname(obs.__file__)

    def hot_loop():
        for _ in range(200):
            obs.counter_add("c")
            obs.counter_add("c", 5)
            obs.gauge_set("g", 1.0)
            obs.observe("h", 0.5)
            obs.trace_counter("tc", 3)
            obs.instant("i", "walk")
            obs.register_source("s", dict)
            with obs.span("s", "train", {"k": 1}):
                pass

    hot_loop()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        hot_loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    leaked = [s for s in after.compare_to(before, "lineno")
              if s.traceback[0].filename.startswith(obs_dir)
              and s.size_diff > 0]
    assert not leaked, [str(s) for s in leaked]
