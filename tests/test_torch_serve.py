"""The serving slice as a whole, port against the JAX package: one
JAX-written checkpoint served by both stores (1 and 3 shards, exact and
int8), the port's launcher end to end on the CPU, and the micro-batcher's
drain and deadline behaviour beside the JAX batcher's."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embed_serve import MicroBatcher as JaxBatcher
from repro.embed_serve import ShardedEmbeddingStore as JaxStore
from repro.runtime import DeadlineExceeded as JaxDeadlineExceeded
from repro.train.checkpoint import save_checkpoint as jax_save
from repro_torch.embed_serve import (MicroBatcher, ShardedEmbeddingStore,
                                     recall_at_k)
from repro_torch.launch import embed_serve
from repro_torch.runtime.errors import DeadlineExceeded

N, D = 301, 32


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A bf16 checkpoint written by the JAX package: integer-valued rows
    (exact scores, many ties) as the vertex table, continuous rows as the
    context table."""
    rng = np.random.default_rng(0)
    vertex = jnp.asarray(rng.integers(-4, 5, size=(N, D)),
                         jnp.float32).astype(jnp.bfloat16)
    context = jnp.asarray(rng.normal(0, 0.1, size=(N, D)),
                          jnp.float32).astype(jnp.bfloat16)
    path = str(tmp_path_factory.mktemp("ckpt") / "embeddings.npz")
    jax_save(path, {"vertex": np.asarray(vertex),
                    "context": np.asarray(context)}, step=7)
    return path


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_stores_agree_on_jax_checkpoint(jax_ckpt, shards, quant):
    kw = {"quant": "int8"} if quant else {}
    jstore = JaxStore.load(jax_ckpt, devices=[jax.devices("cpu")[0]] * shards,
                           **kw)
    store = ShardedEmbeddingStore.load(jax_ckpt, devices=["cpu"] * shards,
                                       **kw)
    assert store.step == 7 and store.valid == jstore.valid
    np.testing.assert_array_equal(
        store.host_table.view(torch.int16).numpy().view(np.uint16),
        jstore.host_table.view(np.uint16))
    q = np.random.default_rng(1).integers(-4, 5, size=(11, D)).astype(
        np.float32)
    for k in (1, 10, 100):
        want = jstore.topk(q, k, impl="quant_xla" if quant else "xla")
        got = store.topk(q, k, impl="quant" if quant else "pallas")
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        rv, ri = store.oracle_topk(q, k)
        np.testing.assert_array_equal(got[1], ri)


def test_stores_agree_on_continuous_table(jax_ckpt):
    """Continuous rows: equal ids, scores within rtol 1e-6 (the f32
    summation order differs between torch and XLA)."""
    jstore = JaxStore.load(jax_ckpt, table="context",
                           devices=[jax.devices("cpu")[0]] * 2)
    store = ShardedEmbeddingStore.load(jax_ckpt, table="context",
                                       devices=["cpu"] * 2)
    q = store.host_table[[3, 50, 299]].float().numpy()
    want = jstore.topk(q, 10, impl="xla")
    got = store.topk(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_store_empty_tail_shards_and_errors():
    tbl = np.random.default_rng(2).integers(-4, 5, size=(9, 8)).astype(
        np.float32)
    store = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"] * 4,
                                             quant="int8")
    assert store.valid == (3, 3, 3, 0)
    q = np.random.default_rng(3).integers(-4, 5, size=(4, 8)).astype(
        np.float32)
    rv, ri = store.oracle_topk(q, 5)
    for impl in ("pallas", "quant"):
        v, i = store.topk(q, 5, impl=impl)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(v, rv)
    assert store.topk(q, 50)[1].shape == (4, 9)      # k clamped to N
    plain = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"],
                                             keep_host_table=False)
    with pytest.raises(RuntimeError, match="no quantized tier"):
        plain.topk(q, 3, impl="quant")
    with pytest.raises(RuntimeError, match="keep_host_table=False"):
        plain.oracle_topk(q, 3)
    with pytest.raises(ValueError, match="unknown quant tier"):
        ShardedEmbeddingStore.from_array(tbl, devices=["cpu"], quant="int4")


def test_store_cosine_normalizes():
    tbl = np.random.default_rng(4).integers(1, 5, size=(12, 8)).astype(
        np.float32)
    store = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"],
                                             normalize=True)
    norms = torch.linalg.vector_norm(store.host_table.float(), dim=1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6)


def test_store_and_launcher_refuse_missing_cuda(monkeypatch, jax_ckpt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedEmbeddingStore.from_array(np.zeros((4, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embed_serve.main(["--ckpt", jax_ckpt, "--queries", "4"])


@pytest.mark.parametrize("extra", [[], ["--quant", "int8"],
                                   ["--table", "context", "--metric",
                                    "cosine", "--noise", "0.01"]],
                         ids=["exact", "int8", "cosine"])
def test_launcher_serves_jax_checkpoint(jax_ckpt, extra):
    out = embed_serve.main(["--ckpt", jax_ckpt, "--k", "10", "--queries",
                            "64", "--qps", "0", "--max-batch", "16",
                            "--device", "cpu", "--check-recall", "1.0",
                            *extra])
    assert out["recall"] == 1.0 and out["batches"] >= 4


def test_launcher_recall_gate_fails_loudly(jax_ckpt, monkeypatch):
    """A wrong answer exits 1: the gate is not decorative."""
    real = ShardedEmbeddingStore.topk

    def wrong(self, queries, k, **kw):
        v, i = real(self, queries, k, **kw)
        return v, (i + 1) % self.num_nodes

    monkeypatch.setattr(ShardedEmbeddingStore, "topk", wrong)
    with pytest.raises(SystemExit) as e:
        embed_serve.main(["--ckpt", jax_ckpt, "--queries", "16", "--qps",
                          "0", "--max-batch", "8", "--device", "cpu",
                          "--check-recall", "1.0"])
    assert e.value.code == 1


def _both_batchers(serve_fn, **kw):
    """Both batchers padding every call to max_batch (fixed_batch=True)."""
    return [(MicroBatcher(serve_fn, 8, fixed_batch=True, **kw),
             DeadlineExceeded),
            (JaxBatcher(serve_fn, 8, fixed_batch=True, **kw),
             JaxDeadlineExceeded)]


def test_batcher_close_serves_backlog_like_jax():
    tbl = np.random.default_rng(5).integers(-4, 5, size=(30, 8)).astype(
        np.float32)
    store = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"])
    rv, ri = store.oracle_topk(tbl[:10], 3)
    outcomes = []
    for batcher, _ in _both_batchers(lambda q: store.topk(q, 3),
                                     max_batch=4, window_ms=50.0):
        futs = [batcher.submit(tbl[i]) for i in range(10)]
        batcher.close()                       # must drain, not drop
        got = [f.result(timeout=10) for f in futs]
        for j, (vals, ids) in enumerate(got):
            np.testing.assert_array_equal(ids, ri[j])
            np.testing.assert_array_equal(vals, rv[j])
        with pytest.raises(RuntimeError):
            batcher.submit(tbl[0])
        st = batcher.stats_snapshot()
        outcomes.append((st.requests, st.expired, st.padded_rows))
    assert outcomes[0] == outcomes[1] == (10, 0, 2)


def test_batcher_deadline_like_jax():
    """The first request holds the backend; the two queued behind it pass
    their deadline and fail with DeadlineExceeded, in both batchers."""
    outcomes = []
    for make in (0, 1):
        gate = threading.Event()

        def serve_fn(q):
            gate.wait(10)
            return np.zeros((q.shape[0], 2)), np.zeros((q.shape[0], 2))

        batcher, expired_cls = _both_batchers(
            serve_fn, max_batch=1, window_ms=0.0, deadline_ms=50.0)[make]
        first = batcher.submit(np.zeros(8, np.float32))
        time.sleep(0.05)                      # the worker holds `first`
        late = [batcher.submit(np.zeros(8, np.float32)) for _ in range(2)]
        time.sleep(0.15)                      # both pass their deadline
        gate.set()
        first.result(timeout=10)
        for f in late:
            with pytest.raises(expired_cls):
                f.result(timeout=10)
        batcher.close()
        st = batcher.stats_snapshot()
        outcomes.append((st.requests, st.batches, st.expired))
    assert outcomes[0] == outcomes[1] == (1, 1, 2)


def test_batcher_concurrent_clients():
    tbl = np.random.default_rng(6).integers(-4, 5, size=(120, 16)).astype(
        np.float32)
    store = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"])
    rv, ri = store.oracle_topk(tbl[:40], 6)
    batcher = MicroBatcher(lambda q: store.topk(q, 6), 16, max_batch=16,
                           window_ms=5.0)
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(12):
            j = int(rng.integers(0, 40))
            vals, ids = batcher.submit(tbl[j]).result(timeout=60)
            if not np.array_equal(ids, ri[j]):
                errors.append((seed, j))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    batcher.close()
    assert not errors
    st = batcher.stats_snapshot()
    assert st.requests == 72 and st.batches < st.requests


def test_recall_at_k_tie_tolerance():
    oracle_ids, oracle_vals = np.array([[4, 7]]), np.array([[2.0, 1.0]])
    assert recall_at_k(np.array([[4, 9]]), oracle_ids) == 0.5
    assert recall_at_k(np.array([[4, 9]]), oracle_ids,
                       got_vals=np.array([[2.0, 1.0]]),
                       oracle_vals=oracle_vals) == 1.0
    assert recall_at_k(np.array([[4, 4]]), oracle_ids,
                       got_vals=np.array([[2.0, 2.0]]),
                       oracle_vals=oracle_vals) == 0.5
