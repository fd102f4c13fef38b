"""The port's numpy copies of the host-side path — graphs (R-MAT and mesh
too), walks (DeepWalk and node2vec-biased), the alias sampler, the sample
store, the 2D block builder, the rotation schedule and the AUC evaluation —
against the JAX package's originals, bitwise: the same seeds give the same
arrays; and the reference's distribution tests of the walk features, run
on the port."""
import threading

import numpy as np
import pytest

from repro.core import eval as jev
from repro.core import partition as jpart
from repro.core import rotation as jrot
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSRGraph
from repro.graph.csr import build_csr as jbuild_csr
from repro.graph.io import load_edge_list as jload_edge_list
from repro.walk import AliasTable as JAliasTable
from repro.walk import MemorySampleStore as JStore
from repro.walk import WalkConfig as JWalkConfig
from repro.walk import WalkEngine as JWalkEngine
from repro.walk.alias import negative_sampling_table as jneg_table
from repro_torch.core import eval as ev
from repro_torch.core import partition as part
from repro_torch.core import rotation
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import CSRGraph, build_csr
from repro_torch.graph.io import load_edge_list
from repro_torch.runtime import StoreStalled
from repro_torch.graph import mesh_graph, rmat_graph
from repro_torch.walk import (AliasTable, MemorySampleStore, WalkConfig,
                              WalkEngine)
from repro_torch.walk.alias import negative_sampling_table


def _same_graph(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("n,seed", [(900, 0), (3000, 5)])
def test_generators_bitwise(n, seed):
    _same_graph(gen.powerlaw_graph(n, 5, seed=seed),
                jgen.powerlaw_graph(n, 5, seed=seed))
    _same_graph(gen.sbm_graph(n, rounds=max(30, n // 40), seed=seed),
                jgen.sbm_graph(n, rounds=max(30, n // 40), seed=seed))


@pytest.mark.parametrize("scale,edge_factor,seed", [(8, 4, 2), (10, 16, 0),
                                                    (6, 8, 5)])
def test_rmat_graph_bitwise(scale, edge_factor, seed):
    _same_graph(gen.rmat_graph(scale, edge_factor, seed=seed),
                jgen.rmat_graph(scale, edge_factor, seed=seed))


@pytest.mark.parametrize("side", [1, 2, 12, 37])
def test_mesh_graph_bitwise(side):
    _same_graph(gen.mesh_graph(side), jgen.mesh_graph(side))


def test_build_csr_and_edge_list_io_bitwise(tmp_path):
    edges = np.random.default_rng(2).integers(0, 50, size=(400, 2))
    for kw in ({}, {"symmetrize": False, "dedup": False}):
        _same_graph(build_csr(edges, 50, **kw), jbuild_csr(edges, 50, **kw))
    txt = tmp_path / "edges.txt"
    np.savetxt(txt, edges, fmt="%d")
    npy = tmp_path / "edges.npy"
    np.save(npy, edges)
    for path in (str(txt), str(npy)):
        _same_graph(load_edge_list(path), jload_edge_list(path))
    # a saved graph reads back in either package
    g, jg = build_csr(edges, 50), jbuild_csr(edges, 50)
    g.save(str(tmp_path / "g.npz"))
    jg.save(str(tmp_path / "jg.npz"))
    _same_graph(CSRGraph.load(str(tmp_path / "jg.npz")), jg)
    _same_graph(JCSRGraph.load(str(tmp_path / "g.npz")), g)
    for v in (0, 17, 49):
        np.testing.assert_array_equal(g.neighbors(v), jg.neighbors(v))


def _epoch_pairs(engine_cls, cfg_cls, store_cls, g, workers, epoch=1):
    store = store_cls()
    cfg = cfg_cls(walk_length=6, window=3, episodes=3, seed=7,
                  workers=workers, chunk_size=128)
    engine = engine_cls(g, cfg, store)
    engine.run_epoch(epoch)
    return [np.asarray(store.get(epoch, ep)) for ep in range(3)], engine


@pytest.mark.parametrize("workers", [1, 2])
def test_walk_engine_pairs_bitwise(workers):
    g = gen.powerlaw_graph(700, 4, seed=1)
    jg = jgen.powerlaw_graph(700, 4, seed=1)
    got, engine = _epoch_pairs(WalkEngine, WalkConfig, MemorySampleStore, g,
                               workers)
    want, _ = _epoch_pairs(JWalkEngine, JWalkConfig, JStore, jg, workers)
    for ep, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(engine.episode_pairs(1, ep), a)


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (2.0, 0.5)])
@pytest.mark.parametrize("graph", ["powerlaw", "mesh"])
def test_node2vec_pairs_bitwise(p, q, graph):
    """The biased step's rejection sampler draws in JAX's order: every
    episode's pairs are the JAX engine's, bitwise, for p != q."""
    if graph == "powerlaw":
        g, jg = gen.powerlaw_graph(500, 4, seed=2), jgen.powerlaw_graph(
            500, 4, seed=2)
    else:
        g, jg = mesh_graph(20), jgen.mesh_graph(20)
    kw = dict(walk_length=8, window=3, episodes=3, seed=11, chunk_size=64,
              node2vec_p=p, node2vec_q=q)
    eng = WalkEngine(g, WalkConfig(**kw))
    jeng = JWalkEngine(jg, JWalkConfig(**kw))
    deepwalk = WalkEngine(g, WalkConfig(**{**kw, "node2vec_p": 1.0,
                                           "node2vec_q": 1.0}))
    for epoch, ep in ((0, 0), (0, 2), (3, 1)):
        a, b = eng.episode_pairs(epoch, ep), jeng.episode_pairs(epoch, ep)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        # the bias really acts: not the DeepWalk stream
        assert not np.array_equal(a, deepwalk.episode_pairs(epoch, ep))


@pytest.mark.parametrize("weights", [
    [1.0, 2.0, 3.0, 4.0], [0.01, 100.0, 5.0], [7.0] * 9,
    list(np.random.default_rng(3).uniform(0.01, 100.0, 50)),
    [0.0, 1.0, 0.0, 2.5, 0.0],
], ids=["ramp", "skewed", "flat", "random50", "zeros"])
def test_alias_table_bitwise(weights):
    """Tables and draws from one seeded generator equal JAX's."""
    tab, jtab = AliasTable(weights), JAliasTable(weights)
    np.testing.assert_array_equal(tab.prob, jtab.prob)
    np.testing.assert_array_equal(tab.alias, jtab.alias)
    assert tab.prob.dtype == jtab.prob.dtype
    assert tab.alias.dtype == jtab.alias.dtype
    for size in (1000, (7, 33)):
        np.testing.assert_array_equal(
            tab.sample(size, np.random.default_rng(4)),
            jtab.sample(size, np.random.default_rng(4)))
    deg = np.array([1, 16, 81, 0, 3])
    n, jn = negative_sampling_table(deg), jneg_table(deg)
    np.testing.assert_array_equal(n.prob, jn.prob)
    np.testing.assert_array_equal(n.alias, jn.alias)


@pytest.mark.parametrize("bad", [[], [[1.0, 2.0]], [-1.0, 2.0], [0.0, 0.0]])
def test_alias_table_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        AliasTable(bad)
    with pytest.raises(ValueError):
        JAliasTable(bad)


# the reference's distribution tests (tests/test_walk.py), on the port; the
# alias case's weights are fixed lists where the reference draws them
@pytest.mark.parametrize("weights", [
    [1.0, 2.0, 3.0, 4.0], [0.01, 100.0], [50.0, 0.5, 0.5, 10.0, 25.0],
    list(np.random.default_rng(9).uniform(0.01, 100.0, 50)),
], ids=["ramp", "two", "mixed", "random50"])
def test_alias_table_distribution(weights):
    w = np.asarray(weights)
    tab = AliasTable(w)
    rng = np.random.default_rng(0)
    s = tab.sample(20000, rng)
    emp = np.bincount(s, minlength=len(w)) / 20000.0
    np.testing.assert_allclose(emp, w / w.sum(), atol=0.05)


def test_negative_sampling_power():
    deg = np.array([1, 16, 81, 0])
    tab = negative_sampling_table(deg, power=0.75)
    rng = np.random.default_rng(1)
    s = tab.sample(40000, rng)
    emp = np.bincount(s, minlength=4) / 40000.0
    w = np.maximum(deg.astype(float) ** 0.75, 1e-12)
    np.testing.assert_allclose(emp, w / w.sum(), atol=0.02)


def test_node2vec_biased_step_runs():
    g = mesh_graph(12)
    cfg = WalkConfig(walk_length=6, window=2, node2vec_p=0.5, node2vec_q=2.0)
    eng = WalkEngine(g, cfg, MemorySampleStore())
    rng = np.random.default_rng(0)
    walks = eng.generate_walks(np.arange(50, dtype=np.int32), rng)
    adj = {v: set(g.neighbors(v)) for v in range(g.num_nodes)}
    for w in walks[:20]:
        for a, b in zip(w[:-1], w[1:]):
            assert b in adj[a] or a == b


def test_async_engine_on_rmat_graph():
    g = rmat_graph(8, 4, seed=2)
    store = MemorySampleStore(stall_timeout_s=60.0)
    eng = WalkEngine(g, WalkConfig(walk_length=6, window=3, episodes=2),
                     store)
    eng.start_async(0)
    pairs = store.get(0, 0)  # blocks until the walker delivers
    eng.join()
    assert pairs.shape[0] > 0


def test_async_engine_and_bounded_store():
    """The walker streams an epoch through a depth-1 store on its own
    thread; backpressure holds the bound, join surfaces no error."""
    g = gen.sbm_graph(400, seed=0)
    store = MemorySampleStore(depth=1)
    engine = WalkEngine(g, WalkConfig(episodes=4, seed=3, workers=2), store)
    engine.start_async(0)
    for ep in range(4):
        assert store.get(0, ep).shape[1] == 2
        store.drop(0, ep)
    engine.join()
    assert engine.finished() and store.peak_resident == 1


def test_walker_error_fails_consumers_and_surfaces_in_join():
    """A chunk that keeps raising is tried ``WalkConfig.retries`` times,
    as in the JAX engine, and no more: the walker finishes the epoch, so a
    consumer waiting on the missing episode fails instead of hanging, and
    join re-raises the error."""
    calls = []

    class Failing(WalkEngine):
        def _chunk_pairs(self, epoch, episode, chunk, starts):
            calls.append((episode, chunk))
            if episode == 1:
                raise RuntimeError("walk chunk failed")
            return super()._chunk_pairs(epoch, episode, chunk, starts)

    store = MemorySampleStore()
    cfg = WalkConfig(episodes=3, seed=3, retry_backoff_s=0.001)
    engine = Failing(gen.sbm_graph(400, seed=0), cfg, store)
    engine.start_async(0)
    assert store.get(0, 0).shape[1] == 2
    with pytest.raises(KeyError):
        store.get(0, 1)
    with pytest.raises(RuntimeError, match="walk chunk failed"):
        engine.join()
    assert calls.count((1, 0)) == cfg.retries == 3 and (2, 0) not in calls


def test_store_stalls_loudly_on_a_dead_producer():
    store = MemorySampleStore(stall_timeout_s=5.0)
    store.set_producer(lambda: False)
    with pytest.raises(StoreStalled, match="producer: DEAD"):
        store.get(0, 0)
    store.abandon()                 # a later put is discarded, not blocked
    t = threading.Thread(target=store.put, args=(0, 0, np.zeros((1, 2))))
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()


@pytest.mark.parametrize("dims,k", [((1, 1), 2), ((1, 1), 4), ((2, 2), 3)])
@pytest.mark.parametrize("chunk", [None, 97], ids=["one-shot", "chunked"])
def test_episode_blocks_bitwise(dims, k, chunk):
    pairs = np.random.default_rng(11).integers(0, 1000, size=(3000, 2))
    p = part.NodePartition(1000, dims=dims, subparts=k)
    jp = jpart.NodePartition(1000, dims=dims, subparts=k)
    for cap in (None, 64):
        got = part.build_episode_blocks(pairs, p, pad_multiple=32,
                                        block_cap=cap, chunk=chunk)
        want = jpart.build_episode_blocks(pairs, jp, pad_multiple=32,
                                          block_cap=cap, chunk=chunk)
        np.testing.assert_array_equal(got.blocks, want.blocks)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.dropped == want.dropped and got.block_cap == want.block_cap


@pytest.mark.parametrize("dims", [(1, 1), (2, 2), (2, 3), (2, 2, 2)])
def test_rotation_schedule_bitwise(dims):
    rotation.check_schedule(dims)
    np.testing.assert_array_equal(rotation.full_schedule(dims),
                                  jrot.full_schedule(dims))


def test_eval_bitwise():
    g = gen.sbm_graph(600, seed=4)
    jg = jgen.sbm_graph(600, seed=4)
    tr, te = ev.split_edges(g, 0.05, seed=4)
    jtr, jte = jev.split_edges(jg, 0.05, seed=4)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(te, jte)
    neg = ev.sample_negative_pairs(g, len(te), seed=5)
    np.testing.assert_array_equal(neg, jev.sample_negative_pairs(jg, len(te),
                                                                 seed=5))
    rng = np.random.default_rng(6)
    pos_s = rng.normal(size=200).round(1)       # ties on purpose
    neg_s = rng.normal(size=300).round(1)
    assert ev.auc_score(pos_s, neg_s) == jev.auc_score(pos_s, neg_s)
    V = rng.normal(size=(600, 8)).astype(np.float32)
    C = rng.normal(size=(600, 8)).astype(np.float32)
    assert (ev.link_prediction_auc(V, C, te, neg)
            == jev.link_prediction_auc(V, C, te, neg))
