"""The port's numpy copies of the host-side path — graphs, walks, the sample
store, the 2D block builder, the rotation schedule and the AUC evaluation —
against the JAX package's originals, bitwise: the same seeds give the same
arrays."""
import threading

import numpy as np
import pytest

from repro.core import eval as jev
from repro.core import partition as jpart
from repro.core import rotation as jrot
from repro.graph import generators as jgen
from repro.graph.csr import build_csr as jbuild_csr
from repro.graph.io import load_edge_list as jload_edge_list
from repro.walk import MemorySampleStore as JStore
from repro.walk import WalkConfig as JWalkConfig
from repro.walk import WalkEngine as JWalkEngine
from repro_torch.core import eval as ev
from repro_torch.core import partition as part
from repro_torch.core import rotation
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import build_csr
from repro_torch.graph.io import load_edge_list
from repro_torch.runtime import StoreStalled
from repro_torch.walk import MemorySampleStore, WalkConfig, WalkEngine


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
    """A chunk that raises runs once: the walker finishes the epoch, so a
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
    engine = Failing(gen.sbm_graph(400, seed=0),
                     WalkConfig(episodes=3, seed=3), store)
    engine.start_async(0)
    assert store.get(0, 0).shape[1] == 2
    with pytest.raises(KeyError):
        store.get(0, 1)
    with pytest.raises(RuntimeError, match="walk chunk failed"):
        engine.join()
    assert calls.count((1, 0)) == 1 and (2, 0) not in calls


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
