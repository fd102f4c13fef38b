"""Tiered tables (host master + device cache of hot rows), port against
the port's resident trainer and against the JAX package.

The load-bearing gate is the reference's: training through tiered tables
at ANY cache budget (0, some rows, all rows), under either policy, after a
resume and with the disk spill, gives the resident trainer's tables and
loss bit for bit. Beside it: the JAX tiered trainer on the same episodes
and negatives within the one-episode tolerances of
``tests/test_torch_train.py``, with its cache statistics and residency
exactly; the spill files byte for byte JAX's; the reference's policy and
byte-model tests on both packages' ``TieredTable``; and the launcher's
``--hbm-rows``, ``--cache-policy`` and ``--cache-spill``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import HybridConfig as JConfig
from repro.core.partition import build_episode_blocks as jbuild
from repro.core.tiered import CacheStats as JCacheStats
from repro.core.tiered import TieredEmbeddingTrainer as JTiered
from repro.core.tiered import TieredTable as JTable
from repro.core.tiered import _replay_neg_indices
from repro.train.checkpoint import load_arrays as jload
from repro_torch.core import (CacheStats, HybridConfig,
                              HybridEmbeddingTrainer, TieredEmbeddingTrainer,
                              TieredTable, build_episode_blocks)
from repro_torch.graph.csr import build_csr
from repro_torch.launch import train as ttrain
from repro_torch.walk import MemorySampleStore, WalkConfig, WalkEngine

# test_torch_train's one-episode tolerances (rtol, atol)
TOL = {"float32": (2e-4, 1e-6), "bfloat16": (3e-2, 3e-3)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run thousands of tiny plain-PyTorch ops: on one thread,
    so that several test workers sharing the machine's cores do not stall
    each other in spinning thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_graph():
    """tests/test_tiered.py's graph: 300 nodes, Zipf-skewed targets."""
    rng = np.random.default_rng(7)
    n = 300
    a = rng.integers(0, n, 6000)
    b = (a + rng.zipf(1.8, 6000)) % n
    return build_csr(np.stack([a, b], 1), n)


def _cfg(**kw):
    base = dict(dim=16, minibatch=32, negatives=4, subparts=2, neg_pool=256,
                lr=0.05)
    base.update(kw)
    return base


def _pairs(g, epochs):
    """One episode of walk pairs an epoch (the reference test's walks)."""
    return [WalkEngine(g, WalkConfig(walk_length=8, window=4, episodes=1,
                                     seed=e), MemorySampleStore())
            .episode_pairs(e, 0) for e in range(epochs)]


def _train_pair(g, cfg, budget, epochs=3, policy="freq", spill_dir=None):
    """The resident and the tiered trainer through the same episodes (the
    same device draws); returns both and their losses."""
    res = HybridEmbeddingTrainer(g.num_nodes, HybridConfig(**cfg),
                                 degrees=g.degrees(), device="cpu")
    tie = TieredEmbeddingTrainer(g.num_nodes, HybridConfig(**cfg),
                                 degrees=g.degrees(), hbm_rows=budget,
                                 policy=policy, spill_dir=spill_dir,
                                 device="cpu")
    res.init_embeddings()
    tie.init_embeddings()
    losses = []
    for i, pairs in enumerate(_pairs(g, epochs)):
        eb = build_episode_blocks(pairs, res.part,
                                  pad_multiple=cfg["minibatch"])
        lr = cfg["lr"] * max(1 - i / epochs, 0.05)
        losses.append((res.train_episode(eb, lr=lr),
                       tie.train_episode(eb, lr=lr)))
    return res, tie, losses


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _same(a, b) -> bool:
    return a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("budget", [0, 48, 10**9])
def test_tiered_bitwise_matches_resident(small_graph, budget, dtype):
    res, tie, losses = _train_pair(small_graph, _cfg(dtype=dtype), budget)
    assert _same(res.embeddings(), tie.embeddings()), budget
    assert _same(res.context_embeddings(), tie.context_embeddings())
    for l_res, l_tie in losses:
        assert l_res == l_tie


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiered_bitwise_lru_policy(small_graph, dtype):
    res, tie, losses = _train_pair(small_graph, _cfg(dtype=dtype), 32,
                                   epochs=2, policy="lru")
    assert _same(res.embeddings(), tie.embeddings())
    assert _same(res.context_embeddings(), tie.context_embeddings())
    assert all(a == b for a, b in losses)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiered_set_embeddings_resume_bitwise(small_graph, dtype):
    """Crash-resume through the tiered path: install a snapshot (numpy
    words, as a checkpoint gives them), keep training, match the resident
    trainer doing the same."""
    g, cfg = small_graph, _cfg(dtype=dtype)
    res, tie, _ = _train_pair(g, cfg, 64, epochs=2)
    v, c = res.embeddings(), res.context_embeddings()
    res.set_embeddings(v, c)
    tie.set_embeddings(v, c)
    eb = build_episode_blocks(_pairs(g, 3)[-1], res.part,
                              pad_multiple=cfg["minibatch"])
    assert res.train_episode(eb, lr=0.03) == tie.train_episode(eb, lr=0.03)
    assert _same(res.embeddings(), tie.embeddings())
    assert _same(res.context_embeddings(), tie.context_embeddings())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disk_spill_master(tmp_path, small_graph, dtype):
    """The memmap master trains the RAM master's bits, and is a memmap of
    the table's words."""
    g, cfg = small_graph, _cfg(dtype=dtype)
    res, disk, _ = _train_pair(g, cfg, 32, epochs=2,
                               spill_dir=str(tmp_path))
    assert isinstance(disk.vert_t.master, np.memmap)
    assert isinstance(disk.ctx_t.master, np.memmap)
    assert disk.vert_t.master.dtype == (np.float32 if dtype == "float32"
                                        else np.uint16)
    _, ram, _ = _train_pair(g, cfg, 32, epochs=2)
    for a, b in ((ram.embeddings(), disk.embeddings()),
                 (ram.context_embeddings(), disk.context_embeddings()),
                 (res.embeddings(), disk.embeddings())):
        assert _same(a, b)


def test_tiered_trainer_reports_hit_rate(small_graph):
    _, tie, _ = _train_pair(small_graph, _cfg(), 10**9, epochs=2)
    st = tie.cache_stats()
    assert st["hit_rate"] > 0.3
    assert st["hbm_bytes_moved"] > 0
    assert st["vertex"]["promotions"] > 0


def test_tiered_rejects_multi_shard():
    tr = TieredEmbeddingTrainer(64, HybridConfig(**_cfg(subparts=1)),
                                hbm_rows=8, device="cpu")
    assert tr.part.num_shards == 1
    # refused before the resident trainer asks for a process group
    with pytest.raises(ValueError, match="single-shard"):
        TieredEmbeddingTrainer(64, HybridConfig(**_cfg(subparts=1)),
                               hbm_rows=8, dims=(1, 2), device="cpu")


# ------------------------------------------------------------ against JAX
def _jax_draws(cfg, k, nmb):
    """The JAX tiered trainer's pool positions, (1, k, nmb, S)."""
    pidx = _replay_neg_indices(np.int32(cfg.get("seed", 0)), total=k * nmb,
                               S=cfg["negatives"], pool_n=cfg["neg_pool"])
    return np.array(pidx).reshape(1, k, nmb, cfg["negatives"])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiered_matches_jax_tiered(small_graph, dtype):
    """Two episodes at budget 48 through both packages' tiered trainers
    (the ``ref`` route on both), the JAX negative stream injected: tables
    and loss within test_torch_train's tolerances, cache statistics and
    residency exactly JAX's after each episode."""
    _against_jax_tiered(small_graph, dtype, inject=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiered_matches_jax_tiered_on_its_own_draws(small_graph, dtype):
    """The same two episodes with nothing injected: the port's own
    negatives are JAX's, so every check above holds."""
    _against_jax_tiered(small_graph, dtype, inject=False)


def test_tiered_default_negatives_are_the_jax_replay(small_graph):
    """With no ``neg_draws`` the positions are JAX's ``_replay_neg_indices``
    bit for bit, and the rows they give are kept per episode shape."""
    cfg = _cfg()
    tt = TieredEmbeddingTrainer(small_graph.num_nodes, HybridConfig(**cfg),
                                degrees=small_graph.degrees(), hbm_rows=48,
                                device="cpu")
    k, nmb = cfg["subparts"], 5
    np.testing.assert_array_equal(
        tt._negative_positions(1, k, nmb, None).numpy(),
        _jax_draws(cfg, k, nmb))
    rows = tt._negatives(1, k, nmb, None)
    np.testing.assert_array_equal(rows, tt.pool[0][_jax_draws(cfg, k, nmb)])
    assert tt._negatives(1, k, nmb, None) is rows


def _against_jax_tiered(small_graph, dtype, *, inject):
    g, cfg = small_graph, _cfg(dtype=dtype, impl="ref")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jt = JTiered(g.num_nodes, mesh, JConfig(**cfg), degrees=g.degrees(),
                 hbm_rows=48)
    tt = TieredEmbeddingTrainer(g.num_nodes, HybridConfig(**cfg),
                                degrees=g.degrees(), hbm_rows=48,
                                device="cpu")
    np.testing.assert_array_equal(tt.pool, jt.pool)
    jt.init_embeddings()
    tt.init_embeddings()
    rtol, atol = TOL[dtype]
    k = cfg["subparts"]
    for i, pairs in enumerate(_pairs(g, 2)):
        jeb = jbuild(pairs, jt.part, pad_multiple=cfg["minibatch"])
        eb = build_episode_blocks(pairs, tt.part,
                                  pad_multiple=cfg["minibatch"])
        draws = (_jax_draws(cfg, k, eb.block_cap // cfg["minibatch"])
                 if inject else None)
        lr = cfg["lr"] * (1 - i / 2)
        jloss = jt.train_episode(jeb, lr=lr)
        loss = tt.train_episode(eb, lr=lr, neg_draws=draws)
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        assert tt.cache_stats() == jt.cache_stats()
        for mine, ref in ((tt.vert_t, jt.vert_t), (tt.ctx_t, jt.ctx_t)):
            np.testing.assert_array_equal(mine.slot_of, ref.slot_of)
            np.testing.assert_array_equal(mine.row_of, ref.row_of)
        for got, want in ((tt.embeddings(), jt.embeddings()),
                          (tt.context_embeddings(), jt.context_embeddings())):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spill_files_match_jax(tmp_path, small_graph, dtype):
    """After init_embeddings, vertex.master and context.master hold the
    JAX trainer's bytes."""
    g, cfg = small_graph, _cfg(dtype=dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jt = JTiered(g.num_nodes, mesh, JConfig(**cfg), degrees=g.degrees(),
                 hbm_rows=16, spill_dir=str(tmp_path / "jax"))
    tt = TieredEmbeddingTrainer(g.num_nodes, HybridConfig(**cfg),
                                degrees=g.degrees(), hbm_rows=16,
                                spill_dir=str(tmp_path / "port"),
                                device="cpu")
    jt.init_embeddings()
    tt.init_embeddings()
    for t in (jt.vert_t, jt.ctx_t, tt.vert_t, tt.ctx_t):
        t.master.flush()
    for name in ("vertex.master", "context.master"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want
        assert len(want) == g.num_nodes * 16 * (4 if dtype == "float32"
                                                else 2)


# ------------------------------------- policy and byte model, both packages
PACKAGES = ["jax", "torch"]


def _mk_table(pkg, rows=32, dim=4, budget=8, policy="freq"):
    if pkg == "jax":
        return JTable(rows, dim, np.float32, budget, policy=policy, name="t")
    return TieredTable(rows, dim, np.float32, budget, policy=policy,
                       name="t", device="cpu")


def _cache(t) -> np.ndarray:
    return np.asarray(t.cache)


def _set_cache_row(t, slot, value):
    if isinstance(t, JTable):
        t.cache = t.cache.at[slot].set(value)
    else:
        t.cache[slot] = value


@pytest.mark.parametrize("pkg", PACKAGES)
def test_promotion_deterministic(pkg):
    """Same access history -> identical residency, bit for bit."""
    ids = np.array([3, 3, 3, 7, 7, 1, 9, 9, 9, 9])
    tabs = [_mk_table(pkg) for _ in range(2)]
    for t in tabs:
        t.master[:] = np.arange(32, dtype=np.float32)[:, None]
        t.note_access(ids, np.ones_like(ids))
        t.promote()
    assert np.array_equal(tabs[0].slot_of, tabs[1].slot_of)
    assert np.array_equal(tabs[0].row_of, tabs[1].row_of)
    assert np.array_equal(_cache(tabs[0]), _cache(tabs[1]))
    # the promoted rows' values came up from the master
    live = tabs[0].row_of >= 0
    np.testing.assert_array_equal(_cache(tabs[0])[:8][live, 0],
                                  tabs[0].row_of[live].astype(np.float32))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_freq_promotes_hottest_and_evicts(pkg):
    t = _mk_table(pkg, budget=2)
    t.note_access(np.array([1, 2, 3]), np.array([5.0, 3.0, 1.0]))
    t.promote()
    assert set(t.row_of) == {1, 2}
    # row 3 overtakes row 2 -> 2 evicted, 3 promoted, 1 stays
    t.note_access(np.array([3]), np.array([10.0]))
    assert t.promote() == (1, 1)
    assert set(t.row_of) == {1, 3}
    assert t.stats.evictions == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_lru_promotes_most_recent(pkg):
    t = _mk_table(pkg, budget=2, policy="lru")
    for row in (1, 2, 3):
        t.note_access(np.array([row]), np.array([1.0]))
    t.promote()
    assert set(t.row_of) == {2, 3}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_eviction_writes_back_updated_rows(pkg):
    t = _mk_table(pkg, budget=1)
    t.master[:] = 1.0
    t.note_access(np.array([5]), np.array([2.0]))
    t.promote()
    _set_cache_row(t, t.slot_of[5], 42.0)          # simulate an update
    t.note_access(np.array([6]), np.array([9.0]))
    t.promote()                                    # 5 evicted for 6
    assert t.slot_of[5] == -1
    assert np.all(t.master[5] == 42.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_hit_rate_oracle_powerlaw(pkg):
    """After one promotion a 25 %-of-rows cache catches the oracle mass of
    the hot set of a Zipf-like stream."""
    rows, budget = 256, 64
    rng = np.random.default_rng(0)
    ranks = rng.zipf(1.3, 200_000)
    stream = (ranks[ranks <= rows] - 1).astype(np.int64)
    hot = np.argsort(-np.bincount(stream, minlength=rows),
                     kind="stable")[:budget]
    oracle = np.bincount(stream, minlength=rows)[hot].sum() / stream.size
    assert oracle >= 0.8, oracle
    t = _mk_table(pkg, rows=rows, dim=4, budget=budget)
    ids, counts = np.unique(stream, return_counts=True)
    t.note_access(ids, counts)
    t.promote()
    uids = np.unique(stream)
    t.plan(uids, uids.size, stream)
    assert t.stats.hit_rate == pytest.approx(oracle)
    assert set(t.row_of) == set(hot)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cache_stats_byte_model(pkg):
    t = _mk_table(pkg, rows=16, dim=4, budget=2)
    t.note_access(np.array([0, 1]), np.array([3.0, 2.0]))
    t.promote()
    host0 = t.stats.host_bytes_moved
    assert host0 == 2 * 4 * 4                     # 2 promoted rows up
    plan = t.plan(np.array([0, 1, 5]), 4, np.array([0, 0, 1, 5]))
    s = t.stats
    assert (s.hits, s.misses) == (3, 1)           # traffic-weighted
    assert (s.row_hits, s.row_misses) == (2, 1)   # unique-row gathers
    assert s.hbm_bytes_moved == 2 * 2 * 4 * 4     # 2 hot rows x (in + out)
    assert s.host_bytes_moved == host0 + 2 * 1 * 4 * 4
    # the plan's device arrays, padded to the cap
    for name, want in (("hot", [1, 1, 0, 0]), ("slot", [0, 1, 0, 0]),
                       ("rank", [0, 0, 0, 0]), ("wslot", [0, 1, 2, 2]),
                       ("coldpos", [2, 0, 0, 0])):
        np.testing.assert_array_equal(np.asarray(getattr(plan, name)),
                                      want, err_msg=name)
    np.testing.assert_array_equal(plan.cold_ids, [5])


@pytest.mark.parametrize("stats_cls", [JCacheStats, CacheStats],
                         ids=PACKAGES)
def test_cache_stats_dataclass(stats_cls):
    s = stats_cls()
    assert s.hit_rate == 0.0
    s.hits, s.misses = 3, 1
    assert s.hit_rate == 0.75
    assert s.as_dict()["hit_rate"] == 0.75


# ---------------------------------------------------------------- launcher
SMOKE = ["--nodes", "400", "--epochs", "2", "--episodes", "2", "--dim", "32",
         "--walk-workers", "1", "--device", "cpu"]


def _tables(path):
    arrays, _ = jload(path)
    return [np.asarray(arrays[k]).tobytes() for k in ("vertex", "context")]


def test_launcher_tiered_checkpoint_equals_resident(tmp_path, capsys):
    """--hbm-rows 40 (then with --cache-policy lru --cache-spill) writes
    the resident launcher's checkpoint bit for bit, prints the JAX
    launcher's two lines and returns the cache statistics."""
    res = ttrain.main([*SMOKE, "--out-dir", str(tmp_path / "res")])
    assert res["cache"] is None
    tie = ttrain.main([*SMOKE, "--out-dir", str(tmp_path / "tie"),
                       "--hbm-rows", "40"])
    out = capsys.readouterr().out
    assert "tiered tables: hbm_rows=40 policy=freq\n" in out
    assert "cache: hit_rate " in out
    assert tie["cache"]["hbm_rows"] == 40 and tie["cache"]["hit_rate"] > 0
    assert tie["episodes"] == res["episodes"] == 4
    assert _tables(tie["checkpoint"]) == _tables(res["checkpoint"])
    spill = ttrain.main([*SMOKE, "--out-dir", str(tmp_path / "spill"),
                         "--hbm-rows", "40", "--cache-policy", "lru",
                         "--cache-spill"])
    out = capsys.readouterr().out
    assert "policy=lru (disk-backed master)" in out
    assert spill["cache"]["policy"] == "lru"
    for name in ("vertex.master", "context.master"):
        assert os.path.getsize(tmp_path / "spill" / "master_spill" / name) > 0
    assert _tables(spill["checkpoint"]) == _tables(res["checkpoint"])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TieredEmbeddingTrainer(100, HybridConfig(**_cfg()), hbm_rows=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TieredTable(16, 4, "float32", 2)
