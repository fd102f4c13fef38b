"""The parameter-server baseline (``core/baseline_ps.py``), port against
the port's resident trainer (bitwise, given the same draws on one device)
and against the JAX package's baseline (its per-block key chain injected):
tables and loss within the one-episode tolerances of
``tests/test_torch_train.py`` and the structural counters exactly, on one
device and on two (JAX on two host devices, in a subprocess); then the
paper's accuracy claim, ported from ``tests/test_system.py``: the hybrid
trainer's AUC is not worse than the baseline's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import HybridConfig as JConfig
from repro.core import ParameterServerTrainer as JPS
from repro.core.partition import build_episode_blocks as jbuild
from repro_torch.core import (HybridConfig, HybridEmbeddingTrainer,
                              ParameterServerTrainer, build_episode_blocks)
from repro_torch.core import eval as ev
from repro_torch.graph.csr import build_csr
from repro_torch.walk import MemorySampleStore, WalkConfig, WalkEngine

SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG = dict(dim=32, minibatch=32, negatives=8, subparts=2, neg_pool=2048,
           lr=0.05, seed=3)
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


def _episode(nodes, n_pairs, seed):
    rng = np.random.default_rng(seed)
    degrees = rng.integers(1, 20, nodes)
    pairs = rng.integers(0, nodes, size=(n_pairs, 2)).astype(np.int32)
    return degrees, pairs


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ps_bitwise_matches_resident_with_same_draws(dtype):
    """One device: the same blocks, in the same order, on the same sub-part
    tables, with the resident trainer's draws, give its tables bit for
    bit."""
    degrees, pairs = _episode(257, 1500, 5)
    cfg = HybridConfig(**CFG, dtype=dtype)
    res = HybridEmbeddingTrainer(257, cfg, degrees=degrees, device="cpu")
    ps = ParameterServerTrainer(257, 1, cfg, degrees=degrees, device="cpu")
    res.init_embeddings()
    np.testing.assert_array_equal(ps.pool, res.pool)
    assert _same(ps.embeddings(), res.embeddings())
    for seed in (0, 1):
        eb = build_episode_blocks(pairs[seed::2], res.part,
                                  pad_multiple=cfg.minibatch)
        nmb = eb.block_cap // cfg.minibatch
        draws = np.random.default_rng(seed).integers(
            0, cfg.neg_pool, (1, cfg.subparts, nmb, cfg.negatives))
        l_res = res.train_episode(eb, lr=0.04, neg_draws=draws)
        l_ps = ps.train_episode(eb, lr=0.04, neg_draws=draws)
        np.testing.assert_allclose(l_ps, l_res, rtol=1e-6)
    assert _same(ps.embeddings(), res.embeddings())
    assert _same(ps.context_embeddings(), res.context_embeddings())
    # per episode: a vertex sub-part round trip per block (both
    # non-empty), one context write-back
    item = 4 if dtype == "float32" else 2
    sub = res.part.rows_per_subpart * cfg.dim * item
    ctx = res.part.padded_num_nodes * cfg.dim * item
    assert ps.counters.host_syncs == 2 * (2 * cfg.subparts + 1)
    assert ps.counters.bytes_through_host == 2 * (
        2 * cfg.subparts * sub + ctx)


def _jax_ps_draws(cfg, counts, nmb):
    """The JAX baseline's pool positions as (devices, rounds, k, nmb, S):
    block after non-empty block (rounds, then devices, then sub-parts)
    keys ``PRNGKey(seed + 131 step)`` and splits it once a minibatch."""
    n, k, S = counts.shape[0], counts.shape[-1], cfg["negatives"]
    out = np.zeros((n, n, k, nmb, S), np.int64)
    step = 0
    for r in range(n):
        for i in range(n):
            for j in range(k):
                if counts[i, 0, r, j] == 0:
                    continue
                key = jax.random.PRNGKey(cfg["seed"] + 131 * step)
                step += 1
                for t in range(nmb):
                    key, kneg = jax.random.split(key)
                    out[i, r, j, t] = np.asarray(jax.random.randint(
                        kneg, (S,), 0, cfg["neg_pool"]))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ps_matches_jax_baseline(dtype):
    """One device, one episode, the ``ref`` route on both sides, the JAX key
    chain injected: tables and loss within tolerance, the counters
    exactly JAX's."""
    _against_jax_baseline(dtype, inject=True, episodes=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ps_matches_jax_baseline_on_its_own_draws(dtype):
    """Two episodes with nothing injected: the port keys each non-empty
    block as JAX does, so the checks above hold."""
    _against_jax_baseline(dtype, inject=False, episodes=2)


def test_ps_default_negatives_are_the_jax_chain():
    """Two devices: with no ``neg_draws`` each non-empty block's positions,
    in (round, device, sub-part) order, are JAX's ``PRNGKey(seed + 131
    step)`` chain bit for bit, drawn once and kept."""
    degrees, pairs = _episode(301, 900, 11)
    cfg = dict(CFG, dtype="float32")
    ps = ParameterServerTrainer(301, 2, HybridConfig(**cfg), degrees=degrees,
                                device="cpu")
    eb = build_episode_blocks(pairs, ps.part, pad_multiple=cfg["minibatch"])
    nmb = eb.block_cap // cfg["minibatch"]
    want = _jax_ps_draws(cfg, eb.counts, nmb)
    step = 0
    for r in range(2):
        for i in range(2):
            for j in range(cfg["subparts"]):
                if eb.counts[i, 0, r, j] == 0:
                    continue
                got = ps._block_positions(step, nmb, ps.devices[i])
                np.testing.assert_array_equal(got.numpy(), want[i, r, j])
                assert ps._block_positions(step, nmb, ps.devices[i]) is got
                step += 1
    assert step > 2


def _against_jax_baseline(dtype, *, inject, episodes):
    degrees, pairs = _episode(200, 700, 9)
    cfg = dict(CFG, dtype=dtype, impl="ref")
    jps = JPS(200, 1, JConfig(**cfg), degrees=degrees)
    ps = ParameterServerTrainer(200, 1, HybridConfig(**cfg), degrees=degrees,
                                device="cpu")
    np.testing.assert_array_equal(ps.pool, jps._pool)
    jeb = jbuild(pairs, jps.part, pad_multiple=cfg["minibatch"])
    eb = build_episode_blocks(pairs, ps.part, pad_multiple=cfg["minibatch"])
    draws = (_jax_ps_draws(cfg, eb.counts, eb.block_cap // cfg["minibatch"])
             if inject else None)
    for _ in range(episodes):
        jloss = jps.train_episode(jeb, lr=0.04)
        loss = ps.train_episode(eb, lr=0.04, neg_draws=draws)
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert (ps.counters.host_syncs, ps.counters.bytes_through_host) == (
        jps.counters.host_syncs, jps.counters.bytes_through_host)
    rtol, atol = TOL[dtype]
    for got, want in ((ps.embeddings(), jps.embeddings()),
                      (ps.context_embeddings(), jps.context_embeddings())):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)


# the JAX baseline on two host devices: one episode, its draws and results
JAX_TWO_DEVICES = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_baseline_ps import _episode, _jax_ps_draws
from repro.core import HybridConfig, ParameterServerTrainer
from repro.core.partition import build_episode_blocks
cfg, out = json.loads(sys.argv[1])
degrees, pairs = _episode(301, 900, 11)
ps = ParameterServerTrainer(301, 2, HybridConfig(**cfg), degrees=degrees)
assert len(ps.devices) == 2, ps.devices
eb = build_episode_blocks(pairs, ps.part, pad_multiple=cfg["minibatch"])
draws = _jax_ps_draws(cfg, eb.counts, eb.block_cap // cfg["minibatch"])
loss = ps.train_episode(eb, lr=0.04)
np.savez(out, draws=draws, loss=loss, vert=np.asarray(ps.embeddings()),
         ctx=np.asarray(ps.context_embeddings()),
         counters=[ps.counters.host_syncs, ps.counters.bytes_through_host])
"""


def test_ps_two_devices_matches_jax(tmp_path):
    """num_devices=2 on the CPU (two vertex shards bouncing between two
    devices through the host) against the JAX baseline on two host
    devices, f32, the JAX draws injected."""
    cfg = dict(CFG, dtype="float32", impl="ref")
    out = str(tmp_path / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_TWO_DEVICES,
                        json.dumps([cfg, out]), str(Path(__file__).parent)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = np.load(out)
    degrees, pairs = _episode(301, 900, 11)
    ps = ParameterServerTrainer(301, 2, HybridConfig(**cfg), degrees=degrees,
                                device="cpu")
    assert [str(d) for d in ps.devices] == ["cpu", "cpu"]
    eb = build_episode_blocks(pairs, ps.part, pad_multiple=cfg["minibatch"])
    loss = ps.train_episode(eb, lr=0.04, neg_draws=ref["draws"])
    np.testing.assert_allclose(loss, float(ref["loss"]), rtol=1e-4)
    assert [ps.counters.host_syncs, ps.counters.bytes_through_host] == list(
        ref["counters"])
    rtol, atol = TOL["float32"]
    np.testing.assert_allclose(ps.embeddings().numpy(), ref["vert"],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(ps.context_embeddings().numpy(), ref["ctx"],
                               rtol=rtol, atol=atol)
    assert not np.allclose(ref["ctx"], 0.0)


# ------------------------------------------------ tests/test_system.py:72-86
def _train(trainer, g, epochs, cfg):
    for epoch in range(epochs):
        pairs = WalkEngine(g, WalkConfig(walk_length=10, window=5,
                                         episodes=1, seed=epoch),
                           MemorySampleStore()).episode_pairs(epoch, 0)
        eb = build_episode_blocks(pairs, trainer.part,
                                  pad_multiple=cfg.minibatch)
        trainer.train_episode(eb, lr=cfg.lr * max(1 - epoch / epochs, 0.05))


def _vv_auc(V, test_e, neg_e):
    V = V.float().numpy()
    Vn = V / (np.linalg.norm(V, axis=1, keepdims=True) + 1e-9)
    return ev.auc_score(
        np.einsum("ij,ij->i", Vn[test_e[:, 0]], Vn[test_e[:, 1]]),
        np.einsum("ij,ij->i", Vn[neg_e[:, 0]], Vn[neg_e[:, 1]]))


def test_hybrid_accuracy_not_worse_than_ps_baseline():
    """The paper's 'competitive or better accuracy' against GraphVite, on
    the reference test's community graph and schedule."""
    rng = np.random.default_rng(0)
    n, k = 1200, 12
    comm = rng.integers(0, k, n)
    src, dst = [], []
    for _ in range(30):
        a = rng.integers(0, n, 20000)
        b = rng.integers(0, n, 20000)
        keep = rng.random(20000) < np.where(comm[a] == comm[b], 0.08, 0.001)
        src.append(a[keep])
        dst.append(b[keep])
    g_full = build_csr(np.stack([np.concatenate(src), np.concatenate(dst)],
                                1), n)
    train_e, test_e = ev.split_edges(g_full, 0.05, seed=1)
    g = build_csr(train_e, n, symmetrize=False, dedup=False)
    neg_e = ev.sample_negative_pairs(g_full, len(test_e), seed=3)
    cfg = HybridConfig(dim=64, minibatch=32, negatives=8, subparts=2,
                       neg_pool=2048, lr=0.025)
    hy = HybridEmbeddingTrainer(n, cfg, degrees=g.degrees(), device="cpu")
    hy.init_embeddings()
    _train(hy, g, 8, cfg)
    auc_h = _vv_auc(hy.embeddings(), test_e, neg_e)
    ps = ParameterServerTrainer(n, 1, cfg, degrees=g.degrees(), device="cpu")
    _train(ps, g, 8, cfg)
    auc_p = _vv_auc(ps.embeddings(), test_e, neg_e)
    # the JAX package reaches 0.6059 and 0.6175 here (bf16, its streams)
    assert auc_h > auc_p - 0.03, (auc_h, auc_p)


def test_ps_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParameterServerTrainer(100, 1, HybridConfig(**CFG))
