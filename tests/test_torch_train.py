"""The training slice as a whole, port against the JAX package: the
trainer's init and negative pool bitwise, one episode against the JAX
hybrid trainer on a (1, 1) mesh with the JAX negative stream replayed, and
the port's launcher end to end on the CPU with checkpoints crossing
between the packages in both directions."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HybridConfig as JConfig
from repro.core import HybridEmbeddingTrainer as JTrainer
from repro.core.partition import build_episode_blocks as jbuild
from repro.train.checkpoint import load_arrays as jload
from repro.train.checkpoint import save_checkpoint as jsave
from repro_torch.core import HybridConfig, HybridEmbeddingTrainer
from repro_torch.core.partition import build_episode_blocks
from repro_torch.launch import embed_serve
from repro_torch.launch import train as ttrain

CFG = dict(dim=32, minibatch=32, negatives=8, subparts=2, neg_pool=2048,
           lr=0.05, seed=3)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_neg_draws(seed, k, nmb, S, pool_n):
    """The JAX trainer's pool positions: fold_in(PRNGKey(seed), device 0),
    then one split per minibatch in (sub-part, minibatch) order."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    out = np.zeros((k, nmb, S), np.int64)
    for j in range(k):
        for i in range(nmb):
            key, kneg = jax.random.split(key)
            out[j, i] = np.asarray(jax.random.randint(kneg, (S,), 0, pool_n))
    return out


def _pair_episode(nodes, n_pairs, seed):
    rng = np.random.default_rng(seed)
    degrees = rng.integers(1, 20, nodes)
    pairs = rng.integers(0, nodes, size=(n_pairs, 2)).astype(np.int32)
    return degrees, pairs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_negative_pool_bitwise(dtype):
    degrees, _ = _pair_episode(301, 0, 1)
    cfg = dict(CFG, dtype=dtype)
    jt = JTrainer(301, _mesh(), JConfig(**cfg), degrees=degrees)
    tt = HybridEmbeddingTrainer(301, HybridConfig(**cfg), degrees=degrees,
                                device="cpu")
    np.testing.assert_array_equal(tt.pool, jt.pool)
    jt.init_embeddings()
    tt.init_embeddings()
    for got, want in ((tt.embeddings(), jt.embeddings()),
                      (tt.context_embeddings(), jt.context_embeddings())):
        want = np.asarray(want)
        if dtype == "bfloat16":
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want)
    assert tt.vert.shape[0] == tt.part.padded_num_nodes


def _episode_pair(cfg, nodes, n_pairs, seed, jimpl, impl="pallas_fused2"):
    """One episode through both trainers from the same init, the JAX one on
    route ``jimpl`` and the port on ``impl``, the port given the JAX
    negative stream. Returns (port loss, jax loss, port trainer, jax
    trainer)."""
    degrees, pairs = _pair_episode(nodes, n_pairs, seed)
    jt = JTrainer(nodes, _mesh(), JConfig(**cfg, impl=jimpl), degrees=degrees)
    tt = HybridEmbeddingTrainer(nodes, HybridConfig(**cfg, impl=impl),
                                degrees=degrees, device="cpu")
    jt.init_embeddings()
    tt.set_embeddings(jt.embeddings(), jt.context_embeddings())
    jeb = jbuild(pairs, jt.part, pad_multiple=cfg["minibatch"])
    eb = build_episode_blocks(pairs, tt.part, pad_multiple=cfg["minibatch"])
    k, nmb = cfg["subparts"], eb.block_cap // cfg["minibatch"]
    draws = _jax_neg_draws(cfg["seed"], k, nmb, cfg["negatives"],
                           cfg["neg_pool"])
    lr = 0.04
    return (tt.train_episode(eb, lr=lr, neg_draws=draws),
            jt.train_episode(jeb, lr=lr), tt, jt)


def test_episode_matches_jax_trainer_f32():
    """One f32 episode, 20 minibatches over 2 sub-parts, against the JAX
    trainer's ref path on a (1, 1) mesh."""
    loss, jloss, tt, jt = _episode_pair(dict(CFG, dtype="float32"), 257, 600,
                                        7, "ref")
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tt.embeddings().numpy(), jt.embeddings(),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tt.context_embeddings().numpy(),
                               jt.context_embeddings(), rtol=2e-4, atol=1e-6)


def test_episode_matches_jax_fused_kernel_bf16():
    """A tiny bf16 episode (4 minibatches) against the JAX trainer running
    the fused Pallas update in interpret mode."""
    loss, jloss, tt, jt = _episode_pair(dict(CFG, dtype="bfloat16"), 120, 100,
                                        9, "pallas_fused2")
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for got, want in ((tt.embeddings(), jt.embeddings()),
                      (tt.context_embeddings(), jt.context_embeddings())):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2,
                                   atol=3e-3)


def test_trainer_refuses_more_shards_and_bad_draws():
    # more than one shard needs a process group of that many ranks
    # (tests/test_torch_ring.py runs them)
    with pytest.raises(ValueError, match="start a process group of 2"):
        HybridEmbeddingTrainer(100, HybridConfig(**CFG), dims=(1, 2),
                               device="cpu")
    tt = HybridEmbeddingTrainer(100, HybridConfig(**CFG), device="cpu")
    tt.init_embeddings()
    eb = build_episode_blocks(np.zeros((10, 2), np.int32), tt.part,
                              pad_multiple=32)
    with pytest.raises(ValueError, match="neg_draws"):
        tt.train_episode(eb, neg_draws=np.zeros((1, 1, 8)))


def test_device_tensors_install_without_a_copy():
    tt = HybridEmbeddingTrainer(100, HybridConfig(**CFG, dtype="float32"),
                                device="cpu")
    vert = torch.zeros((100, 32))
    ctx = torch.ones((100, 32))
    tt.set_embeddings(vert, ctx)
    assert tt.vert.data_ptr() == vert.data_ptr()
    assert tt.ctx.data_ptr() == ctx.data_ptr()


SMOKE = ["--nodes", "400", "--epochs", "2", "--episodes", "2", "--dim", "32",
         "--walk-workers", "1"]


def test_launcher_checkpoint_loads_in_jax_and_serves(tmp_path):
    """The CI smoke run on the CPU: its checkpoint loads in the JAX package
    bitwise and serves through the port's launcher at recall 1.0."""
    out = str(tmp_path / "run")
    stats = ttrain.main([*SMOKE, "--out-dir", out, "--ckpt-every", "2",
                         "--device", "cpu"])
    assert stats["episodes"] == 4 and stats["edges"] > 0
    assert 0.0 <= stats["auc"] <= 1.0 and stats["edges_per_s"] > 0
    path = os.path.join(out, "embeddings_2.npz")
    assert stats["checkpoint"] == path
    arrays, step = jload(path)
    assert step == 2 and arrays["vertex"].shape == (400, 32)
    assert arrays["vertex"].dtype == np.asarray(
        jnp.zeros(0, jnp.bfloat16)).dtype
    served = embed_serve.main(["--ckpt", path, "--k", "10", "--queries", "64",
                               "--qps", "0", "--device", "cpu",
                               "--check-recall", "1.0"])
    assert served["recall"] == 1.0
    assert os.path.exists(os.path.join(out, "resume.npz"))


def test_jax_written_resume_checkpoint_resumes_in_port(tmp_path, capsys):
    """A resume checkpoint written by the JAX package (bf16 tables, cursor
    at epoch 1) continues in the port's launcher."""
    out = tmp_path / "run"
    out.mkdir()
    jt = JTrainer(400, _mesh(), JConfig(dim=32, minibatch=64, negatives=5,
                                        subparts=4, neg_pool=4096))
    jt.init_embeddings()
    jsave(str(out / "resume.npz"),
          {"vertex": jt.embeddings(), "context": jt.context_embeddings()},
          step=2, extra={"__cursor__": np.asarray((1, 0), np.int64)})
    stats = ttrain.main([*SMOKE, "--out-dir", str(out), "--resume",
                         "--device", "cpu"])
    assert "resume <- " in capsys.readouterr().out
    assert stats["episodes"] == 2                # epoch 1 only
    arrays, step = jload(str(out / "embeddings_2.npz"))
    assert step == 2 and not np.array_equal(
        np.asarray(arrays["vertex"]).view(np.int16),
        np.asarray(jt.embeddings()).view(np.int16))


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main([*SMOKE, "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HybridEmbeddingTrainer(100, HybridConfig(**CFG))
