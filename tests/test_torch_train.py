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
from repro_torch.kernels import ops
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


def _episode_pair(cfg, nodes, n_pairs, seed, jimpl, impl="pallas_fused2",
                  *, inject=True, episodes=1):
    """``episodes`` episodes through both trainers from the same init, the
    JAX one on route ``jimpl`` and the port on ``impl``, the port given the
    JAX negative stream replayed (``inject``) or drawing its own. Returns
    (port loss, jax loss, port trainer, jax trainer) of the last."""
    degrees, pairs = _pair_episode(nodes, n_pairs, seed)
    jt = JTrainer(nodes, _mesh(), JConfig(**cfg, impl=jimpl), degrees=degrees)
    tt = HybridEmbeddingTrainer(nodes, HybridConfig(**cfg, impl=impl),
                                degrees=degrees, device="cpu")
    jt.init_embeddings()
    tt.set_embeddings(jt.embeddings(), jt.context_embeddings())
    jeb = jbuild(pairs, jt.part, pad_multiple=cfg["minibatch"])
    eb = build_episode_blocks(pairs, tt.part, pad_multiple=cfg["minibatch"])
    k, nmb = cfg["subparts"], eb.block_cap // cfg["minibatch"]
    draws = (_jax_neg_draws(cfg["seed"], k, nmb, cfg["negatives"],
                            cfg["neg_pool"]) if inject else None)
    lr = 0.04
    for _ in range(episodes):
        losses = (tt.train_episode(eb, lr=lr, neg_draws=draws),
                  jt.train_episode(jeb, lr=lr))
    return (*losses, tt, jt)


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


def test_default_negatives_are_the_jax_stream():
    """With no ``neg_draws`` the trainer draws the JAX trainer's positions
    (``fold_in(PRNGKey(seed), 0)``, one split a minibatch) bit for bit, and
    draws them once per episode shape."""
    tt = HybridEmbeddingTrainer(257, HybridConfig(**CFG), device="cpu")
    k, nmb, S = CFG["subparts"], 6, CFG["negatives"]
    got = tt._negative_positions(1, k, nmb, None)
    np.testing.assert_array_equal(
        got[0].numpy(), _jax_neg_draws(CFG["seed"], k, nmb, S,
                                       CFG["neg_pool"]))
    assert tt._negative_positions(1, k, nmb, None) is got
    assert tuple(tt._negative_positions(1, k, nmb + 1, None).shape) == (
        1, k, nmb + 1, S)


@pytest.mark.parametrize("dtype,tol", [("float32", (2e-4, 1e-6)),
                                       ("bfloat16", (3e-2, 3e-3))])
def test_two_episodes_match_jax_trainer_on_their_own_draws(dtype, tol):
    """Two episodes with nothing injected: the port's own negatives are
    JAX's, so its tables meet the replayed cases' tolerances."""
    loss, jloss, tt, jt = _episode_pair(dict(CFG, dtype=dtype), 257, 600, 7,
                                        "ref", inject=False, episodes=2)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for got, want in ((tt.embeddings(), jt.embeddings()),
                      (tt.context_embeddings(), jt.context_embeddings())):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol[0],
                                   atol=tol[1])


def _jax_scan_sum(seen):
    """JAX's episode loss sum (``core/hybrid.py``'s scan carry) of the
    minibatch losses ``seen`` as (block, loss) in launch order: a running
    f32 sum over each block's minibatches from 0, then the blocks' sums
    added one by one in their order, from 0."""
    blocks = {}
    for blk, loss in seen:
        lj = blocks.get(blk, np.float32(0.0))
        blocks[blk] = np.float32(lj + np.float32(loss))
    lacc = np.float32(0.0)
    for blk in sorted(blocks):
        lacc = np.float32(lacc + blocks[blk])
    return lacc


def _loss_spy(monkeypatch):
    """Record each minibatch's own loss and its block (the offset of the
    block's running sum) as the trainer launches it; the running sum is
    then added to as the routes add to it."""
    seen = []
    real = ops.sgns_step

    def spy(*args, loss_into, **kw):
        v, c, loss = real(*args, **kw)
        seen.append((loss_into.storage_offset(), np.float32(loss.item())))
        return v, c, loss_into.add_(loss)

    monkeypatch.setattr(ops, "sgns_step", spy)
    return seen


@pytest.mark.parametrize("subparts", [1, 3])
def test_episode_loss_is_summed_as_jax_scan_sums_it(monkeypatch, subparts):
    """The episode's loss is JAX's scan carry (``lacc + loss`` a minibatch
    inside a block from 0, ``lacc + lj`` a block): bitwise that order's f32
    sum of the minibatches' own losses over the samples, and within 1e-4 of
    the JAX trainer's episode loss with its negative stream replayed (the
    ring tests hold several rounds to it)."""
    seen = _loss_spy(monkeypatch)
    cfg = dict(CFG, dtype="float32", subparts=subparts)
    loss, jloss, tt, jt = _episode_pair(cfg, 257, 600, 7, "ref")
    assert len({blk for blk, _ in seen}) == subparts
    assert len(seen) > 2 * subparts          # several minibatches a block
    total = np.float32(600)
    assert loss == float(_jax_scan_sum(seen) / total)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)


@pytest.mark.parametrize("impl", ["ref", "pallas", "pallas_fused",
                                  "pallas_fused2"])
def test_sgns_step_adds_its_loss_into_a_running_sum(impl):
    """``loss_into`` on every route: the same tables bit for bit, and the
    running sum returned in the loss's place, plus the loss in one f32 add."""
    rng = np.random.default_rng(5)
    vert, ctx = (torch.from_numpy(rng.normal(0, 0.1, (64, 16)).astype(
        np.float32)) for _ in range(2))
    iv, ic = (torch.from_numpy(rng.integers(0, 64, 24).astype(np.int32))
              for _ in range(2))
    inn = torch.from_numpy(rng.integers(0, 64, 5).astype(np.int32))
    mask = torch.ones(24)
    v1, c1, loss = ops.sgns_step(vert.clone(), ctx.clone(), iv, ic, inn,
                                 mask, 0.05, impl=impl)
    acc = torch.tensor(1.625, dtype=torch.float32)
    v2, c2, got = ops.sgns_step(vert.clone(), ctx.clone(), iv, ic, inn, mask,
                                0.05, impl=impl, loss_into=acc)
    assert got is acc and torch.equal(v1, v2) and torch.equal(c1, c2)
    assert got.item() == float(np.float32(1.625) + np.float32(loss.item()))


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
