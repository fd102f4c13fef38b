"""Long-sequence training in the port: chunked queries and remat.

The chunked ``_attend`` (queries in chunks of ``q_chunk`` against the
whole of k and v, each chunk's mask built from its own positions) against
the one-pass form and JAX's ``_attend`` at S = 2,500 (not a multiple of
1,024) with a sliding window and empty ring slots, within
``tests/test_models.py``'s tolerance for one function computed two ways
(rtol 1e-5, atol 1e-6). Remat (``cfg.remat``: each layer under
``torch.utils.checkpoint``) against no remat on reduced qwen1.5, MoE and
MLA configs: the loss bitwise equal, each gradient leaf within
``tests/test_torch_lm_train.py``'s ``GRAD_TOL`` of its largest element,
and the layers recomputed in the backward pass only when training.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch import configs
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import loss_and_grads, synthetic_batch

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-3
S_LONG = 2500
WINDOW = 700


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(window=WINDOW):
    return JaxModelConfig(name="t", arch_type="dense", num_layers=1,
                          d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                          vocab_size=64, head_dim=16, sliding_window=window)


def _qkv(S, *, seed=0, hole=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, S, 2, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    kv_pos = pos.copy()
    if hole:   # empty ring slots hold position -1
        kv_pos[:, 100:140] = -1
    return q, k, v, pos, kv_pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [0, WINDOW])
def test_chunked_attend_equals_one_pass_and_jax(window):
    jcfg = _cfg(window)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    q, k, v, pos, kv_pos = _qkv(S_LONG)
    got = tattn._attend(*_t(q, k, v, pos, kv_pos), cfg, q_chunk=1024)
    one = tattn._attend(*_t(q, k, v, pos, kv_pos), cfg, q_chunk=S_LONG)
    want = jattn._attend(*(jnp.asarray(a) for a in (q, k, v, pos, kv_pos)),
                         jcfg, q_chunk=1024)
    assert got.shape == (1, S_LONG, 4, 16)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunks_build_only_their_own_masks(monkeypatch):
    """No score or mask wider than a chunk's: every call of the scores
    sees at most ``q_chunk`` queries, the last chunk short (2500 = 2 x
    1024 + 452), and no padding."""
    cfg = ModelConfig(**dataclasses.asdict(_cfg()))
    seen = []
    real = tattn._gqa_scores_combine

    def spy(q, k, v, mask):
        seen.append((q.shape[1], tuple(mask.shape)))
        return real(q, k, v, mask)

    monkeypatch.setattr(tattn, "_gqa_scores_combine", spy)
    q, k, v, pos, kv_pos = _qkv(S_LONG)
    tattn._attend(*_t(q, k, v, pos, kv_pos), cfg, q_chunk=1024)
    assert seen == [(1024, (1, 1, 1024, S_LONG)),
                    (1024, (1, 1, 1024, S_LONG)),
                    (452, (1, 1, 452, S_LONG))]


def test_cross_attention_chunks_the_same_way():
    q, k, v, _, _ = _qkv(S_LONG, hole=False)
    got = tattn._attend_all(*_t(q, k, v), q_chunk=1024)
    one = tattn._attend_all(*_t(q, k, v), q_chunk=S_LONG)
    mask = jnp.ones((1, 1, S_LONG, S_LONG), bool)
    want = jattn._gqa_scores_combine(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), mask)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _reduced(arch):
    cfg = configs.get_config(arch).reduced(layers=2, d_model=128, experts=4)
    return dataclasses.replace(cfg, vocab_size=256)


REMAT_ARCHS = ["qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_keeps_the_loss_and_gradients(arch):
    cfg = _reduced(arch)
    params = tfm.init_params(cfg, seed=1)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 2, 48, seed=2).items()}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = loss_and_grads(params, batch, c, moe_dispatch=True)
    (l0, m0, g0), (l1, m1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for key in m0:
        assert torch.equal(m0[key], m1[key])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        scale = float(a.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= GRAD_TOL * scale


def test_remat_recomputes_layers_in_training_only(monkeypatch):
    """Each layer's forward runs twice in a training step with remat (the
    forward, then the recompute in backward) and once without; prefill and
    decode run under no_grad and are not wrapped."""
    cfg = _reduced("qwen1.5-0.5b")
    params = tfm.init_params(cfg, seed=1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    calls = []
    real = tfm._layer_fwd

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tfm, "_layer_fwd", spy)
    for remat, want in ((True, 2 * cfg.num_layers), (False, cfg.num_layers)):
        calls.clear()
        loss_and_grads(params, batch, dataclasses.replace(cfg, remat=remat))
        assert len(calls) == want, remat
    calls.clear()
    with torch.no_grad():
        tfm.forward_train(params, batch, cfg)
    assert len(calls) == cfg.num_layers
