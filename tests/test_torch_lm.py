"""The port's dense LM serving path against the JAX package's.

JAX initialises the weights; ``params_from_jax`` carries them across, and
both packages prefill the same numpy-seeded prompt and then decode three
teacher-forced tokens. Last-token logits and the caches (``k``, ``v``,
``pos``, ``t``) must agree within 2e-3, the tolerance of
``tests/test_models.py``'s prefill/decode consistency test (f32 stacks
that sum in other orders). The port's prefill takes the flash route on
its first chunk (the plain version on the CPU) and the masked route on
later chunks and wrapped rings, so the cases cover both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtfm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.train.train_step import synthetic_batch as jax_synthetic_batch
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (layers_from_segments, params_from_jax,
                                        params_to_jax)
from repro_torch.train.train_step import synthetic_batch

TOL = dict(rtol=2e-3, atol=2e-3)
B, S, STEPS = 2, 24, 3

# test_models.py's dense cases, and a ring that wraps (W = 16 < S)
CASES = {
    "dense": JaxModelConfig(name="dense", arch_type="dense", num_layers=2,
                            d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                            vocab_size=256, qkv_bias=True),
    "chunked_prefill": JaxModelConfig(name="chunked", arch_type="dense",
                                      num_layers=2, d_model=64, num_heads=4,
                                      num_kv_heads=2, d_ff=128, vocab_size=256,
                                      prefill_chunk=8),
    "sliding": JaxModelConfig(name="sliding", arch_type="dense", num_layers=2,
                              d_model=64, num_heads=4, num_kv_heads=2,
                              d_ff=128, vocab_size=256, sliding_window=64),
    "sliding_wrap": JaxModelConfig(name="sliding", arch_type="dense",
                                   num_layers=2, d_model=64, num_heads=4,
                                   num_kv_heads=2, d_ff=128, vocab_size=256,
                                   sliding_window=16),
    "granite_reduced": jax_configs.get_config("granite-3-2b").reduced(),
}


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_setup(name, seed=0):
    jcfg = CASES[name]
    params = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return jcfg, params, tokens, feed


def _close_caches(got, want_segments):
    want = layers_from_segments(_np(want_segments))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["t"] == int(w["t"])
        np.testing.assert_array_equal(g["pos"].numpy(), w["pos"])
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name], **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode_match_jax(name):
    jcfg, jparams, tokens, feed = _jax_setup(name)
    cache_len = S + 16
    jl, jc = jtfm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                          cache_len)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    before = dict(tattn.ROUTE_CALLS)
    tl, tc = tfm.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                         cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    # the route each prefill chunk took, per layer
    chunks = S // (cfg.prefill_chunk or S)
    W = min(cache_len, cfg.sliding_window or cache_len)
    flash = cfg.num_layers if S // chunks <= W else 0
    assert tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"] == flash
    assert (tattn.ROUTE_CALLS["masked_calls"] - before["masked_calls"]
            == cfg.num_layers * chunks - flash)
    for tok in feed:
        jl, jc = jtfm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tfm.decode_step(params, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)


def _full_logits(params, tokens, cfg):
    x = tfm._embed_tokens(params, tokens)
    x = tfm._run_segments(params["layers"], x, cfg)
    return tfm._lm_logits(params, rms_norm(x, params["final_norm"],
                                           cfg.norm_eps))


@pytest.mark.parametrize("name", ["dense", "sliding_wrap"])
def test_prefill_matches_forward_and_routes_agree(name):
    """Prefill on the flash route equals the masked route within 2e-5 (the
    same f32 attention on the same cached k, v: only summation order
    differs), and the full forward within test_models.py's 2e-3."""
    jcfg, jparams, tokens, _ = _jax_setup(name, seed=1)
    cfg = dataclasses.replace(_port_cfg(jcfg), sliding_window=(
        0 if name == "dense" else S))         # a window the whole prompt fits
    params = params_from_jax(_np(jparams))
    batch = {"tokens": torch.from_numpy(tokens)}
    lf, cf = tfm.prefill(params, batch, cfg, S + 8)
    lm, cm = tfm.prefill(params, batch, cfg, S + 8, flash=False)
    torch.testing.assert_close(lf, lm, rtol=2e-5, atol=2e-5)
    for a, b in zip(cf, cm):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["pos"], b["pos"])
    full = _full_logits(params, batch["tokens"], cfg)
    torch.testing.assert_close(lf[:, 0], full[:, -1], **TOL)


@pytest.mark.parametrize("name", ["dense", "granite_reduced"])
def test_params_round_trip_bitwise(name):
    jcfg, jparams, _, _ = _jax_setup(name, seed=2)
    tree = _np(jparams)
    back = params_to_jax(params_from_jax(tree), _port_cfg(jcfg))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-0.5b"])
def test_port_init_has_the_jax_layout(arch):
    """The port's own init gives the JAX tree's shapes and dtypes (through
    params_to_jax), the QKV biases and an untied lm_head included."""
    jcfg = jax_configs.get_config(arch).reduced()
    cfg = _port_cfg(jcfg)
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    got = params_to_jax(tfm.init_params(cfg, seed=0), cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_registry_names_every_jax_arch():
    """Every JAX arch is in the port's registry, its config equal to JAX's
    (the ten LMs), and no family is left out."""
    assert configs.list_archs() == jax_configs.list_archs()
    lms = [name for name in jax_configs.list_archs()
           if name != "tencent-embedding"]
    assert len(lms) == 10
    for name in lms:
        assert (dataclasses.asdict(configs.get_config(name))
                == dataclasses.asdict(jax_configs.get_config(name)))
    assert configs.NOT_PORTED == {}
    for name in ("deepseek-v3-671b", "seamless-m4t-large-v2"):
        cfg = _port_cfg(jax_configs.get_config(name).reduced())
        tfm.check_family(cfg)
        assert tfm.param_count(cfg) > 0
    with pytest.raises(NotImplementedError, match="modality"):
        tfm.check_family(dataclasses.replace(
            configs.get_config("granite-3-2b"), modality="video"))


def test_synthetic_batch_matches_jax():
    cfg = jax_configs.get_config("granite-3-2b")
    want = jax_synthetic_batch(cfg, 4, 2048, seed=0)
    got = synthetic_batch(_port_cfg(cfg), 4, 2048, seed=0)
    for key in ("tokens", "positions"):
        np.testing.assert_array_equal(got[key], want[key])


def test_greedy_run_matches_jax_decode_loop():
    """``serve.run`` with JAX's weights generates JAX's greedy tokens."""
    jcfg, jparams, _, _ = _jax_setup("granite_reduced", seed=3)
    tokens = jax_synthetic_batch(jcfg, 2, 32, seed=3)["tokens"]
    cache_len = 32 + 5 + 8
    logits, caches = jtfm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, cache_len)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        logits, caches = jtfm.decode_step(jparams, tok, caches, jcfg)
    r = serve.run(params_from_jax(_np(jparams)), _port_cfg(jcfg), tokens,
                  new_tokens=5, cache_len=cache_len)
    np.testing.assert_array_equal(r["tokens"], np.concatenate(want, 1))


def test_cpu_launcher_runs_reduced(capsys):
    r = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "64",
                    "--tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("granite-3-2b: prefill 2x64 ")
    assert out[1] == f"request 0: {r['tokens'][0].tolist()}"
    assert r["tokens"].shape == (2, 4) and r["cache_len"] == 64 + 4 + 8
    assert np.isfinite(r["logits"].numpy()).all()
    assert ((0 <= r["tokens"]) & (r["tokens"] < 1024)).all()
