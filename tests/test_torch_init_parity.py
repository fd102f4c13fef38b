"""The port's LM init against the JAX package's: ``init_params(cfg, seed)``
gives ``init_params(PRNGKey(seed), cfg)`` leaf for leaf (the same paths
and shapes, each value within 2 f32 ulp) for every family's reduced
config; init only, no forward pass. Both draw threefry's numbers under
the same key tree (``repro_torch.prng``): truncated normals and normals
times f32 scales, held to 2 ulp (bit for bit on this suite's machine). Then the serving launcher at temperature 1: the port's weights
and sampling give the JAX decode loop's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtfm
from repro.train.train_step import synthetic_batch as jax_synthetic_batch
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import stack_layers

LMS = [name for name in jax_configs.list_archs() if name != "tencent-embedding"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulps(a, b) -> int:
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


def _check_tree(jcfg, seed):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    want = _flat(jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    got = _flat(stack_layers(tfm.init_params(cfg, seed=seed), cfg))
    assert sorted(got) == sorted(want)
    worst = 0
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        worst = max(worst, _ulps(_f32(g), _f32(w)))
    return worst


@pytest.mark.parametrize("arch", LMS)
def test_init_params_is_jax_init_leaf_for_leaf(arch):
    assert _check_tree(jax_configs.get_config(arch).reduced(), seed=0) <= 2


@pytest.mark.parametrize("arch,changes,seed", [
    # a depth that is no whole number of jamba's periods: one segment a run
    ("jamba-v0.1-52b", dict(num_layers=5), 3),
    # deepseek's dense layers, then its MoE run, and the MTP leaves
    ("deepseek-v3-671b", dict(num_layers=3, moe_layer_start=1), 1),
    # bf16 leaves: the f32 draw, then the cast
    ("granite-3-2b", dict(param_dtype="bfloat16"), 2),
    # a MoE stack past one period
    ("phi3.5-moe-42b-a6.6b", dict(num_layers=3), 4),
])
def test_init_params_key_tree_across_segments_and_dtypes(arch, changes,
                                                         seed):
    jcfg = dataclasses.replace(jax_configs.get_config(arch).reduced(),
                               **changes)
    assert _check_tree(jcfg, seed) <= 2


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-1.3b"])
def test_temperature_one_decoding_gives_jax_tokens(arch):
    """The port's launcher at temperature 1 (its own init, JAX's sampling
    keys) against the JAX launcher's loop on JAX's weights: 8 tokens."""
    B, S, new, seed = 2, 16, 8, 5
    jcfg = jax_configs.get_config(arch).reduced(layers=2, d_model=256,
                                                experts=4)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    batch = {k: jnp.asarray(v) for k, v in
             jax_synthetic_batch(jcfg, B, S, seed=seed).items()}
    cache_len = S + new + 8
    logits, caches = jtfm.prefill(jparams, batch, jcfg, cache_len)
    key = jax.random.PRNGKey(seed + 1)

    def sample(logits, key):
        return jax.random.categorical(key, logits[:, 0] / 1.0, -1).astype(
            jnp.int32)[:, None]

    tok = sample(logits, key)
    want = [np.asarray(tok)]
    for i in range(new - 1):
        logits, caches = jtfm.decode_step(jparams, tok, caches, jcfg)
        key = jax.random.fold_in(key, i)
        tok = sample(logits, key)
        want.append(np.asarray(tok))
    r = serve.main(["--arch", arch, "--device", "cpu", "--batch", str(B),
                    "--prompt-len", str(S), "--tokens", str(new),
                    "--temperature", "1.0", "--seed", str(seed)])
    np.testing.assert_array_equal(r["tokens"], np.concatenate(want, 1))
