"""The dry-run's inputs against the JAX package's, for every arch: the four
input shapes, ``for_shape`` (every field), ``input_specs`` (shapes and
dtypes), ``cache_specs`` (JAX's ``jax.eval_shape`` caches) and the
roofline's ``model_flops`` / ``active_params``. Nothing is allocated on
either side: JAX's structs are abstract, the port's tensors lie on the
``meta`` device."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.configs import shapes as jshapes
from repro.launch import roofline as jrl
from repro.models import transformer as jtfm
from repro.train import serve_step as jserve
from repro_torch import configs as cfgs
from repro_torch.configs import shapes
from repro_torch.launch import roofline as rl
from repro_torch.models.config import ModelConfig
from repro_torch.train import serve_step

LM_ARCHS = [a for a, c in cfgs.ARCHS.items() if isinstance(c, ModelConfig)]
SHAPES = list(shapes.SHAPES)
KEY = jax.random.PRNGKey(0)


def _dtype(d) -> str:
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) else \
        str(d).removeprefix("torch.")


def test_shapes_are_jax_shapes():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_for_shape_and_input_specs_match_jax(arch):
    for name in SHAPES:
        got = cfgs.for_shape(cfgs.get_config(arch), shapes.SHAPES[name])
        want = jcfgs.for_shape(jcfgs.get_config(arch), jshapes.SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        gs = cfgs.input_specs(got, shapes.SHAPES[name])
        ws = jcfgs.input_specs(want, jshapes.SHAPES[name])
        assert list(gs) == list(ws), name
        for k in ws:
            assert gs[k].device.type == "meta"
            assert (tuple(gs[k].shape), _dtype(gs[k].dtype)) == \
                (tuple(ws[k].shape), _dtype(ws[k].dtype)), (name, k)


def test_long_500k_policy():
    """SSM, hybrid and MLA archs decode 524k natively; every other arch
    takes the 8,192-key window."""
    native = {a for a in LM_ARCHS
              if cfgs.get_config(a).arch_type in ("ssm", "hybrid")
              or cfgs.get_config(a).mla}
    assert native == {"mamba2-1.3b", "jamba-v0.1-52b", "deepseek-v3-671b"}
    for a in LM_ARCHS:
        c = cfgs.for_shape(cfgs.get_config(a), shapes.SHAPES["long_500k"])
        assert c.sliding_window == (0 if a in native else 8192), a
        assert not c.remat and c.train_microbatches == 1


def _jax_layers(jcaches):
    """JAX's stacked caches (a list of segments, each a list of slots whose
    leaves lead with the group dim) as one {name: (shape, dtype)} a layer,
    group-major, without the position counter ``t``."""
    layers = []
    for seg in jcaches:
        groups = jax.tree.leaves(seg[0])[0].shape[0]
        for _ in range(groups):
            for slot in seg:
                layers.append({n: (tuple(v.shape[1:]), _dtype(v.dtype))
                               for n, v in slot.items() if n != "t"})
    return layers


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_match_jax(arch):
    for name in ("decode_32k", "long_500k"):
        shape = shapes.SHAPES[name]
        cfg = cfgs.for_shape(cfgs.get_config(arch), shape)
        jcfg = jcfgs.for_shape(jcfgs.get_config(arch), jshapes.SHAPES[name])
        clen = serve_step.cache_len_for(cfg, shape.seq_len)
        assert clen == jserve.cache_len_for(jcfg, shape.seq_len)
        got = serve_step.cache_specs(cfg, shape.global_batch, clen)
        jparams = jax.eval_shape(lambda: jtfm.init_params(KEY, jcfg))
        want = _jax_layers(jserve.cache_specs(jcfg, shape.global_batch, clen,
                                              jparams))
        assert len(got) == len(want) == cfg.num_layers, name
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.get("t", 0) == 0        # a Python int in the port
            got_i = {n: (tuple(v.shape), _dtype(v.dtype))
                     for n, v in g.items() if n != "t"}
            assert all(v.device.type == "meta" for n, v in g.items()
                       if n != "t")
            assert got_i == w, (name, i)


@pytest.mark.parametrize("arch", [*LM_ARCHS, "tencent-embedding"])
def test_model_flops_and_active_params_match_jax(arch):
    cfg, jcfg = cfgs.get_config(arch), jcfgs.get_config(arch)
    assert rl.active_params(cfg) == jrl.active_params(jcfg)
    for name in SHAPES:
        assert rl.model_flops(cfg, shapes.SHAPES[name]) == \
            jrl.model_flops(jcfg, jshapes.SHAPES[name]), name
