"""The port's SSM (mamba2) and hybrid (jamba) families against the JAX
package's: the Mamba-2 mixer (``models/mamba.py``), the stack's "M"
layers and mixed caches, conversion, serving, gradients, train steps and
both launchers.

JAX initialises the weights and ``params_from_jax`` carries them across;
inputs come from numpy seeds. Tolerances, and why:
- the mixer: ``tests/test_mamba.py``'s 3e-4 (the chunked SSD and the
  sequential recurrence sum in different orders);
- prefill and decode logits and caches: ``tests/test_models.py``'s 2e-3;
- the loss 1e-5 relative; each gradient leaf ``GRAD_TOL[arch]`` of its
  largest element, within ten times the f32 noise floor that
  ``test_gradient_tolerance_is_the_f32_noise_floor`` measures (one
  rounding of every weight moves reduced mamba2's gradients by about 3e-6
  of a leaf's max, jamba's by 2e-5 to 4e-5: both far better conditioned
  than the dense models of ``tests/test_torch_lm_train.py``, whose floor
  is 1.5e-4);
- the train steps ``tests/test_torch_lm_train.py``'s (its module
  docstring says why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import mamba as jmamba
from repro.models import transformer as jtfm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import configs, prng
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import mamba
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (count_params, rms_norm, tree_leaves,
                                       tree_map)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (layers_from_segments, params_from_jax,
                                        params_to_jax)
from repro_torch.train.train_step import loss_and_grads, make_train_step

KEY = jax.random.PRNGKey(0)
SSD_TOL = dict(rtol=3e-4, atol=3e-4)
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = {"mamba2-1.3b": 2e-5, "jamba-v0.1-52b": 2e-4}
LATER_NORM_TOL = 5e-2
FLIPPED = 0.2
LR = 3e-4
B, S, STEPS = 2, 24, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and many small plain-PyTorch ops on spinning thread pools crawl when
    they are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mixer: tests/test_mamba.py's properties on the port
# ---------------------------------------------------------------------------
def make_cfg(chunk=8, state=16, hd=16) -> ModelConfig:
    """``tests/test_mamba.py``'s mixer config."""
    return ModelConfig(name="m", arch_type="ssm", num_layers=1, d_model=32,
                       num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=64,
                       ssm_state=state, ssm_head_dim=hd, ssm_chunk=chunk)


def _mixer(cfg, seed=0):
    return mamba.init_mamba_params(prng.key(seed), cfg)


def _x(shape, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.normal(size=shape)
                             ).astype(np.float32))


def test_chunked_matches_sequential():
    cfg = make_cfg()
    params = _mixer(cfg)
    x = _x((2, 37, 32), 1)
    cache = mamba.init_mamba_cache(cfg, 2)
    outs = []
    for t in range(x.shape[1]):
        y1, cache = mamba.mamba_decode(params, x[:, t:t + 1], cache, cfg)
        outs.append(y1)
    torch.testing.assert_close(torch.cat(outs, 1),
                               mamba.mamba_forward(params, x, cfg), **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(5, 4), (17, 8), (37, 16), (60, 4),
                                     (33, 16), (64, 8)])
def test_chunk_size_invariance(S, chunk):
    """The output does not depend on the chunking of the scan (a single
    padded chunk of 64 against ``chunk``)."""
    params = _mixer(make_cfg(chunk=chunk))
    x = _x((1, S, 32), 2)
    torch.testing.assert_close(
        mamba.mamba_forward(params, x, make_cfg(chunk=chunk)),
        mamba.mamba_forward(params, x, make_cfg(chunk=64)), **SSD_TOL)


def test_state_carry_across_chunks():
    """forward(x) == forward(x1), then forward(x2 | state, conv tail): the
    chunked prefill contract."""
    cfg = make_cfg()
    params = _mixer(cfg)
    x = _x((2, 32, 32), 3)
    y1, st1, tail1 = mamba.mamba_forward(params, x[:, :16], cfg,
                                         return_state=True)
    y2, _, _ = mamba.mamba_forward(params, x[:, 16:], cfg, init_state=st1,
                                   conv_init=tail1, return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1),
                               mamba.mamba_forward(params, x, cfg), **SSD_TOL)


def test_decay_bounded():
    """The A_log init keeps exp(dt A) in (0, 1): no state blow-up over 100
    decode steps."""
    cfg = make_cfg()
    params = _mixer(cfg)
    cache = mamba.init_mamba_cache(cfg, 2)
    x = _x((2, 1, 32), 4, scale=1.0)
    for _ in range(100):
        _, cache = mamba.mamba_decode(params, x, cache, cfg)
    assert torch.isfinite(cache["state"]).all()
    assert float(cache["state"].abs().max()) < 1e4


def test_segsum_masks_before_the_exp():
    """Above the diagonal the differences are -inf before the exp, so a
    long chunk of strongly decaying steps leaves no inf or NaN in the
    forward or the backward pass."""
    x = torch.full((1, 64), -50.0, requires_grad=True)
    L = torch.exp(mamba._segsum(x))
    assert torch.equal(L.triu(1), torch.zeros_like(L))
    L.sum().backward()
    assert torch.isfinite(L).all() and torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the mixer against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk,carry", [(24, 8, False), (37, 8, True),
                                           (16, 32, True)])
def test_ssd_chunked_matches_jax(S, chunk, carry):
    rng = np.random.default_rng(S)
    b, H, P, N = 2, 4, 8, 16
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(b, S, N)).astype(np.float32) for _ in "BC")
    init = (rng.normal(size=(b, H, P, N)).astype(np.float32) if carry
            else None)
    jy, jst = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                 chunk=chunk, init_state=None if init is None
                                 else jnp.asarray(init))
    y, st = mamba.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                              chunk=chunk, init_state=None if init is None
                              else torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SSD_TOL)


def test_mamba_forward_and_decode_match_jax():
    """``mamba_forward(return_state=True)`` from a carried state and conv
    tail, then three ``mamba_decode`` steps, on JAX's weights."""
    jcfg = JaxModelConfig(**dataclasses.asdict(make_cfg()))
    cfg = make_cfg()
    jp = jmamba.init_mamba_params(jax.random.fold_in(KEY, 5), jcfg)
    params = _t(jp)
    x = _x((2, 21, 32), 5).numpy()
    rng = np.random.default_rng(6)
    st0 = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state)).astype(np.float32)
    tail0 = rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner_ssm
                             + 2 * cfg.ssm_state)).astype(np.float32)
    jy, jst, jtail = jmamba.mamba_forward(
        jp, jnp.asarray(x), jcfg, init_state=jnp.asarray(st0),
        conv_init=jnp.asarray(tail0), return_state=True)
    y, st, tail = mamba.mamba_forward(
        params, torch.from_numpy(x), cfg, init_state=torch.from_numpy(st0),
        conv_init=torch.from_numpy(tail0), return_state=True)
    for got, want in ((y, jy), (st, jst), (tail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    jcache = {"state": jst, "conv": jtail}
    cache = {"state": st, "conv": tail}
    for t in range(3):
        x1 = _x((2, 1, 32), 10 + t).numpy()
        jy1, jcache = jmamba.mamba_decode(jp, jnp.asarray(x1), dict(jcache),
                                          jcfg)
        y1, cache = mamba.mamba_decode(params, torch.from_numpy(x1), cache,
                                       cfg)
        np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **SSD_TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **SSD_TOL)


# ---------------------------------------------------------------------------
# the stack: tests/test_models.py's ssm and hybrid cases, reduced archs
# ---------------------------------------------------------------------------
CASES = {
    "ssm": JaxModelConfig(name="ssm", arch_type="ssm", num_layers=2,
                          d_model=64, num_heads=0, num_kv_heads=0, d_ff=0,
                          vocab_size=256, ssm_state=16, ssm_head_dim=16,
                          ssm_chunk=8),
    "hybrid": JaxModelConfig(name="hybrid", arch_type="hybrid", num_layers=4,
                             d_model=64, num_heads=4, num_kv_heads=2,
                             d_ff=128, vocab_size=256, layer_pattern="AM",
                             ssm_state=16, ssm_head_dim=16, ssm_chunk=8),
    "mamba2_reduced": jax_configs.get_config("mamba2-1.3b").reduced(),
    "jamba_reduced": jax_configs.get_config("jamba-v0.1-52b").reduced(),
    # 8 of a 24-token prompt a chunk: the state, the conv tail and the KV
    # cache cross chunks, as jamba's 2,048-token chunks do on the card
    "jamba_chunked": dataclasses.replace(
        jax_configs.get_config("jamba-v0.1-52b").reduced(layers=5),
        prefill_chunk=8),
}


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
        assert sorted(g) == sorted(w)
        if "t" in w:
            assert g["t"] == int(w["t"])
            np.testing.assert_array_equal(g["pos"].numpy(), w["pos"])
        for name in ("k", "v", "state", "conv"):
            if name in w:
                assert g[name].dtype == torch.float32
                np.testing.assert_allclose(g[name].numpy(), w[name], **TOL)


@pytest.mark.parametrize("name", sorted(set(CASES) - {"jamba_chunked"}))
def test_train_forward_matches_jax(name):
    jcfg, jparams, tokens, _ = _jax_setup(name, seed=7)
    jloss, jm = jtfm.forward_train(jparams, {"tokens": jnp.asarray(tokens)},
                                   jcfg)
    loss, m = tfm.forward_train(params_from_jax(_np(jparams)),
                                {"tokens": torch.from_numpy(tokens)},
                                _port_cfg(jcfg))
    assert np.isfinite(float(loss)) and float(loss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode_match_jax(name):
    """Prefill, then three teacher-forced decode steps: logits and every
    cache (``state``, ``conv``; ``k``, ``v``, ``pos``, ``t``) within
    2e-3. An attention layer's first chunk takes the flash route, its
    later chunks the masked one."""
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
    n_attn = cfg.layer_types().count("A")
    chunks = S // (cfg.prefill_chunk or S)
    assert tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"] == n_attn
    assert (tattn.ROUTE_CALLS["masked_calls"] - before["masked_calls"]
            == n_attn * (chunks - 1))
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


@pytest.mark.parametrize("name", ["ssm", "hybrid", "jamba_chunked"])
def test_prefill_and_decode_match_forward(name):
    """``tests/test_models.py``'s serving contract on the port alone: the
    prefill's last logits and one decode step equal the full forward of
    the prompt and of the prompt plus the decoded token."""
    jcfg, jparams, tokens, _ = _jax_setup(name, seed=8)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    toks = torch.from_numpy(tokens)
    lp, caches = tfm.prefill(params, {"tokens": toks}, cfg, S + 16)
    torch.testing.assert_close(lp[:, 0], _full_logits(params, toks, cfg)[:, -1],
                               **TOL)
    nxt = lp[:, 0].argmax(-1)[:, None]
    ld, _ = tfm.decode_step(params, nxt, caches, cfg)
    full = _full_logits(params, torch.cat([toks, nxt], 1), cfg)
    torch.testing.assert_close(ld[:, 0], full[:, -1], **TOL)


# ---------------------------------------------------------------------------
# conversion and init
# ---------------------------------------------------------------------------
def _jamba(layers):
    return jax_configs.get_config("jamba-v0.1-52b").reduced(layers=layers)


LAYOUT_CASES = {
    "ssm": CASES["ssm"],
    "mamba2": jax_configs.get_config("mamba2-1.3b").reduced(),
    "jamba2": _jamba(2),
    "jamba5": _jamba(5),
    "jamba16": _jamba(16),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_params_round_trip_bitwise(name):
    jcfg = LAYOUT_CASES[name]
    tree = _np(jtfm.init_params(jax.random.fold_in(KEY, 9), jcfg))
    back = params_to_jax(params_from_jax(tree), _port_cfg(jcfg))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_port_init_has_the_jax_layout(name):
    """The port's own init gives the JAX tree's shapes and dtypes: an SSM
    layer without an FFN (mamba2's) ``ln1`` and ``mixer`` alone, jamba's 16 layers one segment of 2
    groups x 8 slots (attention at slot 4, MoE at the odd slots), a cut
    short of two periods one segment per constant run. ``param_count``
    counts it without allocating."""
    jcfg = LAYOUT_CASES[name]
    cfg = _port_cfg(jcfg)
    want = jax.eval_shape(lambda: jtfm.init_params(KEY, jcfg))
    params = tfm.init_params(cfg, seed=0)
    got = params_to_jax(params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tfm.param_count(cfg) == count_params(params)
    if name == "ssm":
        assert sorted(params["layers"][0]) == ["ln1", "mixer"]
    if name == "jamba16":
        seg, = got["segments"]
        assert len(seg["slots"]) == 8
        assert "attn" in seg["slots"][4] and "moe" in seg["slots"][1]
        assert seg["slots"][0]["mixer"]["A_log"].shape == (2, 16)
    bf16 = tfm.init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                           seed=0)["layers"][1]["mixer"]
    assert bf16["in_proj"].dtype == torch.bfloat16
    assert all(bf16[k].dtype == torch.float32
               for k in ("A_log", "D", "dt_bias"))


def test_full_param_counts():
    """mamba2-1.3b and jamba-v0.1-52b's parameters by the JAX package's
    tree shapes (nothing allocated)."""
    for arch in ("mamba2-1.3b", "jamba-v0.1-52b"):
        jcfg = jax_configs.get_config(arch)
        shapes = jax.eval_shape(lambda: jtfm.init_params(KEY, jcfg))
        n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        assert tfm.param_count(configs.get_config(arch)) == n
    assert tfm.param_count(configs.get_config("mamba2-1.3b")) == 1_343_740_928


# ---------------------------------------------------------------------------
# loss, gradients and train steps
# ---------------------------------------------------------------------------
def _batch(jcfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return {"tokens": tokens, "positions": positions, "loss_mask": mask}


@pytest.mark.parametrize("arch", sorted(GRAD_TOL))
def test_loss_and_gradients_match_jax(arch):
    jcfg = jax_configs.get_config(arch).reduced()
    jparams = jtfm.init_params(KEY, jcfg)
    b = _batch(jcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtfm.forward_train(p, {k: jnp.asarray(v)
                                         for k, v in b.items()}, jcfg),
        has_aux=True)(jparams)
    cfg = _port_cfg(jcfg)
    loss, m, grads = loss_and_grads(
        params_from_jax(_np(jparams)),
        {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    got = params_to_jax(grads, cfg)
    want = _np(jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert g.shape == w.shape, path
        assert _scaled_err(g, w) < GRAD_TOL[arch], (
            jax.tree_util.keystr(path), _scaled_err(g, w))


@pytest.mark.parametrize("arch", sorted(GRAD_TOL))
def test_gradient_tolerance_is_the_f32_noise_floor(arch):
    """Moving every weight of the reduced arch by about one f32 rounding
    (relative 1e-7) moves its gradients by more than a tenth of
    ``GRAD_TOL[arch]``: the tolerance is within ten times what rounding
    alone does."""
    jcfg = jax_configs.get_config(arch).reduced()
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jtfm.init_params(KEY, jcfg)))
    b = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    _, _, g0 = loss_and_grads(params, b, cfg)
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), params)
    _, _, g1 = loss_and_grads(nudged, b, cfg)
    moved = max(_scaled_err(a.numpy(), w.numpy())
                for a, w in zip(tree_leaves(g1), tree_leaves(g0)))
    assert GRAD_TOL[arch] / 10 < moved < GRAD_TOL[arch]


# (config, steps, the first step's grad-norm rtol). Reduced jamba at 16
# layers routes 8 MoE layers by top-k: one f32 rounding of its initial
# weights flips some tokens' experts and moves the first grad norm by up
# to 6.7e-3 in the port alone (seven nudges: 1.4e-5 to 6.7e-3); JAX's is
# 6.2e-3 off the port's. Adafactor's row factor over a stacked (groups, C)
# leaf scales a noise-level element's update up to ~20 lr (jamba16's
# ``conv_b``): three such nudges alone move it by up to 5.8e-3 after one
# step, as far as JAX's step is from the port's (5.9e-3), so an Adafactor
# element is held within twice its leaf's largest JAX update (a full
# flip), an AdamW one within 2 lr a step.
STEP_CASES = {
    "mamba2_adamw": (jax_configs.get_config("mamba2-1.3b").reduced(), 3,
                     1e-4),
    "jamba2_adafactor": (_jamba(2), 3, 1e-4),
    "jamba16_adafactor": (_jamba(16), 1, 1e-2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """Train steps on TokenPipeline batches against JAX's (MoE layers on
    the dense oracle, as JAX's step without a mesh), with the optimizer
    state in JAX's layout leaf for leaf: Adafactor factors the stacked
    mixer leaves such as ``A_log`` (groups, H) as JAX does."""
    jcfg, steps, first_norm_rtol = STEP_CASES[case]
    cfg = _port_cfg(jcfg)
    assert cfg.optimizer == ("adamw" if case.startswith("mamba2")
                             else "adafactor")
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    j0 = _np(jparams)
    params = params_from_jax(j0)
    jstep, jopt = jax_make_train_step(jcfg, lr=LR)
    jstep = jax.jit(jstep)
    step_fn, opt = make_train_step(cfg, lr=LR)
    jstate, state = jopt.init(jparams), opt.init(params)
    pipe = TokenPipeline(cfg, 4, 32, seed=5)
    try:
        for step in range(steps):
            tokens = pipe.next()["tokens"]
            jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step),
                                        {"tokens": jnp.asarray(tokens)})
            params, state, m = step_fn(params, state, step,
                                       {"tokens": torch.from_numpy(tokens)})
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(
                float(m["grad_norm"]), float(jm["grad_norm"]),
                rtol=first_norm_rtol if step == 0 else LATER_NORM_TOL)
    finally:
        pipe.close()
    got_state = jax.tree.map(lambda t: t.numpy(), state)
    assert jax.tree.structure(got_state) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(jstate)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    if cfg.optimizer == "adafactor":
        a_log = [slot["mixer"]["A_log"] for seg in state["f"]["segments"]
                 for slot in seg["slots"] if "mixer" in slot]
        groups = 2 if case.startswith("jamba16") else 1
        assert a_log and all(s["vr"].shape == (groups,)
                             and s["vc"].shape == (cfg.ssm_heads,)
                             for s in a_log)
    back = params_to_jax(params, cfg)
    for a, b, b0 in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jparams)),
                        jax.tree.leaves(j0)):
        d = np.abs(a - b)
        assert d.max() <= (2 * LR * steps if cfg.optimizer == "adamw"
                           else 2 * np.abs(b - b0).max())
        assert (d > LR / 10).mean() <= FLIPPED, (d > LR / 10).mean()


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_launchers_run_reduced_on_the_cpu(arch, tmp_path, capsys):
    """Both launchers run the arch reduced on the CPU: the serving
    launcher's two lines and finite logits, the trainer's steps (its
    checkpoint read back leaf for leaf); a mamba2 prefill launches no
    attention at all."""
    before = dict(tattn.ROUTE_CALLS)
    s = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "32", "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{arch}: prefill 2x32 ")
    assert s["tokens"].shape == (2, 3)
    assert np.isfinite(s["logits"].numpy()).all()
    n_attn = 0 if arch.startswith("mamba2") else 1
    assert tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"] == n_attn
    r = ttrain.main(["--arch", arch, "--reduced", "--steps", "2", "--batch",
                     "2", "--seq", "32", "--layers", "2", "--device", "cpu",
                     "--save", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{arch}: ") and out[0].endswith("M params")
    assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    assert r["grad_norm"][0] > 0
    with np.load(r["checkpoint"]) as f:
        assert any("mixer/A_log" in k for k in f.files)


def test_jamba_at_full_depth_raises_before_allocating(tmp_path):
    with pytest.raises(SystemExit, match="sharding/"):
        serve.main(["--arch", "jamba-v0.1-52b", "--no-reduced", "--device",
                    "cpu"])
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        ttrain.main(["--arch", "jamba-v0.1-52b", "--steps", "1",
                     "--device", "cpu", "--out-dir", str(tmp_path)])
