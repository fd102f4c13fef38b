"""The port's MLA and MTP (deepseek-v3) against the JAX package's: the
MLA attention in the training forward, the prefill over the compressed
ring (whole and chunked), the absorbed decode, the MTP loss, conversion,
gradients, an Adafactor step through the expert dispatch, the token-
blocked MoE oracle and both launchers.

JAX initialises the weights and ``params_from_jax`` carries them across;
inputs come from numpy seeds. Tolerances, and why:
- prefill and decode logits and caches: ``tests/test_models.py``'s 2e-3;
- the loss and its parts (``xent``, ``aux``, ``mtp``): 1e-5 relative;
- each gradient leaf: ``GRAD_TOL`` of its largest element, within ten
  times the f32 noise floor that
  ``test_gradient_tolerance_is_the_f32_noise_floor`` measures (one
  rounding of every weight moves reduced deepseek's gradients by about
  2e-6 of a leaf's max: far better conditioned than the dense models of
  ``tests/test_torch_lm_train.py``, whose floor is 1.5e-4);
- the Adafactor step: the loss within 1e-4 and the grad norm within 1e-3
  (``tests/test_torch_moe.py``'s phi step), each parameter within twice
  its leaf's largest JAX update (``tests/test_torch_mamba.py`` says why);
- the blocked oracle: 1e-6 of one block's output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtfm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import mlp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (count_params, rms_norm, tree_leaves,
                                       tree_map)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (layers_from_segments,
                                        params_from_arrays, params_from_jax,
                                        params_to_jax)
from repro_torch.train.checkpoint import load_arrays
from repro_torch.train.train_step import loss_and_grads, make_train_step

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = 1e-5
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


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _auto_mesh():
    """A one-device host mesh whose axes ``with_sharding_constraint`` may
    name (this JAX's ``make_mesh`` defaults to explicit axes)."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _deepseek(layers=2, **kw):
    return dataclasses.replace(
        jax_configs.get_config(ARCH).reduced(layers=layers), **kw)


# tests/test_models.py's mla_moe case and reduced deepseek-v3
CASES = {
    "mla_moe": JaxModelConfig(
        name="mla", arch_type="moe", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, mla=True, q_lora_rank=32,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, moe_num_experts=4, moe_top_k=2, moe_d_ff=64,
        moe_layer_start=1, moe_num_shared=1, moe_capacity_factor=8.0,
        mtp=True),
    "deepseek_reduced": _deepseek(),
}


def _jax_setup(jcfg, seed=0):
    params = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)}
    feed = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return params, batch, feed


def _close_caches(got, want_segments):
    want = layers_from_segments(_np(want_segments))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["ckv", "kr", "pos", "t"]
        assert g["t"] == int(w["t"])
        np.testing.assert_array_equal(g["pos"].numpy(), w["pos"])
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(g[name].numpy(), w[name], **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_matches_jax(name):
    """The loss with its ``xent``, ``aux`` and ``mtp`` parts, with and
    without a loss mask (MTP reads its ``[:, 2:]``)."""
    jcfg = CASES[name]
    jparams, batch, _ = _jax_setup(jcfg, seed=7)
    params = params_from_jax(_np(jparams))
    for mask in (False, True):
        if mask:
            batch["loss_mask"] = (np.random.default_rng(1).random((B, S))
                                  < 0.7).astype(np.float32)
        jloss, jm = jtfm.forward_train(jparams, _j(batch), jcfg)
        loss, m = tfm.forward_train(params, _t(batch), _port_cfg(jcfg))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert sorted(m) == sorted(jm) == ["aux", "mtp", "xent"]
        for key in m:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode_match_jax(name):
    """The prefill (one flash-route call a layer on the first S rows of the
    expanded ring, the plain version on the CPU), then three
    teacher-forced absorbed decode steps: logits and the compressed caches
    within 2e-3."""
    jcfg = CASES[name]
    jparams, batch, feed = _jax_setup(jcfg)
    cache_len = S + 16
    jl, jc = jtfm.prefill(jparams, _j(batch), jcfg, cache_len)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    before = dict(tattn.ROUTE_CALLS)
    tl, tc = tfm.prefill(params, _t(batch), cfg, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    assert (tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"]
            == cfg.num_layers)
    assert tattn.ROUTE_CALLS["masked_calls"] == before["masked_calls"]
    for tok in feed:
        jl, jc = jtfm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tfm.decode_step(params, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)


def test_chunked_prefill_and_absorbed_decode_match_jax():
    """Reduced deepseek with ``prefill_chunk`` 8 on a 24-token prompt: the
    first chunk takes the flash route, the two later ones the masked route
    over the whole expanded ring, as JAX's chunk scan; then the absorbed
    decode against JAX's."""
    jcfg = _deepseek(prefill_chunk=8)
    jparams, batch, feed = _jax_setup(jcfg, seed=4)
    cache_len = S + 8
    jl, jc = jtfm.prefill(jparams, _j(batch), jcfg, cache_len)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    before = dict(tattn.ROUTE_CALLS)
    tl, tc = tfm.prefill(params, _t(batch), cfg, cache_len)
    L = cfg.num_layers
    assert tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"] == L
    assert tattn.ROUTE_CALLS["masked_calls"] - before["masked_calls"] == 2 * L
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    for tok in feed:
        jl, jc = jtfm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tfm.decode_step(params, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)


def test_prefill_matches_forward_and_routes_agree():
    """``tests/test_models.py``'s serving contract on the port: the
    flash-route prefill equals the masked route within 2e-5 and the full
    forward within 2e-3, and an absorbed decode step the forward of the
    extended prompt."""
    jcfg = CASES["deepseek_reduced"]
    jparams, batch, _ = _jax_setup(jcfg, seed=2)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    tb = _t(batch)
    lf, caches = tfm.prefill(params, tb, cfg, S + 8)
    lm, _ = tfm.prefill(params, tb, cfg, S + 8, flash=False)
    torch.testing.assert_close(lf, lm, rtol=2e-5, atol=2e-5)

    def full(tokens):
        x = tfm._run_segments(params["layers"],
                              tfm._embed_tokens(params, tokens), cfg)
        return tfm._lm_logits(params, rms_norm(x, params["final_norm"],
                                               cfg.norm_eps))

    torch.testing.assert_close(lf[:, 0], full(tb["tokens"])[:, -1], **TOL)
    nxt = lf[:, 0].argmax(-1)[:, None]
    ld, _ = tfm.decode_step(params, nxt, caches, cfg)
    torch.testing.assert_close(
        ld[:, 0], full(torch.cat([tb["tokens"], nxt], 1))[:, -1], **TOL)


# ---------------------------------------------------------------------------
# conversion, the registry, the MoE oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layers", [2, 4])
def test_params_round_trip_and_init_layout(layers):
    """JAX's tree round-trips bitwise, ``mtp_layer`` one layer on both
    sides; the port's init has JAX's tree layout (4 layers: segments of 1
    dense and 3 MoE layers); ``param_count`` counts it."""
    jcfg = _deepseek(layers)
    cfg = _port_cfg(jcfg)
    assert [(s.groups, s.sig) for s in tfm.segments_of(cfg)] == (
        [(1, (("A", False),)), (layers - 1, (("A", True),))])
    tree = _np(jtfm.init_params(jax.random.PRNGKey(3), jcfg))
    params = params_from_jax(tree)
    assert isinstance(params["mtp_layer"]["attn"]["wdq"], torch.Tensor)
    assert params["mtp_layer"]["attn"]["wdq"].shape == tree[
        "mtp_layer"]["attn"]["wdq"].shape
    back = params_to_jax(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    init = tfm.init_params(cfg, seed=0)
    got = params_to_jax(init, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tfm.param_count(cfg) == count_params(init)


def test_registry_and_full_param_counts():
    """The registry's deepseek-v3 is JAX's; ``param_count`` gives JAX's
    counts at full width cut to 2 and 4 layers (the card's cuts) and at
    full depth, where both launchers stop before allocating."""
    jcfg = jax_configs.get_config(ARCH)
    cfg = configs.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for layers, n in ((2, 3_706_583_040), (4, 15_797_352_448),
                      (61, 671_712_655_360)):
        shapes = jax.eval_shape(lambda: jtfm.init_params(
            jax.random.PRNGKey(0), dataclasses.replace(jcfg,
                                                       num_layers=layers)))
        assert sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(shapes)) == n
        assert tfm.param_count(dataclasses.replace(cfg,
                                                   num_layers=layers)) == n


@pytest.mark.parametrize("block", [1, 5, 16])
def test_moe_ref_in_token_blocks_is_one_block(block):
    """The oracle over blocks of tokens equals it over one block within
    1e-6 (each token's arithmetic is the same); the default block at
    deepseek's full width keeps its intermediates near 2 GB, and at the
    tests' widths covers the whole batch."""
    jcfg = _deepseek()
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jtfm.init_params(jax.random.PRNGKey(5),
                                                  jcfg)))
    moe = params["layers"][1]["moe"]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 17, cfg.d_model)).astype(np.float32))
    one, aux1 = mlp.moe_ref(moe, x, cfg, block=34)
    got, aux = mlp.moe_ref(moe, x, cfg, block=block)
    torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)
    assert torch.equal(aux, aux1)
    assert torch.equal(mlp.moe_ref(moe, x, cfg)[0], one)
    full = configs.get_config(ARCH)
    t = mlp.moe_ref_block_tokens(full)
    per_token = full.moe_num_experts * (full.moe_d_ff + full.d_model) * 4
    assert 200 < t < 2048 and t * per_token <= mlp.MOE_REF_BLOCK_BYTES


# ---------------------------------------------------------------------------
# gradients and a train step
# ---------------------------------------------------------------------------
def _grad_batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    mask = (rng.random(tokens.shape) < 0.8).astype(np.float32)
    return {"tokens": tokens, "loss_mask": mask}


@pytest.mark.parametrize("layers", [2, 4])
def test_loss_and_gradients_match_jax(layers):
    """The loss, its ``mtp`` part and every gradient leaf (MLA's, MTP's,
    the oracle's experts; the shared expert's, which the dense oracle does
    not read, are 0 on both) against JAX's."""
    jcfg = _deepseek(layers)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    b = _grad_batch(jcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtfm.forward_train(p, _j(b), jcfg), has_aux=True)(jparams)
    cfg = _port_cfg(jcfg)
    loss, m, grads = loss_and_grads(params_from_jax(_np(jparams)), _t(b), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["mtp"]), float(jm["mtp"]), rtol=1e-5)
    got, want = params_to_jax(grads, cfg), _np(jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    keys = set()
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if "shared" in name:
            assert not w.any() and not g.any(), name
            continue
        assert _scaled_err(g, w) < GRAD_TOL, (name, _scaled_err(g, w))
        keys.add(name.split("]")[0])
    assert {"['mtp_layer'", "['mtp_proj'", "['mtp_norm'"} <= keys


def test_gradient_tolerance_is_the_f32_noise_floor():
    """Moving every weight of reduced deepseek by about one f32 rounding
    (relative 1e-7) moves its gradients by more than a tenth of
    ``GRAD_TOL``: the tolerance is within ten times what rounding alone
    does."""
    jcfg = _deepseek()
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jtfm.init_params(jax.random.PRNGKey(0),
                                                  jcfg)))
    b = _t(_grad_batch(jcfg))
    _, _, g0 = loss_and_grads(params, b, cfg)
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), params)
    _, _, g1 = loss_and_grads(nudged, b, cfg)
    moved = max(_scaled_err(a.numpy(), w.numpy())
                for a, w in zip(tree_leaves(g1), tree_leaves(g0)))
    assert GRAD_TOL / 10 < moved < GRAD_TOL


def test_adafactor_step_through_the_dispatch_matches_jax():
    """One Adafactor step of reduced deepseek at 4 layers (segments of 1
    dense and 3 MoE layers) through the expert dispatch, shared expert
    included, against JAX's step under a one-device host mesh (its
    launcher's route): the loss, the grad norm and every parameter; every
    leaf changes, MTP's and MLA's among them; the factored state keeps
    JAX's layout, ``mtp_layer`` unstacked (its ``wo`` (H, v, d) factored
    over its own last two dims)."""
    jcfg = _deepseek(4)
    assert jcfg.optimizer == "adafactor"
    cfg = _port_cfg(jcfg)
    jparams = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    j0 = _np(jparams)
    params = params_from_jax(j0)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    mesh = _auto_mesh()
    jstep, jopt = jax_make_train_step(jcfg, mesh=mesh, lr=LR)
    with mesh:
        jnew, jstate, jm = jax.jit(jstep)(jparams, jopt.init(jparams),
                                          jnp.int32(0),
                                          {"tokens": jnp.asarray(tokens)})
    step_fn, opt = make_train_step(cfg, lr=LR, moe_dispatch=True)
    new, state, m = step_fn(params, opt.init(params), 0,
                            {"tokens": torch.from_numpy(tokens)})
    for key in ("loss", "xent", "aux", "mtp"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    got_state = jax.tree.map(lambda t: t.numpy(), state)
    assert jax.tree.structure(got_state) == jax.tree.structure(jstate)
    wo = state["f"]["mtp_layer"]["attn"]["wo"]
    assert wo["vr"].shape == (cfg.num_heads, cfg.v_head_dim)
    back = params_to_jax(new, cfg)
    paths = jax.tree_util.tree_flatten_with_path(_np(jnew))[0]
    for (path, b), a, b0 in zip(paths, jax.tree.leaves(back),
                                jax.tree.leaves(j0)):
        name = jax.tree_util.keystr(path)
        assert not np.array_equal(a, b0), f"{name} did not change"
        assert np.abs(a - b).max() <= 2 * np.abs(b - b0).max(), name


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_launchers_run_reduced_on_the_cpu(tmp_path, capsys):
    """``--arch deepseek-v3-671b`` serves (one flash-route prefill a
    layer) and trains (Adafactor through the dispatch, MTP included) with
    ``--reduced`` on the CPU; its ``lm_final.npz`` reads back through the
    port's loader leaf for leaf; at full depth both launchers stop before
    allocating, naming ``sharding/``."""
    before = dict(tattn.ROUTE_CALLS)
    s = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "32", "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: prefill 2x32 ")
    assert s["tokens"].shape == (2, 3)
    assert np.isfinite(s["logits"].numpy()).all()
    assert tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"] == 2
    r = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch",
                     "2", "--seq", "16", "--layers", "2", "--device", "cpu",
                     "--save", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: ") and out[0].endswith("M params")
    assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    assert r["grad_norm"][0] > 0
    arrays, step = load_arrays(r["checkpoint"])
    assert step == 2 and "mtp_layer/attn/wdq" in arrays
    back = params_from_arrays(arrays)
    for a, b in zip(tree_leaves(back), tree_leaves(r["params"])):
        assert torch.equal(a, b)
    with pytest.raises(SystemExit, match="sharding/"):
        serve.main(["--arch", ARCH, "--no-reduced", "--device", "cpu"])
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        ttrain.main(["--arch", ARCH, "--steps", "1", "--device", "cpu",
                     "--out-dir", str(tmp_path)])
