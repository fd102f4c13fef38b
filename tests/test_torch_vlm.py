"""The port's VLM family (llava-next-mistral-7b) against the JAX
package's: the patch-embedding prefix in the training forward and the
prefill, the vision branches of ``synthetic_batch`` and
``TokenPipeline``, conversion, gradients, a train step and both
launchers.

JAX initialises the weights and ``params_from_jax`` carries them across;
inputs come from numpy seeds. Tolerances: prefill and decode logits and
caches ``tests/test_models.py``'s 2e-3; the loss 1e-5 relative; each
gradient leaf ``GRAD_TOL`` of its largest element, within ten times the
f32 noise floor that ``test_gradient_tolerance_is_the_f32_noise_floor``
measures (one rounding of every weight moves reduced llava's gradients by
2.4e-4 of a leaf's max); the batch and the pipeline bitwise. The train
steps are teacher-forced: each starts from JAX's parameters and optimizer
state, so AdamW's first steps, which turn noise-level gradient elements
into +-lr, cannot carry one step's rounding into the next (free-running,
one rounding of the initial weights alone moves the third step's grad
norm by 2.3 % in the port, and JAX's lies 7.7 % off); each step's loss is
then held within 1e-5, its grad norm within 1e-4, and each parameter
within 2 lr of JAX's with at most ``FLIPPED`` of a leaf's elements more
than lr / 10 off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.models import transformer as jtfm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import synthetic_batch as jax_synthetic_batch
from repro_torch import configs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (count_params, rms_norm, tree_leaves,
                                       tree_map)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (layers_from_segments, params_from_jax,
                                        params_to_jax)
from repro_torch.train.train_step import (loss_and_grads, make_train_step,
                                          synthetic_batch)

ARCH = "llava-next-mistral-7b"
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = 2e-3
FLIPPED = 0.2
LR = 3e-4
B, S, P, STEPS = 2, 24, 8, 3


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


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# tests/test_models.py's vlm case and reduced llava
CASES = {
    "vlm": JaxModelConfig(name="vlm", arch_type="vlm", num_layers=2,
                          d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                          vocab_size=256, modality="vision"),
    "llava_reduced": jax_configs.get_config(ARCH).reduced(),
}


def _jax_setup(name, seed=0):
    jcfg = CASES[name]
    params = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32),
        "patch_embeds": rng.normal(size=(B, P, jcfg.d_model)).astype(
            np.float32)}
    feed = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return jcfg, params, batch, feed


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_matches_jax(name, positions):
    """The loss with the patch prefix, with and without the batch's
    positions (extended on the left by the prefix)."""
    jcfg, jparams, batch, _ = _jax_setup(name, seed=7)
    if positions:
        batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                             (B, S)).copy()
    jloss, _ = jtfm.forward_train(jparams, _j(batch), jcfg)
    loss, _ = tfm.forward_train(params_from_jax(_np(jparams)), _t(batch),
                                _port_cfg(jcfg))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_patch_embeds_change_the_loss_only_for_vision():
    """A text config ignores ``patch_embeds``, as JAX's forward does; a
    vision one's loss moves with them."""
    jcfg, jparams, batch, _ = _jax_setup("vlm", seed=1)
    params = params_from_jax(_np(jparams))
    text = dataclasses.replace(_port_cfg(jcfg), modality="text",
                               arch_type="dense")
    no_pe = {"tokens": torch.from_numpy(batch["tokens"])}
    assert torch.equal(tfm.forward_train(params, _t(batch), text)[0],
                       tfm.forward_train(params, no_pe, text)[0])
    vis = _port_cfg(jcfg)
    assert not torch.equal(tfm.forward_train(params, _t(batch), vis)[0],
                           tfm.forward_train(params, no_pe, vis)[0])


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
    """The prefill over patches then tokens (one flash-route call a layer,
    the plain version on the CPU), then three teacher-forced decode
    steps: logits and caches within 2e-3."""
    jcfg, jparams, batch, feed = _jax_setup(name)
    cache_len = P + S + 16
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
    assert all(c["t"] == P + S for c in tc)
    for tok in feed:
        jl, jc = jtfm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tfm.decode_step(params, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)


def test_prefill_matches_forward_and_routes_agree():
    """``tests/test_models.py``'s serving contract with the prefix on the
    port: the flash-route prefill equals the masked route within 2e-5 and
    the full forward over patches and tokens within 2e-3, and a decode
    step the forward of the extended prompt."""
    jcfg, jparams, batch, _ = _jax_setup("vlm", seed=2)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    tb = _t(batch)
    lf, caches = tfm.prefill(params, tb, cfg, P + S + 8)
    lm, _ = tfm.prefill(params, tb, cfg, P + S + 8, flash=False)
    torch.testing.assert_close(lf, lm, rtol=2e-5, atol=2e-5)

    def full(tokens):
        x = torch.cat([tb["patch_embeds"], tfm._embed_tokens(params, tokens)],
                      1)
        x = tfm._run_segments(params["layers"], x, cfg)
        return tfm._lm_logits(params, rms_norm(x, params["final_norm"],
                                               cfg.norm_eps))

    torch.testing.assert_close(lf[:, 0], full(tb["tokens"])[:, -1], **TOL)
    nxt = lf[:, 0].argmax(-1)[:, None]
    ld, _ = tfm.decode_step(params, nxt, caches, cfg)
    torch.testing.assert_close(
        ld[:, 0], full(torch.cat([tb["tokens"], nxt], 1))[:, -1], **TOL)


# ---------------------------------------------------------------------------
# conversion, the batch and the pipeline
# ---------------------------------------------------------------------------
def test_registry_params_and_layout():
    """The registry's llava is JAX's; the port's init has the JAX tree's
    shapes (through ``params_to_jax``), JAX's tree round-trips bitwise,
    and ``param_count`` counts it (7,241,732,096 at full size)."""
    assert (dataclasses.asdict(configs.get_config(ARCH))
            == dataclasses.asdict(jax_configs.get_config(ARCH)))
    jcfg = CASES["llava_reduced"]
    cfg = _port_cfg(jcfg)
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    params = tfm.init_params(cfg, seed=0)
    got = params_to_jax(params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tfm.param_count(cfg) == count_params(params)
    tree = _np(jtfm.init_params(jax.random.PRNGKey(3), jcfg))
    back = params_to_jax(params_from_jax(tree), cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tfm.param_count(configs.get_config(ARCH)) == 7_241_732_096


@pytest.mark.parametrize("seq", [64, 2048, 3000])
def test_synthetic_batch_matches_jax_bitwise(seq):
    """``P = min(frontend_len_cap, seq // 2)`` patch embeddings, then the
    tokens and their positions, bit for bit JAX's (3,000 passes the cap of
    1,152)."""
    jcfg = jax_configs.get_config(ARCH)
    want = jax_synthetic_batch(jcfg, 2, seq, seed=seq)
    got = synthetic_batch(_port_cfg(jcfg), 2, seq, seed=seq)
    assert sorted(got) == sorted(want) == ["patch_embeds", "positions",
                                           "tokens"]
    assert got["patch_embeds"].shape[1] == min(1152, seq // 2)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_token_pipeline_matches_jax_bitwise(seed):
    jcfg = CASES["llava_reduced"]
    jpipe = JaxTokenPipeline(jcfg, 2, 16, seed=seed)
    pipe = TokenPipeline(_port_cfg(jcfg), 2, 16, seed=seed)
    try:
        for _ in range(2):
            want, got = jpipe.next(), pipe.next()
            assert sorted(got) == sorted(want) == ["patch_embeds", "tokens"]
            assert got["patch_embeds"].shape == (2, 256, jcfg.d_model)
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert got[key].tobytes() == want[key].tobytes()
    finally:
        jpipe.close()
        pipe.close()


# ---------------------------------------------------------------------------
# gradients and a train step
# ---------------------------------------------------------------------------
def _grad_batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    b = synthetic_batch(_port_cfg(jcfg), 2, 48, seed=seed)
    b["loss_mask"] = (rng.random(b["tokens"].shape) < 0.8).astype(np.float32)
    return b


def test_loss_and_gradients_match_jax():
    jcfg = CASES["llava_reduced"]
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    b = _grad_batch(jcfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtfm.forward_train(p, _j(b), jcfg), has_aux=True)(jparams)
    cfg = _port_cfg(jcfg)
    loss, _, grads = loss_and_grads(params_from_jax(_np(jparams)), _t(b), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = params_to_jax(grads, cfg), _np(jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert g.shape == w.shape
        assert _scaled_err(g, w) < GRAD_TOL, (jax.tree_util.keystr(path),
                                              _scaled_err(g, w))


def test_gradient_tolerance_is_the_f32_noise_floor():
    """Moving every weight of reduced llava by about one f32 rounding
    (relative 1e-7) moves its gradients on the same batch by more than a
    tenth of ``GRAD_TOL``: the tolerance is within ten times what rounding
    alone does."""
    cfg = _port_cfg(CASES["llava_reduced"])
    params = params_from_jax(_np(jtfm.init_params(jax.random.PRNGKey(0),
                                                  CASES["llava_reduced"])))
    b = _t(_grad_batch(CASES["llava_reduced"]))
    _, _, g0 = loss_and_grads(params, b, cfg)
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), params)
    _, _, g1 = loss_and_grads(nudged, b, cfg)
    moved = max(_scaled_err(a.numpy(), w.numpy())
                for a, w in zip(tree_leaves(g1), tree_leaves(g0)))
    assert GRAD_TOL / 10 < moved < GRAD_TOL


def test_train_steps_match_jax():
    """Three AdamW steps in 2 microbatches on TokenPipeline batches (their
    patch embeddings included), each teacher-forced from JAX's parameters
    and optimizer state (the module docstring says why), against JAX's;
    the port's state keeps JAX's layout leaf for leaf."""
    jcfg = dataclasses.replace(CASES["llava_reduced"], train_microbatches=2,
                               frontend_len_cap=16)
    cfg = _port_cfg(jcfg)
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    jstep, jopt = jax_make_train_step(jcfg, lr=LR)
    jstep = jax.jit(jstep)
    step_fn, _ = make_train_step(cfg, lr=LR)
    jstate = jopt.init(jparams)
    pipe = TokenPipeline(cfg, 4, 32, seed=5)
    try:
        for step in range(STEPS):
            b = pipe.next()
            assert b["patch_embeds"].shape == (4, 16, cfg.d_model)
            state = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                 jstate)
            params, state, m = step_fn(params_from_jax(_np(jparams)), state,
                                       step, _t(b))
            jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step),
                                        _j(b))
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-4)
            got_state = jax.tree.map(lambda t: t.numpy(), state)
            assert (jax.tree.structure(got_state)
                    == jax.tree.structure(jstate))
            back = params_to_jax(params, cfg)
            for a, w in zip(jax.tree.leaves(back),
                            jax.tree.leaves(_np(jparams))):
                d = np.abs(a - w)
                assert d.max() <= 2 * LR
                assert (d > LR / 10).mean() <= FLIPPED
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# serving and the launchers
# ---------------------------------------------------------------------------
def test_greedy_run_with_patches_matches_jax_decode_loop():
    """``serve.run`` with ``patch_embeds`` and JAX's weights generates
    JAX's greedy tokens."""
    jcfg, jparams, _, _ = _jax_setup("llava_reduced", seed=3)
    batch = jax_synthetic_batch(jcfg, 2, 32, seed=3)
    cache_len = 32 + 5 + 8
    logits, caches = jtfm.prefill(
        jparams, {k: jnp.asarray(batch[k]) for k in ("tokens",
                                                     "patch_embeds")},
        jcfg, cache_len)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        logits, caches = jtfm.decode_step(jparams, tok, caches, jcfg)
    r = serve.run(params_from_jax(_np(jparams)), _port_cfg(jcfg),
                  batch["tokens"], patch_embeds=batch["patch_embeds"],
                  new_tokens=5, cache_len=cache_len)
    np.testing.assert_array_equal(r["tokens"], np.concatenate(want, 1))


def test_launchers_run_reduced_on_the_cpu(tmp_path, capsys):
    """``--arch llava-next-mistral-7b`` serves (a 64-long prompt: 32
    patches, 32 tokens, one flash-route prefill a layer) and trains (the
    pipeline's 256 patches a row) with ``--reduced`` on the CPU."""
    before = dict(tattn.ROUTE_CALLS)
    s = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "64", "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: prefill 2x64 ")
    assert s["tokens"].shape == (2, 3) and s["cache_len"] == 64 + 3 + 8
    assert np.isfinite(s["logits"].numpy()).all()
    assert tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"] == 2
    r = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch",
                     "2", "--seq", "16", "--layers", "2", "--device", "cpu",
                     "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: ") and out[0].endswith("M params")
    assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    assert r["grad_norm"][0] > 0
