"""The port's enc-dec family (seamless-m4t-large-v2) against the JAX
package's: the encoder over audio frames, cross-attention in the training
forward, the prefill (the encoder's and each chunk's cross-attention on
the flash route) and decode, the audio branches of ``synthetic_batch`` and
``TokenPipeline``, conversion, gradients, AdamW steps, checkpoints and
both launchers.

JAX initialises the weights and ``params_from_jax`` carries them across;
inputs come from numpy seeds. Tolerances, and why:
- prefill and decode logits and caches: ``tests/test_models.py``'s 2e-3;
- the loss 1e-5 relative;
- each gradient leaf: ``GRAD_TOL`` of its largest element, within ten
  times the f32 noise floor that
  ``test_gradient_tolerance_is_the_f32_noise_floor`` measures (one
  rounding of every weight moves reduced seamless's gradients by 1.0e-3
  to 1.5e-3 of a leaf's max: its encoder attends over unnormalised N(0, 1)
  frames, whose sharp softmax amplifies rounding; the dense models of
  ``tests/test_torch_lm_train.py`` move by 1.5e-4);
- the train steps: ``tests/test_torch_vlm.py``'s teacher-forced AdamW
  steps (its module docstring says why), but each grad norm within 1e-3:
  nudging the weights by one f32 rounding moves this model's grad norm by
  up to 7.3e-4 in the port alone (three nudges at each of three steps:
  5.2e-5 to 7.3e-4), and JAX's lies up to 2.8e-4 off;
- the batch and the pipeline: bitwise.
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
from repro.train.checkpoint import restore_checkpoint, save_checkpoint
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
from repro_torch.models.convert import (layers_from_segments,
                                        params_from_arrays, params_from_jax,
                                        params_to_jax)
from repro_torch.train.checkpoint import load_arrays
from repro_torch.train.checkpoint import \
    save_checkpoint as port_save_checkpoint
from repro_torch.train.train_step import (loss_and_grads, make_train_step,
                                          synthetic_batch)

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = 3e-3
FLIPPED = 0.2
LR = 3e-4
B, S, SE, STEPS = 2, 24, 16, 3


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


# tests/test_models.py's encdec case (GQA cross-attention) and reduced
# seamless
CASES = {
    "encdec": JaxModelConfig(name="audio", arch_type="audio", num_layers=2,
                             d_model=64, num_heads=4, num_kv_heads=2,
                             d_ff=128, vocab_size=256, encoder_layers=2,
                             modality="audio"),
    "seamless_reduced": jax_configs.get_config(ARCH).reduced(),
}


def _jax_setup(jcfg, seed=0):
    params = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32),
        "frames": rng.normal(size=(B, SE, jcfg.d_model)).astype(np.float32)}
    feed = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return params, batch, feed


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_matches_jax(name, positions):
    """The loss through the encoder and the cross-attention, with and
    without the batch's positions (the decoder's; the encoder counts its
    frames from 0)."""
    jcfg = CASES[name]
    jparams, batch, _ = _jax_setup(jcfg, seed=7)
    if positions:
        batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                             (B, S)).copy()
    jloss, jm = jtfm.forward_train(jparams, _j(batch), jcfg)
    loss, m = tfm.forward_train(params_from_jax(_np(jparams)), _t(batch),
                                _port_cfg(jcfg))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(m) == sorted(jm) == ["aux", "xent"]


def test_frames_move_the_loss():
    """The decoder reads the encoder: other frames, another loss."""
    jcfg = CASES["encdec"]
    jparams, batch, _ = _jax_setup(jcfg, seed=1)
    params, cfg = params_from_jax(_np(jparams)), _port_cfg(jcfg)
    other = dict(batch, frames=batch["frames"][::-1].copy())
    assert not torch.equal(tfm.forward_train(params, _t(batch), cfg)[0],
                           tfm.forward_train(params, _t(other), cfg)[0])


def _close_caches(got, want_segments):
    want = layers_from_segments(_np(want_segments))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["enc_k", "enc_v", "k", "pos", "t",
                                          "v"]
        assert g["t"] == int(w["t"])
        np.testing.assert_array_equal(g["pos"].numpy(), w["pos"])
        for name in ("k", "v", "enc_k", "enc_v"):
            np.testing.assert_allclose(g[name].numpy(), w[name], **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode_match_jax(name):
    """The prefill (the encoder's attention, each layer's self-attention
    and its cross-attention on the flash route, the plain version on the
    CPU), then three teacher-forced decode steps: logits and caches, the
    cross-attention's ``enc_k``/``enc_v`` among them, within 2e-3."""
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
    routes = {k: v - before[k] for k, v in tattn.ROUTE_CALLS.items()}
    assert routes == {"flash_calls": cfg.num_layers, "masked_calls": 0,
                      "cross_flash_calls": cfg.num_layers,
                      "cross_masked_calls": 0,
                      "encoder_flash_calls": cfg.encoder_layers}
    for tok in feed:
        jl, jc = jtfm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tfm.decode_step(params, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)


def test_chunked_prefill_matches_jax():
    """Reduced seamless with ``prefill_chunk`` 8: every chunk's
    cross-attention takes the flash route (the encoder memory is whole),
    the self-attention only on the first chunk."""
    jcfg = dataclasses.replace(CASES["seamless_reduced"], prefill_chunk=8)
    jparams, batch, feed = _jax_setup(jcfg, seed=4)
    jl, jc = jtfm.prefill(jparams, _j(batch), jcfg, S + 8)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    before = dict(tattn.ROUTE_CALLS)
    tl, tc = tfm.prefill(params, _t(batch), cfg, S + 8)
    routes = {k: v - before[k] for k, v in tattn.ROUTE_CALLS.items()}
    L = cfg.num_layers
    assert routes == {"flash_calls": L, "masked_calls": 2 * L,
                      "cross_flash_calls": 3 * L, "cross_masked_calls": 0,
                      "encoder_flash_calls": cfg.encoder_layers}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    jl, jc = jtfm.decode_step(jparams, jnp.asarray(feed[0]), jc, jcfg)
    tl, tc = tfm.decode_step(params, torch.from_numpy(feed[0]), tc, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_prefill_matches_forward_and_routes_agree():
    """``tests/test_models.py``'s serving contract on the port: the
    flash-route prefill equals the masked route within 2e-5 and the full
    forward within 2e-3, and a decode step the forward of the extended
    prompt; ``flash=False`` keeps the encoder and the cross-attention on
    their masked routes too."""
    jcfg = CASES["seamless_reduced"]
    jparams, batch, _ = _jax_setup(jcfg, seed=2)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    tb = _t(batch)
    lf, caches = tfm.prefill(params, tb, cfg, S + 8)
    before = dict(tattn.ROUTE_CALLS)
    lm, _ = tfm.prefill(params, tb, cfg, S + 8, flash=False)
    routes = {k: v - before[k] for k, v in tattn.ROUTE_CALLS.items()}
    assert routes == {"flash_calls": 0, "masked_calls": cfg.num_layers,
                      "cross_flash_calls": 0,
                      "cross_masked_calls": cfg.num_layers,
                      "encoder_flash_calls": 0}
    torch.testing.assert_close(lf, lm, rtol=2e-5, atol=2e-5)
    enc, _ = tfm._encoder_forward(params, tb["frames"], cfg)

    def full(tokens):
        x = tfm._run_segments(params["layers"],
                              tfm._embed_tokens(params, tokens), cfg,
                              enc_out=enc)
        return tfm._lm_logits(params, rms_norm(x, params["final_norm"],
                                               cfg.norm_eps))

    torch.testing.assert_close(lf[:, 0], full(tb["tokens"])[:, -1], **TOL)
    nxt = lf[:, 0].argmax(-1)[:, None]
    ld, _ = tfm.decode_step(params, nxt, caches, cfg)
    torch.testing.assert_close(
        ld[:, 0], full(torch.cat([tb["tokens"], nxt], 1))[:, -1], **TOL)


# ---------------------------------------------------------------------------
# conversion, the registry, the batch and the pipeline
# ---------------------------------------------------------------------------
def test_registry_params_and_layout():
    """The registry's seamless is JAX's; the port's init has the JAX tree's
    layout (``enc_segments``, each decoder layer's ``ln_x`` and
    ``cross``), JAX's tree round-trips bitwise, and ``param_count`` counts
    it (2,034,784,256 at full size, as JAX's tree holds)."""
    jfull = jax_configs.get_config(ARCH)
    assert (dataclasses.asdict(configs.get_config(ARCH))
            == dataclasses.asdict(jfull))
    jcfg = CASES["seamless_reduced"]
    cfg = _port_cfg(jcfg)
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    params = tfm.init_params(cfg, seed=0)
    assert len(params["enc_layers"]) == cfg.encoder_layers
    assert all({"ln_x", "cross"} <= set(p) for p in params["layers"])
    got = params_to_jax(params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tfm.param_count(cfg) == count_params(params)
    tree = _np(jtfm.init_params(jax.random.PRNGKey(3), jcfg))
    back = params_to_jax(params_from_jax(tree), cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jfull))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert tfm.param_count(configs.get_config(ARCH)) == n == 2_034_784_256


@pytest.mark.parametrize("seq", [64, 2048, 255])
def test_synthetic_batch_matches_jax_bitwise(seq):
    """``seq // 2`` frames, then ``seq // 2`` tokens and their positions,
    bit for bit JAX's."""
    jcfg = jax_configs.get_config(ARCH)
    want = jax_synthetic_batch(jcfg, 2, seq, seed=seq)
    got = synthetic_batch(_port_cfg(jcfg), 2, seq, seed=seq)
    assert sorted(got) == sorted(want) == ["frames", "positions", "tokens"]
    assert got["frames"].shape == (2, seq // 2, jcfg.d_model)
    assert got["tokens"].shape == (2, seq // 2)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes()


# ---------------------------------------------------------------------------
# gradients and train steps
# ---------------------------------------------------------------------------
def _grad_batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    b = synthetic_batch(_port_cfg(jcfg), 2, 48, seed=seed)
    b["loss_mask"] = (rng.random(b["tokens"].shape) < 0.8).astype(np.float32)
    return b


def test_loss_and_gradients_match_jax():
    """The loss and every gradient leaf, the encoder's and the
    cross-attention's among them."""
    jcfg = CASES["seamless_reduced"]
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
        assert np.abs(w).max() > 0, jax.tree_util.keystr(path)
        assert _scaled_err(g, w) < GRAD_TOL, (jax.tree_util.keystr(path),
                                              _scaled_err(g, w))


def test_gradient_tolerance_is_the_f32_noise_floor():
    """Moving every weight of reduced seamless by about one f32 rounding
    (relative 1e-7) moves its gradients on the same batch by more than a
    tenth of ``GRAD_TOL``: the tolerance is within ten times what rounding
    alone does."""
    jcfg = CASES["seamless_reduced"]
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


@pytest.mark.parametrize("seed", [0, 3])
def test_token_pipeline_matches_jax_bitwise(seed):
    """The audio branch: ``seq`` frames a row after the tokens, from the
    same generator, bit for bit JAX's."""
    jcfg = CASES["seamless_reduced"]
    jpipe = JaxTokenPipeline(jcfg, 2, 16, seed=seed)
    pipe = TokenPipeline(_port_cfg(jcfg), 2, 16, seed=seed)
    try:
        for _ in range(2):
            want, got = jpipe.next(), pipe.next()
            assert sorted(got) == sorted(want) == ["frames", "tokens"]
            assert got["frames"].shape == (2, 16, jcfg.d_model)
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert got[key].tobytes() == want[key].tobytes()
    finally:
        jpipe.close()
        pipe.close()


def test_train_steps_match_jax():
    """Three AdamW steps in 2 microbatches on TokenPipeline batches (their
    frames included), each teacher-forced from JAX's parameters and
    optimizer state, against JAX's; the port's state keeps JAX's layout
    leaf for leaf, and every leaf changes, the encoder's, ``ln_x`` and
    ``cross`` among them."""
    jcfg = dataclasses.replace(CASES["seamless_reduced"],
                               train_microbatches=2)
    cfg = _port_cfg(jcfg)
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    j0 = _np(jparams)
    jstep, jopt = jax_make_train_step(jcfg, lr=LR)
    jstep = jax.jit(jstep)
    step_fn, _ = make_train_step(cfg, lr=LR)
    jstate = jopt.init(jparams)
    pipe = TokenPipeline(cfg, 4, 16, seed=5)
    try:
        for step in range(STEPS):
            b = pipe.next()
            state = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                 jstate)
            params, state, m = step_fn(params_from_jax(_np(jparams)), state,
                                       step, _t(b))
            jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step),
                                        _j(b))
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-3)
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
    paths = jax.tree_util.tree_flatten_with_path(j0)[0]
    for (path, a0), a in zip(paths, jax.tree.leaves(back)):
        assert not np.array_equal(a, a0), jax.tree_util.keystr(path)
    assert "enc_segments" in back and "cross" in back["segments"][0][
        "slots"][0]


# ---------------------------------------------------------------------------
# serving, checkpoints and the launchers
# ---------------------------------------------------------------------------
def test_greedy_run_with_frames_matches_jax_decode_loop():
    """``serve.run`` with ``frames`` and JAX's weights generates JAX's
    greedy tokens."""
    jcfg = CASES["seamless_reduced"]
    jparams = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    batch = jax_synthetic_batch(jcfg, 2, 48, seed=3)
    cache_len = 24 + 5 + 8
    logits, caches = jtfm.prefill(
        jparams, {k: jnp.asarray(batch[k]) for k in ("tokens", "frames")},
        jcfg, cache_len)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        logits, caches = jtfm.decode_step(jparams, tok, caches, jcfg)
    r = serve.run(params_from_jax(_np(jparams)), _port_cfg(jcfg),
                  batch["tokens"], frames=batch["frames"], new_tokens=5,
                  cache_len=cache_len)
    np.testing.assert_array_equal(r["tokens"], np.concatenate(want, 1))


def test_checkpoints_load_in_both_directions(tmp_path):
    """The port's ``lm_final.npz`` (JAX's tree through ``params_to_jax``)
    restores in JAX against ``init_params``'s tree, and a checkpoint JAX
    saves loads through the port's loader, leaf for leaf, the encoder's
    included."""
    jcfg = CASES["seamless_reduced"]
    cfg = _port_cfg(jcfg)
    params = tfm.init_params(cfg, seed=4)
    port_save_checkpoint(str(tmp_path / "port.npz"), params_to_jax(params, cfg), step=2)
    template = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    restored, step = restore_checkpoint(str(tmp_path / "port.npz"), template)
    assert step == 2
    for a, b in zip(jax.tree.leaves(restored),
                    jax.tree.leaves(params_to_jax(params, cfg))):
        np.testing.assert_array_equal(np.asarray(a), b)
    jtree = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    save_checkpoint(str(tmp_path / "jax.npz"), jtree, step=5)
    arrays, step = load_arrays(str(tmp_path / "jax.npz"))
    back = params_from_arrays(arrays)
    assert step == 5 and len(back["enc_layers"]) == cfg.encoder_layers
    for a, b in zip(tree_leaves(back), tree_leaves(params_from_jax(
            _np(jtree)))):
        assert torch.equal(a, b)


def test_launchers_run_reduced_on_the_cpu(tmp_path, capsys):
    """``--arch seamless-m4t-large-v2`` serves (a 64-long prompt: 32
    frames, 32 tokens; the encoder's, each layer's self- and cross-
    attention on the flash route) and trains (the pipeline's frames, as
    many as tokens) with ``--reduced`` on the CPU."""
    before = dict(tattn.ROUTE_CALLS)
    s = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "64", "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: prefill 2x64 ")
    assert s["tokens"].shape == (2, 3) and s["cache_len"] == 64 + 3 + 8
    assert np.isfinite(s["logits"].numpy()).all()
    routes = {k: v - before[k] for k, v in tattn.ROUTE_CALLS.items()}
    assert routes == {"flash_calls": 2, "masked_calls": 0,
                      "cross_flash_calls": 2, "cross_masked_calls": 0,
                      "encoder_flash_calls": 2}
    r = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch",
                     "2", "--seq", "16", "--layers", "2", "--device", "cpu",
                     "--save", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: ") and out[0].endswith("M params")
    assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    assert r["grad_norm"][0] > 0
    arrays, _ = load_arrays(r["checkpoint"])
    assert any(k.startswith("enc_segments/") for k in arrays)
    assert any("/cross/wq" in k for k in arrays)
