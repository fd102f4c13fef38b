"""The port's LM training against the JAX package's: the optimizers, the
loss and its gradients, the train step, the token pipeline and the
launcher's LM mode.

JAX initialises the weights and ``params_from_jax`` carries them across.
Tolerances, and why:
- the optimizers' update and state: ``rtol`` 1e-6 (SGD, AdamW) and 1e-5
  (Adafactor, whose row and column means may sum in another order);
- the loss and ``xent``: 1e-5 relative;
- each gradient leaf: ``GRAD_TOL`` of its largest element. The reduced
  models' gradients move by about 1.5e-4 of it when every weight moves by
  one f32 rounding (``test_gradient_tolerance_is_the_f32_noise_floor``
  measures that), so two f32 implementations that round differently
  cannot agree closer;
- train steps: every step's loss and the first step's grad norm within
  1e-4 relative; the later grad norms within ``LATER_NORM_TOL``. AdamW
  turns each gradient element into about ±lr at its first step, so the
  elements whose gradient is rounding noise move either way; nudging the
  initial weights by one rounding moves the third step's grad norm by up
  to 3.3e-2 in the port alone. Each parameter after the steps stays
  within 2 lr a step of JAX's (a flip each step), and at most
  ``FLIPPED`` of a leaf's elements differ by more than lr / 10: the
  one-rounding nudge alone moves up to 13.7 % of a leaf's elements so
  with AdamW, while Adafactor's moments taken per layer instead of over
  JAX's stacked leaf moved 99 % of a norm scale's.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.models import transformer as jtfm
from repro.models.common import count_params as jax_count_params
from repro.train.checkpoint import restore_checkpoint
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tfm
from repro_torch.models.common import count_params, tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (layers_from_segments,
                                        params_from_arrays, params_from_jax,
                                        params_to_jax)
from repro_torch.train.checkpoint import load_arrays
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import loss_and_grads, make_train_step

GRAD_TOL = 1e-3
LATER_NORM_TOL = 5e-2
FLIPPED = 0.2
LR = 3e-4
ARCHS = ["qwen1.5-0.5b", "granite-3-2b"]


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


def _reduced(arch, **changes):
    """The reduced arch of the JAX launcher (2 layers, d 256, vocab 1,024)."""
    return dataclasses.replace(jax_configs.get_config(arch).reduced(),
                               **changes)


def _jax_params(jcfg, seed=0):
    return jtfm.init_params(jax.random.PRNGKey(seed), jcfg)


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3,)).astype(np.float32),
              "mat": rng.normal(size=(4, 8)).astype(np.float32),
              "cube": rng.normal(size=(2, 3, 5)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name,rtol", [("sgd", 1e-6), ("adamw", 1e-6),
                                       ("adafactor", 1e-5)])
def test_optimizer_matches_jax(name, rtol):
    """Three updates from the same params, grads and steps give JAX's
    params and state, leaf for leaf in JAX's state layout."""
    params, grads = _opt_case()
    jopt = jax_make_optimizer(name, lr=0.05, wd=0.01)
    opt = make_optimizer(name, lr=0.05, wd=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, jnp.int32(step))
        tp, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp, step)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=rtol, atol=rtol)
    want, got = _flat(js), _flat(tree_map(lambda t: t.numpy(), ts))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    """``tests/test_optim_ckpt.py``'s quadratic, on the port."""
    opt = make_optimizer(name, lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5),
              "mat": torch.ones((4, 8))}
    state = opt.init(params)

    def loss(p):
        return (p["w"] ** 2).sum() + p["b"] ** 2 + (p["mat"] ** 2).sum()

    l0 = float(loss(params))
    for step in range(50):
        grads = {k: 2 * v for k, v in params.items()}
        params, state = opt.update(grads, state, params, step)
    assert float(loss(params)) < 0.5 * l0


def test_adafactor_state_is_factored():
    opt = make_optimizer("adafactor", lr=1e-2)
    st = opt.init({"big": torch.ones((64, 128)), "vec": torch.ones((7,))})
    assert st["f"]["big"]["vr"].shape == (64,)
    assert st["f"]["big"]["vc"].shape == (128,)
    assert st["f"]["vec"]["v"].shape == (7,)


def test_adamw_dtype_preserved():
    opt = make_optimizer("adamw", lr=1e-2)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = opt.init(params)
    new, st = opt.update({"w": torch.ones((4, 4), dtype=torch.bfloat16)},
                         st, params, 0)
    assert new["w"].dtype == torch.bfloat16
    assert st["m"]["w"].dtype == torch.float32        # master stats in f32


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def _batch(jcfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return {"tokens": tokens, "positions": positions, "loss_mask": mask}


def _grad_pairs(got, want_tree):
    """(name, port leaf, JAX leaf) for every gradient leaf."""
    want_layers = layers_from_segments(_np(want_tree["segments"]))
    pairs = [(k, got[k], want_tree[k]) for k in got if k != "layers"]

    def walk(g, w, name):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), name
            for k in w:
                walk(g[k], w[k], f"{name}/{k}")
        else:
            pairs.append((name, g, w))

    for i, (g, w) in enumerate(zip(got["layers"], want_layers)):
        walk(g, w, f"layers/{i}")
    return pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg = _reduced(arch)
    jparams = _jax_params(jcfg)
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
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    pairs = _grad_pairs(grads, _np(jgrads))
    assert len(pairs) == len(tree_leaves(grads))
    for name, g, w in pairs:
        assert tuple(g.shape) == w.shape, name
        assert _scaled_err(g.numpy(), w) < GRAD_TOL, name


def test_gradient_tolerance_is_the_f32_noise_floor():
    """Moving every weight by about one f32 rounding (relative 1e-7) moves
    the reduced model's gradients by more than a tenth of ``GRAD_TOL``:
    the tolerance is within ten times what rounding alone does."""
    jcfg = _reduced("qwen1.5-0.5b")
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(_jax_params(jcfg)))
    b = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    _, _, g0 = loss_and_grads(params, b, cfg)
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), params)
    _, _, g1 = loss_and_grads(nudged, b, cfg)
    moved = max(_scaled_err(a.numpy(), w.numpy())
                for a, w in zip(tree_leaves(g1), tree_leaves(g0)))
    assert GRAD_TOL / 10 < moved < GRAD_TOL


def test_a_leaf_the_loss_does_not_read_raises():
    """Only the shared expert on the dense oracle, which JAX's loss does not
    read either, takes a zero gradient; any other unread leaf is a wiring
    fault and raises."""
    jcfg = _reduced("qwen1.5-0.5b")
    params = params_from_jax(_np(_jax_params(jcfg)))
    params["layers"][0]["stray"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match=r"does not read .* \(3,\)"):
        loss_and_grads(params, {k: torch.from_numpy(v)
                                for k, v in _batch(jcfg).items()},
                       _port_cfg(jcfg))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
STEP_CASES = {
    "adamw": dict(optimizer="adamw"),
    "adafactor": dict(optimizer="adafactor"),
    "microbatches2": dict(optimizer="adamw", train_microbatches=2),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(arch, case):
    """Three steps on TokenPipeline batches against JAX's (the module
    docstring gives the tolerances), with the optimizer state in JAX's
    layout, leaf for leaf."""
    jcfg = _reduced(arch, **STEP_CASES[case])
    cfg = _port_cfg(jcfg)
    jparams = _jax_params(jcfg, seed=1)
    params = params_from_jax(_np(jparams))
    jstep, jopt = jax_make_train_step(jcfg, lr=LR)
    jstep = jax.jit(jstep)
    step_fn, opt = make_train_step(cfg, lr=LR)
    jstate, state = jopt.init(jparams), opt.init(params)
    pipe = TokenPipeline(cfg, 4, 32, seed=5)
    try:
        for step in range(3):
            tokens = pipe.next()["tokens"]
            jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step),
                                        {"tokens": jnp.asarray(tokens)})
            params, state, m = step_fn(params, state, step,
                                       {"tokens": torch.from_numpy(tokens)})
            assert sorted(m) == sorted(jm)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(
                float(m["grad_norm"]), float(jm["grad_norm"]),
                rtol=1e-4 if step == 0 else LATER_NORM_TOL)
    finally:
        pipe.close()
    got_state = jax.tree.map(lambda t: t.numpy(), state)
    assert jax.tree.structure(got_state) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(jstate)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    back = params_to_jax(params, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jparams))):
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= 2 * LR * 3
        assert (d > LR / 10).mean() <= FLIPPED, (d > LR / 10).mean()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_pipeline_matches_jax_bitwise(seed):
    jcfg = jax_configs.get_config("qwen1.5-0.5b")
    jpipe = JaxTokenPipeline(jcfg, 3, 48, seed=seed)
    pipe = TokenPipeline(_port_cfg(jcfg), 3, 48, seed=seed)
    try:
        for _ in range(3):
            want, got = jpipe.next(), pipe.next()
            assert sorted(got) == sorted(want) == ["tokens"]
            assert got["tokens"].dtype == want["tokens"].dtype
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    finally:
        jpipe.close()
        pipe.close()


def test_token_pipeline_refuses_other_modalities():
    """The pipeline's audio branch (which used to refuse): ``seq`` encoder
    frames a row after the tokens, bit for bit JAX's."""
    jcfg = dataclasses.replace(_reduced("qwen1.5-0.5b"), modality="audio")
    jpipe = JaxTokenPipeline(jcfg, 2, 8, seed=2)
    pipe = TokenPipeline(_port_cfg(jcfg), 2, 8, seed=2)
    try:
        for _ in range(2):
            want, got = jpipe.next(), pipe.next()
            assert sorted(got) == sorted(want) == ["frames", "tokens"]
            assert got["frames"].shape == (2, 8, jcfg.d_model)
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert got[key].tobytes() == want[key].tobytes()
    finally:
        jpipe.close()
        pipe.close()


# ---------------------------------------------------------------------------
# the launcher's LM mode
# ---------------------------------------------------------------------------
def test_launcher_lm_mode_matches_jax_steps(tmp_path, capsys):
    """``--arch qwen1.5-0.5b --reduced --steps 3 --batch 2 --seq 64 --save
    --device cpu`` prints JAX's lines, its steps are JAX's steps from the
    same weights on the same batches, and JAX's ``restore_checkpoint``
    reads its ``lm_final.npz`` against ``init_params``'s tree.

    The launcher's 4-layer model is worse conditioned than the 2-layer
    ones above: nudging its initial weights by one f32 rounding moves the
    first step's grad norm by 7.1e-4 and the third step's loss by 6.7e-4
    (and the later grad norms by up to 37 %, so they are not compared).
    The first step's loss is held within 1e-5 and its grad norm within
    2e-3, the later losses within 5e-3."""
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "3",
            "--batch", "2", "--seq", "64", "--save", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    r = ttrain.main(argv)
    out = capsys.readouterr().out.splitlines()
    # the launcher's config and its initial weights, rebuilt
    jcfg = dataclasses.replace(
        jax_configs.get_config("qwen1.5-0.5b").reduced(layers=4, d_model=256,
                                                       experts=4),
        vocab_size=1024, train_microbatches=1)
    cfg = _port_cfg(jcfg)
    init = tfm.init_params(cfg, seed=0, device="cpu")
    assert out[0] == f"qwen1.5-0.5b: {count_params(init)/1e6:.1f}M params"
    assert len(out) == 3
    for line, step in zip(out[1:], (0, 2)):
        assert re.fullmatch(rf"step {step:5d} loss \d+\.\d{{4}} "
                            rf"grad_norm \d+\.\d{{2}}", line), line
    jparams = jax.tree.map(jnp.asarray, params_to_jax(init, cfg))
    assert jax_count_params(jparams) == count_params(init)
    jstep, jopt = jax_make_train_step(jcfg, lr=LR)
    jstep, jstate = jax.jit(jstep), jopt.init(jparams)
    pipe = JaxTokenPipeline(jcfg, 2, 64, seed=0)
    try:
        for step in range(3):
            jparams, jstate, jm = jstep(
                jparams, jstate, jnp.int32(step),
                {"tokens": jnp.asarray(pipe.next()["tokens"]),
                 "positions": jnp.broadcast_to(
                     jnp.arange(64, dtype=jnp.int32), (2, 64))})
            np.testing.assert_allclose(r["losses"][step], float(jm["loss"]),
                                       rtol=1e-5 if step == 0 else 5e-3)
            if step == 0:
                np.testing.assert_allclose(r["grad_norm"][0],
                                           float(jm["grad_norm"]), rtol=2e-3)
    finally:
        pipe.close()
    assert r["checkpoint"] == str(tmp_path / "lm_final.npz")
    template = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    restored, step = restore_checkpoint(r["checkpoint"], template)
    assert step == 3
    want = params_to_jax(r["params"], cfg)
    assert jax.tree.structure(restored) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # and through the port's own loader, leaf for leaf
    arrays, step = load_arrays(r["checkpoint"])
    back = params_from_arrays(arrays)
    assert step == 3
    for a, b in zip(tree_leaves(back), tree_leaves(r["params"])):
        assert torch.equal(a, b)
    assert r["step_s"] > 0


def test_launcher_lm_mode_needs_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1",
                     "--out-dir", str(tmp_path)])


def test_embedding_mode_default_lr_is_unchanged(tmp_path):
    """Without ``--lr`` the embedding mode trains at 0.025, as it did
    before ``--lr`` defaulted to None: the same checkpoint, bit for bit."""
    base = ["--nodes", "300", "--epochs", "1", "--episodes", "2", "--dim",
            "16", "--device", "cpu"]
    a = ttrain.main(base + ["--out-dir", str(tmp_path / "a")])
    b = ttrain.main(base + ["--out-dir", str(tmp_path / "b"),
                            "--lr", "0.025"])
    for key in ("vertex", "context"):
        with np.load(a["checkpoint"]) as fa, np.load(b["checkpoint"]) as fb:
            assert fa[key].tobytes() == fb[key].tobytes()
