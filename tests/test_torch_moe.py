"""The port's MoE family against the JAX package's: the layer (the dense
oracle, the aux loss and the one-rank expert dispatch), and phi3.5-moe
reduced (init layout, conversion, serving, a train step, both
launchers' LM modes).

JAX initialises the weights and ``params_from_jax`` carries them across.
Tolerances: the layer 1e-5 (f32 expert products that sum in another
order); serving logits ``tests/test_torch_lm.py``'s 2e-3; the train step
``tests/test_torch_lm_train.py``'s (its loss within 1e-4, its grad norm
within 1e-3, three times what a one-rounding nudge of the weights moves
it, each parameter within 2 lr of JAX's). The dispatch must drop exactly
JAX's rows: a row JAX drops adds nothing to its token, so the rows each
JAX token kept are read off its output against the port's per-expert
outputs.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import mlp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import count_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train.train_step import make_train_step

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "phi3.5-moe-42b-a6.6b"
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and many small plain-PyTorch ops on spinning thread pools crawl when
    they are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(E=4, k=2, cap=8.0, shared=0):
    """``tests/test_moe.py``'s layer config."""
    return JaxModelConfig(name="t", arch_type="moe", num_layers=1, d_model=32,
                          num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                          moe_num_experts=E, moe_top_k=k, moe_d_ff=48,
                          moe_num_shared=shared, moe_capacity_factor=cap)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _auto_mesh():
    """A one-device host mesh whose axes ``with_sharding_constraint`` may
    name (this JAX's ``make_mesh`` defaults to explicit axes, which the
    reference's ``forward_train`` cannot constrain)."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
LAYER_CASES = {
    "top2": dict(),
    "shared": dict(shared=1),
    "e8": dict(E=8, k=2),
    "top1": dict(k=1),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_ref_matches_jax(case):
    jcfg = make_cfg(**LAYER_CASES[case])
    params = jmlp.init_moe_params(KEY, jcfg)
    x = jax.random.normal(jax.random.fold_in(KEY, 1), (2, 8, 32))
    jy, jaux = jmlp.moe_ref(params, x, jcfg)
    y, aux = mlp.moe_ref(_t(params), torch.from_numpy(np.array(x)),
                         _port_cfg(jcfg))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # the serving route is the oracle, as JAX without a mesh
    y2, _ = mlp.moe_forward(_t(params), torch.from_numpy(np.array(x)),
                            _port_cfg(jcfg))
    assert torch.equal(y, y2)


def test_aux_loss_matches_jax():
    """``tests/test_moe.py``'s skewed and uniform gates, on both."""
    cfg = make_cfg(E=8, k=2)
    T, E = 128, 8
    probs = np.full((1, T, E), 1.0 / E, np.float32)
    skew = np.zeros((1, T, E), np.float32)
    skew[:, :, :2] = 0.5
    uni = np.full((1, T, E), 0.25, np.float32)
    for gates in (skew, uni):
        want = float(jmlp._aux_loss(jnp.asarray(probs), jnp.asarray(gates),
                                    cfg))
        got = float(mlp._aux_loss(torch.from_numpy(probs),
                                  torch.from_numpy(gates), _port_cfg(cfg)))
        assert got == pytest.approx(want, rel=1e-6)
    assert float(mlp._aux_loss(torch.from_numpy(probs), torch.from_numpy(skew),
                               _port_cfg(cfg))) < float(mlp._aux_loss(
        torch.from_numpy(probs), torch.from_numpy(uni), _port_cfg(cfg)))


def _skewed(params):
    """``tests/test_moe.py``'s router that sends every token to expert 0."""
    return dict(params, router=jnp.zeros((32, 4)).at[:, 0].set(10.0))


DISPATCH_CASES = {
    "ep": (dict(), (2, 8), lambda p: p),
    "decode": (dict(), (3, 1), lambda p: p),
    "shared": (dict(shared=1), (2, 8), lambda p: p),
    "cap1_top2": (dict(cap=1.0), (2, 8), lambda p: p),
    "skew_cap1": (dict(k=1, cap=1.0), (2, 8), _skewed),
}


def _kept_by_jax(jy, y_all, topw, topi):
    """For each token, which of its k rows JAX's dispatch kept: the subset
    whose gated sum of the port's per-expert outputs (E, T, d) is JAX's
    output row. Returns (T, k) bool."""
    T, k = topi.shape
    kept = np.zeros((T, k), bool)
    for t in range(T):
        best = None
        for subset in itertools.product((False, True), repeat=k):
            y = sum((topw[t, j] * y_all[topi[t, j], t]
                     for j in range(k) if subset[j]), np.zeros_like(jy[t]))
            err = np.abs(y - jy[t]).max()
            if best is None or err < best[0]:
                best = (err, subset)
        assert best[0] < 1e-4, (t, best)
        kept[t] = best[1]
    return kept


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_matches_jax_on_a_one_device_mesh(case):
    """``moe_forward(dispatch=True)`` against JAX's ``moe_forward`` on a
    (1, 1) mesh (its ``_device_moe``): outputs, aux and the dropped rows."""
    changes, (B, S), edit = DISPATCH_CASES[case]
    jcfg = make_cfg(**changes)
    params = edit(jmlp.init_moe_params(KEY, jcfg))
    x = jax.random.normal(jax.random.fold_in(KEY, 5), (B, S, 32))
    mesh = _mesh()
    jy, jaux = jax.jit(lambda p, xx: jmlp.moe_forward(p, xx, jcfg,
                                                      mesh=mesh))(params, x)
    cfg = _port_cfg(jcfg)
    tp, tx = _t(params), torch.from_numpy(np.array(x))
    y, aux = mlp.moe_forward(tp, tx, cfg, dispatch=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # the rows each token kept, JAX's against the port's plan
    xt = tx.reshape(B * S, 32)
    _, topw, topi = mlp._route(xt, tp["router"], cfg.moe_top_k)
    _, kept, _ = mlp.dispatch_plan(topi, cfg)
    h = torch.nn.functional.silu(torch.matmul(xt, tp["w_gate"])) * \
        torch.matmul(xt, tp["w_up"])
    y_all = torch.matmul(h, tp["w_down"]).numpy()
    jy_routed = np.asarray(jy).reshape(B * S, 32)
    if "shared" in params:
        jy_routed = jy_routed - mlp.ffn_forward(tp["shared"], xt).numpy()
    want = _kept_by_jax(jy_routed, y_all, topw.numpy(), topi.numpy())
    np.testing.assert_array_equal(kept.reshape(B * S, -1).numpy(), want)
    assert want.all() == ("cap1" not in case)      # the cap1 cases drop
    if case.startswith("skew"):
        # every token routed to one expert: most rows are dropped, and a
        # dropped token's output is exactly zero in both
        assert 0 < want.sum() < want.size
        dropped = ~want[:, 0]
        assert (np.asarray(jy).reshape(B * S, 32)[dropped] == 0).all()
        assert (y.reshape(B * S, 32).numpy()[dropped] == 0).all()


def test_dispatch_without_drops_is_the_oracle():
    """At a capacity factor of E / k no row can drop: the dispatch then
    computes the oracle (``tests/test_moe.py``'s 1e-4)."""
    jcfg = make_cfg(E=4, k=2, cap=2.0)
    cfg = _port_cfg(jcfg)
    params = _t(jmlp.init_moe_params(KEY, jcfg))
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(KEY, 6), (2, 16, 32))))
    _, topw, topi = mlp._route(x.reshape(-1, 32), params["router"], 2)
    assert mlp.dispatch_plan(topi, cfg)[1].all()
    y0, a0 = mlp.moe_ref(params, x, cfg)
    y1, a1 = mlp.moe_forward(params, x, cfg, dispatch=True)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)
    assert float(a0) == pytest.approx(float(a1), rel=1e-6)


# ---------------------------------------------------------------------------
# phi3.5-moe, reduced
# ---------------------------------------------------------------------------
def _phi(**changes):
    return dataclasses.replace(jax_configs.get_config(ARCH).reduced(),
                               **changes)


def test_registry_holds_phi_as_jax_does():
    assert (dataclasses.asdict(configs.get_config(ARCH))
            == dataclasses.asdict(jax_configs.get_config(ARCH)))
    assert ARCH not in configs.NOT_PORTED


def test_phi_init_has_the_jax_layout():
    """The port's init gives the JAX tree's shapes and dtypes (the router
    f32, the stacked (groups, E, ...) experts), and ``param_count`` counts
    it without allocating."""
    jcfg = _phi()
    cfg = _port_cfg(jcfg)
    want = jax.eval_shape(lambda: jtfm.init_params(KEY, jcfg))
    params = tfm.init_params(cfg, seed=0)
    got = params_to_jax(params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert got["segments"][0]["slots"][0]["moe"]["w_gate"].shape == \
        (2, 4, 256, 256)
    assert tfm.param_count(cfg) == count_params(params)
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    layer = tfm.init_params(bf16, seed=0)["layers"][0]
    assert layer["moe"]["router"].dtype == torch.float32
    assert layer["moe"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phi_convert_round_trips_bitwise(dtype):
    """JAX's tree to the port and back moves no bits; bf16 leaves cross
    from JAX as raw words (the way back needs ml_dtypes, which the port
    does not import)."""
    jcfg = _phi(param_dtype=dtype)
    tree = _np(jtfm.init_params(KEY, jcfg))
    params = params_from_jax(tree)
    w = tree["segments"][0]["slots"][0]["moe"]["w_down"]
    for g in range(jcfg.num_layers):
        got = params["layers"][g]["moe"]["w_down"]
        assert got.dtype == getattr(torch, dtype)
        assert got.view(torch.int16 if dtype == "bfloat16" else torch.int32
                        ).numpy().tobytes() == np.ascontiguousarray(
            w[g]).tobytes()
    if dtype == "float32":
        back = params_to_jax(params, _port_cfg(jcfg))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_phi_prefill_and_decode_match_jax():
    jcfg = _phi()
    jparams = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(2)
    B, S = 2, 24
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (3, B, 1)).astype(np.int32)
    cache_len = S + 8
    jl, jc = jtfm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                          cache_len)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_np(jparams))
    before = dict(tattn.ROUTE_CALLS)
    tl, tc = tfm.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                         cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    # one flash-route prefill a layer (the plain version on the CPU)
    assert (tattn.ROUTE_CALLS["flash_calls"] - before["flash_calls"]
            == cfg.num_layers)
    assert tattn.ROUTE_CALLS["masked_calls"] == before["masked_calls"]
    for tok in feed:
        jl, jc = jtfm.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
        tl, tc = tfm.decode_step(params, torch.from_numpy(tok), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)


def test_phi_train_step_matches_jax():
    """One Adafactor step through the expert dispatch against JAX's step
    under a one-device host mesh (its launcher's route)."""
    jcfg = _phi()
    assert jcfg.optimizer == "adafactor"
    cfg = _port_cfg(jcfg)
    jparams = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(_np(jparams))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    mesh = _auto_mesh()
    jstep, jopt = jax_make_train_step(jcfg, mesh=mesh, lr=LR)
    with mesh:
        jnew, _, jm = jax.jit(jstep)(jparams, jopt.init(jparams),
                                     jnp.int32(0),
                                     {"tokens": jnp.asarray(tokens)})
    step_fn, opt = make_train_step(cfg, lr=LR, moe_dispatch=True)
    new, _, m = step_fn(params, opt.init(params), 0,
                        {"tokens": torch.from_numpy(tokens)})
    for key in ("loss", "xent", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4)
    # nudging the weights by one f32 rounding moves this grad norm by up
    # to 3.3e-4 in the port alone (three nudges: 1.3e-5, 6.6e-6, 3.3e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert float(m["aux"]) > 0
    back = params_to_jax(new, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jnew))):
        assert np.abs(a - b).max() <= 2 * LR


def test_phi_launchers_run_reduced_on_the_cpu(tmp_path, capsys):
    """``--arch phi3.5-moe-42b-a6.6b`` trains and serves with
    ``--reduced`` on the CPU; serving it at full depth raises before it
    allocates, naming ``sharding/``."""
    r = ttrain.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch",
                     "2", "--seq", "32", "--layers", "2", "--device", "cpu",
                     "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: ") and out[0].endswith("M params")
    assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    s = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "32", "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}: prefill 2x32 ")
    assert s["tokens"].shape == (2, 3)
    assert np.isfinite(s["logits"].numpy()).all()
    with pytest.raises(SystemExit, match="sharding/"):
        serve.main(["--arch", ARCH, "--no-reduced", "--device", "cpu"])
