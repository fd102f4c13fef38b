"""The port's sharded compute on four ``gloo`` CPU ranks against the JAX
package's sharded reference and the port's one-process runs.

One spawn of four ranks per mesh, (2, 2) and (1, 4), runs every case of
that mesh; the JAX reference runs once in a subprocess on four forced host
devices under an auto-axes mesh (the explicit-axes mesh that
``tests/test_distributed.py`` builds fails on this JAX). The cases:

* the expert-parallel ``moe_forward`` on both meshes, at a prefill shape
  (the sequence sliced over "model"; on (2, 2) the combined
  ("data", "model") EP) and at a decode shape (the quota mode), at a
  capacity factor that drops rows, against JAX's ``moe_forward(mesh=)``
  and the one-process plan ``moe_ep_plain`` (``rtol = atol = 1e-4``,
  ``tests/test_distributed.py``'s);
* one sharded Adafactor step of reduced phi3.5-moe (2 layers, d 256, 4
  experts, 2 microbatches) on (2, 2): loss, grad norm and the gathered
  updated parameters against JAX's sharded step and the port's one-rank
  step running the same 4-rank plan (``tests/test_torch_moe.py``'s
  tolerances: loss 1e-4, grad norm 1e-3, each parameter within 2 lr);
* one sharded AdamW step of reduced qwen1.5 on (1, 4) against the
  one-rank step (the loss within 1e-5, the grad norm within 1e-4, each
  parameter within 2 lr: ``tests/test_torch_lm_train.py``'s);
* the sharded Adafactor and AdamW on both meshes, two steps on the same
  gradients, against the one-rank optimizer and JAX's optimizer on its
  sharded state: the gathered parameters within 1e-5 lr (a few roundings
  of the update; without the means' cross-shard sum Adafactor's move by
  1e-3 lr), the gathered state (``m``/``v``, ``vr``/``vc``/``v`` in their
  own layouts) within ``rtol`` 1e-5 and 1e-6 of the leaf's largest
  value. The tree's leaves take the layouts the rule gives: vocab over
  "model" and d over "data", a factored moment sharded otherwise than its
  parameter's rows, stacked leaves, experts over ("data", "model"), a
  sharded vector;
* the sequence-parallel island (``tp_size`` 4, 6 heads) against the
  one-pass ``_attend``, values and gradients (1e-5, 1e-6), and a training
  loss through it against the unsharded loss;
* sharded prefill and decode against one rank (the serving tolerance
  2e-3): granite-3-2b reduced on (2, 2), phi3.5-moe reduced on (1, 4);
* ``shard_params`` then ``gather_params`` bitwise the tree, on every rank;
* the training launcher's LM mode under the ``torchrun`` variables on two
  ranks, its checkpoint read back.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import attention as tattn
from repro_torch.models import mlp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_arrays, params_to_jax
from repro_torch.train.checkpoint import _flatten, load_arrays
from repro_torch.train.train_step import make_train_step, synthetic_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
EP_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
LR = 3e-4
OPT_LR, OPT_WD = 1e-2, 0.1
# the optimizer tests' tree, JAX layout (``segments`` stacked)
OPT_SHAPES = {"embed": (8192, 128), "lm_head": (65536, 8),
              "final_norm": (256,), "bias": (131072,),
              "segments": [{"slots": [{"wq": (2, 32768, 4),
                                       "w_gate": (2, 4, 64, 256),
                                       "w_down": (2, 512, 256),
                                       "attn_norm": (2, 256)}]}]}
ATTN = dict(B=2, S=64, H=6, hd=16, tp=4)


class Duck:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


def layer_cfg():
    """``tests/test_distributed.py``'s EP layer at a capacity factor that
    drops rows."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="t", arch_type="moe", num_layers=1, d_model=64,
                       num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
                       moe_num_experts=8, moe_top_k=2, moe_d_ff=96,
                       moe_capacity_factor=0.5)


def phi_cfg():
    cfg = configs.get_config("phi3.5-moe-42b-a6.6b").reduced(
        layers=2, d_model=256, experts=4)
    return dataclasses.replace(cfg, train_microbatches=2)


def qwen_cfg():
    return configs.get_config("qwen1.5-0.5b").reduced(layers=2, d_model=256)


def seqpar_cfg():
    return dataclasses.replace(
        configs.get_config("qwen1.5-0.5b").reduced(layers=2, d_model=384),
        num_heads=6, num_kv_heads=6, tp_size=ATTN["tp"])


def serve_cfg(arch):
    cfg = configs.get_config(arch).reduced(layers=2, d_model=256, experts=4)
    return dataclasses.replace(cfg, moe_capacity_factor=8.0) \
        if cfg.moe_num_experts else cfg


SERVE = {"2x2": "granite-3-2b", "1x4": "phi3.5-moe-42b-a6.6b"}


def flat(tree, prefix="") -> dict:
    """A tree of dicts and lists as ``{"a/0/b": leaf}``."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k2: v2 for k, v in items
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def unflat(leaves: dict, fn=lambda x: x):
    """:func:`flat`'s inverse (all-digit keys make a list), ``fn`` on each
    leaf."""
    root: dict = {}
    for key, v in leaves.items():
        *path, last = key.split("/")
        node = root
        for a in path:
            node = node.setdefault(a, {})
        node[last] = fn(v)

    def fix(n):
        if not isinstance(n, dict):
            return n
        if all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()}
    return fix(root)


def opt_inputs() -> dict:
    """The optimizer tests' parameters (``p/...``) and two steps'
    gradients (``g0/...``, ``g1/...``), f32, from one seed; each
    gradient's rows and columns scaled apart, so the factored moments are
    not flat."""
    rng = np.random.default_rng(12)
    out = {}
    for key, shape in flat(OPT_SHAPES, "").items():
        shape = tuple(shape)
        out["p/" + key] = rng.normal(0, 0.01, shape).astype(np.float32)
        for s in range(2):
            scale = np.exp(rng.normal(0, 0.7, shape[:-1] + (1,))
                           + rng.normal(0, 0.7, shape[-1:]))
            out[f"g{s}/" + key] = (rng.normal(0, 1, shape) * scale
                                   ).astype(np.float32)
    return out


def pick(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{REPO}/tests",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run_ranks(argv, world, timeout=300):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, *argv],
        env=_env(WORLD_SIZE=world, RANK=r, LOCAL_RANK=r,
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


JAX_REF = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.models import mlp, transformer as tfm
from repro.models.config import ModelConfig
from repro.sharding.specs import param_shardings
from repro.train.train_step import make_train_step, synthetic_batch
out, lr = sys.argv[1], float(sys.argv[2])
res = {}

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(e, "key", getattr(e, "idx", "")))
                       for e in path)
        res[prefix + key] = np.asarray(leaf)

lcfg = ModelConfig(name="t", arch_type="moe", num_layers=1, d_model=64,
                   num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
                   moe_num_experts=8, moe_top_k=2, moe_d_ff=96,
                   moe_capacity_factor=0.5)
key = jax.random.PRNGKey(0)
lp = mlp.init_moe_params(key, lcfg)
flat(lp, "layer/")
xs = {"prefill": jax.random.normal(jax.random.fold_in(key, 1), (2, 64, 64)),
      "quota": jax.random.normal(jax.random.fold_in(key, 2), (64, 1, 64))}
for name, x in xs.items():
    res["x/" + name] = np.asarray(x)
    for mname, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
        mesh = mesh_of(shape)
        y, aux = jax.jit(lambda p, xx: mlp.moe_forward(p, xx, lcfg,
                                                       mesh=mesh))(lp, x)
        res[f"y/{mname}/{name}"] = np.asarray(y)
        res[f"aux/{mname}/{name}"] = np.asarray(aux)

cfg = configs.get_config("phi3.5-moe-42b-a6.6b").reduced(
    layers=2, d_model=256, experts=4)
cfg = dataclasses.replace(cfg, train_microbatches=2)
mesh = mesh_of((2, 2))
params = tfm.init_params(jax.random.PRNGKey(3), cfg)
flat(params, "phi/")
batch = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, 4, 32).items()}
params = jax.device_put(params, param_shardings(params, mesh))
step_fn, opt = make_train_step(cfg, mesh=mesh, data_axes=("data",), lr=lr)
state = jax.device_put(opt.init(params), param_shardings(
    jax.eval_shape(opt.init, params), mesh))
with mesh:
    new, _, m = jax.jit(step_fn)(params, state, jnp.int32(0), batch)
flat(new, "phi_new/")
for k in ("loss", "grad_norm", "xent"):
    res["phi_m/" + k] = np.asarray(m[k])

# the optimizers alone: two steps on the test's gradients, sharded state
import test_torch_sharded_step as T
from repro.train.optimizer import make_optimizer
opt_in = dict(np.load(sys.argv[3]))
def tree(prefix):
    return T.unflat(T.pick(opt_in, prefix), jnp.asarray)
for mname, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
    mesh = mesh_of(shape)
    specs = param_shardings(tree("p/"), mesh)
    p0 = jax.device_put(tree("p/"), specs)
    gs = [jax.device_put(tree(f"g{s}/"), specs) for s in range(2)]
    for oname in ("adafactor", "adamw"):
        opt = make_optimizer(oname, lr=T.OPT_LR, wd=T.OPT_WD)
        st = jax.device_put(opt.init(p0), param_shardings(
            jax.eval_shape(opt.init, p0), mesh))
        upd, p = jax.jit(opt.update), p0
        for s in range(2):
            p, st = upd(gs[s], st, p, jnp.int32(s))
        flat(p, f"opt/{mname}/{oname}/p/")
        flat(st, f"opt/{mname}/{oname}/s/")
np.savez(out, **res)
"""

RANKS = r"""
import dataclasses, json, sys
import numpy as np, torch
torch.set_num_threads(1)
import test_torch_sharded_step as T
from repro_torch.models import attention as tattn, mlp, transformer as tfm
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_arrays, params_to_jax
from repro_torch.sharding import param_shardings, shard
from repro_torch.sharding.mesh import init_ranks, make_host_mesh
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step, synthetic_batch
name, ref, out, opt_in = sys.argv[1:5]
shape = tuple(int(n) for n in name.split("x"))
init_ranks(torch.device("cpu"), False)
mesh = make_host_mesh(shape)
jref = dict(np.load(ref))
res = {}

def pick(prefix):
    return T.pick(jref, prefix)

def rows_of(t, view):
    return t[mesh.batch_slice(t.shape[0])]

def all_rows(t, view):
    return shard.all_gather(t, view, view.b_axes, 0) if view.b_axes else t

# shard then gather: the identity
for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"):
    cfg = configs_cfg = T.serve_cfg(arch)
    p = tfm.init_params(cfg, seed=5)
    specs = param_shardings(p, mesh, cfg)
    back = shard.gather_params(shard.shard_params(p, specs, mesh), specs,
                               mesh)
    res[f"gather_ok/{arch}"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(back))))

# the optimizers alone: two steps on this rank's shards of the
# gradients; parameters and state gathered by JAX's specs of the state
from repro_torch.sharding import state_shardings
from repro_torch.train.optimizer import make_optimizer
opt_in = dict(np.load(opt_in))
whole = T.unflat(T.pick(opt_in, "p/"), torch.from_numpy)
ospecs = param_shardings(whole, mesh)
for oname in ("adafactor", "adamw"):
    opt = make_optimizer(oname, lr=T.OPT_LR, wd=T.OPT_WD, mesh=mesh,
                         specs=ospecs)
    p = shard.shard_params(whole, ospecs, mesh)
    st = opt.init(p)
    for s in range(2):
        g = T.unflat(T.pick(opt_in, f"g{s}/"), torch.from_numpy)
        p, st = opt.update(shard.shard_params(g, ospecs, mesh), st, p, s)
    sspecs = state_shardings(make_optimizer(oname).init(whole), mesh)
    for k, v in T.flat(shard.gather_params(p, ospecs, mesh)).items():
        res[f"opt/{oname}/p/{k}"] = v.numpy()
    for k, v in T.flat(shard.gather_params(st, sspecs, mesh)).items():
        res[f"opt/{oname}/s/{k}"] = v.numpy()

# the EP layer
lcfg = T.layer_cfg()
lp = {k: torch.from_numpy(v) for k, v in pick("layer/").items()}
lspec = param_shardings(lp, mesh)
local = shard.shard_params(lp, lspec, mesh)
for case in ("prefill", "quota"):
    x = torch.from_numpy(jref["x/" + case])
    view = mesh.for_batch(x.shape[0])
    y, aux = mlp.moe_forward(local, rows_of(x, view), lcfg, mesh=view,
                             spec=lspec)
    res[f"y/{case}"] = all_rows(y, view).numpy()
    res[f"aux/{case}"] = aux.detach().numpy()

if name == "2x2":
    cfg = T.phi_cfg()
    params = params_from_arrays(pick("phi/"))
    specs = param_shardings(params, mesh, cfg)
    step, opt = make_train_step(cfg, lr=T.LR, mesh=mesh, specs=specs)
    local = shard.shard_params(params, specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 4, 32).items()}
    new, _, m = step(local, opt.init(local), 0, batch)
    whole = shard.gather_params(new, specs, mesh)
    for i, t in enumerate(tree_leaves(params_to_jax(whole, cfg))):
        res[f"phi_new/{i}"] = t
    for k in ("loss", "grad_norm", "xent"):
        res["phi_m/" + k] = m[k].numpy()

if name == "1x4":
    cfg = T.qwen_cfg()
    params = tfm.init_params(cfg, seed=7)
    specs = param_shardings(params, mesh, cfg)
    step, opt = make_train_step(cfg, lr=T.LR, mesh=mesh, specs=specs)
    local = shard.shard_params(params, specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 4, 32, seed=1).items()}
    new, _, m = step(local, opt.init(local), 0, batch)
    whole = shard.gather_params(new, specs, mesh)
    for i, t in enumerate(tree_leaves(whole)):
        res[f"qwen_new/{i}"] = t.numpy()
    for k in ("loss", "grad_norm"):
        res["qwen_m/" + k] = m[k].numpy()
    # the sequence-parallel island
    cfg = T.seqpar_cfg()
    q, k, v, pos, w = T.attn_inputs()
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    view = mesh.for_batch(q.shape[0])
    got = tattn._attend(q, k, v, pos, pos, cfg, q_chunk=8, mesh=view)
    grads = torch.autograd.grad((got * w).sum() / mesh.size, (q, k, v))
    res["attn/out"] = got.detach().numpy()
    for n, g in zip("qkv", grads):
        res["attn/d" + n] = shard.all_reduce_(g, mesh, mesh.axis_names).numpy()
    params = tfm.init_params(cfg, seed=9)
    specs = param_shardings(params, mesh, cfg)
    local = shard.shard_params(params, specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 32, seed=3).items()}
    view = mesh.for_batch(2)
    loss, m = tfm.forward_train(local, {k: rows_of(v, view)
                                        for k, v in batch.items()}, cfg,
                                mesh=view, specs=specs)
    res["seqpar/xent"] = m["xent"].numpy()

# sharded serving
arch = T.SERVE[name]
cfg = T.serve_cfg(arch)
params = tfm.init_params(cfg, seed=11)
specs = param_shardings(params, mesh, cfg)
local = shard.shard_params(params, specs, mesh)
pre = make_prefill_step(cfg, 48, mesh=mesh, specs=specs)
dec = make_decode_step(cfg, mesh=mesh, specs=specs)
tokens = torch.from_numpy(synthetic_batch(cfg, 4, 32, seed=4)["tokens"])
with torch.no_grad():
    logits, caches = pre(local, {"tokens": tokens})
    res["serve/0"] = logits.numpy()
    tok = logits.argmax(-1)
    for i in range(3):
        logits, caches = dec(local, tok, caches)
        res[f"serve/{i + 1}"] = logits.numpy()
        tok = logits.argmax(-1)
if mesh.rank == 0:
    np.savez(out, **res)
print("RANK_OK", mesh.rank)
"""


def attn_inputs():
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = ATTN["B"], ATTN["S"], ATTN["H"], ATTN["hd"]
    q, k, v = (torch.randn((B, S, H, hd), generator=g) for _ in range(3))
    pos = torch.arange(S).expand(B, S)
    w = torch.randn((B, S, H, hd), generator=g)
    return q, k, v, pos, w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference, then one 4-rank spawn per mesh."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref, opt_in = str(tmp / "jax.npz"), str(tmp / "opt_in.npz")
    np.savez(opt_in, **opt_inputs())
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_REF, ref, str(LR), opt_in],
                       env=env, timeout=600, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    out = {"jax": dict(np.load(ref)), "opt_in": dict(np.load(opt_in))}
    for name in ("2x2", "1x4"):
        path = str(tmp / f"{name}.npz")
        _run_ranks(["-c", RANKS, name, ref, path, opt_in], 4)
        out[name] = dict(np.load(path))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer_params(jax_res):
    return {k[len("layer/"):]: torch.from_numpy(v)
            for k, v in jax_res.items() if k.startswith("layer/")}


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("case", ["prefill", "quota"])
def test_ep_moe_matches_jax_and_the_plain_plan(runs, mesh, case):
    jres, got = runs["jax"], runs[mesh]
    cfg = layer_cfg()
    x = torch.from_numpy(jres["x/" + case])
    plain, plain_aux = mlp.moe_ep_plain(_layer_params(jres), x, cfg,
                                        Duck(tuple(map(int, mesh.split("x")))))
    np.testing.assert_allclose(got[f"y/{case}"], jres[f"y/{mesh}/{case}"],
                               **EP_TOL)
    np.testing.assert_allclose(got[f"aux/{case}"], jres[f"aux/{mesh}/{case}"],
                               **EP_TOL)
    np.testing.assert_allclose(plain.numpy(), jres[f"y/{mesh}/{case}"],
                               **EP_TOL)
    np.testing.assert_allclose(float(plain_aux), got[f"aux/{case}"],
                               **EP_TOL)
    # the capacity factor drops rows: the plain plan differs from the
    # dense oracle
    y_ref, _ = mlp.moe_ref(_layer_params(jres), x, cfg)
    assert float((y_ref - plain).abs().max()) > 1e-3


def test_sharded_adafactor_step_matches_jax(runs):
    jres, got = runs["jax"], runs["2x2"]
    for k, rtol in (("loss", 1e-4), ("xent", 1e-4), ("grad_norm", 1e-3)):
        np.testing.assert_allclose(got["phi_m/" + k], jres["phi_m/" + k],
                                   rtol=rtol)
    want = [v for k, v in sorted(
        ((k, v) for k, v in jres.items() if k.startswith("phi_new/")),
        key=lambda kv: _order(jres, "phi_new/").index(kv[0]))]
    new = [got[f"phi_new/{i}"] for i in range(len(want))]
    for a, b in zip(new, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2 * LR


def _order(res, prefix):
    """JAX's leaf order of the flattened tree (the npz keeps it)."""
    return [k for k in res if k.startswith(prefix)]


def test_sharded_adafactor_step_matches_the_one_rank_plan(runs):
    """The port's one-rank step running the same (2, 2) plan in one
    process (``moe_dispatch`` a duck mesh: ``moe_ep_plain``)."""
    jres, got = runs["jax"], runs["2x2"]
    cfg = phi_cfg()
    params = params_from_arrays({k[len("phi/"):]: v for k, v in jres.items()
                                 if k.startswith("phi/")})
    step, opt = make_train_step(cfg, lr=LR, moe_dispatch=Duck((2, 2)))
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 4, 32).items()}
    new, _, m = step(params, opt.init(params), 0, batch)
    np.testing.assert_allclose(got["phi_m/loss"], float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["phi_m/grad_norm"], float(m["grad_norm"]),
                               rtol=1e-4)
    for i, t in enumerate(tree_leaves(params_to_jax(new, cfg))):
        assert np.abs(got[f"phi_new/{i}"] - t).max() <= 2 * LR


def test_sharded_adamw_step_matches_one_rank(runs):
    got = runs["1x4"]
    cfg = qwen_cfg()
    params = tfm.init_params(cfg, seed=7)
    step, opt = make_train_step(cfg, lr=LR)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 4, 32, seed=1).items()}
    new, _, m = step(params, opt.init(params), 0, batch)
    np.testing.assert_allclose(got["qwen_m/loss"], float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["qwen_m/grad_norm"],
                               float(m["grad_norm"]), rtol=1e-4)
    for i, t in enumerate(tree_leaves(new)):
        assert np.abs(got[f"qwen_new/{i}"] - t.numpy()).max() <= 2 * LR


def _one_rank_opt(opt_in, oname):
    """The one-rank optimizer's two steps on the whole tree: flat
    parameters and state."""
    from repro_torch.train.optimizer import make_optimizer

    opt = make_optimizer(oname, lr=OPT_LR, wd=OPT_WD)
    p = unflat(pick(opt_in, "p/"), torch.from_numpy)
    st = opt.init(p)
    for s in range(2):
        p, st = opt.update(unflat(pick(opt_in, f"g{s}/"), torch.from_numpy),
                           st, p, s)
    return ({k: v.numpy() for k, v in flat(p).items()},
            {k: v.numpy() for k, v in flat(st).items()})


@pytest.mark.parametrize("against", ["one_rank", "jax"])
@pytest.mark.parametrize("oname", ["adafactor", "adamw"])
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_optimizer_matches(runs, mesh, oname, against):
    """Two sharded steps of each optimizer on the same gradients: the
    gathered parameters within 1e-5 lr and the gathered state within
    ``rtol`` 1e-5 (and 1e-6 of its largest value) of the one-rank optimizer's and of JAX's sharded ones;
    the factored moments are sharded (in their own layouts)."""
    from repro_torch.sharding import state_shardings
    from repro_torch.sharding.specs import P
    from repro_torch.train.optimizer import make_optimizer

    got_p = pick(runs[mesh], f"opt/{oname}/p/")
    got_s = pick(runs[mesh], f"opt/{oname}/s/")
    if against == "jax":
        want_p = pick(runs["jax"], f"opt/{mesh}/{oname}/p/")
        want_s = pick(runs["jax"], f"opt/{mesh}/{oname}/s/")
    else:
        want_p, want_s = _one_rank_opt(runs["opt_in"], oname)
    assert set(got_p) == set(want_p) and set(got_s) == set(want_s)
    p0 = pick(runs["opt_in"], "p/")
    for k, v in want_p.items():
        assert got_p[k].shape == v.shape, k
        assert np.abs(got_p[k] - v).max() <= 1e-5 * OPT_LR, k
        # the update is the optimizer's, not a rounding: lr-sized
        assert np.abs(v - p0[k]).max() > 0.5 * OPT_LR, k
    for k, v in want_s.items():
        # rtol, and a few roundings of the leaf's largest value where a
        # moment's terms cancel
        np.testing.assert_allclose(got_s[k], v, rtol=1e-5,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)
    whole = unflat(p0, torch.from_numpy)
    sspecs = flat(state_shardings(make_optimizer(oname).init(whole),
                                  Duck(tuple(map(int, mesh.split("x"))))))
    assert sum(s != P() for s in sspecs.values()) >= (
        3 if oname == "adafactor" else 6)


def test_sequence_parallel_island_matches_attend(runs):
    got = runs["1x4"]
    cfg = seqpar_cfg()
    assert tattn._use_seq_parallel(cfg, ATTN["H"], ATTN["S"], Duck((1, 4)))
    q, k, v, pos, w = attn_inputs()
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    want = tattn._attend(q, k, v, pos, pos, cfg)
    grads = torch.autograd.grad((want * w).sum(), (q, k, v))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["attn/out"], want.detach().numpy(), **tol)
    for n, g in zip("qkv", grads):
        np.testing.assert_allclose(got["attn/d" + n], g.numpy(), **tol)
    params = tfm.init_params(cfg, seed=9)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 32, seed=3).items()}
    with torch.no_grad():
        _, m = tfm.forward_train(params, batch, cfg)
    np.testing.assert_allclose(got["seqpar/xent"], float(m["xent"]),
                               rtol=1e-5)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_serving_matches_one_rank(runs, mesh):
    got = runs[mesh]
    cfg = serve_cfg(SERVE[mesh])
    params = tfm.init_params(cfg, seed=11)
    tokens = torch.from_numpy(synthetic_batch(cfg, 4, 32, seed=4)["tokens"])
    with torch.no_grad():
        logits, caches = tfm.prefill(params, {"tokens": tokens}, cfg, 48)
        np.testing.assert_allclose(got["serve/0"], logits.numpy(),
                                   **SERVE_TOL)
        tok = logits.argmax(-1)
        for i in range(3):
            logits, caches = tfm.decode_step(params, tok, caches, cfg)
            np.testing.assert_allclose(got[f"serve/{i + 1}"], logits.numpy(),
                                       **SERVE_TOL)
            tok = logits.argmax(-1)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_shard_then_gather_is_the_tree(runs, mesh):
    for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"):
        assert bool(runs[mesh][f"gather_ok/{arch}"]), arch


def test_lm_launcher_under_torchrun(tmp_path):
    """Two ranks through the launcher's ``torchrun`` environment: rank 0
    prints JAX's lines, and ``--save`` writes the gathered tree, which
    reads back into the port's layout."""
    outs = _run_ranks(["-m", "repro_torch.launch.train", "--arch",
                       "phi3.5-moe-42b-a6.6b", "--reduced", "--steps", "2",
                       "--batch", "4", "--seq", "32", "--device", "cpu",
                       "--save", "--out-dir", str(tmp_path)], 2)
    assert "step     1 loss" in outs[0] and "step" not in outs[1]
    arrays, step = load_arrays(str(tmp_path / "lm_final.npz"))
    cfg = configs.get_config("phi3.5-moe-42b-a6.6b").reduced(
        layers=4, d_model=256, experts=4)
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 8192))
    want = _flatten(params_to_jax(tfm.init_params(cfg, seed=0), cfg))
    assert step == 2
    assert {k: tuple(v.shape) for k, v in arrays.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    back = params_from_arrays(arrays)
    assert all(torch.isfinite(t).all() for t in tree_leaves(back))
