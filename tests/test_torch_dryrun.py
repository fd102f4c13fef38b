"""The dry-run (``launch/steps.py``, ``launch/dryrun.py``) against the JAX
package's specs, and its kernels' shape-only paths.

* Argument bytes: rank 0's bytes of every argument ``build_step`` makes at
  16 x 16 and 2 x 16 x 16, for every LM arch x shape, equal the bytes
  JAX's own ``param_shardings`` / ``batch_spec`` / ``cache_shardings``
  give each leaf of JAX's abstract arguments (``NamedSharding`` swapped
  for the bare spec, as ``tests/test_torch_sharding.py`` does). JAX's
  train step takes an int32 ``step`` and its caches an int32 ``t`` per
  layer on the device; the port's are Python ints, so those leaves are
  left out of JAX's count.
* Records: ``dryrun_one`` completes at 16 x 16 for ``qwen1.5-0.5b x
  decode_32k`` and ``tencent-embedding x train_4k``.
* Kernels: on storage-less tensors, #11's and #7's wrappers give the
  kernels' output shapes and strides, report the kernels' work, and never
  call the plain version or the CUDA library.

Every fake world (``sharding/mesh.py::fake_world``) is destroyed when its
block ends, so no default group outlives a test.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jcfgs
from repro.configs import shapes as jshapes
from repro.models import transformer as jtfm
from repro.sharding import specs as jspecs
from repro.train import serve_step as jserve
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch import configs as cfgs
from repro_torch.configs import shapes
from repro_torch.kernels import build, flash_attention as fa, ops, sgns
from repro_torch.launch import dryrun, op_cost, steps
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.mesh import Mesh, fake_world

KEY = jax.random.PRNGKey(0)
LM_ARCHS = [a for a, c in cfgs.ARCHS.items() if isinstance(c, ModelConfig)]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _bare_specs(monkeypatch):
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jserve, "NamedSharding", lambda mesh, spec: spec)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class DuckMesh:
    def __init__(self, dims, axes):
        self.shape = dict(zip(axes, dims))
        self.axis_names = tuple(axes)


def _spec_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, (tuple, jax.sharding.PartitionSpec)))


def _local_bytes(struct, specs, mesh, skip=()) -> int:
    """The bytes of every leaf's block under its spec; leaves named in
    ``skip`` left out."""
    total = 0
    leaves = jax.tree_util.tree_flatten_with_path(struct)[0]
    for (path, leaf), spec in zip(leaves, _spec_leaves(specs)):
        name = str(getattr(path[-1], "key", "")) if path else ""
        if name in skip:
            continue
        n = 1
        for d, size in enumerate(leaf.shape):
            entry = tuple(spec)[d] if d < len(tuple(spec)) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n *= size // int(np.prod([mesh.shape[a] for a in axes]))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


_JAX_PARAMS: dict = {}


def _jax_params(arch, jcfg):
    if arch not in _JAX_PARAMS:      # bf16 for every shape
        _JAX_PARAMS[arch] = jax.eval_shape(
            lambda: jtfm.init_params(KEY, jcfg))
    return _JAX_PARAMS[arch]


def _jax_arg_bytes(arch, shape_name, mesh) -> dict:
    shape = jshapes.SHAPES[shape_name]
    jcfg = jcfgs.for_shape(jcfgs.get_config(arch), shape)
    jcfg = dataclasses.replace(jcfg, tp_size=mesh.shape["model"])
    params = _jax_params(arch, jcfg)
    out = {"params": _local_bytes(
        params, jspecs.param_shardings(params, mesh), mesh)}
    bs = tuple(jspecs.batch_spec(shape.global_batch, mesh))
    batch = jcfgs.input_specs(jcfg, shape)
    out["batch"] = sum(_local_bytes(
        v, jax.sharding.PartitionSpec(*bs, *(None,) * (v.ndim - 1)), mesh)
        for v in batch.values())
    if shape.kind == "train":
        state = jax.eval_shape(jax_make_optimizer(jcfg.optimizer).init,
                               params)
        out["opt_state"] = _local_bytes(
            state, jspecs.param_shardings(state, mesh), mesh)
    if shape.kind == "decode":
        clen = jserve.cache_len_for(jcfg, shape.seq_len)
        caches = jserve.cache_specs(jcfg, shape.global_batch, clen, params)
        out["caches"] = _local_bytes(
            caches, jserve.cache_shardings(caches, shape.global_batch, mesh),
            mesh, skip=("t",))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_argument_bytes_match_jax_specs(arch):
    for mname, (dims, axes) in MESHES.items():
        want = {s: _jax_arg_bytes(arch, s, DuckMesh(dims, axes))
                for s in shapes.SHAPES}
        with fake_world(int(np.prod(dims))):
            mesh = Mesh(dims, axes)
            for s in shapes.SHAPES:
                got = steps.build_step(arch, s, mesh).arg_bytes
                assert got == want[s], (mname, s)
        assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "decode_32k"),
                                        ("tencent-embedding", "train_4k")])
def test_dryrun_one_production_records(arch, shape):
    rec = dryrun.dryrun_one(arch, shape, verbose=False)
    assert not dist.is_initialized()
    assert rec["mesh"] == [16, 16] and rec["chips"] == 256
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(mem["argument_parts"].values()) > 0
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["replicated_batch_bytes"])
    assert mem["temp_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["cost"]["bytes_per_device"] > 0
    coll = rec["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    t = rec["roofline"]
    assert t["dominant"] in ("compute", "memory", "collective")
    assert sum(t["link_bytes"].values()) == coll["total"]
    assert rec["model_flops"] > 0 and rec["useful_flops_ratio"] > 0
    if arch == "tencent-embedding":
        # every minibatch of the episode through #7's shape path: 256
        # rounds x 4 sub-parts x 32 minibatches; the vertex shard moves
        # around both rings (a model-ring neighbour shares the node, a
        # data-ring one does not)
        assert rec["cost"]["kernels"]["sgns_fused_update"]["calls"] == \
            256 * 4 * 32
        assert coll["collective-permute"] > 0 and t["links"] == "nvlink+ib"
        parts = mem["argument_parts"]
        rows = -(-1_050_000_000 // 256 // 4) * 4
        assert parts["tables"] == 2 * rows * 128 * 4
        assert mem["replicated_batch_bytes"] == 0
        # temp: the spare vertex shard the ring receives into, the
        # episode's negative ids, then one minibatch's fused-update scratch
        # at a time (344,192 + 10,348 B) and the block sums (16,388 B):
        # 358,640 B, where holding every minibatch's scratch took 11.28 GB
        spare, neg_ids = rows * 128 * 4, 256 * 4 * 32 * 5 * 4
        assert 0 < mem["temp_bytes"] - spare - neg_ids < 400_000
    else:
        assert mem["argument_parts"]["caches"] > 0
        # the step takes the whole (B, 1) int32 token batch; the rank's
        # shard is its rows over "data"
        B = shapes.SHAPES[shape].global_batch
        assert mem["replicated_batch_bytes"] == 4 * B - \
            mem["argument_parts"]["batch"] > 0
        assert t["links"] == "ib"         # a "model" group spans 2 nodes
        assert rec["cost"]["kernels"] == {}


def test_episode_temp_does_not_grow_with_its_minibatches():
    """An embedding episode's temp on a 2 x 2 mesh at 4 and 16 minibatches a
    block: it grows by the extra minibatches' negative ids (S int32 each)
    and nothing else, since no minibatch's scratch outlives its launch."""
    temps = {}
    for cap in (256, 1024):
        cfg = dataclasses.replace(cfgs.get_config("tencent-embedding"),
                                  num_nodes=200_000, neg_pool=4096,
                                  block_cap=cap)
        _, counts = dryrun.trace_step(
            lambda m: steps.build_embedding_step(cfg, shapes.SHAPES[
                "train_4k"], m), 4, lambda: Mesh((2, 2), ("data", "model")))
        assert not dist.is_initialized()
        calls = counts["kernels"]["sgns_fused_update"]["calls"]
        assert calls == 4 * cfg.subparts * cap // cfg.minibatch
        temps[cap] = counts["temp_bytes"], calls
    (t4, n4), (t16, n16) = temps[256], temps[1024]
    assert t16 - t4 == (n16 - n4) * cfg.negatives * 4


class _Spy:
    def __init__(self):
        self.calls = []

    def __call__(self, name, flops, nbytes):
        self.calls.append((name, flops, nbytes))


@pytest.mark.parametrize("hd,hd_v,window", [(64, 64, 0), (128, 128, 512),
                                            (192, 128, 0)])
def test_flash_attention_shape_path(monkeypatch, hd, hd_v, window):
    """A meta q, k, v give the kernel's (B, Sq, H, hd_v) buffer seen as
    (B, H, Sq, hd_v), report 2 (hd + hd_v) flop per valid pair, and touch
    neither the plain version nor the library."""
    def refuse(*a, **k):
        raise AssertionError("reached")

    monkeypatch.setattr(fa, "mha_plain", refuse)
    monkeypatch.setattr(build, "library", refuse)
    spy = _Spy()
    monkeypatch.setattr(build, "TRACE_SINK", spy)
    B, H, Hkv, S = 2, 8, 2, 300
    q = torch.empty((B, S, H, hd), device="meta").transpose(1, 2)
    k = torch.empty((B, S, Hkv, hd), device="meta").transpose(1, 2)
    v = torch.empty((B, S, Hkv, hd_v), device="meta").transpose(1, 2)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    assert out.device.type == "meta"
    assert out.shape == (B, H, S, hd_v)
    assert out.stride() == (S * H * hd_v, hd_v, H * hd_v, 1)
    pairs = sum(min(i + 1, window or S) for i in range(S))
    assert fa.valid_pairs(S, S, True, window) == pairs
    nbytes = 4 * (B * S * H * hd + B * S * Hkv * (hd + hd_v)
                  + B * S * H * hd_v)
    assert spy.calls == [("flash_attention",
                          2.0 * (hd + hd_v) * B * H * pairs, nbytes)]
    # a row stride the card's 16-byte copies cannot take is refused on
    # meta too, as the card's wrapper refuses it
    wide = torch.empty((B, H, S, hd + 1), device="meta")[..., :hd]
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        fa.flash_attention(wide, k, v, causal=True, window=window)
    assert len(spy.calls) == 1
    # a CPU tensor still takes the plain version
    with pytest.raises(AssertionError, match="reached"):
        fa.flash_attention(torch.zeros(1, 1, 4, hd), torch.zeros(1, 1, 4, hd),
                           torch.zeros(1, 1, 4, hd_v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgns_fused_update_shape_path(monkeypatch, dtype):
    """Meta tables through ``ops.sgns_step``'s default route: the tables
    back, a scalar loss, #7's work reported, no plain version and no
    library."""
    def refuse(*a, **k):
        raise AssertionError("reached")

    monkeypatch.setattr(sgns, "sgns_fused_update_plain", refuse)
    monkeypatch.setattr(build, "library", refuse)
    spy = _Spy()
    monkeypatch.setattr(build, "TRACE_SINK", spy)
    N, d, B, S = 1000, 128, 256, 5
    vert = torch.empty((N, d), dtype=dtype, device="meta")
    ctx = torch.empty((N, d), dtype=dtype, device="meta")
    iv, ic = (torch.empty(B, dtype=torch.int32, device="meta")
              for _ in range(2))
    inn = torch.empty(S, dtype=torch.int32, device="meta")
    mask = torch.empty(B, dtype=dtype, device="meta")
    v2, c2, loss = ops.sgns_step(vert, ctx, iv, ic, inn, mask, 0.025)
    assert v2 is vert and c2 is ctx
    assert loss.shape == () and loss.dtype == torch.float32
    assert loss.device.type == "meta"
    item = torch.empty((), dtype=dtype).element_size()
    assert spy.calls == [("sgns_fused_update",
                          6.0 * B * S * d + 4.0 * B * d,
                          2.0 * (2 * B + S) * d * item + (3 * B + S) * 4)]


def test_op_cost_counts_matmuls_and_kernel_reports():
    """2 M N K a product, forward and backward; a kernel's report joins
    the operations and bytes."""
    a = torch.empty((64, 32), device="meta", requires_grad=True)
    b = torch.empty((32, 16), device="meta")

    def step(a, b):
        (a @ b).sum().backward()
        build.traced("k", 1000.0, 24.0)
        return a.grad

    r = op_cost.analyze(step, (a, b))
    assert r["flops"] == 2 * 64 * 32 * 16 * 2 + 1000.0     # fwd, dA, kernel
    assert r["kernels"] == {"k": {"calls": 1, "flops": 1000.0,
                                  "bytes": 24.0}}
    assert r["output_bytes"] == 64 * 32 * 4
    # the product is freed once summed (its backward keeps a and b, not
    # it); a's gradient and two scalars are what is live at the end
    assert r["temp_bytes"] == 64 * 32 * 4 + 2 * 4
