"""The port's sharding rule engine against the JAX package's, with no
processes: ``spec_for``, ``param_shardings``, ``batch_spec``,
``batch_shardings``, ``cache_shardings`` and the optimizer-state specs,
for every LM config of the registry on the production duck meshes (16 x
16, 2 x 16 x 16) and on (1, 2), (2, 2) and (1, 4); the rules of
``tests/test_sharding.py`` as parametrised cases on the port; and
``shard_params`` followed by the reassembly of every rank's blocks as the
identity, each rank's block where JAX's ``NamedSharding`` numbers it
(row-major over a dim's axes).

JAX's ``param_shardings``/``cache_shardings`` wrap each spec in a
``NamedSharding``, which needs a real mesh: the tests swap it for the bare
spec, so the duck meshes serve both packages.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jtfm
from repro.sharding import specs as jspecs
from repro.train import serve_step as jserve
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch import configs
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard, specs
from repro_torch.sharding.mesh import _Group

KEY = jax.random.PRNGKey(0)


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "1x2": FakeMesh({"data": 1, "model": 2}),
    "2x2": FakeMesh({"data": 2, "model": 2}),
    "1x4": FakeMesh({"data": 1, "model": 4}),
}
LM_ARCHS = [a for a, c in configs.ARCHS.items() if isinstance(c, ModelConfig)]


@pytest.fixture(autouse=True)
def _bare_specs(monkeypatch):
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jserve, "NamedSharding", lambda mesh, spec: spec)


def _norm(spec):
    """A spec as a tuple of axis tuples, trailing unsharded dims dropped
    (JAX's ``PartitionSpec`` may keep or fold 1-tuples)."""
    out = [specs.axes_of(e) for e in tuple(spec)]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, (tuple, jax.sharding.PartitionSpec)))


_STRUCTS: dict = {}


def _struct(arch):
    """JAX's abstract parameter tree of the full-size config."""
    if arch not in _STRUCTS:
        cfg = jax_configs.get_config(arch)
        _STRUCTS[arch] = jax.eval_shape(lambda: jtfm.init_params(KEY, cfg))
    return _STRUCTS[arch]


class Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _to_shapes(tree):
    return jax.tree.map(lambda s: Shape(s.shape), tree)


def _port_layout(struct):
    """The port's tree of shapes (one dict per layer, group-major) from the
    JAX tree of shapes."""
    out = {k: v for k, v in struct.items() if k not in ("segments",
                                                         "enc_segments")}
    for jkey, key in (("segments", "layers"), ("enc_segments", "enc_layers")):
        if jkey not in struct:
            continue
        layers = []
        for seg in struct[jkey]:
            groups = jax.tree.leaves(seg["slots"][0])[0].shape[0]
            for _ in range(groups):
                for slot in seg["slots"]:
                    layers.append(jax.tree.map(lambda s: Shape(s.shape[1:]),
                                               slot, is_leaf=lambda x:
                                               isinstance(x, Shape)))
        out[key] = layers
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shardings_match_jax_on_every_mesh(arch):
    struct = _to_shapes(_struct(arch))
    cfg = configs.get_config(arch)
    port_tree = _port_layout(struct)
    for name, mesh in MESHES.items():
        want = jspecs.param_shardings(struct, mesh)
        got = specs.param_shardings(struct, mesh)
        assert [_norm(s) for s in _leaves(got)] == \
            [_norm(s) for s in _leaves(want)], name
        # the port's per-layer tree: the stacked leaf's spec less its
        # (never sharded) group dim
        per_layer = specs.param_shardings(port_tree, mesh, cfg)
        stacked = {k: v for k, v in want.items()
                   if k not in ("segments", "enc_segments")}
        assert [_norm(s) for s in _leaves(
            {k: per_layer[k] for k in stacked})] == \
            [_norm(s) for s in _leaves(stacked)], name
        for jkey, key in (("segments", "layers"),
                          ("enc_segments", "enc_layers")):
            if jkey not in want:
                continue
            rows = []
            for seg, seg_shapes in zip(want[jkey], struct[jkey]):
                groups = jax.tree.leaves(seg_shapes["slots"][0])[0].shape[0]
                for _ in range(groups):
                    for slot in seg["slots"]:
                        rows.append([_norm(s) for s in _leaves(slot)])
            got_rows = [[_norm(specs.P(None, *s)) for s in _leaves(layer)]
                        for layer in per_layer[key]]
            for w in rows:
                for s in w:
                    assert not s or s[0] == (), "group dim sharded"
            assert got_rows == rows, (name, key)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_shardings_match_jax(arch, optimizer):
    """The optimizer state's specs by its own leaf names: AdamW's m/v
    inherit the parameter's, Adafactor's vr/vc take the default rule."""
    struct = _struct(arch)
    state = jax.eval_shape(jax_make_optimizer(optimizer).init, struct)
    shapes = _to_shapes(state)
    for name, mesh in MESHES.items():
        want = jspecs.param_shardings(shapes, mesh)
        got = specs.state_shardings(shapes, mesh)
        assert [_norm(s) for s in _leaves(got)] == \
            [_norm(s) for s in _leaves(want)], name


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_shardings_match_jax(arch):
    jcfg = jax_configs.get_config(arch)
    for B in (1, 8, 256):
        caches = _to_shapes(jserve.cache_specs(jcfg, B, 64, _struct(arch)))
        for name, mesh in MESHES.items():
            want = jserve.cache_shardings(caches, B, mesh)
            got = specs.cache_shardings(caches, B, mesh)
            assert [_norm(s) for s in _leaves(got)] == \
                [_norm(s) for s in _leaves(want)], (name, B)
            # the port's per-layer caches: the same less the group dim
            layers = [jax.tree.map(lambda s: Shape(s.shape[1:]), slot,
                                   is_leaf=lambda x: isinstance(x, Shape))
                      for seg in caches for slot in seg]
            per_layer = specs.cache_shardings(layers, B, mesh)
            want_rows = [[_norm(s)[1:] if _norm(s) else () for s in
                          _leaves(slot)] for seg in want for slot in seg]
            got_rows = [[_norm(s) for s in _leaves(layer)]
                        for layer in per_layer]
            assert got_rows == want_rows, (name, B)


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 16, 32, 256])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_shardings_match_jax(B, mesh):
    m = MESHES[mesh]
    assert _norm(specs.batch_spec(B, m)) == _norm(jspecs.batch_spec(B, m))
    leaves = {"tokens": Shape((B, 64)), "patch_embeds": Shape((B, 8, 32))}
    want = jspecs.batch_shardings(leaves, B, m)
    got = specs.batch_shardings(leaves, B, m)
    assert {k: _norm(v) for k, v in got.items()} == \
        {k: _norm(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# tests/test_sharding.py's rules, on the port
# ---------------------------------------------------------------------------
SWEEP = list(itertools.product(
    ["embed", "wq", "wk", "wo", "w_gate", "w_down", "in_proj", "router",
     "unknown_leaf"],
    [(151936, 7168), (64, 20, 128), (16, 7168, 128), (3, 8, 65536),
     (20, 128, 151936), (1, 1 << 17)],
    ["16x16", "2x16x16"], [0, 1]))


@pytest.mark.parametrize("name,shape,mesh,offset", SWEEP[::3])
def test_spec_always_divides_and_matches_jax(name, shape, mesh, offset):
    m = MESHES[mesh]
    spec = specs.spec_for(shape, name, m, offset=offset)
    assert _norm(spec) == _norm(jspecs.spec_for(shape, name, m,
                                                offset=offset))
    assert len(spec) <= len(shape)
    for dim, entry in enumerate(spec):
        n = int(np.prod([m.shape[a] for a in specs.axes_of(entry)]))
        assert shape[dim] % n == 0
    if offset:
        assert not spec or spec[0] is None


@pytest.mark.parametrize("shape,want", [
    ((58, 256, 7168, 2048), ((), ("data", "model"))),
    ((32, 16, 4096, 6400), ((), ("model",))),
])
def test_stacked_offset_protects_group_dim(shape, want):
    spec = specs.spec_for(shape, "w_gate", MESHES["16x16"], offset=1)
    assert _norm(spec)[:2] == want


@pytest.mark.parametrize("case", ["vocab", "heads_fallback", "small"])
def test_sharding_rules(case):
    m = MESHES["16x16"]
    if case == "vocab":
        assert specs.spec_for((151936, 2560), "embed", m)[0] == "model"
    elif case == "heads_fallback":   # qwen1.5-4b: 20 heads on 16
        spec = specs.spec_for((24, 2560, 20, 128), "wq", m, offset=1)
        assert len(spec) < 3 or spec[2] != "model"
    else:
        assert all(s is None for s in specs.spec_for((64,), "ln1", m))


@pytest.mark.parametrize("mesh,want", [("1x2", ()), ("2x2", ((), ("data",)))])
def test_granite_vocab_is_not_model_sharded(mesh, want):
    """granite's vocabulary of 49,155 does not divide by 2, and the rule's
    "model" fallback skips ``embed``'s data dim (d): on (1, 2) ``embed`` is
    replicated, on (2, 2) its d is FSDP-sharded over "data", as JAX's rule
    says. The vocab-parallel head and lookup then gather it whole."""
    cfg = configs.get_config("granite-3-2b")
    shape = (cfg.vocab_size, cfg.d_model)
    spec = specs.spec_for(shape, "embed", MESHES[mesh])
    assert _norm(spec) == want == _norm(jspecs.spec_for(shape, "embed",
                                                        MESHES[mesh]))


# ---------------------------------------------------------------------------
# shard_params: every rank's block, reassembled
# ---------------------------------------------------------------------------
class RankMesh(FakeMesh):
    """One rank's view of a duck mesh: the groups' sizes and this rank's
    flat index over their axes (row-major, the mesh's order)."""

    def __init__(self, shape: dict, rank: int):
        super().__init__(shape)
        dims = [shape[a] for a in self.axis_names]
        self.coord = dict(zip(self.axis_names, np.unravel_index(rank, dims)))

    def group(self, axes):
        axes = specs.axes_of(axes)
        index = 0
        for a in axes:
            index = index * self.shape[a] + int(self.coord[a])
        return _Group(None, int(np.prod([self.shape[a] for a in axes])),
                      index)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
def test_shard_params_blocks_reassemble_to_the_tree(mesh):
    cfg = dataclasses.replace(
        configs.get_config("phi3.5-moe-42b-a6.6b").reduced(
            layers=2, d_model=256, experts=4), vocab_size=1024)
    from repro_torch.models import transformer as tfm
    params = tfm.init_params(cfg, seed=0)
    shape = MESHES[mesh].shape
    n = int(np.prod(list(shape.values())))
    spec_tree = specs.param_shardings(params, MESHES[mesh], cfg)
    ranks = [shard.shard_params(params, spec_tree, RankMesh(shape, r))
             for r in range(n)]
    flat_specs = _leaves(spec_tree)
    for i, whole in enumerate(_leaves(params)):
        spec = flat_specs[i]
        ents = [specs.axes_of(e) for e in tuple(spec)] + \
            [()] * (whole.ndim - len(spec))
        rebuilt = torch.zeros_like(whole)
        for r, tree in enumerate(ranks):
            block = _leaves(tree)[i]
            m = RankMesh(shape, r)
            idx = []
            for d, axes in enumerate(ents):
                if not axes:
                    idx.append(slice(None))
                    continue
                g = m.group(axes)
                size = whole.shape[d] // g.size
                idx.append(slice(g.index * size, (g.index + 1) * size))
            assert block.shape == whole[tuple(idx)].shape
            rebuilt[tuple(idx)] = block
            assert torch.equal(block, whole[tuple(idx)])
        assert torch.equal(rebuilt, whole)
