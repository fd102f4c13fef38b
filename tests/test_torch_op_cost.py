"""The op counter (``launch/op_cost.py``) against the JAX package's HLO cost
model (``launch/hlo_cost.py``) on the same steps: JAX's ``build_lm_step``
lowered and compiled on host devices, the port's ``build_lm_step`` traced
as rank 0 of a fake world, on a reduced dense config (granite-3-2b) and a
reduced MoE config (phi3.5-moe), train and prefill, on one device and on a
(2, 2) mesh (auto axes; JAX on four forced host devices in a subprocess).

Train steps count the same operations, exactly. The prefill differs by
exactly the attention the flash kernel (#11) does not do: JAX's prefill
scores every query of a chunk against the whole cache (masked), the
kernel only the valid (causal) pairs, 2 (hd + hd_v) flop each; with those
added back the counts are equal. The raw prefill gap is printed (2.6 % at
the shapes here).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.flash_attention import valid_pairs
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.steps import build_lm_step
from repro_torch.sharding.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 64
CASES = {f"{name}_{kind}_{n}": [arch, kind, B, S, mesh]
         for name, arch in (("dense", "granite-3-2b"),
                            ("moe", "phi3.5-moe-42b-a6.6b"))
         for kind in ("train", "prefill")
         for n, mesh in ((1, [1, 1]), (4, [2, 2]))}

JAX_SIDE = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro import configs
from repro.configs.shapes import InputShape
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.steps import build_lm_step
out = {}
for key, (arch, kind, B, S, mesh_shape) in json.loads(sys.argv[1]).items():
    cfg = configs.get_config(arch).reduced()
    n = mesh_shape[0] * mesh_shape[1]
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:n])
    built = build_lm_step(cfg, InputShape(kind, S, B, kind), mesh)
    with mesh:
        comp = jax.jit(built.fn, in_shardings=built.in_shardings).lower(
            *built.args).compile()
    out[key] = analyze_hlo(comp.as_text())["flops"]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_flops():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(CASES)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skipped_pairs_flops(cfg, mesh) -> float:
    """The attention flops per device JAX's masked prefill does and the
    flash kernel does not: every (query, key) pair of the S x S scores
    but the valid ones, 2 (hd + hd_v) flop each, on a device's batch rows
    and heads."""
    hd = cfg.resolved_head_dim
    rows = B // mesh[0]
    heads = cfg.num_heads // mesh[1]
    masked = S * S - valid_pairs(S, S, True, 0)
    return 2.0 * 2 * hd * rows * heads * masked * cfg.num_layers


@pytest.mark.parametrize("key", list(CASES))
def test_op_cost_flops_match_hlo_cost(jax_flops, key):
    arch, kind, b, s, mesh = CASES[key]
    cfg = configs.get_config(arch).reduced()
    _, counts = trace_step(
        lambda m: build_lm_step(cfg, InputShape(kind, s, b, kind), m),
        mesh[0] * mesh[1], lambda: Mesh(tuple(mesh), ("data", "model")))
    got, want = counts["flops"], jax_flops[key]
    gap = got / want - 1
    print(f"{key}: op_cost {got:.6g}, hlo_cost {want:.6g}, gap "
          f"{100 * gap:+.2f} %")
    if kind == "train":
        assert got == want
    else:
        assert got + _skipped_pairs_flops(cfg, mesh) == want
        assert counts["kernels"]["flash_attention"]["calls"] == \
            cfg.num_layers
