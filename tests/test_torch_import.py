"""The PyTorch port imports without JAX, ml_dtypes or the JAX package, and
its entry points refuse to run on a CUDA device that is not there."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BANNED = {banned!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    """Every module of the package imports in a fresh interpreter whose
    import system refuses jax, ml_dtypes and the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(banned=BANNED)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15     # every module was imported


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import_in_source(path):
    """No file of the port, and not the chip smoke script, names jax,
    ml_dtypes or the JAX package in an import statement."""
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path} imports {bad}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py prints no result and exits non-zero where CUDA is
    missing, also when it is alone in a directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=120, cwd=script.parent,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


DRY_RUN = ("launch/dryrun.py", "launch/steps.py", "launch/op_cost.py",
           "launch/roofline.py", "launch/report.py", "configs/shapes.py",
           "collectives.py")


@pytest.mark.parametrize("rel", DRY_RUN)
def test_dry_run_modules_exist_and_import_nothing_banned(rel):
    """The dry-run's modules are in the package (so the blocked-import
    run above imports each) and name no banned import."""
    path = PKG / rel
    assert path.exists()
    assert not set(_imported_roots(path)) & set(BANNED)


def test_only_the_dry_run_starts_a_fake_world():
    """``fake_world`` is defined in ``sharding/mesh.py`` and used by the
    dry-run alone: no launcher's entry point can start a fake group."""
    users = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                   if "fake_world" in p.read_text())
    assert users == ["launch/dryrun.py", "launch/steps.py",
                     "sharding/mesh.py"]
    for launcher in ("launch/train.py", "launch/serve.py",
                     "launch/embed_serve.py"):
        assert "dryrun" not in (PKG / launcher).read_text()


_AFTER_DRY_RUN = r"""
import torch, torch.distributed as dist
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
rec = dryrun.dryrun_one("qwen1.5-0.5b", "long_500k", verbose=False)
assert not dist.is_initialized()
torch.cuda.is_available = lambda: False
try:
    resolve_device("cuda")
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
    print("RAISED", rec["chips"])
"""


def test_dry_run_leaves_no_group_and_the_card_check():
    """After a dry-run the process has no default group, and asking for
    CUDA without it still raises."""
    out = subprocess.run([sys.executable, "-c", _AFTER_DRY_RUN],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RAISED 256" in out.stdout
