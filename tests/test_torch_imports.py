"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

Every ``repro_torch`` module imports in a process where ``jax`` cannot be
imported, an AST scan finds no ``jax`` or ``repro.`` import in the package
or in ``chip_smoke.py``, and ``chip_smoke.py`` refuses to run (exit != 0,
no result line) without a CUDA device or outside a checkout.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _sources():
    return sorted(PKG.rglob("*.py")) + [SMOKE]


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import importlib; "
            f"[importlib.import_module(m) for m in {_modules()!r}]; "
            "import chip_smoke; print('ok')")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
