"""The port stands alone: xrseg_tpu_torch and chip_smoke.py import neither
JAX nor anything of the xrseg_tpu package, and importing them touches no
device. Checked twice: by importing every module in a fresh interpreter
and reading sys.modules, and by scanning every import statement in the
sources (which also catches imports inside functions)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "xrseg_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "xrseg_tpu")


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_module_names()) + ["chip_smoke"]
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'xrseg_tpu'))\n"
        "print('BAD', bad)\n"
        "print('CUDA_INIT', torch.cuda.is_initialized())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "CUDA_INIT False" in out.stdout, out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_reaches_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    """No card here: it exits non-zero and prints no result. Alone in a
    directory without the package: it fails to start at all."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card; chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "xrseg_tpu_torch" in out.stderr
