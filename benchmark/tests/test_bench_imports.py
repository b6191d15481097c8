"""Nothing under benchmark/ imports JAX or the JAX package (compared by
whole top-level module name); benchmark/reference/ imports nothing of
the program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "xrseg_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    found = set(top_level_imports(path)) & (FORBIDDEN | {"xrseg_tpu_torch"})
    assert not found, f"{path} imports {found}"


def test_scan_sees_whole_names():
    """`xrseg_tpu_torch` is not `xrseg_tpu`: names compare whole."""
    assert "xrseg_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "xrseg_tpu.ops".split(".")[0] in FORBIDDEN
