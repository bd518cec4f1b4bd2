"""No module under benchmark/ imports JAX or the JAX package (slam2d_tpu),
compared by whole top-level name; the plain references import nothing of
the program either."""

import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "slam2d_tpu"}
MODULES = sorted(p for p in SRC.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(SRC)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((SRC / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    names = top_level_imports(path)
    assert "slam2d_tpu_torch" not in names
    assert names <= {"__future__", "math", "numpy", "torch", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "benchmark"):
            assert node.module == "benchmark.reference" or \
                node.module.startswith("benchmark.reference."), node.module


def test_whole_name_compare(monkeypatch):
    """slam2d_tpu_torch begins with slam2d_tpu: only whole top-level names
    count in the run's own look at sys.modules."""
    import sys
    import types

    from benchmark.harness import forbidden_modules
    for name in ("jax", "jaxlib", "flax", "slam2d_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "slam2d_tpu_torch_x",
                        types.ModuleType("slam2d_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "slam2d_tpu.config",
                        types.ModuleType("slam2d_tpu.config"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax", "slam2d_tpu"]
