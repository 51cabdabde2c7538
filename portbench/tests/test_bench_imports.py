"""What the benchmark imports: no module of portbench names jax, jaxlib,
flax, optax or joeys2t_tpu (top-level names compared whole), and the
reference nothing of the program."""
import ast

import pytest

from benchutil import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "joeys2t_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "joeys2t_torch" not in top_level_imports(path)
    assert "harness" not in top_level_imports(path)


def test_the_check_compares_whole_names(monkeypatch):
    import sys
    import types

    from harness import cell as C

    for name in ("joeys2t_tpuish", "jaxtyping", "joeys2t_torch.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = C.forbidden_modules()
    assert "joeys2t_tpuish" not in found and "jaxtyping" not in found
    monkeypatch.setitem(sys.modules, "joeys2t_tpu.search", types.ModuleType("x"))
    assert "joeys2t_tpu" in C.forbidden_modules()
