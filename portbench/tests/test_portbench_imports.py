"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``repro_torch`` begins with ``repro`` and is allowed."""
from __future__ import annotations

import ast

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def _modules():
    return sorted(p for p in (ROOT / "portbench").rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(ROOT)): sorted(set(_imports(p)) & FORBIDDEN)
           for p in _modules()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_takes_nothing_of_the_program():
    for name in ("reference.py", "roofline.py", "corpus.py"):
        tops = set(_imports(ROOT / "portbench" / name))
        assert not tops & (FORBIDDEN | {"repro_torch"}), name


def test_the_check_sees_whole_names():
    tops = set(_imports(ROOT / "portbench" / "systems" / "cooc.py"))
    assert "repro_torch" in tops and "repro" not in tops
