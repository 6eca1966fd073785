"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the program.  Modules are compared by their
top-level name, whole: ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from kbbench import run

from .conftest import ROOT

HERE = ROOT / "kbbench"
JAX = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set[str]:
    """Top-level names of the modules a file imports (relative imports
    resolve inside ``kbbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("kbbench" if node.level else node.module.split(".", 1)[0])
    return out


def _sources(folder: Path) -> list[Path]:
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


@pytest.mark.parametrize("path", _sources(HERE), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", _sources(HERE / "reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "repro", "kbbench", "jax"}


def test_loaded_modules_are_compared_whole(monkeypatch):
    import sys
    import types

    for name in ("repro_torch", "reprox", "jaxtyping", "benchmarks_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m.split(".")[0] in JAX}
    try:
        assert run.forbidden_modules() == []
        monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.update(saved)
