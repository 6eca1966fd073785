"""Fixtures of the harness's tests: a checkout of this one's benchmark, a
small KB for every cell (the sizes its own KB generator gives), and the
``card`` marker of the tests that need a CUDA device."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import pytest

from kbbench.spec import load_generator

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:  # the program, as the harness reaches it
    sys.path.insert(0, str(ROOT / "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells() -> list[str]:
    return [w["name"] for w in bench()["workloads"]]


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> Path:
    """A checkout of links to this one's ``kbbench`` and ``src``, with a
    copy of its ``BENCHMARK.json``."""
    root = tmp_path_factory.mktemp("checkout")
    (root / "BENCHMARK.json").write_text(json.dumps(bench()))
    (root / "kbbench").symlink_to(ROOT / "kbbench")
    (root / "src").symlink_to(ROOT / "src")
    return root


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; this test runs on the card")
    return "cuda"


def generator_of(cfg: dict, root: Path = ROOT) -> ModuleType:
    """The module of the configuration's KB generator, in the checkout at
    ``root``."""
    return load_generator(cfg["kb"]["generator"], root / "kbbench")


def config_of(cell: str, root: Path = ROOT, size: str = "TINY", **sizes) -> dict:
    """The cell's configuration in the checkout at ``root``, cut by its
    generator's ``size`` overrides (``TINY``: a KB small enough for a test;
    ``WIDE``: ids past 2**16, where the control's narrower codes collide),
    then by ``sizes``."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    w = next(c for c in b["workloads"] if c["name"] == cell)
    entry = next(c for c in b["configs"] if c["name"] == w["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    cfg["kb"].update(getattr(generator_of(cfg, root), size), **sizes)
    return cfg


def run_in_subprocess(root: Path, argv: list[str], config: dict, timeout: float = 180):
    """``kbbench.run.run_cell`` of the checkout at ``root`` in a fresh
    process, on the CPU, with ``config`` in place of the cell's: the
    completed process."""
    code = (
        "import json, pathlib, sys; sys.path.insert(0, sys.argv[1]); "
        "from kbbench.run import run_cell; "
        "sys.exit(run_cell(sys.argv[3:], device='cpu', root=pathlib.Path(sys.argv[1]), "
        "config=json.loads(sys.argv[2])))"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-c", code, str(root), json.dumps(config), *argv],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout, check=False,
    )
