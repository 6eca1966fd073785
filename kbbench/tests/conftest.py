"""Fixtures of the harness's tests: a checkout of this one's benchmark, a
small KB for every cell, and the ``card`` marker of the tests that need a
CUDA device."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:  # the program, as the harness reaches it
    sys.path.insert(0, str(ROOT / "src"))

#: a KB small enough for a test (one university, about 120,000 triples),
#: and one whose ids pass 2**16, where the control's narrower codes collide
TINY = {"n_universities": 1}
WIDE = {"n_universities": 5}


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


def config_of(cell: str, root: Path = ROOT, **sizes) -> dict:
    b = json.loads((root / "BENCHMARK.json").read_text())
    w = next(c for c in b["workloads"] if c["name"] == cell)
    entry = next(c for c in b["configs"] if c["name"] == w["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    cfg["kb"].update(sizes or TINY)
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
