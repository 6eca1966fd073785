"""Shapes of the port's models against the JAX package's, exactly, on the
CPU; and the serving driver.

For all ten *full* configs: every parameter leaf's path, shape and dtype
from ``abstract_params`` (``meta`` tensors, nothing allocated) equals
``jax.eval_shape`` of the reference's ``init_params``, and so does the
parameter count; ``init_cache`` and ``input_specs`` for the four
``SHAPES`` likewise.  Then ``python -m repro_torch.launch.serve --smoke
--device cpu`` and ``repro_torch.examples.serve_decode`` run and print
their lines, and the entry points raise without a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.models import model, transformer

ROOT = Path(__file__).resolve().parent.parent
ARCHS = list_configs()


def _leaves(tree, prefix="") -> dict[str, tuple[tuple[int, ...], str]]:
    """``{path: (shape, dtype name)}`` of a tree of ``meta`` tensors or
    ``jax.ShapeDtypeStruct``s (``None`` subtrees have no leaves)."""
    if tree is None:
        return {}
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_leaves(sub, f"{prefix}/{key}"))
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.is_meta, prefix
        return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    return {prefix: (tuple(tree.shape), np.dtype(tree.dtype).name)}


def test_all_archs_registered():
    assert len(ARCHS) == 10
    assert set(SHAPES) == set(JSHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = _leaves(model.abstract_params(cfg))
    want = _leaves(jmodel.abstract_params(jcfg))
    assert got == want
    n = sum(int(np.prod(shape)) for shape, _ in got.values())
    assert n == sum(int(np.prod(shape)) for shape, _ in want.values())
    assert all(dtype == "float32" for _, dtype in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = _leaves(transformer.init_cache(cfg, 3, 40, device="meta"))
    want = _leaves(jax.eval_shape(lambda: jtransformer.init_cache(jcfg, 3, 40)))
    assert got == want and got


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    got = _leaves(model.input_specs(get_config(arch), SHAPES[shape]))
    want = _leaves(jmodel.input_specs(jget_config(arch), JSHAPES[shape]))
    assert got == want


LINES = [
    r"prefill: 32 steps in \d+\.\d\ds",
    r"decode:  32 steps x batch 4 = 128 tokens in \d+\.\d\ds \(\d+\.\d tok/s\)",
    r"sample token ids: \[(\d+, ){15}\d+\]",
]


def test_serve_cli_prints_its_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 3
    for line, pattern in zip(lines, LINES):
        assert re.fullmatch(pattern, line), line


def test_serve_run_is_seeded_and_greedy():
    """``run`` twice with one seed serves the same tokens; each generated
    token is the argmax of the step before it."""
    from repro_torch.launch import serve

    argv = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    a, b = serve.run(argv), serve.run(argv)
    assert torch.equal(a.prompts, b.prompts) and torch.equal(a.generated, b.generated)
    assert a.prefill_logits.shape == (2, 5, a.model.cfg.vocab_size)
    assert a.generated.shape == (2, 4)
    assert torch.equal(a.generated[:, 0], a.prefill_logits[:, -1].argmax(-1).to(torch.int32))


def test_serve_decode_example(capsys):
    from repro_torch.examples import serve_decode

    assert serve_decode.main(["--arch", "falcon-mamba-7b", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3
    assert out[0].startswith("prefill: 16 steps in ")
    assert out[1].startswith("decode:  16 steps x batch 4 = 64 tokens in ")
    assert out[2].startswith("sample token ids: [")


def test_entry_points_default_to_cuda_and_raise_without(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(["--smoke"])


def test_encdec_decode_needs_memory():
    cfg = get_config("seamless-m4t-large-v2", smoke=True)
    m = model.Model(cfg, "cpu")
    net = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="memory"):
        m.decode_step(net, torch.zeros(1, 1, dtype=torch.int32), m.init_cache(1, 4), 0)
