"""A cell's configuration names its KB generator and its engine: the
harness builds the KB with the generator the configuration names, and a
name that is not a generator under ``kbbench/data/`` fails when the cell
is loaded, before set-up, naming the configuration."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from kbbench.data import uba
from kbbench.harness import Context
from kbbench.run import measure
from kbbench.spec import Spec

from .conftest import ROOT, cells, config_of


@pytest.mark.parametrize("seed", [3, 2147483693])
def test_context_kb_is_the_named_generators(seed, bench_root):
    cell = cells()[0]
    spec = Spec.load(bench_root, cell).with_config(config_of(cell))
    assert spec.generator is uba
    got = Context(spec, seed, 1, False, "cpu", 0).kb()
    want = uba.generate(spec.config["kb"], seed, (ROOT / spec.config["program"]).read_text())
    assert got.n_terms == want.n_terms and got.counts == want.counts
    assert got.program == want.program
    assert sorted(got.dataset) == sorted(want.dataset)
    for pred, rows in want.dataset.items():
        assert rows.dtype == got.dataset[pred].dtype
        np.testing.assert_array_equal(got.dataset[pred], rows, err_msg=pred)


def _checkout_with(tmp_path, cell: str, **changes) -> Spec:
    """``Spec.load`` of a checkout whose configuration of ``cell`` has its
    ``kb`` and ``engine`` keys changed by ``changes``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    file = next(c["file"] for c in bench["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / file).read_text())
    for group, (key, value) in changes.items():
        cfg[group][key] = value
    (tmp_path / file).parent.mkdir(parents=True)
    (tmp_path / file).write_text(json.dumps(cfg))
    return Spec.load(tmp_path, cell)


@pytest.mark.parametrize("generator", [
    "kbbench/configs/uba.py",      # outside kbbench/data/
    "kbbench/data/../data/uba.py",  # through ..
    "/kbbench/data/uba.py",        # absolute
    "kbbench/data/nowhere.py",     # no such file
    "kbbench/data/univ-bench-L.txt",  # no module
])
def test_a_bad_generator_fails_when_the_cell_loads(generator, tmp_path):
    cell = cells()[0]
    config = next(w["config"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
                  ["workloads"] if w["name"] == cell)
    with pytest.raises(ValueError) as err:
        _checkout_with(tmp_path, cell, kb=("generator", generator))
    assert repr(config) in str(err.value) and generator in str(err.value)


def test_an_engine_is_named_in_full_within_the_programs_core(tmp_path):
    cell = cells()[0]
    with pytest.raises(ValueError, match="engine.class 'repro_torch.engine.CMatEngine'"):
        _checkout_with(tmp_path, cell, engine=("class", "repro_torch.engine.CMatEngine"))


def test_an_engine_the_core_lacks_fails_at_the_drivers_lookup(bench_root):
    cell = cells()[0]
    cfg = config_of(cell)
    cfg["engine"]["class"] = "repro_torch.core.NoSuchEngine"
    spec = Spec.load(bench_root, cell).with_config(cfg)  # the form is right
    with pytest.raises(AttributeError, match=f"{spec.cell['config']!r}.*NoSuchEngine"):
        measure(["--workload", cell, "--seed", "7", "--seconds", "1"], device="cpu",
                root=bench_root, config=cfg)
