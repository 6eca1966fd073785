"""What decides ``correct`` can fail: the control (the reference with
32-bit fact codes in the program's place, run through the harness) comes
out not correct, and so does a run whose timed path is broken underneath,
once for each fault a cell can have."""

from __future__ import annotations

import pytest
import torch

from kbbench import control
from kbbench.run import measure, result

from .conftest import cells, config_of


@pytest.mark.parametrize("cell", cells())
def test_control_fails_every_cell(cell, bench_root):
    out = control.control(["--workload", cell, "--seed", "2147483671", "--seconds", "1"],
                          device="cpu", root=bench_root, config=config_of(cell, size="WIDE"))
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["fact_mismatches"]["value"] > out["checks"]["fact_mismatches"]["limit"]


def test_control_is_taken_out_again(bench_root):
    import repro_torch.core as core

    engine = core.CMatEngine
    cell = cells()[0]
    with control.in_place(control.Spec.load(bench_root, cell)):
        assert core.CMatEngine is not engine
    assert core.CMatEngine is engine


# --------------------------------------------------------------------- #
# faults planted under the timed path
# --------------------------------------------------------------------- #
def _unchanged_fixpoint(mp):
    from repro_torch.core.engine import CMatEngine

    mp.setattr(CMatEngine, "materialise", lambda self: self.stats)


def _half_loaded(mp):
    from repro_torch.core.engine import CMatEngine

    load = CMatEngine.load
    mp.setattr(CMatEngine, "load",
               lambda self, ds: load(self, {p: r[: len(r) // 2] for p, r in ds.items()}))


def _fact_dropped(mp):
    import repro_torch.core.engine as engine

    elim = engine.elim_dup

    def drop_one(*a, **k):
        delta = elim(*a, **k)
        return delta[:-1] if len(delta) > 1 else delta

    mp.setattr(engine, "elim_dup", drop_one)


FAULTS = {
    "state_unchanged": _unchanged_fixpoint,
    "half_the_batch": _half_loaded,
    "answer_altered": _fact_dropped,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch, bench_root):
    FAULTS[fault](monkeypatch)
    torch.manual_seed(0)
    ctx, outcome = measure(["--workload", cell, "--seed", "2147483677", "--seconds", "1"],
                           device="cpu", root=bench_root, config=config_of(cell))
    out = result(ctx, outcome)
    assert out["correct"] is False, out["checks"]
