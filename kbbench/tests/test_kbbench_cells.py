"""Each cell's command, end to end on a tiny KB, on the CPU, in a fresh
process: its last line is the result the contract fixes, and it is
correct."""

from __future__ import annotations

import json

import pytest

from .conftest import bench, cells, config_of, run_in_subprocess

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_end_to_end(cell, trace, bench_root):
    b = bench()
    proc = run_in_subprocess(
        bench_root, ["--workload", cell, "--seed", "2147483659", "--seconds", "2",
               "--trace", str(trace)], config_of(cell))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == KEYS, out.keys()
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared are the last lines of standard error
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail), tail
    units = {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name]
    if trace == 0:
        e2e = {m["name"] for m in b["end_to_end"]
               if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == e2e
    else:
        # on the CPU no device metric is read, and every other one is
        layer = {m["name"] for m in b["per_layer"] if cell in m["workloads"]}
        assert set(out["metrics"]) <= layer
        assert {n for n in layer - set(out["metrics"])} <= {
            n for n in layer if n.startswith(("device.", "kernels_roofline.")) or "syncs" in n}


@pytest.mark.card
def test_cell_runs_on_the_card(cuda_device):
    """The materialisation cell at a tiny size on the card, traced: the
    device's operations are read and the kernels' share stays under 100 %."""
    from kbbench.run import measure, result

    cell = cells()[0]
    ctx, outcome = measure(["--workload", cell, "--seed", "11", "--seconds", "2", "--trace", "1"],
                           device=cuda_device, config=config_of(cell))
    out = result(ctx, outcome)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    share = out["metrics"].get("kernels_roofline.materialise")
    assert share is None or 0 < share["value"] <= 100
