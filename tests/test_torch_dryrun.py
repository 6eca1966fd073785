"""The port's dry runs (``repro_torch.launch.dryrun``,
``repro_torch.launch.dryrun_datalog``) against the JAX package's.

* ``cell_skipped`` gives the reference's verdict on every cell;
* the per-device argument bytes of a train cell on an ``AbstractMesh`` of
  (2, 2) and (16, 16) equal the sum, over the reference's shard shapes
  (its specs, the reference's ``NamedSharding`` stubbed to hand them
  back), of the same tree's leaves;
* under a fake group of 2x2 ranks a smoke train cell and a decode cell
  are OK with collective bytes above 0, a 1x1 cell has none and counts
  the FLOPs of the same plain step (the equality ``chip_smoke.py``'s
  phase 1a (f) holds on the card): one subprocess, since the fake group
  is the process's default group;
* ``round_cost(8)``'s facts equal the one-shard run's.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.models import model as jmodel
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from torch_ranks import ROOT

ARCHS = list_configs()
MESHES = {"2x2": AbstractMesh(("data", "model"), (2, 2)),
          "16x16": AbstractMesh(("data", "model"), (16, 16))}


@functools.lru_cache(maxsize=None)
def _ref_cell_skipped():
    """The reference's ``cell_skipped``; importing its module sets
    ``XLA_FLAGS`` to 512 host devices, which is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import cell_skipped
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return cell_skipped


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_skipped_matches_reference(arch, shape):
    assert dryrun.cell_skipped(get_config(arch), SHAPES[shape]) == _ref_cell_skipped()(
        jget_config(arch), JSHAPES[shape])


class _Spec:
    """The stub of the reference's ``NamedSharding``: a leaf holding the
    spec (``jax.tree_util`` never looks into it)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@functools.lru_cache(maxsize=None)
def _ref_train_leaves(arch: str) -> tuple:
    """The reference dry run's train-cell arguments: ``(state, batch)``
    abstract trees."""
    import jax

    from repro.optim import adamw_init

    cfg = jget_config(arch)
    params = jmodel.abstract_params(cfg)
    state = {"params": params, "opt": jax.eval_shape(adamw_init, params)}
    return state, jmodel.input_specs(cfg, JSHAPES["train_4k"])


def _ref_shard_bytes(tree, specs, sizes: dict) -> int:
    import jax

    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, _Spec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, sp in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for i, axis in enumerate(sp.spec):
            for a in (() if axis is None else axis if isinstance(axis, tuple) else (axis,)):
                shape[i] //= sizes[a]
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference(monkeypatch, arch, mesh):
    from jax.sharding import PartitionSpec as P

    monkeypatch.setattr(jsharding, "NamedSharding", _Spec)
    m = MESHES[mesh]
    state, batch = _ref_train_leaves(arch)
    specs = {"params": jsharding.param_shardings(state["params"], m),
             "opt": {"mu": jsharding.param_shardings(state["opt"]["mu"], m),
                     "nu": jsharding.param_shardings(state["opt"]["nu"], m),
                     "step": _Spec(m, P())}}
    want = (_ref_shard_bytes(state, specs, m.shape)
            + _ref_shard_bytes(batch, jsharding.batch_shardings(batch, m), m.shape))
    assert dryrun.argument_bytes(get_config(arch), SHAPES["train_4k"], m) == want


_CELLS = """
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline.op_cost import count_ops
from repro_torch.train import TrainConfig, init_train_state, make_train_step

cfg = get_config("llama3.2-1b", smoke=True)
train = ShapeConfig("train_smoke", 16, 4, "train")
out = {
    "train": dryrun.trace_cell(cfg, train, lambda: make_host_mesh(2, 2), 4, mesh="2x2"),
    "decode": dryrun.trace_cell(cfg, ShapeConfig("decode_smoke", 32, 4, "decode"),
                                lambda: make_host_mesh(2, 2), 4, mesh="2x2"),
    "one": dryrun.trace_cell(cfg, train, lambda: make_host_mesh(1, 1), 1, mesh="1x1"),
}
state = init_train_state(torch.Generator().manual_seed(0), cfg, TrainConfig())
batch = {"tokens": torch.zeros((4, 16), dtype=torch.int32)}
out["plain_flops"] = count_ops(make_train_step(cfg, TrainConfig()), state, batch)[1].flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    proc = subprocess.run([sys.executable, "-c", _CELLS], capture_output=True, text=True,
                          cwd=ROOT, timeout=600,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _check_record(rec, n_devices: int):
    assert rec["status"] == "OK" and rec["n_devices"] == n_devices
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["temp_bytes"] > 0
    assert rec["collective_total_per_device"] == sum(rec["collective_bytes_per_device"].values())


@pytest.mark.parametrize("cell", ["train", "decode"])
def test_cell_under_fake_group_2x2(cells, cell):
    rec = cells[cell]
    _check_record(rec, 4)
    assert rec["collective_total_per_device"] > 0
    assert rec["mesh"] == "2x2"


def test_one_rank_cell_has_no_collectives(cells):
    rec = cells["one"]
    _check_record(rec, 1)
    assert rec["collective_bytes_per_device"] == {}
    assert rec["collective_total_per_device"] == 0


def test_one_rank_cell_counts_the_plain_step(cells):
    assert cells["one"]["flops_per_device"] == cells["plain_flops"]
    # four ranks share the step: each counts less than the whole
    assert cells["train"]["flops_per_device"] < cells["plain_flops"]


def test_round_cost_facts_equal_one_shard():
    from repro_torch.launch.dryrun_datalog import round_cost

    rec = round_cost(8)  # raises unless the facts equal the one-shard run's
    assert rec["n_shards"] == 8 and rec["n_rules"] == 24
    assert rec["facts"] == 4377 and rec["rounds"] == 15
    assert rec["exchanges"] > 0 and rec["flops_per_device"] == 0
    for part in (rec["round"], rec["materialise"]):
        assert part["hbm_bytes_per_device"] > 0 and part["temp_bytes"] > 0
    assert rec["materialise"]["collective_bytes_per_device"]["all-to-all"] >= \
        rec["round"]["collective_bytes_per_device"]["all-to-all"] > 0
