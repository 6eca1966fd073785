"""The port's distributed engine at four shards against the JAX package's
on a four-device mesh, on the CPU.

The reference runs in one subprocess with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as in
``tests/test_distributed_multishard.py``) and dumps a snapshot of every
case: after ``materialise`` and after each ``apply`` batch, its fact sets,
every non-timing ``DistributedStats`` field and each shard's state
(rows, count, delta watermark).  The port runs in this process with
``device="cpu", n_shards=4`` and must give the same snapshots: on chain,
paper and lubm, with and without planner exchange keys and with
``seminaive=False``; a one-hub star KB whose re-keyed join side
overflows an exchange bucket (a regrow that the join padding does not explain); the
delete and re-add of two chain edges; seeded ``random_kb`` batch
sequences (one of them also at three shards, on three of the four
devices: a shard count that is not a power of two); and, on the chain
run, the derivation journal's records after ``merge_shard_records``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_distributed import (
    CAPACITY,
    WORKLOADS,
    _as_sets,
    _assert_same,
    _random_workload,
    _ref_snapshot,
    _rows,
    _stats,
)
from test_torch_provenance import _reset
from test_torch_provenance import _untimed as _untimed_records

from repro.core.generators import bipartite
from repro_torch.core.distributed import DistributedEngine
from repro_torch.core.flat import flat_seminaive
from repro_torch.obs import provenance as tprov

N_SHARDS = 4
#: the exchange-bucket regrow: ``bipartite(100, 1)`` is a star, A(x_i, hub)
#: for 100 spokes and B(hub, t) for one; the join re-keys A on the hub, so
#: each shard sends its ~25 A rows to one bucket of capacity // 4 = 16 slots
HUB_CAPACITY, HUB_JOIN_CAPACITY = 64, 1024
RANDOM_SEEDS = (9, 10)
#: the shard count that is not a power of two, on ``RANDOM_SEEDS[0]``
ODD_SHARDS = 3
#: chain edges deleted, then re-added
CHAIN_EDGES = slice(5, 7)


def _workload(name):
    if name == "hub":
        return bipartite(100, 1)
    return WORKLOADS[name]()


#: (case, workload, engine options): the cases whose snapshots are only
#: the materialisation's
MATERIALISE_CASES = [
    (f"{name}-{variant}", name, kw)
    for name in ("chain", "paper", "lubm")
    for variant, kw in (
        ("default", {}),
        ("no-planner-keys", {"planner_exchange_keys": False}),
        ("naive", {"seminaive": False}),
    )
] + [
    ("hub-regrow", "hub",
     {"capacity": HUB_CAPACITY, "join_capacity": HUB_JOIN_CAPACITY}),
]


def _chain_batches(dataset):
    edges = {"edge": _rows(dataset, "edge")[CHAIN_EDGES]}
    return [(None, edges), (edges, None)]


#: the reference's cases in two subprocesses that run side by side: the
#: lubm engines compile the most round variants
PARTS = {
    "lubm": [c for c in MATERIALISE_CASES if c[1] == "lubm"],
    "rest": [c for c in MATERIALISE_CASES
             if c[1] != "lubm" and c[0] != "chain-default"],
}


def _dump_reference(path: str, part: str) -> None:
    """The reference's snapshots of one part of the cases, pickled to
    ``path``; run in a process that sees four host devices."""
    import jax
    from jax.sharding import Mesh

    from repro.core.distributed import DistributedEngine as JDistributedEngine
    from repro.core.flat import flat_seminaive as jflat
    from repro.obs import provenance as jprov

    def engine(program, n_shards=N_SHARDS, **kw):
        mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("data",))
        program = JDistributedEngine.supported_program(program)
        return JDistributedEngine(program, mesh, **{"capacity": CAPACITY, **kw})

    out = {}
    for case, name, kw in PARTS[part]:
        program, dataset, _ = _workload(name)
        eng = engine(program, **kw)
        eng.materialise(dataset)
        out[case] = [_ref_snapshot(eng)]
    if part == "rest":
        # the chain's materialise, delete and re-add, with the journal on
        journal = jprov.get_journal()
        journal.enabled = True
        _reset(journal)
        program, dataset, _ = _workload("chain")
        eng = engine(program)
        eng.materialise(dataset)
        snaps = [_ref_snapshot(eng)]
        for adds, dels in _chain_batches(dataset):
            eng.apply(additions=adds, deletions=dels)
            snaps.append(_ref_snapshot(eng))
        out["chain-default"] = snaps
        out["chain-shard-records"] = _untimed_records(journal)
        journal.enabled = False
        oracle = jflat(eng.program, dataset)
        journal.enabled = True
        eng.check_integrity(oracle)
        out["chain-merged-records"] = _untimed_records(journal)
        journal.enabled = False
        _reset(journal)
        for seed, n_shards in [(s, N_SHARDS) for s in RANDOM_SEEDS] + [
                (RANDOM_SEEDS[0], ODD_SHARDS)]:
            program, dataset, batches = _random_workload(seed)
            eng = engine(program, n_shards)
            eng.materialise(dataset)
            snaps = [_ref_snapshot(eng)]
            for adds, dels in batches:
                eng.apply(additions=adds, deletions=dels)
                snaps.append(_ref_snapshot(eng))
            out[f"random-{seed}-{n_shards}"] = snaps
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's snapshots from two four-device subprocesses."""
    tmp = tmp_path_factory.mktemp("multishard")
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_SHARDS}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(root / "src"), str(root / "tests")])
    code = ("import sys, test_torch_multishard as m; "
            "m._dump_reference(sys.argv[1], sys.argv[2])")
    procs = {
        part: subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"{part}.pkl"), part],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root,
        )
        for part in PARTS
    }
    snaps = {}
    try:
        for part, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{part}: stdout={stdout}\nstderr={stderr[-3000:]}"
            with open(tmp / f"{part}.pkl", "rb") as f:
                snaps.update(pickle.load(f))
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return snaps


def _port(name, **kw):
    program, dataset, _ = _workload(name)
    program = DistributedEngine.supported_program(program)
    eng = DistributedEngine(
        program, device="cpu", n_shards=N_SHARDS, **{"capacity": CAPACITY, **kw}
    )
    return eng, eng.materialise(dataset), program, dataset


@pytest.mark.parametrize(
    "case,name,kw", MATERIALISE_CASES, ids=[c[0] for c in MATERIALISE_CASES]
)
def test_materialise_matches_reference(reference, case, name, kw):
    """Fact sets, every non-timing stats field and each shard's buffers,
    counts and watermarks equal the reference's, and the flat oracle's."""
    eng, result, program, dataset = _port(name, **kw)
    _assert_same(eng, reference[case][0], result)
    assert _as_sets(eng.to_dict()) == _as_sets(
        flat_seminaive(program, dataset, device="cpu")
    )
    st = eng.stats
    if name == "chain":
        assert st.exchanges > 0
        assert (st.exchanges_skipped > 0) == kw.get("planner_exchange_keys", True)
    if case == "hub-regrow":
        # no join outgrew its padding: the regrow came from a bucket
        assert st.exchange_regrows > 0
        assert max(r["rows_joined"] for r in st.per_round) <= HUB_JOIN_CAPACITY


def test_shards_partition_on_the_first_column():
    """Every shard holds exactly the rows whose first column hashes to it,
    and the shards' counts sum to the planner's global counts."""
    from repro.core.distributed import _hash_shard_np

    eng, _, _, _ = _port("lubm")
    for p, (rows, cnt, _lo) in eng._state.items():
        assert sum(cnt) == eng._counts[p]
        for s, (r, c) in enumerate(zip(rows, cnt)):
            assert (_hash_shard_np(r[:c, 0].numpy(), N_SHARDS) == s).all(), (p, s)


def test_apply_and_records_match_reference(reference):
    """Delete two chain edges and add them back: after each batch the
    shards equal the reference's and the flat oracle; the journal's
    records, after ``merge_shard_records``, equal the reference's."""
    journal = tprov.get_journal()
    was = journal.enabled
    journal.enabled = True
    _reset(journal)
    try:
        eng, result, program, dataset = _port("chain")
        snaps = reference["chain-default"]
        _assert_same(eng, snaps[0], result)
        batches = _chain_batches(dataset)
        for (adds, dels), snap in zip(batches, snaps[1:]):
            st = eng.apply(additions=adds, deletions=dels)
            _assert_same(eng, snap)
            if dels:
                assert st.n_overdeleted > 0 and st.n_deleted > 0
                kept = {"edge": np.delete(_rows(dataset, "edge"),
                                          np.arange(20)[CHAIN_EDGES], axis=0)}
                journal.enabled = False  # the oracle journals too
                want = flat_seminaive(program, kept, device="cpu")
                journal.enabled = True
                assert _as_sets(eng.to_dict()) == _as_sets(want)
        shard_records = _untimed_records(journal)
        journal.enabled = False
        oracle = flat_seminaive(program, dataset, device="cpu")
        journal.enabled = True
        eng.check_integrity(oracle)
        merged_records = _untimed_records(journal)
    finally:
        journal.enabled = was
        _reset(journal)
    assert shard_records == reference["chain-shard-records"]
    assert merged_records == reference["chain-merged-records"]
    assert len(merged_records) < len(shard_records)
    shards = {r[-2] for r in shard_records if r[0] == "apply"}
    assert len(shards) > 1, "growth records from one shard only"


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_random_kb_apply_sequence_matches_reference(reference, seed):
    """A seeded ``random_kb``: materialise, then a mixed batch, its
    inverse, a delete of every explicit fact and its re-add, each held
    against the reference's four shards."""
    _check_random(reference, seed, N_SHARDS)


def test_random_kb_three_shards_match_reference(reference):
    """The same sequence at three shards, against the reference's mesh of
    three devices."""
    _check_random(reference, RANDOM_SEEDS[0], ODD_SHARDS)


def _check_random(reference, seed, n_shards):
    program, dataset, batches = _random_workload(seed)
    snaps = reference[f"random-{seed}-{n_shards}"]
    eng = DistributedEngine(program, device="cpu", n_shards=n_shards,
                            capacity=CAPACITY)
    _assert_same(eng, snaps[0], eng.materialise(dataset))
    for (adds, dels), snap in zip(batches, snaps[1:]):
        eng.apply(additions=adds, deletions=dels)
        _assert_same(eng, snap)
    assert _stats(eng.stats)["epoch"] == len(batches)


def test_devices_place_one_shard_each():
    """``devices`` puts one shard on each entry; the shard count follows
    it, and a mismatch is refused."""
    program, dataset, _ = _workload("chain")
    eng = DistributedEngine(program, devices=["cpu", "cpu"], capacity=CAPACITY)
    assert eng.n_shards == 2 and len(eng.devices) == 2
    eng.materialise(dataset)
    assert all(len(part) == 2 for state in eng._state.values() for part in state)
    with pytest.raises(ValueError, match="devices"):
        DistributedEngine(program, devices=["cpu"], n_shards=2)


def test_visible_devices_one_shard_per_card(monkeypatch):
    """The server and ``distributed_reasoning`` put one shard on each
    visible device of their device type: every card, or the CPU."""
    import torch

    from repro_torch.core.distributed import visible_devices

    assert visible_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert visible_devices(None) == [torch.device("cuda", 0), torch.device("cuda", 1)]
