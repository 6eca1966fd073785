"""The port's distributed engine against the JAX package's, on the CPU:
materialisation, DRed ``apply``, the tensor primitives and the guards.

The reference ``DistributedEngine`` runs on the 1-device CPU mesh, with
``use_pallas_kernels`` False and True (Pallas in interpret mode; True on
the two cheaper workloads).  Each reference engine compiles its own round
variants, so one engine per (workload, pallas) materialises, records its
state, runs the workload's apply batches and records its state after
each; the parametrised cases compare against those records.  After
``materialise`` and after every batch the port's
``DistributedEngine(device="cpu")`` must give the same fact sets, every
non-timing field of ``DistributedStats`` and the same state buffers row
for row (rows, count, delta watermark), and equal the port's
``flat_seminaive`` of the explicit set.  The cases mirror
``tests/test_distributed_seminaive.py``.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from numpy.testing import assert_array_equal

from repro.core import distributed as jdist
from repro.core.distributed import DistributedEngine as JDistributedEngine
from repro.core.generators import chain, lubm_like, paper_example, random_kb
from repro_torch.core import distributed as tdist
from repro_torch.core import generators as tgenerators
from repro_torch.core.distributed import DistributedEngine
from repro_torch.core.flat import flat_seminaive

WORKLOADS = {
    "chain": lambda: chain(15),
    "paper": lambda: paper_example(4, 3),
    "lubm": lambda: lubm_like(n_dept=3, n_students=40, n_courses=6, seed=0),
}
CAPACITY = 1 << 10


def _mesh():
    return Mesh(np.asarray(jax.devices()), ("data",))


def _stats(stats) -> dict:
    return {
        f.name: getattr(stats, f.name)
        for f in dataclasses.fields(stats)
        if not f.name.startswith("time_")
    }


def _ref_snapshot(eng) -> dict:
    """A reference engine's observable state, copied out as numpy."""
    return {
        "to_dict": eng.to_dict(),
        "stats": _stats(eng.stats),
        "state": {
            p: (np.asarray(rows), np.asarray(cnt).tolist(), np.asarray(lo).tolist())
            for p, (rows, cnt, lo) in eng._state.items()
        },
    }


def _assert_same(eng, snap, result=None):
    got = eng.to_dict()
    assert set(got) == set(snap["to_dict"])
    for p, rows in snap["to_dict"].items():
        assert_array_equal(got[p].numpy(), rows)
    if result is not None:  # materialise's return: empty predicates too
        for p, rows in result.items():
            want = snap["to_dict"].get(p, rows.numpy()[:0])
            assert_array_equal(rows.numpy(), want)
    assert _stats(eng.stats) == snap["stats"]
    assert list(eng._state) == list(snap["state"])
    for p, (rows, cnt, lo) in snap["state"].items():
        trows, tcnt, tlo = eng._state[p]
        assert (tcnt, tlo) == (cnt, lo), p
        assert len(trows) == len(rows), p
        for s, shard in enumerate(rows):  # each shard's buffer row for row
            assert_array_equal(trows[s].numpy(), shard, err_msg=f"{p} shard {s}")


def _rows(dataset, pred):
    r = np.asarray(dataset[pred], dtype=np.int64)
    return r.reshape(len(r), -1)


def pick_batch(dataset, k, seed=0):
    rng = np.random.default_rng(seed)
    pool = [(p, tuple(row)) for p in dataset for row in _rows(dataset, p).tolist()]
    rng.shuffle(pool)
    out: dict[str, list] = {}
    for p, row in pool[:k]:
        out.setdefault(p, []).append(row)
    return {p: np.asarray(r, dtype=np.int64) for p, r in out.items()}


def _batches(name, dataset) -> list:
    """The workload's apply batches ``(additions, deletions)``: a mixed
    batch and its inverse, and on ``chain`` also deleting every explicit
    fact and adding them back."""
    if name == "paper":
        return []
    dels = pick_batch(dataset, 5, seed=1)
    adds = {
        p: (np.arange(2 * _rows(dataset, p).shape[1]).reshape(2, -1) + 900).astype(np.int64)
        for p in list(dataset)[:2]
    }
    batches = [(adds, dels), (dels, adds)]
    if name == "chain":
        batches += [(None, dataset), (dataset, None)]
    return batches


def _reference(name, pallas, seminaive=True) -> list:
    """One reference engine's snapshots: after ``materialise``, then after
    each of the workload's apply batches (semi-naive engines only)."""
    return _reference_run(name, pallas, seminaive)


@functools.lru_cache(maxsize=None)
def _reference_run(name, pallas, seminaive) -> list:
    program, dataset, _ = WORKLOADS[name]()
    program = JDistributedEngine.supported_program(program)
    eng = JDistributedEngine(
        program, _mesh(), capacity=CAPACITY, use_pallas_kernels=pallas,
        seminaive=seminaive,
    )
    eng.materialise(dataset)
    snaps = [_ref_snapshot(eng)]
    for adds, dels in _batches(name, dataset) if seminaive else ():
        eng.apply(additions=adds, deletions=dels)
        snaps.append(_ref_snapshot(eng))
    return snaps


def _port(name, **kw):
    program, dataset, _ = WORKLOADS[name]()
    program = DistributedEngine.supported_program(program)
    eng = DistributedEngine(program, device="cpu", capacity=CAPACITY, **kw)
    return eng, eng.materialise(dataset), program, dataset


def _as_sets(facts):
    return {
        p: frozenset(map(tuple, np.asarray(r).astype(np.int64).tolist()))
        for p, r in facts.items()
        if len(r)
    }


# --------------------------------------------------------------------- #
# materialisation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "name,pallas",
    [("chain", False), ("chain", True), ("paper", False), ("paper", True),
     ("lubm", False)],
)
def test_materialise_matches_reference(name, pallas):
    eng, result, program, dataset = _port(name)
    _assert_same(eng, _reference(name, pallas)[0], result)
    assert set(result) == set(eng._preds)
    assert _as_sets(eng.to_dict()) == _as_sets(
        flat_seminaive(program, dataset, device="cpu")
    )


@pytest.mark.parametrize("name", ["chain", "lubm"])
def test_seminaive_skips_work_naive_matches(name):
    """Delta-restricted rounds skip (rule, pivot) pairs and join fewer
    rows than the naive iteration, which reaches the same fixpoint."""
    sn, _, _, _ = _port(name)
    nv, _, _, _ = _port(name, seminaive=False)
    assert _as_sets(sn.to_dict()) == _as_sets(nv.to_dict())
    assert sn.stats.rows_joined < nv.stats.rows_joined
    assert sn.stats.rule_applications_skipped > 0
    if name == "chain":
        _assert_same(
            nv,
            _reference("chain", False, seminaive=False)[0],
        )
    else:
        assert sn.stats.n_strata > 1 and sn.stats.per_stratum


def test_round_deltas_strictly_shrink_on_acyclic_data():
    program, dataset, _ = chain(20)
    eng = DistributedEngine(program, device="cpu", capacity=1 << 11)
    eng.materialise(dataset)
    news = [r["new_facts"] for r in eng.stats.per_round]
    while news and news[-1] == 0:
        news.pop()
    assert len(news) >= 3
    assert all(a > b for a, b in zip(news, news[1:])), news


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("seminaive", [True, False])
def test_static_exchange_counts_match_reference(seminaive, n_shards):
    """One shard issues no all_to_all and elides none, as the reference
    does on its one-device mesh.  At four shards the port's static
    exchange schedule equals the reference's host mirror of it (an engine
    over a four-entry ``data`` axis) for the entry and the delta pair sets,
    with and without planner exchange keys."""
    name = "lubm" if seminaive else "chain"
    eng, _, program, _ = _port(name, seminaive=seminaive, n_shards=n_shards)
    pair_sets = [
        eng._resolve([(r, None) for r in program if r.body]),
        eng._resolve([(r, i) for r in program for i in range(len(r.body))]),
    ]
    if n_shards == 1:
        assert eng._static_exchange_counts(pair_sets[0]) == (0, 0)
        want = _reference(name, False, seminaive=seminaive)[0]["stats"]
        got = (eng.stats.exchanges, eng.stats.exchanges_skipped)
        assert got == (want["exchanges"], want["exchanges_skipped"]) == (0, 0)
        return
    ref = JDistributedEngine(program, SimpleNamespace(shape={"data": 4}))
    for planner in (True, False):
        eng.planner_exchange_keys = ref.planner_exchange_keys = planner
        for pairs in pair_sets:
            got = eng._static_exchange_counts(pairs)
            assert got == ref._static_exchange_counts(pairs), (planner, pairs)
            assert got[0] > 0 and (got[1] > 0) == planner


def test_merge_block_exact_fill_keeps_last_row():
    """Appending exactly up to capacity keeps the row written to the final
    slot, as the reference's out-of-bounds drop does."""
    trows = np.concatenate([np.arange(12).reshape(6, 2), np.full((2, 2), -1)]).astype(np.int32)
    cand = np.asarray([[50, 50], [9, 9], [50, 50]], np.int32)
    program, _, _ = chain(3)
    ref = JDistributedEngine(program, _mesh(), capacity=8)
    jr, jc, jf, jo = jax.jit(ref._merge_block)(
        jax.numpy.asarray(trows), jax.numpy.int32(6), jax.numpy.asarray(cand),
        jax.numpy.asarray([True, True, True]),
    )
    eng = DistributedEngine(program, device="cpu", capacity=8)
    tr, tc, tf, to = eng._merge_block(
        torch.from_numpy(trows), 6, torch.from_numpy(cand), torch.ones(3, dtype=torch.bool)
    )
    assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (int(tc), int(tf), int(to)) == (int(jc), int(jf), int(jo)) == (8, 2, 0)
    assert [9, 9] in tr.tolist() and [50, 50] in tr.tolist()


def test_join_regrow_instead_of_abort():
    """A join bigger than join_capacity doubles the padding and retries
    the round, as many times as the reference does."""
    program, dataset, _ = chain(30)
    ref = JDistributedEngine(program, _mesh(), capacity=CAPACITY, join_capacity=8)
    ref.materialise(dataset)
    eng = DistributedEngine(program, device="cpu", capacity=CAPACITY, join_capacity=8)
    eng.materialise(dataset)
    _assert_same(eng, _ref_snapshot(ref))
    assert eng.stats.exchange_regrows > 0 and eng._factor == ref._factor


def test_constants_out_of_packing_range_are_rejected():
    program, dataset, _ = chain(5)
    bad = dict(dataset)
    bad["edge"] = np.asarray([[40000, 1]], np.int64)
    with pytest.raises(ValueError, match="constants"):
        DistributedEngine(program, device="cpu", capacity=1 << 9).materialise(bad)
    eng = DistributedEngine(program, device="cpu", capacity=1 << 9)
    eng.materialise(dataset)
    with pytest.raises(ValueError, match="constants"):
        eng.apply(additions={"edge": np.asarray([[1, 40000]], np.int64)})
    with pytest.raises(ValueError, match="constants"):
        eng.apply(deletions={"edge": np.asarray([[-1, 0]], np.int64)})


def test_guards():
    program, dataset, _ = chain(4)
    with pytest.raises(RuntimeError, match="materialise"):
        DistributedEngine(program, device="cpu").apply(additions=dataset)
    with pytest.raises(ValueError, match="n_shards"):
        DistributedEngine(program, device="cpu", n_shards=0)
    with pytest.raises(ValueError, match="too small"):
        DistributedEngine(program, device="cpu", capacity=2).materialise(dataset)
    with pytest.raises(RuntimeError, match="overflow"):
        DistributedEngine(program, device="cpu", capacity=4).materialise(dataset)


# --------------------------------------------------------------------- #
# apply (DRed maintenance)
# --------------------------------------------------------------------- #
def subtract(dataset, dels):
    out = {}
    for pred in dataset:
        rows = _rows(dataset, pred)
        drop = set(map(tuple, _rows(dels, pred).tolist())) if pred in dels else set()
        keep = [r for r in rows.tolist() if tuple(r) not in drop]
        if keep:
            out[pred] = np.asarray(keep, dtype=np.int64)
    return out


def union(dataset, adds):
    out = {p: _rows(dataset, p) for p in dataset}
    for pred in adds:
        rows = _rows(adds, pred)
        prev = out.get(pred)
        out[pred] = np.unique(rows if prev is None else np.concatenate([prev, rows]), axis=0)
    return out


def _check_against_flat(eng, program, explicit):
    want = _as_sets(flat_seminaive(program, explicit, device="cpu"))
    assert _as_sets(eng.to_dict()) == want
    eng.check_integrity(flat_seminaive(program, explicit, device="cpu"))


@pytest.mark.parametrize(
    "name,pallas",
    [("chain", False), ("chain", True), ("lubm", False)],
)
def test_apply_matches_reference(name, pallas):
    """After each apply batch the port equals the reference and the flat
    oracle of the edited explicit set, and the last batch restores the
    original materialisation."""
    eng, original, program, dataset = _port(name)
    snaps = _reference(name, pallas)
    batches = _batches(name, dataset)
    assert len(snaps) == len(batches) + 1
    explicit = dataset
    for (batch_adds, batch_dels), snap in zip(batches, snaps[1:]):
        st = eng.apply(additions=batch_adds, deletions=batch_dels)
        _assert_same(eng, snap)
        explicit = union(subtract(explicit, batch_dels or {}), batch_adds or {})
        if explicit:
            _check_against_flat(eng, program, explicit)
        else:
            assert eng.to_dict() == {}
            assert st.n_deleted > 0 and st.n_rederived == 0
    assert eng.epoch == len(batches)
    assert _as_sets(eng.to_dict()) == _as_sets(original)


def test_random_batches_match_rematerialisation():
    """Randomised add/delete batches applied in sequence: the result
    equals a re-materialisation of the updated explicit set."""
    rng = np.random.default_rng(7)
    program, dataset = random_kb(rng, n_constants=8, n_facts=18, n_rules=4)
    program = DistributedEngine.supported_program(program)
    assert len(program.rules)
    eng = DistributedEngine(program, device="cpu", capacity=1 << 11)
    eng.materialise(dataset)
    explicit = {p: np.asarray(r, np.int64) for p, r in dataset.items()}
    for _ in range(6):
        dels = {
            p: rows[rng.choice(rows.shape[0], size=int(rng.integers(1, rows.shape[0] + 1)), replace=False)]
            for p, rows in explicit.items()
            if rows.shape[0] and rng.random() < 0.7
        }
        adds = {
            p: rng.integers(20, 26, size=(2, _rows(dataset, p).shape[1])).astype(np.int64)
            for p in dataset
            if rng.random() < 0.5
        }
        eng.apply(additions=adds, deletions=dels)
        explicit = union(subtract(explicit, dels), adds)
        _check_against_flat(eng, program, explicit)


def test_failed_apply_blocks_until_rematerialised():
    program, dataset, _ = chain(4)  # 10 path facts
    eng = DistributedEngine(program, device="cpu", capacity=16)
    eng.materialise(dataset)
    with pytest.raises(RuntimeError, match="overflow"):
        eng.apply(additions={"edge": np.asarray([[4, 5], [5, 6], [6, 7]], np.int64)})
    with pytest.raises(RuntimeError, match="mid-sweep"):
        eng.apply(deletions={"edge": _rows(dataset, "edge")[:1]})
    eng.materialise(dataset)
    with pytest.raises(NotImplementedError, match="absent"):
        eng.apply(additions={"other": np.asarray([[1, 2]], np.int64)})
    eng.apply(deletions={"edge": _rows(dataset, "edge")[:1]})


# --------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------- #
def test_primitives_match_reference():
    rng = np.random.default_rng(3)
    jnp = jax.numpy
    rows = rng.integers(0, 1 << 15, size=(300, 2)).astype(np.int32)
    rows[::7] = -1  # EMPTY rows pack to -1
    keys = tdist.pack_pairs(torch.from_numpy(rows))
    assert keys.dtype == torch.int32
    assert_array_equal(keys.numpy(), np.asarray(jdist.pack_pairs(jnp.asarray(rows))))
    assert_array_equal(
        tdist.unpack_pairs(keys, 2).numpy(), np.asarray(jdist.unpack_pairs(jnp.asarray(keys.numpy()), 2))
    )
    for n in (1, 2, 3, 4):  # the routing hash, EMPTY keys too
        got = tdist._hash_shard(torch.from_numpy(rows[:, 0]), n)
        assert got.dtype == torch.int32
        assert_array_equal(got.numpy(), jdist._hash_shard_np(rows[:, 0], n))
        assert_array_equal(got.numpy(), np.asarray(jdist._hash_shard(jnp.asarray(rows[:, 0]), n)))
    new = rng.integers(0, 50, size=400).astype(np.int32)
    valid = rng.random(400) < 0.8
    old = np.sort(rng.choice(60, size=20, replace=False)).astype(np.int32)
    assert_array_equal(
        tdist.dedup_against(torch.from_numpy(new), torch.from_numpy(valid), torch.from_numpy(old)).numpy(),
        np.asarray(jax.jit(jdist.dedup_against)(jnp.asarray(new), jnp.asarray(valid), jnp.asarray(old))),
    )
    lk = rng.integers(0, 30, size=50).astype(np.int32)
    rk = rng.integers(0, 30, size=70).astype(np.int32)
    lv, rv = rng.random(50) < 0.9, rng.random(70) < 0.9
    lp = rng.integers(0, 1000, size=(50, 2)).astype(np.int32)
    rp = rng.integers(0, 1000, size=(70, 2)).astype(np.int32)
    ref_join = jax.jit(jdist.join_on_key, static_argnums=6)
    for cap in (16, 400):
        got = tdist.join_on_key(*map(torch.from_numpy, (lk, lv, lp, rk, rv, rp)), cap)
        want = ref_join(*map(jnp.asarray, (lk, lv, lp, rk, rv, rp)), cap)
        v = np.asarray(want[2])
        assert_array_equal(got[2].numpy(), v)
        assert int(got[3]) == int(want[3])
        for g, w in zip(got[:2], want[:2]):
            assert_array_equal(g.numpy()[v], np.asarray(w)[v])


def test_lubm_full_size_generator_matches_reference():
    """The full-size distributed workload comes from the port's own copy
    of the generator: it must give the reference's dataset and program."""
    program, dataset, _ = tgenerators.lubm_like(n_dept=500, n_students=30_000, n_courses=1_000)
    jprogram, jdataset, _ = lubm_like(n_dept=500, n_students=30_000, n_courses=1_000)
    assert [str(r) for r in program] == [str(r) for r in jprogram]
    assert set(dataset) == set(jdataset)
    for p in dataset:
        assert_array_equal(dataset[p], jdataset[p])
    assert sum(int(v.shape[0]) for v in dataset.values()) == 163_500
    assert max(int(v.max()) for v in dataset.values()) == 32_500
    assert len(DistributedEngine.supported_program(program)) == 24


def test_stats_are_published():
    """``materialise`` and ``apply`` publish their stats under ``dist.*``:
    counters accumulate over the two runs, the epoch is a gauge."""
    from repro_torch.obs import get_registry
    from repro_torch.obs.adapters import DISTRIBUTED_COUNTERS

    reg = get_registry()
    reg.reset("dist.")
    eng, _, _, dataset = _port("chain")
    mat = _stats(eng.stats)
    app = _stats(eng.apply(deletions={"edge": np.asarray(dataset["edge"])[:2]}))
    snap = reg.snapshot("dist.")
    for f in ("rounds", "n_rule_applications", "rule_applications_skipped") + DISTRIBUTED_COUNTERS:
        assert snap[f"dist.{f}"] == mat[f] + app[f], f
    assert snap["dist.epoch"] == 1 and app["n_del_explicit"] == 2
    reg.reset("dist.")


# --------------------------------------------------------------------- #
# seeded random KBs: materialise, then four apply batches
# --------------------------------------------------------------------- #
RANDOM_SEEDS = (9, 10, 11, 13)  # programs with two-atom joins


def _random_workload(seed):
    """``random_kb`` at ``seed`` (3-29 constants, 1-39 facts, 1-5 rules),
    its supported program, and four batches ``(additions, deletions)``:
    a mixed batch, its inverse, deleting every explicit fact, re-adding
    them."""
    rng = np.random.default_rng(seed)
    n_constants = int(rng.integers(3, 30))
    program, dataset = random_kb(rng, n_constants=n_constants,
                                 n_facts=int(rng.integers(1, 40)),
                                 n_rules=int(rng.integers(1, 6)))
    program = JDistributedEngine.supported_program(program)
    dels = {p: rows[rng.random(rows.shape[0]) < 0.3] for p, rows in dataset.items()}
    dels = {p: r for p, r in dels.items() if r.shape[0]}
    adds = {
        p: rng.integers(n_constants, n_constants + 4, size=(2, rows.shape[1])).astype(np.int64)
        for p, rows in dataset.items()
        if rng.random() < 0.5
    }
    batches = [(adds, dels), (dels, adds), (None, dataset), (dataset, None)]
    return program, dataset, batches


@functools.lru_cache(maxsize=None)
def _random_reference(seed) -> list:
    program, dataset, batches = _random_workload(seed)
    eng = JDistributedEngine(program, _mesh(), capacity=CAPACITY)
    eng.materialise(dataset)
    snaps = [_ref_snapshot(eng)]
    for adds, dels in batches:
        eng.apply(additions=adds, deletions=dels)
        snaps.append(_ref_snapshot(eng))
    return snaps


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_random_kb_apply_sequence_matches_reference(seed):
    """After ``materialise`` and after each batch: ``to_dict``, every
    non-timing ``DistributedStats`` field and the state buffers (rows,
    count, delta watermark) equal the reference's."""
    program, dataset, batches = _random_workload(seed)
    assert len(program.rules)
    snaps = _random_reference(seed)
    eng = DistributedEngine(program, device="cpu", capacity=CAPACITY)
    result = eng.materialise(dataset)
    _assert_same(eng, snaps[0], result)
    for (adds, dels), snap in zip(batches, snaps[1:]):
        eng.apply(additions=adds, deletions=dels)
        _assert_same(eng, snap)
    assert eng.epoch == len(batches)
