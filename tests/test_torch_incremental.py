"""The port's incremental store, compaction and kernel facade against the
JAX package's, on the CPU.

Both packages' ``IncrementalStore`` load the same generator output and
apply the same deletion and addition batches.  After every batch the
maintained rows (row for row), the derivation counts (and a recount),
every non-timing ``IncrementalStats`` field, the epoch, the journal, the
mu-store's node count and ``mu_usage()`` must be equal.  The journal's
byte count holds each entry's ``time_s`` float, whose JSON length varies
with the measured time, so the bytes are compared without those floats.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core.generators import chain, lubm_like, random_kb
from repro.incremental import IncrementalStats as JIncrementalStats
from repro.incremental import IncrementalStore as JIncrementalStore
from repro.incremental import RowIndex as JRowIndex
from repro.query import QueryEngine as JQueryEngine
from repro_torch import convert
from repro_torch.core import Dictionary
from repro_torch.incremental import IncrementalStore, RowIndex
from repro_torch.kernels import ops
from repro_torch.kernels.fused import fused_join_dedup, merge_sorted_unique
from repro_torch.kernels.join_bounds import join_bounds
from repro_torch.kernels.rle_expand import rle_expand
from repro_torch.kernels.sorted_member import sorted_member
from repro_torch.query import QueryEngine
from test_incremental import KBS, pick_batch

TIMING = {f.name for f in dataclasses.fields(JIncrementalStats) if f.name.startswith("time_")}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stats(st) -> dict:
    """Non-timing fields; ``journal_bytes`` holds the ``time_s`` floats'
    lengths and is compared through :func:`_journal` instead."""
    return {k: v for k, v in dataclasses.asdict(st).items()
            if k not in TIMING and k != "journal_bytes"}


def _journal(inc) -> tuple[list, int]:
    """The journal's entries and byte count without the ``time_s``
    floats."""
    entries = [{k: v for k, v in e.items() if k != "time_s"} for e in inc.journal]
    floats = sum(len(json.dumps(e["time_s"])) for e in inc.journal)
    return entries, inc.journal_bytes() - floats


def _assert_same_store(inc, ref, tag=""):
    got, want = inc.to_dict(), ref.to_dict()
    assert set(got) == set(want), tag
    for pred in want:
        assert got[pred].dtype == torch.int64
        assert_array_equal(got[pred].numpy(), want[pred], err_msg=f"{tag} {pred}")
    assert set(inc.counts) == set(ref.counts), tag
    for pred, c in ref.counts.items():
        assert_array_equal(inc.counts[pred].numpy(), c, err_msg=f"{tag} counts {pred}")
    # a recount runs through the plan cache: run it in both packages so
    # their plan-cache counters stay comparable
    recount, ref_recount = inc.recompute_counts(), ref.recompute_counts()
    for pred, c in inc.counts.items():
        assert torch.equal(recount[pred], c), f"{tag} recount {pred}"
        assert_array_equal(recount[pred].numpy(), ref_recount[pred])
    assert inc.epoch == ref.epoch, tag
    assert _journal(inc) == _journal(ref), tag
    assert inc.store.n_nodes() == ref.store.n_nodes(), tag
    assert dataclasses.astuple(inc.mu_usage()) == dataclasses.astuple(ref.mu_usage()), tag
    assert inc.facts.n_meta_facts() == ref.facts.n_meta_facts(), tag


def _load_both(program, dataset, **kw):
    ref = JIncrementalStore(program, **kw)
    inc = IncrementalStore(program, device="cpu", **kw)
    want, got = ref.load(dataset), inc.load(dataset)
    for f in ("rounds", "n_meta_facts", "n_facts", "rule_applications_skipped",
              "n_rule_applications"):
        assert getattr(got, f) == getattr(want, f), f
    _assert_same_store(inc, ref, "load")
    return ref, inc


def _batches(dataset):
    """A deletion, its re-add, a mixed batch (fresh additions with
    deletions) and its inverse, a delete-all and its re-add."""
    dels = pick_batch(dataset, 5, seed=1)
    arity = {p: np.asarray(r).reshape(len(r), -1).shape[1] for p, r in dataset.items()}
    fresh = {p: (np.arange(2 * arity[p]).reshape(2, arity[p]) + 10_000).astype(np.int64)
             for p in list(dataset)[:2]}
    mixed = pick_batch(dataset, 4, seed=2)
    return [({}, dels), (dels, {}), (fresh, mixed), (mixed, fresh), ({}, dataset),
            (dataset, {})]


def _apply_both(ref, inc, batches):
    for k, (adds, dels) in enumerate(batches):
        want = ref.apply(additions=adds, deletions=dels)
        got = inc.apply(additions=adds, deletions=dels)
        assert _stats(got) == _stats(want), k
        _assert_same_store(inc, ref, f"batch {k}")
    inc.check_integrity()
    ref.check_integrity()  # recounts through its plan cache, as the port's did


@pytest.mark.parametrize("name,gen", KBS, ids=[k for k, _ in KBS])
def test_apply_matches_reference(name, gen):
    program, dataset, _ = gen()
    ref, inc = _load_both(program, dataset)
    _apply_both(ref, inc, _batches(dataset))


@pytest.mark.parametrize("counting", [True, False], ids=["counting", "dred"])
@pytest.mark.parametrize("seed", range(4))
def test_random_kb_apply_matches_reference(seed, counting):
    program, dataset = random_kb(np.random.default_rng(seed), n_constants=10, n_facts=30)
    ref, inc = _load_both(program, dataset, counting=counting)
    _apply_both(ref, inc, _batches(dataset))


def _churn(ref, inc, dataset, rounds, size=4):
    for i in range(rounds):
        batch = pick_batch(dataset, size, seed=i)
        _apply_both(ref, inc, [({}, batch), (batch, {})])


def _compaction(cs) -> dict:
    return {k: v for k, v in dataclasses.asdict(cs).items() if k != "time_s"}


@pytest.mark.parametrize(
    "gen,rounds,size",
    [(lambda: lubm_like(n_dept=3, n_students=30, n_courses=6, seed=0), 4, 4),
     (lambda: chain(30), 3, 2)],
    ids=["lubm", "chain"],
)
def test_compact_matches_reference(gen, rounds, size):
    """``compact()`` after churn: the same ``CompactionStats`` (time
    aside), node table and rows; the fact set and query answers are
    unchanged across the swap, and maintenance goes on after it."""
    program, dataset, jd = gen()
    ref, inc = _load_both(program, dataset)
    _churn(ref, inc, dataset, rounds, size)
    assert inc.mu_usage().dead_fraction > 0
    d = Dictionary()
    for i in range(len(jd)):
        d.intern(jd.term_of(i))
    queries = {
        "lubm": ['?s, ?c <- memberOf(?s, "dept0"), takesCourse(?s, ?c)',
                 "?x, ?u <- memberOf(?x, ?d), subOrganizationOf(?d, ?u)"],
        "chain": ['?y <- path("v000003", ?y)', "?x, ?z <- edge(?x, ?y), edge(?y, ?z)"],
    }["lubm" if "memberOf" in dataset else "chain"]
    qe, jqe = QueryEngine(inc, d), JQueryEngine(ref, jd)
    before = [qe.answer(t).answers for t in queries]
    rows_before = inc.to_dict()

    want, got = ref.compact(), inc.compact()
    assert _compaction(got) == _compaction(want)
    assert got.nodes_after < got.nodes_before
    assert inc.mu_usage().n_dead == 0
    assert inc.store.memory_report()["nodes_bytes"] == got.bytes_after
    _assert_same_store(inc, ref, "compacted")
    inc.check_integrity()
    ref.check_integrity()
    after = inc.to_dict()
    assert all(torch.equal(after[p], rows_before[p]) for p in rows_before)
    qe.bump_epoch(inc)
    jqe.bump_epoch(ref)
    for text, b in zip(queries, before):
        res = qe.answer(text)
        assert torch.equal(res.answers, b), text
        assert_array_equal(res.answers.numpy(), jqe.answer(text).answers)
    _apply_both(ref, inc, [({}, pick_batch(dataset, 3, seed=99))])


def test_maybe_compact_matches_reference():
    program, dataset, _ = lubm_like(n_dept=3, n_students=30, n_courses=6, seed=0)
    ref, inc = _load_both(program, dataset)
    assert inc.maybe_compact(threshold=0.99, min_nodes=1) is None
    assert inc.maybe_compact(threshold=0) is None  # disabled
    _churn(ref, inc, dataset, 4)
    frac = inc.mu_usage().dead_fraction
    assert frac == ref.mu_usage().dead_fraction
    assert inc.maybe_compact(threshold=frac + 0.01, min_nodes=1) is None
    want = ref.maybe_compact(0.3, min_nodes=1)
    got = inc.maybe_compact(0.3, min_nodes=1)
    assert want is not None and got is not None
    assert _compaction(got) == _compaction(want)
    _assert_same_store(inc, ref, "maybe_compact")


def _export(ref, **extra) -> dict:
    """A reference store's state as ``incremental_from_numpy``'s input."""
    store = ref.store
    nodes = {}
    for cid in store.live_ids():
        if store.is_leaf(cid):
            rv, rc = store.leaf_payload(cid)
            nodes[cid] = ("leaf", np.asarray(rv), np.asarray(rc))
        else:
            nodes[cid] = ("concat", store.children(cid))
    return dict(
        nodes=nodes, next_id=store._next_id,
        meta_facts=[(mf.predicate, mf.columns, mf.length, mf.round)
                    for p in ref.facts.predicates() for mf in ref.facts.all(p)],
        explicit=ref.explicit, rows={p: ref.rows.rows(p) for p in ref.rows.predicates()},
        counts=ref.counts, epoch=ref.epoch, round_no=ref._round, **extra,
    )


@pytest.mark.parametrize("name,gen", KBS, ids=[k for k, _ in KBS])
def test_carried_state_applies_as_reference(name, gen):
    """The reference's state after batch k carried into the port; batch
    k + 1 applied in both gives the same store."""
    program, dataset, _ = gen()
    ref = JIncrementalStore(program)
    ref.load(dataset)
    batches = _batches(dataset)
    for k in range(len(batches) - 1):
        ref.apply(additions=batches[k][0], deletions=batches[k][1])
        inc = convert.incremental_from_numpy(program, **_export(ref), device="cpu")
        assert inc.store.n_nodes() == ref.store.n_nodes()
        inc.check_integrity()
        adds, dels = batches[k + 1]
        want = ref.apply(additions=adds, deletions=dels)
        got = inc.apply(additions=adds, deletions=dels)
        # plans are compiled afresh in the port, so plan-cache counters differ
        assert ({k: v for k, v in _stats(got).items() if k != "plan_cache"}
                == {k: v for k, v in _stats(want).items() if k != "plan_cache"})
        got_rows, want_rows = inc.to_dict(), ref.to_dict()
        assert set(got_rows) == set(want_rows)
        for pred in want_rows:
            assert_array_equal(got_rows[pred].numpy(), want_rows[pred])
        for pred, c in ref.counts.items():
            assert_array_equal(inc.counts[pred].numpy(), c)
        assert inc.store.n_nodes() == ref.store.n_nodes()
        assert inc.epoch == ref.epoch
        inc.check_integrity()


def test_row_index_matches_reference():
    """``RowIndex`` seed / add / remove / positions against the
    reference's, with the permutation and keep mask they hand out."""
    rng = np.random.default_rng(5)
    for arity in (1, 2, 3):
        rows = rng.integers(0, 50, size=(200, arity))
        ref, idx = JRowIndex(), RowIndex(torch.device("cpu"))
        ref.seed("p", rows)
        idx.seed("p", _t(rows))
        assert_array_equal(idx.rows("p").numpy(), ref.rows("p"))
        fresh = np.unique(rng.integers(50, 90, size=(30, arity)), axis=0)[::-1].copy()
        assert_array_equal(idx.add("p", _t(fresh)).numpy(), ref.add("p", fresh))
        assert_array_equal(idx.rows("p").numpy(), ref.rows("p"))
        probe = ref.rows("p")[rng.choice(ref.n_rows("p"), 25, replace=False)]
        assert_array_equal(idx.positions("p", _t(probe)).numpy(), ref.positions("p", probe))
        mixed = np.concatenate([probe, fresh + 1000])
        assert_array_equal(idx.member_mask("p", _t(mixed)).numpy(),
                           ref.member_mask("p", mixed))
        assert_array_equal(idx.remove("p", _t(probe)).numpy(), ref.remove("p", probe))
        assert_array_equal(idx.rows("p").numpy(), ref.rows("p"))
        assert idx.add("q", _t(fresh)).tolist() == ref.add("q", fresh).tolist()


def test_facade_equals_wrappers_and_meters_no_cpu_call():
    """The facade's functions give their wrappers' results, and CPU calls
    are not metered (the meter counts card launches)."""
    ops.meter_reset()
    rng = np.random.default_rng(0)
    a = _t(rng.integers(0, 100, 300))
    b = torch.unique(_t(rng.integers(0, 100, 80)))
    assert torch.equal(ops.member(a, b), sorted_member(a, b))
    assert torch.equal(ops.anti_join_mask(a, b), ~sorted_member(a, b))
    vals, counts = _t(np.arange(5)), _t(np.array([3, 0, 2, 1, 4]))
    assert torch.equal(ops.expand_rle(vals, counts, 10), rle_expand(vals, counts, 10))
    for got, want in zip(ops.group_spans(a, b), join_bounds(a, b)):
        assert torch.equal(got, want)
    l32, r32 = a.to(torch.int32), torch.sort(a.to(torch.int32)).values
    got = ops.join_dedup(l32, l32, r32, r32, capacity=512)
    want = fused_join_dedup(l32, l32, r32, r32, 512)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    buf = torch.full((128,), torch.iinfo(torch.int64).max, dtype=torch.int64)
    buf[:3] = torch.tensor([1, 5, 9])
    fresh = torch.tensor([2, 5, 7])
    for g, w in zip(ops.merge_unique(buf, fresh), merge_sorted_unique(buf, fresh)):
        assert torch.equal(g, w)
    assert ops.meter() == {}
    assert ops.launch_count() == 0
