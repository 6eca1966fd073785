"""The port's query subsystem against the JAX package's, on the CPU.

Both packages' engines are built from the same generator output (the
port gets a dictionary with the same ids), then answer the same queries:
parse and plan text, answers, every non-timing ``ExecStats`` field,
``BatchStats``, ``FrozenFacts`` statistics, the serving caches' counters,
``in_set`` (against the reference's Pallas kernel in interpret mode and
its numpy path) and ``OntologyBuilder`` must agree exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import CMatEngine as JCMatEngine
from repro.core import MetaFact as JMetaFact
from repro.core.frozen import FrozenFacts as JFrozenFacts
from repro.core.generators import chain, lubm_like, paper_example, random_kb, star
from repro.core.owl2rl import OntologyBuilder as JOntologyBuilder
from repro.kernels.lookup import in_set as j_in_set
from repro.query import QueryEngine as JQueryEngine
from repro.query import answer_flat as j_answer_flat
from repro.query import parse_query as j_parse_query
from repro.query import plan_query as j_plan_query
from repro_torch.core import CMatEngine, Dictionary, MetaFact
from repro_torch.core.frozen import FrozenFacts
from repro_torch.core.owl2rl import OntologyBuilder
from repro_torch.kernels.lookup import in_set
from repro_torch.query import QueryEngine, answer_flat, parse_query, plan_query
from test_query import CHAIN_QUERIES, LUBM_QUERIES, PAPER_QUERIES, STAR_QUERIES

REPO = Path(__file__).resolve().parents[1]

#: ``benchmarks/bench_query.py``'s smoke KBs and queries
BENCH_SMOKE = [
    ("bench-lubm", lambda: lubm_like(n_dept=4, n_students=60, n_courses=10, seed=0), [
        '?s, ?c <- memberOf(?s, "dept3"), takesCourse(?s, ?c)',
        '?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)',
        '?s <- takesCourse(?s, "course7"), GraduateStudent(?s)',
        '?x, ?u <- memberOf(?x, ?dv), subOrganizationOf(?dv, ?u)',
    ]),
    ("bench-chain", lambda: chain(n=30), [
        '?y <- path("v000003", ?y)',
        '?x, ?z <- edge(?x, ?y), path(?y, ?z)',
    ]),
    ("bench-paper", lambda: paper_example(n=32, m=12), [
        "?x, ?y <- S(?x, ?y)",
        '?x, ?z <- P(?x, ?y), T(?y, ?z)',
    ]),
]

#: ``tests/test_query.py``'s ``TestDifferential`` KBs and queries
DIFFERENTIAL = [
    ("lubm", lambda: lubm_like(n_dept=6, n_students=100, n_courses=12, seed=1), LUBM_QUERIES),
    ("paper", lambda: paper_example(n=6, m=4), PAPER_QUERIES),
    ("chain", lambda: chain(n=40), CHAIN_QUERIES),
    ("star", lambda: star(n_spokes=60, n_hubs=3), STAR_QUERIES),
]

KBS = {name: gen for name, gen, _ in DIFFERENTIAL + BENCH_SMOKE}
KBS["lookup"] = lambda: lubm_like(n_dept=4, n_students=60, n_courses=8, seed=2)

RANDOM_QUERIES = [
    "?x, ?y <- P(?x, ?y)",
    "?x <- P(?x, ?y), Q(?y, ?z)",
    "?x <- P(?x, ?x)",
    "?x, ?z <- P(?x, ?y), Q(?x, ?z)",
]

ENGINE_STATS = ("rounds", "n_meta_facts", "n_facts", "rule_applications_skipped")


def _port_dictionary(jd) -> Dictionary:
    """The port's dictionary holding the reference's terms at the same ids."""
    d = Dictionary()
    for i in range(len(jd)):
        d.intern(jd.term_of(i))
    return d


def _materialise(program, dataset, **kw):
    ref = JCMatEngine(program, **kw)
    ref.load(dataset)
    ref_stats = ref.materialise()
    eng = CMatEngine(program, device="cpu", **kw)
    eng.load(dataset)
    stats = eng.materialise()
    return ref, eng, ref_stats, stats


@functools.lru_cache(maxsize=None)
def _kb(name: str):
    """``(ref_engine, port_engine, ref_dict, port_dict)`` of one KB (each
    engine materialised once per module; queries release their scratch,
    so sharing them is safe)."""
    program, dataset, jd = KBS[name]()
    kw = {"dedup_index": True} if name.startswith("bench-") else {}
    ref, eng, ref_stats, stats = _materialise(program, dataset, **kw)
    for f in ENGINE_STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    return ref, eng, jd, _port_dictionary(jd)


def _stats(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items() if k != "time_s"}


def _assert_same_result(got, want, text=""):
    assert got.answers.dtype == torch.int64
    assert tuple(got.answers.shape) == want.answers.shape, text
    assert_array_equal(got.answers.numpy(), want.answers, err_msg=text)
    assert got.plan.explain() == want.plan.explain(), text
    assert _stats(got.stats) == _stats(want.stats), text
    assert got.from_cache == want.from_cache, text


def _flat(eng) -> dict[str, torch.Tensor]:
    return eng.materialisation()


# --------------------------------------------------------------------- #
# parse and plan
# --------------------------------------------------------------------- #
PLANNER_QUERIES = [
    '?s, ?c <- takesCourse(?s, ?c), memberOf(?s, "dept2")',
    "?s, ?p, ?c <- takesCourse(?s, ?c), teacherOf(?p, ?c), advisor(?s, ?p)",
    "?s, ?c <- takesCourse(?s, ?c)",
    "?x <- noSuchPred(?x, ?y)",
    '?s, ?c, ?p <- Professor(?p), memberOf(?s, "dept1"), takesCourse(?s, ?c)',
    '?s <- memberOf(?s, "dept1")',
    'Q(?x, ?y) <- S(?x, ?y), P(?x, "e2")',
    '<- Professor("prof1")',
]


@pytest.mark.parametrize("text", PLANNER_QUERIES)
def test_parse_and_plan_match_reference(text):
    """``TestPlanner``'s cases (and an atom-style head, an ASK): the
    parsed query's text forms and the plan's ``explain()``, before and
    after the snapshots it needs exist."""
    ref, eng, jd, d = _kb("lubm")
    jq, q = j_parse_query(text, jd), parse_query(text, d)
    assert str(q) == str(jq)
    assert q.to_text(d) == jq.to_text(jd)
    assert parse_query(str(q)) == q and parse_query(q.to_text(d), d) == q
    jf, f = ref.facts.freeze(), eng.facts.freeze()
    assert plan_query(q, f).explain() == j_plan_query(jq, jf).explain()
    for atom in q.body:  # exact selectivities once snapshots exist
        if atom.predicate in f.predicates():
            f.snapshot(atom.predicate)
            jf.snapshot(atom.predicate)
    assert plan_query(q, f).explain() == j_plan_query(jq, jf).explain()


# --------------------------------------------------------------------- #
# answers and ExecStats
# --------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "name,queries",
    [(n, q) for n, _, q in DIFFERENTIAL + BENCH_SMOKE],
    ids=[n for n, _, _ in DIFFERENTIAL + BENCH_SMOKE],
)
def test_answers_and_stats_match_reference(name, queries):
    """``TestDifferential``'s KBs and ``bench_query.py``'s smoke queries:
    answers, plans and every non-timing ``ExecStats`` field, cold and
    from the result cache; the flat oracle agrees with the reference's."""
    ref, eng, jd, d = _kb(name)
    jqe, qe = JQueryEngine(ref, jd), QueryEngine(eng, d)
    jflat, flat = ref.materialisation(), _flat(eng)
    for _ in range(2):  # the second pass is served from the result cache
        for text in queries:
            want, got = jqe.answer(text), qe.answer(text)
            _assert_same_result(got, want, text)
            assert_array_equal(answer_flat(qe.parse(text), flat).numpy(),
                               j_answer_flat(jqe.parse(text), jflat), err_msg=text)
            assert_array_equal(got.answers.numpy(),
                               answer_flat(qe.parse(text), flat).numpy(), err_msg=text)
    assert qe.cache_stats() == jqe.cache_stats()


@pytest.mark.parametrize("seed", range(4))
def test_random_kb_matches_reference(seed):
    """Seeded ``random_kb`` KBs: the CMat run's ``rounds`` and
    ``n_meta_facts`` (and the other engine stats), then
    ``TestDifferential.test_random_kbs``'s queries."""
    program, dataset = random_kb(np.random.default_rng(seed), n_constants=10, n_facts=30)
    ref, eng, ref_stats, stats = _materialise(program, dataset)
    for f in ENGINE_STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    jqe, qe = JQueryEngine(ref), QueryEngine(eng)
    flat = _flat(eng)
    for text in RANDOM_QUERIES:
        want, got = jqe.answer(j_parse_query(text)), qe.answer(parse_query(text))
        _assert_same_result(got, want, text)
        assert torch.equal(got.answers, answer_flat(parse_query(text), flat))


# --------------------------------------------------------------------- #
# in_set
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n_constants", [0, 1, 37])
@pytest.mark.parametrize("n_values", [0, 700])
def test_in_set_matches_reference(n_values, n_constants, dtype):
    """The port's ``in_set`` (on the CPU: the plain ``sorted_member``)
    against the reference's Pallas ``sorted_member`` in interpret mode
    and its numpy path, on seeded values."""
    rng = np.random.default_rng([n_values, n_constants, np.dtype(dtype).itemsize])
    values = rng.integers(0, 90, size=n_values).astype(dtype)
    constants = rng.integers(0, 90, size=n_constants).astype(dtype)
    got = in_set(torch.as_tensor(values), torch.as_tensor(constants))
    assert got.dtype == torch.bool and got.shape == (n_values,)
    for use_pallas in (True, False):
        want = j_in_set(values, constants, use_pallas=use_pallas, interpret=True)
        assert_array_equal(got.numpy(), np.asarray(want))
    assert_array_equal(got.numpy(), np.isin(values, constants))
    # a sequence of ids works as the constants too
    assert torch.equal(in_set(torch.as_tensor(values), constants.tolist()), got)


def test_lookup_path_matches_reference():
    """``test_pallas_lookup_path``'s queries: a two-constant atom, whose
    second constant filters the anchor's slice through ``in_set``, against
    the reference with ``use_pallas=True``."""
    ref, eng, jd, d = _kb("lookup")
    jqe, qe = JQueryEngine(ref, jd, use_pallas=True, interpret=True), QueryEngine(eng, d)
    flat = _flat(eng)
    row = flat["takesCourse"][0]
    s, c = jd.term_of(int(row[0])), jd.term_of(int(row[1]))
    for text in [f'<- takesCourse("{s}", "{c}")', f'<- takesCourse("{s}", "prof0")',
                 '?p <- advisor("student3", ?p), teacherOf(?p, "course2")']:
        want, got = jqe.answer(text), qe.answer(text)
        _assert_same_result(got, want, text)
        assert torch.equal(got.answers, answer_flat(qe.parse(text), flat))
    assert qe.answer(f'<- takesCourse("{s}", "{c}")').ask
    assert not qe.answer(f'<- takesCourse("{s}", "prof0")').ask


# --------------------------------------------------------------------- #
# FrozenFacts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["lubm", "paper", "star"])
def test_frozen_facts_match_reference(name):
    """Per predicate (and one it lacks): ``n_rows``, ``arity``,
    ``approx_distinct``, ``selectivity`` before and after the snapshot,
    the snapshot itself, ``count_eq`` and ``eq_slice`` of every value and
    of a missing one, and the byte reports."""
    ref, eng, _, _ = _kb(name)
    jf, f = ref.facts.freeze(), eng.facts.freeze()
    preds = sorted(jf.predicates())
    assert sorted(f.predicates()) == preds
    for pred in preds + ["noSuchPred"]:
        assert f.n_rows(pred) == jf.n_rows(pred)
        assert f.arity(pred) == jf.arity(pred)
        for pos in range(jf.arity(pred)):
            assert f.approx_distinct(pred, pos) == jf.approx_distinct(pred, pos)
            assert f.selectivity(pred, pos, 3) == jf.selectivity(pred, pos, 3)
        assert not f.has_snapshot(pred)
        assert_array_equal(f.snapshot(pred).numpy(), jf.snapshot(pred))
        assert f.has_snapshot(pred) and f.sorted_rows(pred).n_rows == jf.sorted_rows(pred).n_rows
        rows = jf.snapshot(pred)
        for pos in range(rows.shape[1] if rows.shape[0] else 0):
            for value in [*np.unique(rows[:, pos]).tolist(), -1, 10**9]:
                assert f.count_eq(pred, pos, value) == jf.count_eq(pred, pos, value)
                assert f.selectivity(pred, pos, value) == jf.selectivity(pred, pos, value)
                assert_array_equal(f.eq_slice(pred, pos, value).numpy(),
                                   jf.eq_slice(pred, pos, value))
        got, want = f.sorted_rows(pred).memory_report(), jf.sorted_rows(pred).memory_report()
        # the reference files np.unique's reshaped view under its backed
        # bytes; the port's rows own their storage: the totals agree
        assert got.keys() == want.keys()
        assert got["lazy_order_bytes"] == want["lazy_order_bytes"]
        assert (got["rows_bytes"] + got["rows_snapshot_backed_bytes"]
                == want["rows_bytes"] + want["rows_snapshot_backed_bytes"])
        assert sum(got.values()) == f.sorted_rows(pred).nbytes
        assert not f.sorted_rows(pred).snapshot_backed
    got, want = f.memory_report(), jf.memory_report()
    assert got.keys() == want.keys()
    assert got["n_snapshots"] == want["n_snapshots"]
    assert (got["snapshots_bytes"] + got["snapshots_snapshot_backed_bytes"]
            == want["snapshots_bytes"] + want["snapshots_snapshot_backed_bytes"])
    assert f.snapshot_cells == jf.snapshot_cells
    assert f.snapshot_resident_bytes() + f.snapshot_backed_bytes() == (
        jf.snapshot_resident_bytes() + jf.snapshot_backed_bytes())


def test_frozen_facts_seed_rows_and_pin_meta_match_reference():
    """Seeded snapshots are served as given (nothing unfolded); a pinned
    freeze keeps its meta-fact lists when the store gains a fact later,
    an unpinned one sees it — in both packages."""
    ref, eng, _, _ = _kb("paper")
    rows = np.unique(ref.materialisation()["P"], axis=0)
    block = np.concatenate([rows, rows])
    jf = JFrozenFacts(ref.facts, seed_rows={"P": block[: rows.shape[0]]})
    tblock = torch.as_tensor(block)
    f = FrozenFacts(eng.facts, seed_rows={"P": tblock[: rows.shape[0]]})
    assert f.has_snapshot("P") and jf.has_snapshot("P")
    assert_array_equal(f.snapshot("P").numpy(), jf.snapshot("P"))
    assert f.snapshot_cells == jf.snapshot_cells == 0
    value = int(rows[0, 1])
    assert f.count_eq("P", 1, value) == jf.count_eq("P", 1, value)
    # the seeded rows view a larger block: reported apart from the owned
    # bytes, which are the lazily built orders alone
    assert f.sorted_rows("P").snapshot_backed
    assert f.snapshot_backed_bytes() == rows.nbytes
    assert f.snapshot_resident_bytes() == f.sorted_rows("P").memory_report()["lazy_order_bytes"] > 0

    program, dataset, _ = paper_example()
    ref, eng, _, _ = _materialise(program, dataset)
    counts = {}
    for pkg, e, frozen_cls, mf_cls, vec in (
        ("ref", ref, JFrozenFacts, JMetaFact, np.arange(3)),
        ("port", eng, FrozenFacts, MetaFact, torch.arange(3)),
    ):
        pinned = frozen_cls(e.facts, pin_meta=True)
        live = frozen_cls(e.facts)
        n0 = pinned.n_rows("P")
        e.facts.add(mf_cls("P", (e.store.new_leaf(vec), e.store.new_leaf(vec)), 3))
        counts[pkg] = (pinned.pinned, live.pinned, n0, pinned.n_rows("P"),
                       len(pinned.meta_facts("P")), live.n_rows("P"),
                       len(live.meta_facts("P")), sorted(pinned.predicates()))
        assert pinned.n_rows("P") == n0 and live.n_rows("P") == n0 + 3
    assert counts["port"] == counts["ref"]


# --------------------------------------------------------------------- #
# store hygiene
# --------------------------------------------------------------------- #
def test_mark_release_restore_the_store_like_the_reference():
    """Scratch nodes (leaves, constants, a concat, their unfoldings)
    above a mark are dropped by ``release``: node count, id counter, byte
    report and parent links as before, in both packages; and a repeated
    query stream leaves the store as its first pass did."""
    program, dataset, _ = paper_example()
    ref, eng, _, _ = _materialise(program, dataset)
    seen = {}
    for pkg, e, vec in (("ref", ref, np.arange(4)), ("port", eng, torch.arange(4))):
        store = e.store
        before = (store.n_nodes(), store._next_id, dict(store.memory_report()),
                  {k: set(v) for k, v in store._parents.items() if v})
        mark = store.mark()
        a = store.new_constant(7, 5)
        b = store.new_leaf(vec)
        c = store.new_concat([a, b, 0])
        store.unfold(c)
        store.unfold(a)
        assert store._next_id == mark + 3 and 0 in store._parents
        store.release(mark)
        after = (store.n_nodes(), store._next_id, dict(store.memory_report()),
                 {k: set(v) for k, v in store._parents.items() if v})
        assert after == before
        assert all(cid < mark for cid in store._nodes)
        assert all(cid < mark for cid in store._unfold_cache)
        seen[pkg] = (before[0], before[1])
    assert seen["port"] == seen["ref"]

    ref, eng, jd, d = _kb("lubm")
    text = '?s, ?c <- memberOf(?s, "dept1"), takesCourse(?s, ?c)'
    for qe in (QueryEngine(eng, d, result_cache_size=0),
               JQueryEngine(ref, jd, result_cache_size=0)):
        qe.answer(text)  # builds snapshots
        store = qe.frozen.store
        n0, next0, mem0 = store.n_nodes(), store._next_id, dict(store.memory_report())
        for _ in range(5):
            qe.answer(text)
        assert (store.n_nodes(), store._next_id) == (n0, next0)
        assert store.memory_report() == mem0
    assert (eng.store.n_nodes(), eng.store._next_id) == (ref.store.n_nodes(), ref.store._next_id)


# --------------------------------------------------------------------- #
# answer_batch
# --------------------------------------------------------------------- #
def test_answer_batch_matches_reference():
    """Shared-plan micro-batches: a 32-query single-slot group (constants
    unknown past ``dept5`` collapse onto one query), an ASK group, a
    duplicate, two-slot and constant-free singles; then the same batch
    again, from the cache.  Results, ``BatchStats`` and cache counters."""
    ref, eng, jd, d = _kb("lubm")
    batch = [f'?s, ?c <- memberOf(?s, "dept{k}"), takesCourse(?s, ?c)' for k in range(32)]
    batch += [f'<- memberOf("student{k}", "dept1")' for k in range(6)]
    batch += [batch[3], "?s, ?p <- advisor(?s, ?p)",
              '?c <- takesCourse("student1", ?c), teacherOf("prof1", ?c)']
    for min_group in (2, 2, 40):
        jqe, qe = JQueryEngine(ref, jd), QueryEngine(eng, d)
        for _ in range(2):
            want, wstats = jqe.answer_batch(batch, min_group=min_group)
            got, gstats = qe.answer_batch(batch, min_group=min_group)
            assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)
            for text, g, w in zip(batch, got, want):
                _assert_same_result(g, w, text)
            assert qe.cache_stats() == jqe.cache_stats()
    flat = _flat(eng)
    for text, g in zip(batch, got):
        assert torch.equal(g.answers, answer_flat(qe.parse(text), flat)), text


# --------------------------------------------------------------------- #
# OntologyBuilder
# --------------------------------------------------------------------- #
def _ontology(builder_cls):
    return (
        builder_cls()
        .sub_class_of("GraduateStudent", "Student")
        .sub_class_of("Student", "Person")
        .sub_class_of("Professor", "Person")
        .domain("teacherOf", "Professor")
        .range("teacherOf", "Course")
        .domain("advisor", "Student")
        .range("advisor", "Professor")
        .property_chain("advisor", "teacherOf", "advisedCourse")
        .sub_property_of("advisor", "knows")
    )


def _query_kb_dataset(jd):
    """``examples/query_kb.py::build_kb``'s explicit facts, rebuilt."""
    profs = jd.intern_many([f"prof{i}" for i in range(4)])
    students = jd.intern_many([f"student{i}" for i in range(12)])
    courses = jd.intern_many([f"course{i}" for i in range(6)])
    depts = jd.intern_many(["cs", "math"])
    rng = np.random.default_rng(7)
    return {
        "teacherOf": np.stack([profs[rng.integers(0, 4, 6)], courses], axis=1),
        "takesCourse": np.stack(
            [np.repeat(students, 2), courses[rng.integers(0, 6, 24)]], axis=1),
        "advisor": np.stack([students, profs[rng.integers(0, 4, 12)]], axis=1),
        "memberOf": np.stack([profs, depts[rng.integers(0, 2, 4)]], axis=1),
        "GraduateStudent": students[::2].reshape(-1, 1),
    }


def test_ontology_builder_matches_reference():
    """Every axiom template gives the reference's rules; the example KB's
    ontology materialises to the reference's facts and answers its three
    queries alike."""
    def every_axiom(cls):
        return (cls().sub_class_of("A", "B").intersection_of("A", "B", "C")
                .some_values_from("p", "C", "D").sub_property_of("p", "q")
                .domain("p", "A").range("p", "B").transitive("p").symmetric("q")
                .inverse_of("p", "r").property_chain("p", "q", "s"))

    for make in (every_axiom, _ontology):
        got, want = make(OntologyBuilder).build(), make(JOntologyBuilder).build()
        assert [str(r) for r in got] == [str(r) for r in want]
        def atoms(prog):
            return [[(a.predicate, a.terms) for a in (r.head, *r.body)] for r in prog]

        assert atoms(got) == atoms(want)

    from repro.core import Dictionary as JDictionary

    jd = JDictionary()
    dataset = _query_kb_dataset(jd)
    ref = JCMatEngine(_ontology(JOntologyBuilder).build())
    ref.load(dataset)
    ref_stats = ref.materialise()
    eng = CMatEngine(_ontology(OntologyBuilder).build(), device="cpu")
    eng.load(dataset)
    stats = eng.materialise()
    for f in ENGINE_STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    want = ref.materialisation()
    got = eng.materialisation()
    assert set(got) == set(want)
    for pred in want:
        assert_array_equal(got[pred].numpy(), np.unique(want[pred], axis=0))
    d = _port_dictionary(jd)
    jqe, qe = JQueryEngine(ref, jd), QueryEngine(eng, d)
    for text in [
        '?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)',
        '?p <- Professor(?p), memberOf(?p, "cs")',
        '?s, ?c <- advisedCourse(?s, ?c), GraduateStudent(?s)',
    ]:
        w, g = jqe.answer(text), qe.answer(text)
        _assert_same_result(g, w, text)
        assert qe.decode(g.answers) == jqe.decode(w.answers)


# --------------------------------------------------------------------- #
# the serving caches
# --------------------------------------------------------------------- #
def test_engine_caches_match_reference():
    """Plan and result caches, LRU eviction, epoch bumps and their stale
    evictions, cache peeks, unknown constants (the dictionary must not
    grow) and an empty dictionary: equal counters after every step."""
    ref, eng, jd, d = _kb("lookup")
    texts = [f'?s <- memberOf(?s, "dept{i}")' for i in range(3)]
    texts += ["?s, ?p <- advisor(?s, ?p)", '?s <- memberOf(?s, "nosuch1")']
    jqe = JQueryEngine(ref, jd, result_cache_size=2, plan_cache_size=3)
    qe = QueryEngine(eng, d, result_cache_size=2, plan_cache_size=3)
    n_terms = len(d)
    steps = [("answer", t) for t in texts] + [("answer", texts[0]), ("plan", texts[3]),
                                              ("plan", texts[3]), ("cached", texts[4]),
                                              ("cached", texts[0]), ("bump", None)]
    steps += [("answer", t) for t in texts[::-1]] + [("explain", texts[1])]
    for op, text in steps:
        for e, src in ((qe, eng), (jqe, ref)):
            if op == "bump":
                e.bump_epoch(src)
            else:
                getattr(e, op)(text)
        assert qe.cache_stats() == jqe.cache_stats(), (op, text)
        assert len(qe._result_cache) == len(jqe._result_cache)
        assert len(qe._plan_cache) == len(jqe._plan_cache)
        assert qe.epoch == jqe.epoch
    assert len(d) == n_terms

    # a caller mutating its answers in place cannot poison the cache
    first = qe.answer(texts[3])
    keep = first.answers.clone()
    first.answers[:] = -1
    again = qe.answer(texts[3])
    assert again.from_cache and torch.equal(again.answers, keep)
    again.answers[:] = -2
    assert torch.equal(qe.answer(texts[3]).answers, keep)

    # an empty Dictionary is still a dictionary: unknown terms stay unknown
    program, dataset = random_kb(np.random.default_rng(3), n_constants=8, n_facts=20)
    _, e, _, _ = _materialise(program, dataset)
    assert QueryEngine(e, Dictionary()).answer('?x <- P(?x, "unknownTerm")').n_answers == 0


def test_query_lists_are_the_reference_tests():
    """``chip_smoke.py`` answers ``tests/test_query.py``'s query lists on
    the card: its copies must stay equal to them."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.LUBM_QUERIES == LUBM_QUERIES
    assert smoke.PAPER_QUERIES == PAPER_QUERIES
    assert smoke.CHAIN_QUERIES == CHAIN_QUERIES
    assert smoke.STAR_QUERIES == STAR_QUERIES
    assert [q for *_, qs in smoke.BENCH_QUERY_KBS for q in qs] == [
        q for _, _, qs in BENCH_SMOKE for q in qs]
