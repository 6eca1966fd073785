"""The port's derivation provenance against the JAX package's, on the CPU.

The same seeded inputs go through both packages with both journals on
(``repro.obs.provenance`` and ``repro_torch.obs.provenance``); the
reference's Pallas paths run as its own tests run them on the CPU.  Held
equal: journal records, every slot but ``time_ns`` (host time, which
differs between the packages), after CMat (both tails), Flat, the
one-shard distributed engine (``materialise``, ``apply``,
``merge_shard_records``) and every ``IncrementalStore.apply`` batch;
proof trees (``proof_to_json``); journal payloads (and each package loads
the other's); the ``rule.*`` gauges and ``hot_rules`` by ``rule_id``; the
checkpoint sidecar both ways; ``MemorySampler`` on one span sequence.
Turning the journal on changes no fact set.  The fixture below enables
both journals and restores them (``tests/conftest.py`` checks the
reference's only)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import repro.obs.memory as jmemory
import repro.obs.metrics as jmetrics
import repro.obs.provenance as jprov
import repro.obs.trace as jtrace
import repro_torch.obs.memory as tmemory
import repro_torch.obs.metrics as tmetrics
import repro_torch.obs.provenance as tprov
import repro_torch.obs.trace as ttrace
from repro.core import CMatEngine as JCMatEngine
from repro.core import FlatEngine as JFlatEngine
from repro.core.datalog import Atom, Program, Rule
from repro.core.generators import bipartite, chain, lubm_like, paper_example, star
from repro.incremental import IncrementalStore as JIncrementalStore
from repro.storage import CheckpointManager as JCheckpointManager
from repro_torch.core import CMatEngine, FlatEngine
from repro_torch.incremental import IncrementalStore
from repro_torch.obs import get_tracer
from repro_torch.storage import CheckpointManager

WORKLOADS = [
    ("paper", lambda: paper_example(n=30, m=20)),
    ("chain", lambda: chain(n=60)),
    ("lubm", lambda: lubm_like(n_dept=4, n_students=60, n_courses=10)),
    ("star", lambda: star(n_spokes=80, n_hubs=3)),
    ("bipartite", lambda: bipartite(n_left=30, n_right=30)),
]
WL_IDS = [w[0] for w in WORKLOADS]

TC_PROGRAM = Program([
    Rule(head=Atom("path", ("X", "Y")), body=(Atom("edge", ("X", "Y")),)),
    Rule(
        head=Atom("path", ("X", "Z")),
        body=(Atom("path", ("X", "Y")), Atom("edge", ("Y", "Z"))),
    ),
])
DIAMOND = np.array([[0, 1], [0, 2], [1, 3], [2, 3]], np.int64)
CHAIN8 = np.array([[i, i + 1] for i in range(8)], np.int64)


def _reset(journal) -> None:
    journal.clear()
    journal.configure(max_records=100_000)
    journal.begin_epoch(0)
    journal.rule_strs.clear()


@pytest.fixture
def journals():
    """Both packages' journals on, empty, uncapped and at epoch 0;
    restored after."""
    pair = (jprov.get_journal(), tprov.get_journal())
    was = [j.enabled for j in pair]
    for j in pair:
        j.enabled = True
        _reset(j)
    yield pair
    for j, w in zip(pair, was):
        j.enabled = w
        _reset(j)
    jmetrics.get_registry().reset("rule.")
    tmetrics.get_registry().reset("rule.")


def _untimed(journal) -> list:
    return [r.to_list()[:-1] for r in journal.records]


def _payload_untimed(payload: dict) -> dict:
    out = dict(payload)
    out["records"] = [r[:-1] for r in payload["records"]]
    out["costs"] = {
        rid: {k: v for k, v in c.items() if k != "time_ns"}
        for rid, c in payload["costs"].items()
    }
    return out


def _by_rule(hot: list[dict]) -> dict:
    return {h["rule_id"]: {k: v for k, v in h.items() if k != "time_ns"} for h in hot}


def _tree(node):
    return None if node is None else json.loads(tprov.proof_to_json(node))


def _assert_verified(node):
    assert node is not None and node["verified"] is True
    for child in node["children"]:
        _assert_verified(child)


def _derived(mat, explicit) -> list[tuple[str, tuple]]:
    """(pred, terms) pairs of the materialisation that are not explicit."""
    out = []
    for pred in sorted(mat):
        rows = np.asarray(mat[pred]).reshape(len(mat[pred]), -1)
        exp = explicit.get(pred)
        seen = set() if exp is None else {
            tuple(map(int, r)) for r in np.asarray(exp).reshape(-1, rows.shape[1])
        }
        out += [(pred, t) for t in map(lambda r: tuple(map(int, r)), rows) if t not in seen]
    return out


def _cmat_pair(program, dataset, fused=False):
    ref = JCMatEngine(program, fused=fused)
    ref.load(dataset)
    ref.materialise()
    eng = CMatEngine(program, fused=fused, device="cpu")
    eng.load(dataset)
    eng.materialise()
    return ref, eng


def _assert_trees_equal(ref, eng, targets):
    assert targets
    for pred, terms in targets:
        want = ref.explain_fact(pred, terms)
        got = eng.explain_fact(pred, terms)
        assert _tree(got) == want, (pred, terms)
        if want is not None:
            _assert_verified(got)


# --------------------------------------------------------------------- #
# off by default, inert, and the engines' records
# --------------------------------------------------------------------- #
def test_journal_off_by_default_and_records_nothing():
    journal = tprov.get_journal()
    assert journal.enabled is False
    program, dataset, _ = chain(n=10)
    eng = CMatEngine(program, device="cpu")
    eng.load(dataset)
    eng.materialise()
    assert eng._journal is None and not journal.records


@pytest.mark.parametrize("fused", [False, True], ids=["per-step", "fused"])
@pytest.mark.parametrize("name,gen", WORKLOADS, ids=WL_IDS)
def test_cmat_records_match_reference(name, gen, fused, journals):
    jj, tj = journals
    program, dataset, _ = gen()
    tj.enabled = False
    off = CMatEngine(program, fused=fused, device="cpu")
    off.load(dataset)
    off.materialise()
    tj.enabled = True
    ref, eng = _cmat_pair(program, dataset, fused)
    assert tj.records and _untimed(tj) == _untimed(jj)
    on, base = eng.materialisation(), off.materialisation()
    assert set(on) == set(base)
    for pred in base:
        assert torch.equal(on[pred], base[pred])


@pytest.mark.parametrize("name,gen", WORKLOADS, ids=WL_IDS)
def test_flat_records_match_reference(name, gen, journals):
    jj, tj = journals
    program, dataset, _ = gen()
    tj.enabled = False
    base = FlatEngine(program, device="cpu")
    base.load(dataset)
    base = base.materialise()
    tj.enabled = True
    ref = JFlatEngine(program)
    ref.load(dataset)
    ref.materialise()
    eng = FlatEngine(program, device="cpu")
    eng.load(dataset)
    on = eng.materialise()
    assert tj.records and _untimed(tj) == _untimed(jj)
    assert set(on) == set(base)
    for pred in base:
        assert torch.equal(on[pred], base[pred])


def test_distributed_records_match_reference(journals):
    """One shard: materialise, a delete + add ``apply``, and the shard
    records merged at ``check_integrity``."""
    import jax
    from jax.sharding import Mesh

    from repro.core.distributed import DistributedEngine as JDistributedEngine
    from repro_torch.core.distributed import DistributedEngine

    jj, tj = journals
    dataset = {"edge": np.array([[i, i + 1] for i in range(10)], np.int64)}
    ref = JDistributedEngine(TC_PROGRAM, Mesh(np.asarray(jax.devices()), ("data",)),
                             capacity=512)
    eng = DistributedEngine(TC_PROGRAM, device="cpu", capacity=512)
    batch = {"deletions": {"edge": np.array([[4, 5]], np.int64)},
             "additions": {"edge": np.array([[4, 6]], np.int64)}}
    hosts = []
    for e, Inc, kw in ((ref, JIncrementalStore, {}), (eng, IncrementalStore, {"device": "cpu"})):
        e.materialise(dict(dataset))
        e.apply(**batch)
        host = Inc(TC_PROGRAM, **kw)
        host.load(dict(dataset))
        host.apply(**batch)
        hosts.append(host)
    assert {"apply", "schedule", "overdelete"} <= {r.kind for r in tj.records}
    assert _untimed(tj) == _untimed(jj)
    ref.check_integrity(hosts[0])
    eng.check_integrity(hosts[1])
    assert _untimed(tj) == _untimed(jj)
    keys = [r.key() for r in tj.records if r.kind == "apply" and r.engine == "dist"]
    assert len(keys) == len(set(keys)), "shard records not merged"


def _inc_batches(name):
    if name == "diamond":
        return TC_PROGRAM, {"edge": DIAMOND}, [
            ({}, {"edge": np.array([[1, 3]], np.int64)}),
            ({"edge": np.array([[1, 3], [3, 4]], np.int64)}, {}),
        ]
    program, dataset, _ = lubm_like(n_dept=3, n_students=30, n_courses=6)
    rng = np.random.default_rng(0)
    batches = []
    for pred in ("takesCourse", "advisor"):
        rows = np.asarray(dataset[pred])
        pick = rows[rng.choice(rows.shape[0], size=3, replace=False)]
        batches += [({}, {pred: pick}), ({pred: pick}, {})]
    return program, dataset, batches


@pytest.mark.parametrize("counting", [True, False], ids=["counting", "dred"])
@pytest.mark.parametrize("name", ["diamond", "lubm"])
def test_incremental_records_match_reference(name, counting, journals):
    jj, tj = journals
    program, dataset, batches = _inc_batches(name)
    ref = JIncrementalStore(program, counting=counting)
    inc = IncrementalStore(program, counting=counting, device="cpu")
    ref.load(dataset)
    inc.load(dataset)
    assert _untimed(tj) == _untimed(jj)
    for adds, dels in batches:
        ref.apply(additions=adds, deletions=dels)
        inc.apply(additions=adds, deletions=dels)
        assert _untimed(tj) == _untimed(jj)
        assert tj.epoch == jj.epoch == inc.epoch
    assert {r.kind for r in tj.records if r.engine == "inc"}


# --------------------------------------------------------------------- #
# proof trees
# --------------------------------------------------------------------- #
def test_chain_tc_every_derived_fact(journals):
    program, dataset, _ = chain(n=20)
    ref, eng = _cmat_pair(program, dataset)
    _assert_trees_equal(ref, eng, _derived(ref.materialisation(), dataset))


def test_paper_example_every_derived_fact(journals):
    program, dataset, _ = paper_example(n=10, m=8)
    ref, eng = _cmat_pair(program, dataset, fused=True)
    _assert_trees_equal(ref, eng, _derived(ref.materialisation(), dataset))


def test_lubm_seeded_sample(journals):
    program, dataset, _ = lubm_like(n_dept=3, n_students=30, n_courses=6)
    ref, eng = _cmat_pair(program, dataset, fused=True)
    pool = _derived(ref.materialisation(), dataset)
    pick = np.random.default_rng(0).choice(len(pool), size=40, replace=False)
    _assert_trees_equal(ref, eng, [pool[i] for i in pick])


def test_flat_engine_trees(journals):
    program, dataset, _ = chain(n=15)
    ref = JFlatEngine(program)
    ref.load(dataset)
    eng = FlatEngine(program, device="cpu")
    eng.load(dataset)
    eng.materialise()
    _assert_trees_equal(ref, eng, _derived(ref.materialise(), dataset)[:30])


def test_explicit_leaf_and_absent_fact(journals):
    program, dataset, _ = chain(n=10)
    ref, eng = _cmat_pair(program, dataset)
    row = tuple(int(v) for v in np.asarray(dataset["edge"])[0])
    node = eng.explain_fact("edge", row)
    assert node["kind"] == "explicit" and node["children"] == []
    assert _tree(node) == ref.explain_fact("edge", row)
    assert eng.explain_fact("path", (999, 998)) is None


@pytest.mark.parametrize("case", ["dred-delete", "deleted-fact", "insertion-epoch"])
def test_incremental_trees(case, journals):
    start, batch, facts = {
        "dred-delete": (DIAMOND, {"deletions": {"edge": np.array([[1, 3]], np.int64)}},
                        [("path", (0, 3)), ("path", (1, 3)), ("path", (0, 1))]),
        "deleted-fact": (np.array([[0, 1], [1, 2]], np.int64),
                         {"deletions": {"edge": np.array([[1, 2]], np.int64)}},
                         [("path", (0, 2)), ("path", (0, 1))]),
        "insertion-epoch": (np.array([[0, 1]], np.int64),
                            {"additions": {"edge": np.array([[1, 2], [2, 3]], np.int64)}},
                            [("path", (0, 3)), ("path", (1, 3)), ("path", (0, 2))]),
    }[case]
    ref = JIncrementalStore(TC_PROGRAM)
    inc = IncrementalStore(TC_PROGRAM, device="cpu")
    for s in (ref, inc):
        s.load({"edge": start})
        s.apply(**batch)
    inc.check_integrity()
    _assert_trees_equal(ref, inc, facts)
    if case == "deleted-fact":
        assert inc.explain_fact("path", (0, 2)) is None


def test_capped_journal_still_explains(journals):
    for j in journals:
        j.configure(max_records=8)
    program, dataset, _ = chain(n=25)
    ref, eng = _cmat_pair(program, dataset)
    assert journals[1].dropped == journals[0].dropped > 0
    assert _untimed(journals[1]) == _untimed(journals[0])
    _assert_trees_equal(ref, eng, _derived(ref.materialisation(), dataset)[:20])


def test_explain_tables_dropped_by_every_mutation(tmp_path, journals):
    inc = IncrementalStore(TC_PROGRAM, device="cpu")
    inc.load({"edge": CHAIN8})
    _assert_verified(inc.explain_fact("path", (0, 8)))
    assert inc._prov_tables is not None
    inc.apply(additions={"edge": np.array([[8, 9]], np.int64)})
    assert inc._prov_tables is None
    _assert_verified(inc.explain_fact("path", (0, 9)))  # a fact of the new epoch
    inc.apply(deletions={"edge": np.array([[3, 4]], np.int64)})
    assert inc.explain_fact("path", (0, 9)) is None  # gone with the edge
    assert inc._prov_tables is not None
    inc.compact()
    assert inc._prov_tables is None and inc.engine._prov_tables is None
    _assert_verified(inc.explain_fact("path", (4, 9)))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.checkpoint(inc)
    inc2, _ = mgr.restore(TC_PROGRAM, device="cpu")
    assert inc2._prov_tables is None
    assert _tree(inc2.explain_fact("path", (4, 9))) == _tree(inc.explain_fact("path", (4, 9)))
    eng = CMatEngine(TC_PROGRAM, device="cpu")
    eng.load({"edge": CHAIN8[:5]})
    _assert_verified(eng.explain_fact("edge", (0, 1)))
    assert eng.explain_fact("path", (0, 1)) is None  # not materialised yet
    eng.load({"label": np.array([[0]], np.int64)})
    assert eng._prov_tables is None
    _assert_verified(eng.explain_fact("label", (0,)))
    eng.materialise()
    assert eng._prov_tables is None
    _assert_verified(eng.explain_fact("path", (0, 5)))


# --------------------------------------------------------------------- #
# payloads, gauges, spans
# --------------------------------------------------------------------- #
def test_payload_matches_and_cross_loads(journals):
    jj, tj = journals
    program, dataset, _ = lubm_like(n_dept=3, n_students=30, n_courses=6)
    _cmat_pair(program, dataset, fused=True)
    jp, tp = jj.to_payload(), tj.to_payload()
    assert _payload_untimed(tp) == _payload_untimed(jp)
    into_port, into_ref = tprov.DerivationJournal(), jprov.DerivationJournal()
    into_port.load_payload(json.loads(json.dumps(jp)))
    into_ref.load_payload(json.loads(json.dumps(tp)))
    assert [r.to_list() for r in into_port.records] == [r.to_list() for r in jj.records]
    assert [r.to_list() for r in into_ref.records] == [r.to_list() for r in tj.records]
    assert into_port.to_payload() == jp and into_ref.to_payload() == tp
    assert tj.memory_report() == jj.memory_report()
    assert tj.memory_report()["journal_bytes"] > 0


def test_rule_gauges_and_hot_rules(journals):
    jj, tj = journals
    prev_j = jmetrics.set_registry(jmetrics.MetricsRegistry())
    prev_t = tmetrics.set_registry(tmetrics.MetricsRegistry())
    try:
        program, dataset, _ = lubm_like(n_dept=3, n_students=30, n_courses=6)
        _cmat_pair(program, dataset)
        want = jmetrics.get_registry().snapshot("rule.")
        got = tmetrics.get_registry().snapshot("rule.")
    finally:
        jmetrics.set_registry(prev_j)
        tmetrics.set_registry(prev_t)
    untimed = lambda snap: {k: v for k, v in snap.items() if not k.endswith(".time_ns")}
    assert set(got) == set(want) and untimed(got) == untimed(want)
    assert got["rule.journal.records"] == len(tj.records)
    assert _by_rule(tj.hot_rules(100)) == _by_rule(jj.hot_rules(100))
    hot = tj.hot_rules(5)
    assert len(hot) == 5 and hot[0]["time_ns"] >= hot[-1]["time_ns"]


def test_cmat_rule_span_carries_rule_id(journals):
    tr = get_tracer()
    was = tr.enabled
    tr.enable()
    try:
        tr.reset()
        program, dataset, _ = chain(n=8)
        eng = CMatEngine(program, device="cpu")
        eng.load(dataset)
        eng.materialise()
        spans = [e for e in tr.events if e.name == "cmat.rule"]
        assert spans and all("rule_id" in e.args and "stratum" in e.args for e in spans)
        assert {e.args["rule_id"] for e in spans} <= set(range(len(program.rules)))
    finally:
        tr.reset()
        if not was:
            tr.disable()


def test_proof_exports(journals):
    program, dataset, _ = chain(n=8)
    _, eng = _cmat_pair(program, dataset)
    node = eng.explain_fact("path", (0, 8))
    assert json.loads(tprov.proof_to_json(node))["fact"] == node["fact"]
    assert tprov.proof_to_dot(node) == jprov.proof_to_dot(node)


# --------------------------------------------------------------------- #
# the checkpoint sidecar
# --------------------------------------------------------------------- #
def _checkpoint(mgr_cls, root, edges=CHAIN8, program=TC_PROGRAM, **kw):
    inc = (IncrementalStore if mgr_cls is CheckpointManager else JIncrementalStore)(
        program, **kw)
    inc.load({"edge": edges})
    mgr = mgr_cls(str(root))
    mgr.checkpoint(inc)
    return inc, mgr


def test_sidecar_written_by_both_and_cross_restored(tmp_path, journals):
    jj, tj = journals
    _checkpoint(JCheckpointManager, tmp_path / "ref")
    _checkpoint(CheckpointManager, tmp_path / "port", device="cpu")
    sidecars = {}
    for who in ("ref", "port"):
        snap = (JCheckpointManager if who == "ref" else CheckpointManager)(
            str(tmp_path / who)).latest()
        with open(os.path.join(snap, "provenance.json")) as fh:
            sidecars[who] = json.load(fh)
    assert _payload_untimed(sidecars["port"]) == _payload_untimed(sidecars["ref"])
    for j in journals:
        j.clear()
    # the port restores the reference's directory, the reference the port's
    inc, _ = CheckpointManager(str(tmp_path / "ref")).restore(TC_PROGRAM, device="cpu")
    ref, _ = JCheckpointManager(str(tmp_path / "port")).restore(TC_PROGRAM)
    assert tj.to_payload() == sidecars["ref"] and jj.to_payload() == sidecars["port"]
    _assert_trees_equal(ref, inc, [("path", (0, 4)), ("path", (2, 8))])


def test_restore_without_sidecar_explains(tmp_path, journals):
    jj, tj = journals
    tj.enabled = False  # the checkpoint is written with the journal off
    _checkpoint(CheckpointManager, tmp_path / "ck", device="cpu")
    snap = CheckpointManager(str(tmp_path / "ck")).latest()
    assert not os.path.exists(os.path.join(snap, "provenance.json"))
    tj.enabled = True
    inc, _ = CheckpointManager(str(tmp_path / "ck")).restore(TC_PROGRAM, device="cpu")
    assert not tj.records  # nothing loaded: the Explainer searches every rule
    _assert_verified(inc.explain_fact("path", (0, 3)))


def test_sidecar_ignored_with_journal_off(tmp_path, journals):
    jj, tj = journals
    _checkpoint(CheckpointManager, tmp_path / "ck", device="cpu")
    tj.clear()
    tj.enabled = False
    inc, _ = CheckpointManager(str(tmp_path / "ck")).restore(TC_PROGRAM, device="cpu")
    assert not tj.records
    _assert_verified(inc.explain_fact("path", (0, 3)))


def test_restore_then_dred_delete_explains(tmp_path, journals):
    jj, tj = journals
    _checkpoint(JCheckpointManager, tmp_path / "ref", edges=DIAMOND)
    _checkpoint(CheckpointManager, tmp_path / "port", edges=DIAMOND, device="cpu")
    ref, _ = JCheckpointManager(str(tmp_path / "ref")).restore(TC_PROGRAM)
    inc, _ = CheckpointManager(str(tmp_path / "port")).restore(TC_PROGRAM, device="cpu")
    for s in (ref, inc):
        s.apply(deletions={"edge": np.array([[1, 3]], np.int64)})
    inc.check_integrity()
    assert _untimed(tj) == _untimed(jj)
    _assert_trees_equal(ref, inc, [("path", (0, 3)), ("path", (2, 3))])


# --------------------------------------------------------------------- #
# MemorySampler
# --------------------------------------------------------------------- #
class _Bytes:
    def __init__(self):
        self.n = 0

    def memory_report(self):
        self.n += 1000
        return {"payload_bytes": self.n}


def _drive_sampler(memory, metrics, trace):
    acc, reg = memory.MemoryAccountant(), metrics.MetricsRegistry()
    owner = _Bytes()
    acc.register("test", owner)
    tracer = trace.Tracer(enabled=False)
    sampler = memory.MemorySampler(accountant=acc, registry=reg, rss=False, budget=0)
    sampler.attach(tracer)
    with tracer.span("cmat.materialise"):
        for r in range(3):
            with tracer.span("cmat.round", round=r):
                with tracer.span("cmat.rule"):
                    pass
    with tracer.span("inc.apply"):
        with tracer.span("inc.deletion_sweep"):
            with tracer.span("inc.dred_stratum"):
                pass
    with tracer.span("storage.restore"):
        pass
    with tracer.span("cmat.round"):  # no phase open
        pass
    sampler.detach()
    assert not tracer.enabled and not tracer.hooks
    return sampler, reg.snapshot("mem.")


def test_memory_sampler_matches_reference():
    want, want_snap = _drive_sampler(jmemory, jmetrics, jtrace)
    got, got_snap = _drive_sampler(tmemory, tmetrics, ttrace)
    assert got.peaks == want.peaks
    assert (got.samples, got.throttled) == (want.samples, want.throttled) == (9, 0)
    assert set(got_snap) == set(want_snap)
    assert {k: v for k, v in got_snap.items() if k != "mem.sampler.time_s"} == {
        k: v for k, v in want_snap.items() if k != "mem.sampler.time_s"}
    assert {"mem.peak.materialise.resident_bytes", "mem.peak.apply.resident_bytes",
            "mem.peak.restore.resident_bytes"} <= set(got_snap)
    assert tmemory.PHASE_SPANS == jmemory.PHASE_SPANS
    assert tmemory.ROUND_SPANS == jmemory.ROUND_SPANS


def test_memory_sampler_throttles_itself():
    tracer = ttrace.Tracer(enabled=False)
    sampler = tmemory.MemorySampler(accountant=tmemory.MemoryAccountant(),
                                    registry=tmetrics.MetricsRegistry(), rss=False,
                                    budget=1e-9)
    sampler.attach(tracer)
    for _ in range(50):
        with tracer.span("cmat.round"):
            pass
    sampler.detach()
    assert sampler.throttled > 0 and sampler.samples + sampler.throttled == 51


def test_journal_registers_with_the_port_accountant(journals):
    _, tj = journals
    live = tmemory.get_accountant().live().get("provenance", [])
    assert tj in live
    program, dataset, _ = chain(n=10)
    _cmat_pair(program, dataset)
    assert tmemory.get_accountant().collect()["provenance"]["n_records"] == len(tj.records)


def test_rows_stay_on_the_store_device(journals):
    program, dataset, _ = chain(n=6)
    _, eng = _cmat_pair(program, dataset)
    eng.explain_fact("path", (0, 6))
    for rows, rounds in eng._prov_tables.values():
        assert rows.device == rounds.device == eng.device
        assert rows.dtype == rounds.dtype == torch.int64
    ex = tprov.Explainer(program, eng._prov_tables, eng._explicit)
    for pred, (rows, rounds) in eng._prov_tables.items():
        assert_array_equal(rows.numpy(), np.unique(rows.numpy(), axis=0))
    assert ex.device == eng.device
