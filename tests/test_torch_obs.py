"""The port's span tracer (``repro_torch.obs.trace``): span ids, the
collector span ``host.gc``, its callback's lifetime, the Chrome export,
and the spans of ``CMatEngine`` on a small UBA KB, traced and held to the
JAX package's engine, on the CPU."""

from __future__ import annotations

import gc
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import CMatEngine as JCMatEngine
from repro.core import parse_program as j_parse_program
from repro.core.flat import flat_seminaive as j_flat_seminaive
from repro_torch.core import CMatEngine, parse_program
from repro_torch.obs import chrome_trace, get_tracer, set_tracer
from repro_torch.obs.trace import _NOOP, Tracer

ROOT = Path(__file__).resolve().parents[1]


def _callbacks(tracer: Tracer) -> int:
    return sum(getattr(cb, "__self__", None) is tracer for cb in gc.callbacks)


@pytest.fixture
def tracer():
    tr = Tracer(enabled=True)
    try:
        yield tr
    finally:
        tr.disable()


def test_ids_parent_and_root_follow_the_nesting(tracer):
    with tracer.span("a"):
        with tracer.span("b"):
            with tracer.span("c"):
                pass
            tracer.instant("i")
        with tracer.span("d"):
            pass
    with tracer.span("e"):
        pass
    by = {r.name: r for r in tracer.events if r.name != "host.gc"}
    a, b, c, d, e, i = (by[k] for k in "abcdei")
    assert len({r.id for r in by.values()}) == 6
    assert (a.parent, b.parent, c.parent, d.parent, i.parent) == (None, a.id, b.id, a.id, b.id)
    assert {r.root for r in (a, b, c, d, i)} == {a.id}
    assert (e.parent, e.root) == (None, e.id)
    assert a.id < b.id < c.id < d.id < e.id  # a serial, drawn at entry

    doc = chrome_trace(tracer)
    args = {ev["name"]: ev["args"] for ev in doc["traceEvents"] if ev["ph"] in "Xi"}
    for name, r in by.items():
        assert {k: args[name][k] for k in ("id", "parent", "root")} == {
            "id": r.id, "parent": r.parent, "root": r.root}


def test_span_args_stay_beside_the_ids_in_the_export(tracer):
    with tracer.span("x", rows=3) as sp:
        sp.set(segments=2)
    (ev,) = [ev for ev in chrome_trace(tracer)["traceEvents"] if ev.get("name") == "x"]
    assert ev["args"]["rows"] == 3 and ev["args"]["segments"] == 2
    assert ev["args"]["parent"] is None and ev["args"]["root"] == ev["args"]["id"]


def test_disabled_span_is_the_shared_noop_and_draws_no_id():
    tr = Tracer(enabled=False)
    before = next(tr._ids)
    assert tr.span("x", rows=1) is _NOOP
    tr.instant("y")
    assert next(tr._ids) == before + 1 and tr.events == []
    assert _callbacks(tr) == 0


def test_a_collection_inside_a_span_is_one_host_gc_span_under_it(tracer):
    with tracer.span("outer"):
        with tracer.span("work") as sp:
            gc.collect()
    work = next(r for r in tracer.events if r.name == "work")
    outer = next(r for r in tracer.events if r.name == "outer")
    full = [r for r in tracer.events if r.name == "host.gc" and r.args["generation"] == 2]
    assert len(full) == 1, full
    (g,) = full
    assert (g.parent, g.root, g.depth) == (work.id, outer.id, work.depth + 1)
    assert set(g.args) == {"generation", "collected", "uncollectable"}
    assert work.start_ns <= g.start_ns and g.start_ns + g.dur_ns <= work.start_ns + work.dur_ns
    assert g.tid == work.tid and sp is not _NOOP
    assert tracer.misnested == 0


def test_a_collection_outside_any_span_is_a_root(tracer):
    gc.collect()
    g = [r for r in tracer.events if r.name == "host.gc" and r.args["generation"] == 2][-1]
    assert (g.parent, g.root, g.depth) == (None, g.id, 0)


def test_the_collector_callback_lives_while_the_tracer_is_enabled():
    tr = Tracer()
    assert _callbacks(tr) == 0
    tr.enable()
    tr.enable()
    assert _callbacks(tr) == 1
    tr.disable()
    tr.disable()
    assert _callbacks(tr) == 0
    gc.collect()
    assert tr.events == []


def test_swapping_tracers_moves_the_collector_callback():
    first, second = Tracer(enabled=True), Tracer()
    prev = set_tracer(first)
    try:
        assert _callbacks(first) == 1
        assert set_tracer(second) is first
        # the swapped-out tracer holds no callback and records nothing
        assert (_callbacks(first), _callbacks(second)) == (0, 0)
        n = len(first.events)
        gc.collect()
        assert len(first.events) == n and second.events == []
        second.enable()
        assert set_tracer(second) is second and _callbacks(second) == 1
        assert set_tracer(first) is second
        assert (_callbacks(first), _callbacks(second)) == (1, 0)
        gc.collect()
        assert [r.name for r in first.events[n:]].count("host.gc") >= 1
        assert second.events == []
    finally:
        set_tracer(prev)
        first.disable()
        second.disable()
    assert (_callbacks(first), _callbacks(second)) == (0, 0)


def test_the_event_cap_counts_collections_as_drops():
    tr = Tracer(enabled=True, max_events=0)
    try:
        gc.collect()
    finally:
        tr.disable()
    assert tr.events == [] and tr.dropped >= 1


def test_hooks_see_spans_and_not_collections(tracer):
    seen = []
    tracer.add_hook(lambda t, rec: seen.append(rec.name))
    with tracer.span("s"):
        gc.collect()
    assert seen == ["s"]


# --------------------------------------------------------------------- #
# CMatEngine on a small UBA KB
# --------------------------------------------------------------------- #

ENGINE_SPANS = {
    "cmat.load", "load.to_device", "load.unique", "load.seed_index", "load.compress",
    "compress.rows", "compress.sort", "compress.segments", "compress.leaves",
    "dedup.unfold", "dedup.mask", "dedup.split", "host.gc",
}


@pytest.fixture(scope="module")
def uba_kb():
    from kbbench.data import uba

    cfg = json.loads((ROOT / "kbbench/configs/lubm40-l.json").read_text())
    cfg["kb"]["n_universities"] = 1
    return uba.generate(cfg["kb"], 2147483659, (ROOT / cfg["program"]).read_text())


STATS = ("rounds", "n_meta_facts", "n_facts", "rule_applications_skipped")


def _job(kb):
    eng = CMatEngine(parse_program(kb.program), fused=True, device="cpu")
    eng.load(kb.dataset)
    return eng, eng.materialise()


def test_engine_spans_on_a_uba_kb(uba_kb):
    program = j_parse_program(uba_kb.program)
    ref = JCMatEngine(program, fused=True)
    ref.load(uba_kb.dataset)
    ref_stats = ref.materialise()
    want = {p: np.unique(np.asarray(r), axis=0) for p, r in ref.materialisation().items()}
    oracle = j_flat_seminaive(program, uba_kb.dataset)
    assert set(oracle) == set(want)
    for p in want:
        assert_array_equal(np.unique(np.asarray(oracle[p]), axis=0), want[p])

    prev = set_tracer(Tracer(enabled=True))
    try:
        eng, stats = _job(uba_kb)
        tr = get_tracer()
    finally:
        set_tracer(prev)
    assert _callbacks(tr) == 0
    untraced = _job(uba_kb)[0].materialisation()
    got = eng.materialisation()
    # traced, the port gives the reference's facts and counts, and its
    # own untraced facts
    assert set(got) == set(want) == set(untraced)
    for p in want:
        assert_array_equal(got[p].numpy(), want[p])
        assert torch.equal(got[p], untraced[p])
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f

    names = {r.name for r in tr.events}
    assert ENGINE_SPANS <= names, ENGINE_SPANS - names
    assert tr.misnested == 0 and tr.dropped == 0
    by_id = {r.id: r for r in tr.events}
    (load,) = [r for r in tr.events if r.name == "cmat.load"]
    (mat,) = [r for r in tr.events if r.name == "cmat.materialise"]
    assert load.args["preds"] == len(uba_kb.dataset)
    assert load.args["rows_in"] == sum(len(r) for r in uba_kb.dataset.values())
    assert load.args["meta_facts"] == sum(
        1 for r in tr.events if r.name == "compress.rows" and r.root == load.id
        for _ in range(r.args["segments"]))
    for r in tr.events:
        # every span belongs to one of the two calls, under its parent
        assert r.root in (load.id, mat.id) or r.name == "host.gc", r
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.depth + 1 == r.depth and p.root == r.root
        if r.name.startswith("load."):
            assert by_id[r.parent].name == "cmat.load"
        if r.name.startswith("dedup."):
            assert by_id[r.parent].name == "cmat.dedup"
        if r.name in ("compress.sort", "compress.segments", "compress.leaves"):
            assert by_id[r.parent].name == "compress.rows"
    # no new span is named as a child of dedup that its share subtracts
    assert not any(n.startswith("cmat.") for n in ENGINE_SPANS - {"cmat.load"})
