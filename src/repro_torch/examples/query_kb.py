"""Query quickstart: ontology -> materialise -> ask BGP queries.

Builds a small university ontology with :class:`OntologyBuilder`,
materialises the compressed store once on the card (or ``--device
cpu``), then answers three queries through :class:`QueryEngine`,
printing each plan and the decoded answers.  Then the warm-start
walkthrough: snapshot the materialised store to disk, restore it with
:func:`load_frozen`, and answer the same queries without re-running the
fixpoint.  Next the provenance walkthrough: the derivation journal is on
for the materialisation, so ``explain_fact`` shows a *verified* proof
tree for a derived fact, and the per-rule cost table.  Last the
concurrent serving walkthrough: a :class:`ServingTier` over an
:class:`IncrementalStore` serves threaded readers from pinned epoch
snapshots while a writer applies an update — a reader holding a
``tier.pin()`` lease keeps seeing its epoch unchanged, new queries see
the new one, and nobody blocks on the writer.

    python -m repro_torch.examples.query_kb [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import threading
import time

import numpy as np
import torch

from ..core import CMatEngine, Dictionary
from ..core.owl2rl import OntologyBuilder
from ..core.util import resolve_device
from ..incremental import IncrementalStore
from ..obs.provenance import get_journal
from ..query import QueryEngine
from ..serving import ServingTier
from ..storage import load_frozen, snapshot_nbytes, write_snapshot

QUERIES = [
    # who teaches a course a grad student takes? (3-way join)
    '?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)',
    # derived-class lookup with a constant
    '?p <- Professor(?p), memberOf(?p, "cs")',
    # property-chain derived predicate
    '?s, ?c <- advisedCourse(?s, ?c), GraduateStudent(?s)',
]


def build_kb():
    d = Dictionary()
    profs = d.intern_many([f"prof{i}" for i in range(4)])
    students = d.intern_many([f"student{i}" for i in range(12)])
    courses = d.intern_many([f"course{i}" for i in range(6)])
    depts = d.intern_many(["cs", "math"])

    rng = np.random.default_rng(7)
    dataset = {
        "teacherOf": np.stack([profs[rng.integers(0, 4, 6)], courses], axis=1),
        "takesCourse": np.stack(
            [np.repeat(students, 2), courses[rng.integers(0, 6, 24)]], axis=1),
        "advisor": np.stack([students, profs[rng.integers(0, 4, 12)]], axis=1),
        "memberOf": np.stack([profs, depts[rng.integers(0, 2, 4)]], axis=1),
        "GraduateStudent": students[::2].reshape(-1, 1),
    }

    ontology = (
        OntologyBuilder()
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
    return ontology.build(), dataset, d


def print_proof(node, indent="  "):
    mark = "✓" if node["verified"] else "?"
    via = (f"  [R{node['rule_id']}: {node['rule']}]"
           if node.get("rule_id") is not None and node["kind"] == "derived"
           else "  (explicit)")
    print(f"{indent}{mark} {node['fact']}{via}")
    for child in node["children"]:
        print_proof(child, indent + "  ")


def main(argv=None) -> dict:
    """Run the example; returns each query's decoded answers
    (``answers``), the proof tree of ``Person(student0)`` (``proof``) and
    the serving walkthrough's epochs and answer counts (``serving``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    program, dataset, dictionary = build_kb()
    # provenance on: the journal records one compact record per rule
    # application, which explain_fact uses to find minimal proofs fast
    journal = get_journal()
    journal.enabled = True
    journal.clear()
    eng = CMatEngine(program, device=device)
    eng.load(dataset)
    stats = eng.materialise()
    print(f"materialised: {stats.n_facts} facts in {stats.n_meta_facts} "
          f"meta-facts ({stats.rounds} rounds)\n")

    qe = QueryEngine(eng, dictionary)
    answers = {}
    for text in QUERIES:
        res = qe.answer(text)
        answers[text] = qe.decode(res.answers)
        print(res.plan)
        print(f"  -> {res.n_answers} answers "
              f"(flat rows scanned: {sum(res.stats.rows_scanned.values())})")
        for row in answers[text][:5]:
            print("     ", row)
        if res.n_answers > 5:
            print("      ...")
        print()

    # -- warm start: snapshot the store, restore, answer again -------- #
    with tempfile.TemporaryDirectory() as tmp:
        snap = f"{tmp}/snap"
        frozen = eng.facts.freeze()
        rows = {p: frozen.snapshot(p) for p in frozen.predicates()}
        manifest = write_snapshot(snap, eng.facts, kind="frozen", rows=rows)
        print(f"snapshot: {snapshot_nbytes(snap)} bytes on disk, "
              f"{manifest['store']['n_payloads']} leaf payloads for "
              f"{manifest['store']['n_leaves']} leaves "
              f"({manifest['store']['dedup_saved_bytes']}B shared by dedup)")
        t0 = time.perf_counter()
        qe2 = QueryEngine(load_frozen(snap, device=device), dictionary)
        t_restore = time.perf_counter() - t0
        for text in QUERIES:
            if not torch.equal(qe2.answer(text).answers, qe.answer(text).answers):
                raise AssertionError(f"restored store answers {text!r} otherwise")
        print(f"warm start: restored + re-answered all queries identically "
              f"in {t_restore * 1e3:.1f}ms (no fixpoint, no re-unfold)")

    # -- provenance: why is a derived fact true? ---------------------- #
    # student0 is a Person only through GraduateStudent -> Student ->
    # Person: two taxonomic rule applications the proof tree makes
    # explicit, each step re-derived (never trusted) before ✓ is shown
    sid = dictionary.id_of("student0")
    proof = eng.explain_fact("Person", (sid,), decode=dictionary.term_of)
    print("\nexplain Person(student0) — verified proof tree:")
    print_proof(proof)

    print("\nhot rules (derivation cost attribution from the journal):")
    for h in journal.hot_rules(3):
        print(f"  R{h['rule_id']}: {h['derived']} derived, "
              f"{h['redundant']} redundant, {h['time_ns'] / 1e6:.2f}ms "
              f"over {h['rounds_active']} round(s) — {h['rule']}")
    print("\n(same machinery from the CLI: serve_datalog "
          "--explain 'Person(student0)' --explain-sample 3 --hot-rules)")
    journal.enabled = False
    journal.clear()

    # -- concurrent serving: pinned epochs under live writes ---------- #
    # The MVCC tier wraps an IncrementalStore: readers pin an immutable
    # epoch snapshot, a single writer thread applies updates and
    # publishes new epochs, queries arriving together are folded into
    # shared-plan micro-batches.
    inc = IncrementalStore(program, device=device)
    inc.load(dataset)
    tier = ServingTier(inc, dictionary)
    tier.start()  # writer + admission threads (unstarted = inline)

    knows_q = '?s, ?p <- knows(?s, ?p)'
    # a reader pins epoch v0 and keeps it for several queries...
    with tier.pin() as lease:
        before = lease.answer(knows_q).n_answers
        # ...while the writer publishes a new epoch: a fresh advisor
        # edge derives one more knows() fact via the sub-property rule
        s_new = dictionary.id_of("student1")
        p_new = dictionary.id_of("prof3")
        tier.apply_sync(additions={"advisor": np.array([[s_new, p_new]])})
        pinned = lease.answer(knows_q).n_answers   # still the old epoch
        fresh = tier.answer(knows_q).n_answers     # current epoch
        serving = {"lease_version": lease.version, "before": before, "pinned": pinned,
                   "fresh": fresh, "version": tier.registry.version}
        print(f"\nserving: lease pinned v{lease.version} sees {pinned} "
              f"knows() answers (was {before}), unpinned readers see "
              f"{fresh} at v{tier.registry.version}")
        if not (pinned == before and fresh >= before):
            raise AssertionError(f"pinned epoch moved: {serving}")

    # concurrent closed-loop readers: contemporaries in the admission
    # queue that share a plan signature run as ONE batched scan/join
    def client(n):
        for _ in range(n):
            resp = tier.answer('?p <- Professor(?p), memberOf(?p, "cs")')
            if resp.stale:
                raise AssertionError("stale read")

    threads = [threading.Thread(target=client, args=(25,)) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    st = tier.stats()
    print(f"serving: {st['queries']} queries in {st['batches']} "
          f"micro-batches (mean {st['mean_batch']:.1f}/batch, "
          f"{st['dedup_hits']} dedup + {st['cache_hits']} cache hits), "
          f"{st['stale_reads']} stale reads, "
          f"{st['epochs_published']} epochs published")
    tier.close()
    if st["stale_reads"]:
        raise AssertionError(f"{st['stale_reads']} stale reads")
    serving["queries"] = st["queries"]
    return {"answers": answers, "proof": proof, "serving": serving}


if __name__ == "__main__":
    main()
