"""The port's examples on the CPU, against the JAX package's engines on the
same inputs: ``repro_torch.examples.quickstart`` (the paper's running
example through ``CMatEngine``),
``repro_torch.examples.distributed_reasoning`` (the distributed engine,
one shard per visible device: one here) and
``repro_torch.examples.query_kb`` (ontology, queries, warm start,
provenance, MVCC serving) against ``examples/query_kb.py`` run in this
process.  Each example checks itself and raises if it differs."""

import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
from jax.sharding import Mesh

from repro.core import CMatEngine as JCMatEngine
from repro.core.distributed import DistributedEngine as JDistributedEngine
from repro.core.generators import lubm_like, paper_example
from repro_torch.examples import distributed_reasoning, query_kb, quickstart

ROOT = Path(__file__).resolve().parent.parent
#: query_kb's lines that hold a host time, or that the serving threads'
#: interleaving decides (the micro-batch counts; hot rules rank by time)
QUERY_KB_VARYING = re.compile(r"^warm start: |^  R\d+: .* derived, |^serving: \d+ queries in ")
#: the snapshot's bytes on disk: its manifest holds ``created_unix``,
#: whose digits vary (the payload and leaf counts are compared)
QUERY_KB_SNAPSHOT_BYTES = re.compile(r"^snapshot: \d+ bytes")


def test_quickstart_matches_reference(capsys):
    rep = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK: compressed materialisation == flat semi-naive oracle" in out
    program, dataset, _ = paper_example(n=4, m=3)
    ref = JCMatEngine(program)
    ref.load(dataset)
    ref.materialise()
    want = ref.report()
    for key in ("rounds", "n_meta_facts", "n_facts_materialised", "flat_size_E",
                "flat_size_I", "compressed_size"):
        assert rep[key] == want[key], key
    assert f"materialised in {want['rounds']} rounds, {want['n_meta_facts']} meta-facts" in out


def test_distributed_reasoning_matches_reference(capsys):
    eng = distributed_reasoning.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "1 shard(s)" in out and "distributed result == flat oracle" in out
    program, dataset, _ = lubm_like(n_dept=8, n_students=120, n_courses=16)
    program = JDistributedEngine.supported_program(program)
    ref = JDistributedEngine(program, Mesh(np.asarray(jax.devices()), ("data",)),
                             capacity=1 << 13)
    want = ref.materialise(dataset)
    assert eng.rounds == ref.rounds
    for key in ("n_rule_applications", "rule_applications_skipped", "rows_joined"):
        assert getattr(eng.stats, key) == getattr(ref.stats, key), key
    got = eng.to_dict()
    assert {p: len(r) for p, r in got.items()} == {
        p: len(r) for p, r in want.items() if len(r)
    }


def _reference_query_kb():
    spec = importlib.util.spec_from_file_location("ref_query_kb", ROOT / "examples" / "query_kb.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_query_kb_matches_reference(capsys):
    ref = _reference_query_kb()
    ref.main()
    want_out = capsys.readouterr().out
    got = query_kb.main(["--device", "cpu"])
    got_out = capsys.readouterr().out

    def steady(text):
        return [QUERY_KB_SNAPSHOT_BYTES.sub("snapshot: N bytes", line)
                for line in text.splitlines() if not QUERY_KB_VARYING.match(line)]

    assert steady(got_out) == steady(want_out)
    assert len(steady(got_out)) < len(got_out.splitlines())
    # every answer, not only the five printed; the proof tree; the epochs
    program, dataset, dictionary = ref.build_kb()
    eng = ref.CMatEngine(program)
    eng.load(dataset)
    eng.materialise()
    qe = ref.QueryEngine(eng, dictionary)
    for text in query_kb.QUERIES:
        assert got["answers"][text] == qe.decode(qe.answer(text).answers), text
    want_proof = eng.explain_fact("Person", (dictionary.id_of("student0"),),
                                  decode=dictionary.term_of)
    assert got["proof"] == want_proof
    assert got["serving"]["lease_version"] == 0 and got["serving"]["version"] == 1
    assert got["serving"]["pinned"] == got["serving"]["before"] == 12
    assert got["serving"]["fresh"] == 13
    assert "serving: lease pinned v0 sees 12 knows() answers (was 12), unpinned readers see 13 at v1" in want_out
