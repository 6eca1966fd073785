"""The port's examples on the CPU, against the JAX package's engines on the
same inputs: ``repro_torch.examples.quickstart`` (the paper's running
example through ``CMatEngine``) and
``repro_torch.examples.distributed_reasoning`` (the distributed engine,
one shard per visible device: one here).  Each example checks itself
against the flat oracle and raises if it differs."""

import jax
import numpy as np
from jax.sharding import Mesh

from repro.core import CMatEngine as JCMatEngine
from repro.core.distributed import DistributedEngine as JDistributedEngine
from repro.core.generators import lubm_like, paper_example
from repro_torch.examples import distributed_reasoning, quickstart


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
