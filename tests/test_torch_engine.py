"""The port's engines against the JAX package's, on the CPU, plus the
port's guards.

On the five workloads of ``test_fused_engine.py`` and the paper's own
example, the port's ``CMatEngine(device="cpu")`` — both ``fused`` modes —
must give the reference ``CMatEngine``'s fact sets and its ``rounds``,
``n_meta_facts``, ``n_facts`` and ``rule_applications_skipped``, and the
port's ``flat_seminaive`` must equal the reference's.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import CMatEngine as JCMatEngine
from repro.core.flat import flat_seminaive as j_flat_seminaive
from repro.core.generators import bipartite, chain, lubm_like, paper_example, star
from repro_torch.core import CMatEngine, ColumnStore, FlatEngine, flat_seminaive
from repro_torch.core.distributed import DistributedEngine
from repro_torch.incremental import IncrementalStore
from repro_torch.kernels.buffers import FactBuffers

WORKLOADS = [
    ("paper", lambda: paper_example(n=30, m=20)),
    ("chain", lambda: chain(n=60)),
    ("lubm", lambda: lubm_like(n_dept=4, n_students=60, n_courses=10)),
    ("star", lambda: star(n_spokes=80, n_hubs=3)),
    ("bipartite", lambda: bipartite(n_left=30, n_right=30)),
    ("paper_example", lambda: paper_example()),
]

STATS = ("rounds", "n_meta_facts", "n_facts", "rule_applications_skipped")

REPO = Path(__file__).resolve().parents[1]


def _assert_same_facts(got: dict, want: dict):
    assert set(got) == set(want)
    for pred in want:
        assert_array_equal(
            np.asarray(got[pred]), np.unique(np.asarray(want[pred]), axis=0)
        )


@pytest.mark.parametrize("fused", [False, True], ids=["per-step", "fused"])
@pytest.mark.parametrize("name,gen", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_cmat_matches_reference(name, gen, fused):
    program, dataset, _ = gen()
    ref = JCMatEngine(program, fused=fused)
    ref.load(dataset)
    ref_stats = ref.materialise()
    eng = CMatEngine(program, fused=fused, device="cpu")
    eng.load(dataset)
    stats = eng.materialise()
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    got = {p: r.numpy() for p, r in eng.materialisation().items()}
    _assert_same_facts(got, ref.materialisation())
    _assert_same_facts(got, j_flat_seminaive(program, dataset))


@pytest.mark.parametrize("name,gen", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_flat_matches_reference(name, gen):
    program, dataset, _ = gen()
    got = flat_seminaive(program, dataset, device="cpu")
    want = j_flat_seminaive(program, dataset)
    assert set(got) == set(want)
    for pred in want:
        assert_array_equal(got[pred].numpy(), want[pred])


def test_flat_per_step_tail_matches_fused():
    program, dataset, _ = lubm_like(n_dept=4, n_students=60, n_courses=10)
    out = {}
    for fused in (False, True):
        eng = FlatEngine(program, fused=fused, device="cpu")
        eng.load(dataset)
        out[fused] = eng.materialise()
    for pred in out[True]:
        assert torch.equal(out[False][pred], out[True][pred])


def test_cmat_fused_wide_join_falls_back():
    """``fused_max_pairs=0`` pushes every final xjoin to the structure-
    shared fallback; the result must not change."""
    program, dataset, _ = chain(n=30)
    capped = CMatEngine(program, fused=True, fused_max_pairs=0, device="cpu")
    capped.load(dataset)
    capped.materialise()
    got = {p: r.numpy() for p, r in capped.materialisation().items()}
    _assert_same_facts(got, j_flat_seminaive(program, dataset))


def test_cmat_options_keep_reference_results():
    """The reference's other constructor options, on one workload."""
    program, dataset, _ = star(n_spokes=40, n_hubs=2)
    want = j_flat_seminaive(program, dataset)
    for kw in (
        {"dedup_index": True},
        {"plan_bodies": False, "stratify_program": False},
        {"snapshot_old_scans": False},
        {"inplace_splits": True},
    ):
        eng = CMatEngine(program, device="cpu", **kw)
        eng.load(dataset)
        eng.materialise()
        got = {p: r.numpy() for p, r in eng.materialisation().items()}
        _assert_same_facts(got, want)


def test_report_matches_reference():
    program, dataset, _ = paper_example(n=8, m=5)
    ref = JCMatEngine(program)
    ref.load(dataset)
    ref.materialise()
    eng = CMatEngine(program, device="cpu")
    eng.load(dataset)
    eng.materialise()
    got, want = eng.report(), ref.report()
    for key in (
        "rounds", "n_strata", "n_meta_facts", "n_facts_explicit",
        "n_facts_materialised", "flat_size_E", "flat_size_I",
        "compressed_size", "mu_stats", "rule_applications",
        "rule_applications_skipped", "old_snapshot_scans",
    ):
        assert got[key] == want[key], key


# --------------------------------------------------------------------- #
# guards
# --------------------------------------------------------------------- #
def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + sorted((REPO / "tools").glob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue  # relative: inside the port
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not bad, bad
    assert len(_port_files()) > 10
    port = REPO / "src" / "repro_torch"
    scanned = {path.relative_to(port).as_posix()
               for path in _port_files() if path.is_relative_to(port)}
    assert REPO / "tools" / "trace_distributed.py" in _port_files()
    assert {"core/frozen.py", "core/owl2rl.py", "kernels/lookup.py", "query/ast.py",
            "query/plan.py", "query/exec.py", "query/ref.py", "query/engine.py",
            "query/batch.py", "query/__init__.py", "incremental/index.py",
            "incremental/eval.py", "incremental/dred.py", "incremental/store.py",
            "storage/__init__.py", "storage/compact.py", "storage/format.py",
            "storage/wal.py", "storage/manager.py", "serving/__init__.py",
            "serving/admission.py", "serving/epochs.py", "serving/tier.py",
            "launch/__init__.py", "launch/serve_datalog.py", "obs/export.py",
            "obs/memory.py", "obs/provenance.py", "examples/quickstart.py",
            "examples/distributed_reasoning.py", "configs/__init__.py", "configs/base.py",
            "configs/qwen3_0_6b.py", "models/layers.py", "models/attention.py",
            "models/mla.py", "models/moe.py", "models/ssm.py", "models/transformer.py",
            "models/model.py", "launch/serve.py", "examples/serve_decode.py",
            "optim/__init__.py", "optim/adamw.py", "optim/compress.py", "optim/schedule.py",
            "data/__init__.py", "data/pipeline.py", "data/kb_corpus.py", "train/__init__.py",
            "train/train_step.py", "train/checkpoint.py", "train/ft.py", "launch/train.py",
            "examples/kb_train.py", "examples/elastic_restart.py", "roofline/__init__.py",
            "roofline/analysis.py", "roofline/op_cost.py", "launch/dryrun.py",
            "launch/dryrun_datalog.py", "kernels/tune.py"} <= scanned


@pytest.mark.parametrize(
    "make",
    [
        lambda p, d: CMatEngine(p),
        lambda p, d: CMatEngine(p, fused=True),
        lambda p, d: flat_seminaive(p, d),
        lambda p, d: DistributedEngine(p),
        lambda p, d: ColumnStore(),
        lambda p, d: FactBuffers(),
        lambda p, d: FactBuffers(dtype=torch.int32),
        lambda p, d: IncrementalStore(p),
    ],
    ids=["cmat", "cmat-fused", "flat_seminaive", "distributed", "column-store",
         "fact-buffers", "fact-buffers-int32", "incremental-store"],
)
def test_entry_points_default_to_cuda_and_raise_without(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program, dataset, _ = paper_example()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(program, dataset)
