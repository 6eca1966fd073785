"""``BENCHMARK.json`` keeps to the benchmark's contract, and a later
change adds a configuration with a KB generator of its own, a traffic mix,
a cell and a per-layer metric by new files and entries alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from kbbench.spec import GENERATOR_NAMES

from .conftest import ROOT, config_of, generator_of, run_in_subprocess

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expan|per_tok")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.fullmatch(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    assert len(set(names)) == len(names)

    assert 1 <= len(b["configs"]) <= 24
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(r) and not WIDTH.search(r) for r in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        gen = cfg["kb"]["generator"]
        assert re.fullmatch(r"kbbench/data/[^/]+\.py", gen) and (ROOT / gen).is_file()
        assert all(hasattr(generator_of(cfg), n) for n in GENERATOR_NAMES)
        assert cfg["engine"]["class"].startswith("repro_torch.core.")
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}

    assert 1 <= len(b["workloads"]) <= 24
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.fullmatch(w["traffic"])
        assert (ROOT / "kbbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))

    cells = {w["name"] for w in b["workloads"]}
    assert 1 <= len(b["end_to_end"]) <= 16
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert e2e["setup_s"] == cells
    assert 1 <= len(b["per_layer"]) <= 128
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert (ROOT / "kbbench/metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            layers.setdefault(cell, set()).add(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert len([n for n, ws in e2e.items() if cell in ws and n != "setup_s"]) >= 1
        assert layers.get(cell)


#: a KB generator that UBA's is not: random DAGs, one per component
DAG = """\"\"\"Random DAGs: ``graphs`` components of ``nodes`` nodes, each node with
``out_degree`` edges to later nodes of its component.\"\"\"

import numpy as np

from . import KB

TINY = {"graphs": 4}
WIDE = {"graphs": 250}


def generate(kb, seed, program):
    rng = np.random.default_rng(seed)
    g, n, d = int(kb["graphs"]), int(kb["nodes"]), int(kb["out_degree"])
    src = np.repeat(np.arange(g * n, dtype=np.int64), d)
    local = src % n
    dst = src + 1 + (rng.random(len(src)) * (n - 1 - local)).astype(np.int64)
    keep = local < n - 1
    edges = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    return KB(program, {"edge": edges}, g * n, {"node": g * n, "edge": len(edges)})
"""
#: the two-rule transitive closure
TC = "edge(x, y) -> path(x, y)\npath(x, y), edge(y, z) -> path(x, z)\n"


def test_a_config_a_mix_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "kbbench", root / "kbbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    before = {p: p.read_bytes() for p in (root / "kbbench").rglob("*") if p.is_file()}

    # the new files: a configuration, a traffic mix of the existing driver,
    # a metric reader; a KB generator, a program and a configuration of them
    bench = json.loads((root / "BENCHMARK.json").read_text())
    old = bench["configs"][0]
    cfg = json.loads((root / old["file"]).read_text())
    cfg["kb"].update(generator_of(cfg).TINY)
    (root / "kbbench/configs/dummy-u1.json").write_text(json.dumps(cfg))
    (root / "kbbench/traffic/dummy-jobs.json").write_text(json.dumps({"kind": "jobs"}))
    (root / "kbbench/metrics/dummy.jobs.py").write_text(
        "def read(record):\n    return float(record.counters['jobs'])\n")
    (root / "kbbench/data/dag.py").write_text(DAG)
    (root / "kbbench/data/tc.txt").write_text(TC)
    dag = {"name": "dag-tc", "kb": {"generator": "kbbench/data/dag.py", "graphs": 2,
                                    "nodes": 300, "out_degree": 2},
           "program": "kbbench/data/tc.txt",
           "engine": {"class": cfg["engine"]["class"], "args": {"fused": True}}}
    (root / "kbbench/configs/dag-tc.json").write_text(json.dumps(dag))
    # ... and entries
    cell, tc_cell = "dummy-u1.jobs", "dag-tc.materialise"
    bench["configs"].append(dict(old, name="dummy-u1", file="kbbench/configs/dummy-u1.json"))
    bench["configs"].append(dict(old, name="dag-tc", file="kbbench/configs/dag-tc.json",
                                 reduced=[], why="recursive rules"))
    bench["workloads"].append({"name": cell, "config": "dummy-u1", "traffic": "dummy-jobs",
                               "chips": 1, "why": "one university"})
    bench["workloads"].append({"name": tc_cell, "config": "dag-tc",
                               "traffic": "materialise-jobs", "chips": 1,
                               "why": "transitive closure"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [cell, tc_cell]
    bench["per_layer"].append({"name": "dummy.jobs", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "reason_facts_per_s", "workloads": [cell, tc_cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    for name in (cell, tc_cell):
        for trace in (0, 1):
            proc = run_in_subprocess(root, ["--workload", name, "--seed", "5", "--seconds", "1",
                                            "--trace", str(trace)], config_of(name, root))
            assert proc.returncode == 0, proc.stderr[-3000:]
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            assert out["correct"] is True
            if trace:
                assert out["metrics"]["dummy.jobs"]["value"] >= 1
                assert out["metrics"]["dummy.jobs"]["unit"] == "jobs"
            else:
                assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there was edited
