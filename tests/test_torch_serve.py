"""The port's query server against the JAX package's, in-process on the
CPU: ``repro_torch.launch.serve_datalog.main(..., "--device", "cpu")``
and ``repro.launch.serve_datalog.main`` write their reports with
``--report-json``, and every non-timing field of every block must be
equal.  Each run gets fresh metrics registries (swapped in and restored),
since the report reads the process-wide scopes."""

from __future__ import annotations

import json
import threading

import pytest

import repro.launch.serve_datalog as jserve
import repro.obs.metrics as jmetrics
import repro_torch.launch.serve_datalog as serve
import repro_torch.obs.metrics as tmetrics
from repro_torch.kernels import ops

#: report keys that hold times, or (``inc.journal_bytes``) the lengths of
#: the journal's time floats
TIMED = ("seconds", "qps", "time", "apply_s", "journal_bytes")

RUNS = {
    "lubm-static": ["--kb", "lubm", "--scale", "1", "--n-queries", "300"],
    "lubm-live": ["--kb", "lubm", "--scale", "1", "--n-queries", "300", "--live",
                  "--update-every", "100", "--update-size", "6", "--live-verify"],
    "chain-live-compact": ["--kb", "chain", "--scale", "1", "--n-queries", "300",
                           "--live", "--update-every", "40", "--update-size", "4",
                           "--compact-threshold", "0.3", "--live-verify"],
}


@pytest.fixture
def fresh_registries():
    """A fresh metrics registry in each package for the test's runs."""
    prev_j = jmetrics.set_registry(jmetrics.MetricsRegistry())
    prev_t = tmetrics.set_registry(tmetrics.MetricsRegistry())
    try:
        yield
    finally:
        jmetrics.set_registry(prev_j)
        tmetrics.set_registry(prev_t)


def _report(main, argv, path) -> dict[str, dict]:
    assert main([*argv, "--report-json", str(path)]) == 0
    blocks = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        blocks[rec.pop("block")] = rec
    return blocks


def _untimed(block: dict) -> dict:
    return {k: v for k, v in block.items() if not any(t in k for t in TIMED)}


@pytest.mark.parametrize("run", list(RUNS))
def test_report_matches_reference(run, tmp_path, capsys, fresh_registries):
    argv = RUNS[run]
    want = _report(jserve.main, argv, tmp_path / "ref.jsonl")
    got = _report(serve.main, [*argv, "--device", "cpu"], tmp_path / "port.jsonl")
    capsys.readouterr()
    # the reference emits its kernels block only under --pallas; the port
    # always does
    assert set(got) == set(want) | {"kernels"}
    for block in sorted(set(want) - {"latency", "memory"}):
        assert _untimed(got[block]) == _untimed(want[block]), block
    assert got["serve"]["answers"] > 0
    if "--live" in argv:
        assert got["live-verify"]["ok"] is True
        assert got["live"]["inc.epoch"] == got["live"]["inc.batches"] > 0
    # CPU calls take the kernels' plain versions: nothing metered or launched
    assert got["kernels"]["launches"] == dict.fromkeys(ops.KERNELS, 0)
    assert not any(k.endswith(".calls") for k in got["kernels"])


def test_trace_and_metrics_files(tmp_path, capsys, fresh_registries):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    blocks = _report(serve.main, [*RUNS["lubm-live"], "--device", "cpu", "--trace-out",
                                  str(trace), "--metrics-out", str(metrics)],
                     tmp_path / "port.jsonl")
    capsys.readouterr()
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"serve.warmup", "serve.update_batch", "inc.apply", "cmat.materialise"} <= names
    assert blocks["trace"]["events"] == sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
    snap = json.loads(metrics.read_text())
    assert snap["inc.batches"] == blocks["live"]["inc.batches"]
    assert snap["query.epoch"] == snap["inc.epoch"]
    assert not serve.get_tracer().enabled  # main restored the tracer


UNPORTED = [
    (["--checkpoint-dir", "ckpt"], 8),
    (["--checkpoint-every", "2"], 8),
    (["--restore"], 8),
    (["--mvcc"], 10),
    (["--concurrency", "4"], 10),
    (["--distributed"], 10),
    (["--provenance"], 9),
    (["--explain", "path(v000000, v000003)"], 9),
    (["--explain-sample", "3"], 9),
    (["--hot-rules"], 9),
]


@pytest.mark.parametrize("flag,item", UNPORTED, ids=[f[0][0] for f in UNPORTED])
def test_unported_flags_name_their_item(flag, item, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--kb", "paper", "--scale", "1", *flag])
    assert exc.value.code == 2
    assert f"ROADMAP.md queue 1 item {item}" in capsys.readouterr().err


def test_report_sink_concurrent_emits(tmp_path, capsys):
    """One JSON record per emit, none torn, from eight threads at once."""
    path = tmp_path / "report.jsonl"
    sink = serve.ReportSink(str(path))
    n_threads, per_thread = 8, 200

    def emitter(tid):
        for i in range(per_thread):
            sink.emit(f"t{tid}", f"payload {i}",
                      {"thread": tid, "i": i, "filler": "x" * 64})

    threads = [threading.Thread(target=emitter, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    sink.close()
    lines = path.read_text().splitlines()
    assert len(lines) == n_threads * per_thread
    seen = set()
    for line in lines:
        rec = json.loads(line)
        assert rec["block"] == f"t{rec['thread']}"
        assert rec["filler"] == "x" * 64
        seen.add((rec["thread"], rec["i"]))
    assert len(seen) == n_threads * per_thread
    capsys.readouterr()


@pytest.mark.parametrize("name", ["lubm", "chain", "star", "paper"])
def test_stream_and_batches_match_reference(name):
    """The query stream and the update batches (the pool's shuffle) are
    the reference's for the same seed."""
    assert serve.make_stream(name, 2, 200, 1.1, 3) == jserve.make_stream(name, 2, 200, 1.1, 3)
    _, dataset, _ = serve.build_kb(name, 1)
    _, jdataset, _ = jserve.build_kb(name, 1)
    got = serve.make_update_batches(dataset, 4, 5, 3)
    want = jserve.make_update_batches(jdataset, 4, 5, 3)
    assert len(got) == len(want)
    for (gd, ga), (wd, wa) in zip(got, want):
        for g, w in ((gd, wd), (ga, wa)):
            assert g.keys() == w.keys()
            assert all((g[p] == w[p]).all() for p in w)


def test_device_defaults_to_cuda_and_raises_without(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--kb", "paper", "--scale", "1", "--n-queries", "5"])
