"""The port's query server against the JAX package's, in-process on the
CPU: ``repro_torch.launch.serve_datalog.main(..., "--device", "cpu")``
and ``repro.launch.serve_datalog.main`` write their reports with
``--report-json``, and every non-timing field of every block must be
equal: static and ``--live``, durable (``--checkpoint-dir`` then
``--restore``, live and static), ``--mvcc`` (``--concurrency 4`` on its
order-free fields) and ``--distributed``.  Each run gets fresh metrics
registries (swapped in and restored), since the report reads the
process-wide scopes; each package writes its own checkpoint directory."""

from __future__ import annotations

import json
import os
import threading

import pytest

import repro.launch.serve_datalog as jserve
import repro.obs.metrics as jmetrics
import repro_torch.launch.serve_datalog as serve
import repro_torch.obs.metrics as tmetrics
from repro_torch.kernels import ops

#: report keys that hold times, or (``inc.journal_bytes``) the lengths of
#: the journal's time floats
TIMED = ("seconds", "qps", "time", "apply_s", "journal_bytes", "restore_snapshot_s",
         "restore_replay_s", "_ms")

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


PROVENANCE_RUNS = {
    "provenance": ["--provenance"],
    "explain": ["--explain", "taughtBy(student0, prof4)", "--explain",
                "memberOf(student0, dept0)", "--explain", "bogus"],
    "explain-sample": ["--explain-sample", "5"],
    "hot-rules": ["--hot-rules"],
    "live": ["--live", "--update-every", "100", "--update-size", "6", "--live-verify",
             "--provenance", "--explain-sample", "4", "--hot-rules"],
    "mvcc": ["--mvcc", "--concurrency", "1", "--live", "--update-every", "100",
             "--update-size", "6", "--explain-sample", "3", "--hot-rules"],
}


@pytest.fixture
def journals_on():
    """Both journals on before each run, so that ``main`` leaves them
    filled for the cost comparison; restored after."""
    import repro.obs.provenance as jprov
    import repro_torch.obs.provenance as tprov

    pair = (jprov.get_journal(), tprov.get_journal())
    was = [j.enabled for j in pair]
    for j in pair:
        j.enabled = True
    yield pair
    for j, w in zip(pair, was):
        j.enabled = w
        j.clear()
        j.begin_epoch(0)


def _costs(journal) -> dict:
    return {h["rule_id"]: {k: v for k, v in h.items() if k != "time_ns"}
            for h in journal.hot_rules(len(journal.costs))}


@pytest.mark.parametrize("run", list(PROVENANCE_RUNS))
def test_provenance_flags_match_reference(run, tmp_path, capsys, fresh_registries,
                                          journals_on):
    """The ``[provenance]`` block of the four flags, live and under MVCC:
    every non-timing field equal to the reference's; ``hot_rules`` (ranked
    by host time, which differs) by ``rule_id`` against the whole cost
    table, whose untimed fields must be equal."""
    argv = ["--kb", "lubm", "--scale", "1", "--n-queries", "300", *PROVENANCE_RUNS[run]]
    jj, tj = journals_on
    want = _report(jserve.main, argv, tmp_path / "ref.jsonl")
    want_costs = _costs(jj)
    got = _report(serve.main, [*argv, "--device", "cpu"], tmp_path / "port.jsonl")
    capsys.readouterr()
    got_costs = _costs(tj)
    assert got_costs == want_costs
    prov, want_prov = dict(got["provenance"]), dict(want["provenance"])
    hot, want_hot = prov.pop("hot_rules"), want_prov.pop("hot_rules")
    assert prov == want_prov
    assert len(hot) == len(want_hot) == (min(10, len(got_costs)) if "--hot-rules" in argv
                                         else 0)
    for h in hot:
        assert {k: v for k, v in h.items() if k != "time_ns"} == got_costs[h["rule_id"]]
    assert prov["records"] == len(tj.records) > 0
    explained = prov["explanations"]
    if run == "explain":
        assert [e["found"] for e in explained] == [True, False]
        assert len(prov["parse_errors"]) == 1
    assert all(e["verified"] for e in explained if e["found"])
    if run != "mvcc":  # the other blocks too (the MVCC tier's order-free test is below)
        for block in sorted(set(want) - {"latency", "memory", "provenance"}):
            assert _untimed(got[block]) == _untimed(want[block]), block


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


LUBM_LIVE = RUNS["lubm-live"]
LUBM_STATIC = ["--kb", "lubm", "--scale", "1", "--n-queries", "200"]
#: runs in order, each package in its own checkpoint directory ``{D}``
SEQUENCES = {
    "live-checkpoint-restore": [
        [*LUBM_LIVE, "--checkpoint-dir", "{D}", "--checkpoint-every", "2"],
        [*LUBM_LIVE, "--checkpoint-dir", "{D}", "--restore"],
    ],
    "static-frozen-restore": [
        [*LUBM_STATIC, "--checkpoint-dir", "{D}"],
        [*LUBM_STATIC, "--checkpoint-dir", "{D}", "--restore"],
    ],
    "mvcc-concurrency-1": [[*LUBM_STATIC, "--mvcc", "--concurrency", "1"]],
    "distributed-static": [["--kb", "chain", "--scale", "1", "--n-queries", "200",
                            "--distributed"]],
    "distributed-live": [["--kb", "chain", "--scale", "1", "--n-queries", "200",
                          "--distributed", "--live", "--update-every", "40",
                          "--update-size", "4", "--live-verify"]],
}


def _manifest_bytes(root: str) -> int:
    """Bytes of the manifests of the snapshots under a checkpoint root."""
    return sum(
        os.path.getsize(os.path.join(root, name, "manifest.json"))
        for name in os.listdir(root)
        if os.path.isfile(os.path.join(root, name, "manifest.json"))
    )


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_durable_mvcc_distributed_reports_match_reference(seq, tmp_path, capsys,
                                                          fresh_registries):
    """Every non-timing field equal, run after run; a snapshot's path is
    compared below its checkpoint directory, and the disk bytes up to the
    manifests' ``created_unix`` digits (the data and the WAL are equal byte
    for byte, ``tests/test_torch_storage.py``)."""
    tdir, jdir = tmp_path / "port-ckpt", tmp_path / "ref-ckpt"
    for k, argv in enumerate(SEQUENCES[seq]):
        jmetrics.set_registry(jmetrics.MetricsRegistry())
        tmetrics.set_registry(tmetrics.MetricsRegistry())
        want = _report(jserve.main, [a.replace("{D}", str(jdir)) for a in argv],
                       tmp_path / f"ref{k}.jsonl")
        got = _report(serve.main, [*(a.replace("{D}", str(tdir)) for a in argv),
                                   "--device", "cpu"], tmp_path / f"port{k}.jsonl")
        out = capsys.readouterr().out
        assert set(got) == set(want) | {"kernels"}
        for block in sorted(set(want) - {"latency", "memory"}):
            g, w = _untimed(got[block]), _untimed(want[block])
            if block == "restore":
                g["snapshot"] = os.path.relpath(g["snapshot"], tdir)
                w["snapshot"] = os.path.relpath(w["snapshot"], jdir)
            if block == "storage":
                jitter = _manifest_bytes(tdir) - _manifest_bytes(jdir)
                assert g.pop("storage.disk_bytes") - w.pop("storage.disk_bytes") == jitter
            assert g == w, block
        if "--restore" in argv:
            assert "[restore] warm start" in out or "[restore] frozen snapshot" in out
        if "--live-verify" in argv:
            assert got["live-verify"]["ok"] is True
        if "--distributed" in argv:
            assert "MISMATCH" not in json.dumps(got["dist-verify"])
            assert got["dist-verify"]["dist.verify_ok"] == 1
    if seq == "live-checkpoint-restore":
        assert got["restore"]["snapshot_epoch"] == got["restore"]["final_epoch"] == 2
        assert got["live"]["inc.epoch"] == 4


def test_mvcc_concurrency_4_matches_reference_order_free(tmp_path, capsys, fresh_registries):
    """Four clients and a writer: what does not depend on the threads'
    order equals the reference's (the KB, the load, the queries served,
    zero stale reads, a verified final store, the checkpoints' presence)."""
    argv = [*LUBM_LIVE[:6], "--mvcc", "--concurrency", "4", "--live", "--update-every", "60",
            "--update-size", "6", "--live-verify", "--checkpoint-dir", "{D}",
            "--checkpoint-every", "1"]
    want = _report(jserve.main, [a.replace("{D}", str(tmp_path / "j")) for a in argv],
                   tmp_path / "ref.jsonl")
    got = _report(serve.main, [*(a.replace("{D}", str(tmp_path / "t")) for a in argv),
                               "--device", "cpu"], tmp_path / "port.jsonl")
    capsys.readouterr()
    assert set(got) == set(want) | {"kernels"}
    for block in ("kb:lubm", "materialise", "fixpoint"):
        assert _untimed(got[block]) == _untimed(want[block]), block
    for key in ("concurrency", "queries", "stale_reads"):
        assert got["serving"][key] == want["serving"][key], key
    assert got["serving"]["stale_reads"] == 0 and got["serving"]["queries"] == 300
    assert got["serve"]["queries"] == 300 and got["live-verify"]["ok"] is True
    live = got["live"]
    # how many batches land before the clients finish depends on the threads
    assert live["inc.epoch"] == live["apply_batches"] == got["serving"]["applies"] >= 1
    assert got["serving"]["epochs_published"] >= live["apply_batches"] + 1
    assert got["storage"]["storage.checkpoints"] == live["apply_batches"] + 1


def test_mvcc_rejects_distributed(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--mvcc", "--distributed"])
    assert exc.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err


def test_mvcc_client_failure_exits_non_zero(monkeypatch, capsys, fresh_registries):
    """An error in a client thread reaches the caller."""
    from repro_torch.serving import ServingTier

    real = ServingTier.answer
    calls = {"n": 0}

    def flaky(self, text, timeout=60.0):
        calls["n"] += 1
        if calls["n"] == 70:  # past the warm-up, inside a client thread
            raise RuntimeError("client failed")
        return real(self, text, timeout)

    monkeypatch.setattr(ServingTier, "answer", flaky)
    with pytest.raises(RuntimeError, match="client failed"):
        serve.main([*LUBM_STATIC, "--device", "cpu", "--mvcc", "--concurrency", "2"])
    capsys.readouterr()


def test_run_returns_the_served_state(tmp_path, capsys, fresh_registries):
    """``run`` hands back the checkpoint manager, the recovery and the
    distributed engine for drivers."""
    argv = [*LUBM_LIVE, "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "1"]
    served = serve.run(argv)
    assert served.rc == 0 and served.recovery is None
    assert served.ckpt.latest().endswith(f"snap-{served.inc.epoch:08d}")
    restored = serve.run([*argv, "--restore", "--n-queries", "10"])
    assert restored.recovery.final_epoch == served.inc.epoch == restored.inc.epoch
    dist = serve.run(["--kb", "chain", "--scale", "1", "--n-queries", "5", "--device", "cpu",
                      "--distributed"])
    assert dist.dist is not None and dist.dist.n_shards == 1
    capsys.readouterr()
