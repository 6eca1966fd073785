"""Batched datalog query serving on one device: materialise once, answer a
query stream.

    PYTHONPATH=src python -m repro_torch.launch.serve_datalog --kb lubm \
        --n-queries 2000 --zipf 1.1 [--device cuda|cpu]

Load a KB, run the compressed materialisation once, freeze the store,
then serve a stream of templated BGP queries through
:class:`repro_torch.query.QueryEngine` (LRU plan and result caches,
scratch reclaimed per miss) and report p50/p99 latency, throughput, the
cache hit rate and the store's node count.  Query streams are drawn from
per-KB templates with Zipf-distributed constants; ``--no-result-cache``
measures pure evaluation throughput instead.

``--live`` turns the server into an update-serving loop: the KB is held
in a :class:`repro_torch.incremental.IncrementalStore`, and every
``--update-every`` queries a batch of ``--update-size`` explicit facts is
deleted (and the batch deleted one update earlier re-inserted, so the KB
churns without draining).  Each applied batch bumps the query engine's
epoch, invalidating the version-stamped caches; ``--compact-threshold``
triggers a compaction epoch when deletion churn strands more than that
fraction of mu-nodes.  The report adds apply-latency percentiles, stale
evictions and, with ``--live-verify``, a final check against
``flat_seminaive`` of the ending explicit set, on the store's device.

Everything runs on ``--device`` (default ``cuda``; without a card the
server raises, it never falls back).  On a card the hand kernels run, on
the CPU their plain versions; the ``[kernels]`` block reports the kernel
facade's registry meter and the launch meter's per-kernel counts.  The
flags for durable storage, the MVCC tier, the sharded engine and
provenance are not ported yet and exit with the ``ROADMAP.md`` item that
will port them.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import CMatEngine, Dictionary, Program, flat_seminaive
from ..core.generators import chain, lubm_like, paper_example, star
from ..core.util import resolve_device
from ..incremental import IncrementalStore
from ..kernels import ops
from ..obs import (
    get_registry,
    get_tracer,
    publish_predicate_effectiveness,
    publish_query_cache,
    sample_memory,
    span,
    write_chrome_trace,
    write_metrics,
)
from ..query import QueryEngine

__all__ = [
    "ReportSink",
    "ServeRun",
    "build_kb",
    "main",
    "make_stream",
    "make_update_batches",
    "query_templates",
    "run",
]


class ReportSink:
    """Report sink: every block prints its ``[tag] ...`` line and (with
    ``--report-json``) appends one JSON object per block, ``{"block":
    tag, ...data}``.  Thread-safe: the print and the JSON append happen
    under one lock, and each record is serialised outside it and written
    with a single ``write``."""

    def __init__(self, json_path: str | None = None):
        self._fh = open(json_path, "w") if json_path else None
        self._lock = threading.Lock()

    def emit(self, block: str, text: str, data: dict | None = None) -> None:
        line = f"[{block}] {text}"
        rec = None
        if self._fh is not None:
            payload = {"block": block}
            payload.update(data or {})
            rec = json.dumps(payload, default=float, sort_keys=True) + "\n"
        with self._lock:
            print(line)
            if rec is not None and self._fh is not None:
                self._fh.write(rec)
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def build_kb(name: str, scale: int):
    if name == "lubm":
        return lubm_like(
            n_dept=4 * scale, n_students=100 * scale, n_courses=8 * scale, seed=0
        )
    if name == "chain":
        return chain(n=60 * scale)
    if name == "star":
        return star(n_spokes=400 * scale, n_hubs=3)
    if name == "paper":
        return paper_example(n=4 * scale, m=3 * scale)
    raise ValueError(f"unknown KB {name!r} (use lubm|chain|star|paper)")


def query_templates(name: str, scale: int):
    """(template, constant-pool) pairs; ``{c}`` is filled per request."""
    if name == "lubm":
        return [
            ('?s, ?c <- memberOf(?s, "{c}"), takesCourse(?s, ?c)',
             [f"dept{i}" for i in range(4 * scale)]),
            ('?s <- takesCourse(?s, "{c}"), GraduateStudent(?s)',
             [f"course{i}" for i in range(8 * scale)]),
            ('?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)',
             None),
            ('?x, ?u <- memberOf(?x, ?dv), subOrganizationOf(?dv, ?u)', None),
            ('?p <- teacherOf(?p, "{c}")', [f"course{i}" for i in range(8 * scale)]),
        ]
    if name == "chain":
        n = 60 * scale
        return [
            ('?y <- path("{c}", ?y)', [f"v{i:06d}" for i in range(n)]),
            ('?x <- path(?x, "{c}")', [f"v{i:06d}" for i in range(1, n + 1)]),
            ('?x, ?z <- edge(?x, ?y), edge(?y, ?z)', None),
        ]
    if name == "star":
        return [
            ('?y <- S("{c}", ?y)', [f"s{i:06d}" for i in range(0, 400 * scale, 2)]),
            ('?x, ?z <- S(?x, ?y), T(?y, ?z)', None),
        ]
    if name == "paper":
        return [
            ("?x, ?y <- S(?x, ?y)", None),
            ('?x, ?z <- P(?x, ?y), T(?y, ?z)', None),
            ('?y <- P("a2", ?y)', None),
        ]
    raise ValueError(name)


def make_stream(name: str, scale: int, n_queries: int, zipf: float, seed: int):
    rng = np.random.default_rng(seed)
    templates = query_templates(name, scale)
    out = []
    for _ in range(n_queries):
        template, pool = templates[int(rng.integers(0, len(templates)))]
        if pool is None:
            out.append(template)
            continue
        # Zipf skew over the pool, the tail folded back with a modulo
        # (clamping would pile every out-of-range draw onto one element)
        rank = int(rng.zipf(zipf)) - 1 if zipf > 1.0 else int(
            rng.integers(0, len(pool))
        )
        out.append(template.format(c=pool[rank % len(pool)]))
    return out


def _rows_by_pred(items):
    out: dict[str, list] = {}
    for pred, row in items:
        out.setdefault(pred, []).append(row)
    return {p: np.asarray(r, dtype=np.int64) for p, r in out.items()}


def make_update_batches(dataset, n_updates: int, size: int, seed: int):
    """Rotating explicit-fact update batches: each batch deletes ``size``
    facts from a shuffled pool and re-inserts the batch deleted one
    update earlier (the KB churns but never drains).  The pool and its
    shuffle are the JAX package's, so a seed picks the same facts."""
    rng = np.random.default_rng(seed + 1)
    pool = [
        (pred, tuple(int(v) for v in row))
        for pred, rows in dataset.items()
        for row in np.asarray(rows).reshape(len(rows), -1)
    ]
    rng.shuffle(pool)
    batches = []
    prev: list = []
    off = 0
    for _ in range(n_updates):
        cur = [pool[(off + j) % len(pool)] for j in range(size)]
        off += size
        # (deletions, additions)
        batches.append((_rows_by_pred(cur), _rows_by_pred(prev)))
        prev = cur
    return batches


def _synchronize(device: torch.device) -> None:
    """Wait for the device's queued work, so a host wall covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: unported flags: (flag, ROADMAP item, what ports it)
_UNPORTED = (
    ("checkpoint_dir", "--checkpoint-dir", 8, "storage"),
    ("checkpoint_every", "--checkpoint-every", 8, "storage"),
    ("restore", "--restore", 8, "storage"),
    ("mvcc", "--mvcc", 10, "serving"),
    ("distributed", "--distributed", 10, "serving"),
    ("provenance", "--provenance", 9, "observability"),
    ("explain", "--explain", 9, "observability"),
    ("explain_sample", "--explain-sample", 9, "observability"),
    ("hot_rules", "--hot-rules", 9, "observability"),
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kb", default="lubm", choices=["lubm", "chain", "star", "paper"])
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--n-queries", type=int, default=2000)
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the store lives and the kernels run (cpu: "
                         "their plain versions)")
    ap.add_argument("--no-result-cache", action="store_true")
    ap.add_argument("--live", action="store_true",
                    help="serve updates interleaved with queries through "
                         "the incremental maintenance subsystem")
    ap.add_argument("--update-every", type=int, default=200,
                    help="apply an update batch every N queries (--live)")
    ap.add_argument("--update-size", type=int, default=8,
                    help="explicit facts deleted (and re-inserted) per batch")
    ap.add_argument("--live-verify", action="store_true",
                    help="check the final store against flat_seminaive of the "
                         "final explicit set (--live)")
    ap.add_argument("--compact-threshold", type=float, default=0.5,
                    help="dead mu-node fraction that triggers a compaction "
                         "epoch (--live; 0 disables)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome trace-event "
                         "JSON file here (rewritten after every update batch "
                         "in --live mode)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a flat JSON metrics-registry snapshot here "
                         "(periodic in --live mode, final always)")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="append one JSON object per report block here")
    # not ported yet: each exits naming its ROADMAP item
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR")
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--mvcc", action="store_true")
    ap.add_argument("--concurrency", type=int, default=1, metavar="N")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--provenance", action="store_true")
    ap.add_argument("--explain", action="append", default=[], metavar="FACT")
    ap.add_argument("--explain-sample", type=int, default=0, metavar="N")
    ap.add_argument("--hot-rules", action="store_true")
    return ap


@dataclass
class ServeRun:
    """What one run served: its exit code, the KB, the store (``source``;
    ``inc`` under ``--live``), the query engine, the stream, the update
    batches and how many were applied, and the measured walls.  A caller
    can drive the same state further (one more batch, one more pass)."""

    rc: int
    program: Program
    dataset: dict
    dictionary: Dictionary
    source: CMatEngine | IncrementalStore
    inc: IncrementalStore | None = None
    qe: QueryEngine | None = None
    stream: list[str] = field(default_factory=list)
    batches: list = field(default_factory=list)
    applied: int = 0
    latencies_s: np.ndarray | None = None
    apply_s: list[float] = field(default_factory=list)


def run(argv=None) -> ServeRun:
    """Parse ``argv``, serve, report; returns the :class:`ServeRun`."""
    ap = _parser()
    args = ap.parse_args(argv)
    for attr, flag, item, area in _UNPORTED:
        if getattr(args, attr):
            ap.error(f"{flag} is not ported yet ({area}: ROADMAP.md queue 1 item {item})")
    if args.concurrency > 1:
        ap.error("--concurrency above 1 is not ported yet (serving: ROADMAP.md "
                 "queue 1 item 10)")
    device = resolve_device(args.device)

    if args.trace_out:
        get_tracer().enable()
    report = ReportSink(args.report_json)

    def flush_telemetry() -> None:
        if args.metrics_out:
            write_metrics(args.metrics_out)
        if args.trace_out:
            write_chrome_trace(args.trace_out)

    program, dataset, dictionary = build_kb(args.kb, args.scale)
    n_explicit = sum(np.asarray(r).shape[0] for r in dataset.values())
    report.emit(
        f"kb:{args.kb}",
        f"{n_explicit} explicit facts, {len(program)} rules",
        {"explicit_facts": n_explicit, "rules": len(program), "scale": args.scale},
    )

    t0 = time.perf_counter()
    inc = None
    if args.live:
        inc = IncrementalStore(program, device=device)
        stats = inc.load(dataset)
        source = inc
    else:
        eng = CMatEngine(program, dedup_index=True, device=device)
        eng.load(dataset)
        stats = eng.materialise()
        source = eng
    _synchronize(device)
    t_mat = time.perf_counter() - t0
    report.emit(
        "materialise",
        f"{stats.rounds} rounds over {stats.n_strata} strata, "
        f"{stats.n_facts} facts in {stats.n_meta_facts} meta-facts, "
        f"{t_mat:.2f}s",
        {"rounds": stats.rounds, "n_strata": stats.n_strata,
         "n_facts": stats.n_facts, "n_meta_facts": stats.n_meta_facts,
         "seconds": t_mat},
    )
    report.emit(
        "fixpoint",
        f"{stats.n_rule_applications} rule applications, "
        f"{stats.rule_applications_skipped} skipped without a probe; "
        f"plans: {stats.plan_cache.get('plans', 0)} compiled, "
        f"{stats.plan_cache.get('plan_hits', 0)} hits, "
        f"{stats.plan_cache.get('plan_replans', 0)} replans",
        {"n_rule_applications": stats.n_rule_applications,
         "rule_applications_skipped": stats.rule_applications_skipped,
         **{f"plan_cache.{k}": v for k, v in stats.plan_cache.items()}},
    )

    # high-water mark of the load/materialise phase; the per-predicate
    # compression gauges start from the fresh store
    sample_memory(phase="materialise")
    publish_predicate_effectiveness(source.facts)

    stream = make_stream(args.kb, args.scale, args.n_queries, args.zipf, args.seed)
    served = ServeRun(0, program, dataset, dictionary, source, inc, stream=stream)
    if not stream:
        print("[serve] empty query stream (--n-queries 0); nothing to do")
        return served

    update_at = max(args.update_every, 1)
    batches = (
        make_update_batches(
            dataset, len(stream) // update_at + 1, args.update_size, args.seed
        )
        if args.live
        else []
    )
    served.batches = batches

    qe = served.qe = QueryEngine(
        source, dictionary, result_cache_size=0 if args.no_result_cache else 1024
    )
    # warmup: build snapshots and plans off the measured path
    with span("serve.warmup"):
        for text in dict.fromkeys(stream[: min(50, len(stream))]):
            qe.answer(text)
    warm_cells = qe.frozen.snapshot_cells
    warm_cache = qe.cache_stats()

    latencies = np.zeros(len(stream))
    apply_lat: list[float] = []
    n_answers = 0
    next_batch = 0
    _synchronize(device)
    t_serve0 = time.perf_counter()
    for i, text in enumerate(stream):
        if args.live and i and i % update_at == 0 and next_batch < len(batches):
            with span("serve.update_batch", batch=next_batch):
                deletions, additions = batches[next_batch]
                next_batch += 1
                t0 = time.perf_counter()
                inc.apply(additions=additions, deletions=deletions)
                inc.maybe_compact(args.compact_threshold)
                qe.bump_epoch(inc)
                _synchronize(device)
                apply_lat.append(time.perf_counter() - t0)
                sample_memory(phase="serve_batch", rss=False)
            # live telemetry: the files track the loop batch by batch
            flush_telemetry()
        t0 = time.perf_counter()
        res = qe.answer(text)
        _synchronize(device)
        latencies[i] = time.perf_counter() - t0
        n_answers += res.n_answers
    t_serve = time.perf_counter() - t_serve0
    served.applied, served.latencies_s, served.apply_s = next_batch, latencies, apply_lat

    lat_ms = latencies * 1e3
    # measured-window counters only (the warmup answered queries too)
    cache = {k: v - warm_cache[k] for k, v in qe.cache_stats().items()}
    hit_rate = cache["result_hits"] / max(
        cache["result_hits"] + cache["result_misses"], 1
    )
    lat_hist = get_registry().histogram("serve.query_s")
    for v in latencies:
        lat_hist.observe(float(v))
    publish_query_cache(qe)
    report.emit(
        "serve",
        f"{len(stream)} queries in {t_serve:.2f}s "
        f"({len(stream) / max(t_serve, 1e-9):.0f} q/s), "
        f"{n_answers} answers total",
        {"queries": len(stream), "seconds": t_serve,
         "qps": len(stream) / max(t_serve, 1e-9), "answers": n_answers},
    )
    report.emit(
        "latency",
        f"p50={np.percentile(lat_ms, 50):.3f}ms "
        f"p90={np.percentile(lat_ms, 90):.3f}ms "
        f"p99={np.percentile(lat_ms, 99):.3f}ms "
        f"max={lat_ms.max():.3f}ms",
        get_registry().snapshot("serve.query_s"),
    )
    report.emit(
        "cache",
        f"result hit rate {hit_rate:.1%} "
        f"(plans: {cache['plan_hits']} hits / {cache['plan_misses']} misses); "
        f"snapshot warmup {warm_cells} cells, "
        f"{qe.frozen.snapshot_cells - warm_cells} after",
        {**get_registry().snapshot("query."), "hit_rate": hit_rate},
    )
    report.emit(
        "store",
        f"{qe.frozen.store.n_nodes()} mu-nodes (flat across stream)",
        {"mu_nodes": qe.frozen.store.n_nodes()},
    )
    if args.live:
        reg = get_registry()
        ap_ms = np.asarray(apply_lat) * 1e3 if apply_lat else np.zeros(1)
        # the registry's inc. scope accumulated these batch by batch
        inc_snap = reg.snapshot("inc.")
        report.emit(
            "live",
            f"{len(apply_lat)} update batches applied "
            f"(epoch {inc.epoch}), apply p50={np.percentile(ap_ms, 50):.2f}ms "
            f"p99={np.percentile(ap_ms, 99):.2f}ms; "
            f"{int(inc_snap.get('inc.n_deleted', 0))} deleted / "
            f"{int(inc_snap.get('inc.n_inserted', 0))} inserted facts, "
            f"{int(inc_snap.get('inc.n_rederived', 0))} rederived; "
            f"{qe.stale_evictions} stale cache entries evicted",
            {**inc_snap, "stale_evictions": qe.stale_evictions},
        )
        usage = inc.mu_usage()
        reg.gauge("gc.nodes").set(usage.n_nodes)
        reg.gauge("gc.dead_fraction").set(usage.dead_fraction)
        reg.gauge("gc.resident_bytes").set(usage.total_bytes)
        gc_snap = reg.snapshot("gc.")
        n_compactions = int(gc_snap.get("gc.compactions", 0))
        compact_note = (
            f"{n_compactions} compaction epochs "
            f"(-{int(gc_snap.get('gc.nodes_reclaimed', 0))} "
            f"nodes, {int(gc_snap.get('gc.reshared_leaves', 0))} leaves "
            f"re-shared)"
            if n_compactions
            else "no compactions"
        )
        report.emit(
            "mu-gc",
            f"{usage.n_nodes} nodes "
            f"({usage.dead_fraction:.1%} dead, "
            f"{usage.total_bytes / 1024:.1f}KiB resident); {compact_note}",
            gc_snap,
        )
        if args.live_verify:
            want = {
                p: r
                for p, r in flat_seminaive(program, inc.explicit, device=inc.device).items()
                if r.shape[0]
            }
            got = inc.to_dict()
            ok = set(want) == set(got) and all(
                torch.equal(want[p], got[p]) for p in want
            )
            n_facts = sum(int(r.shape[0]) for r in want.values())
            report.emit(
                "live-verify",
                f"{'OK' if ok else 'MISMATCH'} ({n_facts} facts)",
                {"ok": ok, "facts": n_facts},
            )
            if not ok:
                served.rc = 1
                return served
    _emit_tail(args, report, flush_telemetry)
    return served


def _emit_tail(args, report, flush_telemetry) -> None:
    """Trailing report blocks: kernels, memory, trace, metrics."""
    traffic = ", ".join(
        f"{op}: {m['calls']} calls / {m['elements']} elems"
        for op, m in sorted(ops.meter().items())
    )
    launches = ops.launch_counts()
    launched = ", ".join(f"{k} {n}" for k, n in launches.items() if n)
    text = f"facade: {traffic or 'no metered calls'}; launches: {launched or 'none'}"
    report.emit(
        "kernels", text,
        {**get_registry().snapshot("kernels."), "launches": launches},
    )
    # final roll-up: resident bytes from the reporters, RSS, and the peak
    # watermarks the phase samples accumulated
    mem_rep = sample_memory()
    mem_snap = get_registry().snapshot("mem.")
    report.emit(
        "memory",
        f"resident {mem_rep['resident_bytes'] / 1024:.1f}KiB "
        f"(peak {int(mem_snap.get('mem.peak_resident_bytes', 0)) / 1024:.1f}"
        f"KiB), rss {mem_rep['rss_bytes'] / (1 << 20):.1f}MiB",
        mem_snap,
    )
    flush_telemetry()
    if args.trace_out:
        tr = get_tracer()
        report.emit(
            "trace",
            f"{len(tr.events)} span/instant events -> {args.trace_out} "
            f"({tr.dropped} dropped)",
            {"events": len(tr.events), "dropped": tr.dropped, "path": args.trace_out},
        )
    if args.metrics_out:
        report.emit(
            "metrics",
            f"{len(get_registry().snapshot())} metrics -> {args.metrics_out}",
            {"path": args.metrics_out},
        )
    report.close()


def main(argv=None) -> int:
    # --trace-out enables the process tracer: restore it on every exit
    # path so in-process callers see no state leak
    tr = get_tracer()
    was_enabled = tr.enabled
    try:
        return run(argv).rc
    finally:
        if not was_enabled:
            tr.disable()


if __name__ == "__main__":
    raise SystemExit(main())
