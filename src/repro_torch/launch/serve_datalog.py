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

``--checkpoint-dir`` makes the store durable: update batches are
write-ahead logged, a snapshot is checkpointed every
``--checkpoint-every`` batches (and once more at the end), and
``--restore`` warm-starts from the latest snapshot + WAL replay instead of
re-materialising.  Without ``--live`` the directory holds one frozen
snapshot of the static materialisation, and ``--restore`` serves from it.
Snapshots and WAL files are the JAX package's format, byte for byte.

``--mvcc`` serves through the epoch-based :class:`~repro_torch.serving.ServingTier`:
``--concurrency`` closed-loop client threads, micro-batched admission over
pinned epochs, update batches through the tier's single writer thread.
``--distributed`` shadows the KB on the :class:`~repro_torch.core.distributed.DistributedEngine`
(one shard per visible device of the server's device type: every card, or
the one CPU): it is materialised beside the host
store, checked against it (``[dist-verify]``), and under ``--live`` every
update batch also goes through its ``apply``.  ``--mvcc`` and
``--distributed`` exclude each other, as in the JAX package.

Everything runs on ``--device`` (default ``cuda``; without a card the
server raises, it never falls back).  On a card the hand kernels run, on
the CPU their plain versions; the ``[kernels]`` block reports the kernel
facade's registry meter and the launch meter's per-kernel counts.

``--provenance`` records the derivation journal
(:mod:`repro_torch.obs.provenance`) through materialisation and updates;
``--explain FACT`` (repeatable) and ``--explain-sample N`` add verified
proof trees, built on the store's device, and ``--hot-rules`` the
per-rule cost table (any of the three turns the journal on).  The
``[provenance]`` block reports them; a rule's ``time_ns`` is host time,
which on a card holds device time only where the rule waits for it.  A
failure in a server thread reaches the caller and a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import CMatEngine, Dictionary, Program, flat_seminaive
from ..core.generators import chain, lubm_like, paper_example, star
from ..core.distributed import DistributedEngine, visible_devices
from ..core.frozen import FrozenFacts
from ..core.util import resolve_device, synchronize
from ..incremental import IncrementalStore
from ..kernels import ops
from ..obs import (
    get_journal,
    get_registry,
    get_tracer,
    publish_predicate_effectiveness,
    publish_query_cache,
    publish_serving,
    sample_memory,
    span,
    write_chrome_trace,
    write_metrics,
)
from ..query import QueryEngine
from ..serving import ServingTier
from ..storage import CheckpointManager, RecoveryStats, load_frozen, write_snapshot

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


def _parse_fact_spec(spec: str, dictionary):
    """``pred(t1, t2)`` -> ``(pred, (id1, id2))``; terms resolve through
    the KB dictionary, falling back to raw integer ids."""
    spec = spec.strip()
    if "(" not in spec or not spec.endswith(")"):
        raise ValueError(f"bad --explain spec {spec!r}; expected pred(term, term)")
    pred, rest = spec.split("(", 1)
    terms = []
    for tok in rest[:-1].split(","):
        tok = tok.strip().strip("'\"")
        if dictionary is not None and tok in dictionary:
            terms.append(dictionary.id_of(tok))
        else:
            terms.append(int(tok))
    return pred.strip(), tuple(terms)


def _proof_summary(node: dict) -> dict:
    depth, n_nodes, all_verified = 0, 0, True
    stack = [(node, 1)]
    while stack:
        nd, d = stack.pop()
        n_nodes += 1
        depth = max(depth, d)
        all_verified = all_verified and bool(nd.get("verified"))
        for child in nd.get("children", ()):
            stack.append((child, d + 1))
    return {"depth": depth, "nodes": n_nodes, "verified": all_verified}


def _sample_derived(mat, explicit, n: int, seed: int):
    """Up to ``n`` (pred, terms) pairs drawn from the materialisation
    minus the explicit set, the JAX package's draw: the pool is counted
    per predicate on the store's device (no list of its facts) and the
    chosen pool positions are mapped back through the per-predicate
    offsets."""
    from ..core.util import multicol_member

    preds, derived = [], []
    for pred in sorted(mat):
        rows = mat[pred]
        rows = rows.reshape(rows.shape[0], -1)
        keep = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        exp = explicit.get(pred)
        if exp is not None and exp.shape[0]:
            exp = exp.reshape(exp.shape[0], -1)
            if exp.shape[1] == rows.shape[1]:
                keep = ~multicol_member(rows, exp.to(rows.device))
        preds.append((pred, rows))
        derived.append(keep)
    if not preds:
        return []
    counts = torch.stack([k.sum() for k in derived]).tolist()
    total = sum(counts)
    if not total:
        return []
    rng = np.random.default_rng(seed)
    idx = rng.choice(total, size=min(n, total), replace=False)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    owner = np.searchsorted(offsets, idx, side="right") - 1
    picked = {}
    for k in sorted(set(owner.tolist())):
        pred, rows = preds[k]
        at = idx[owner == k] - offsets[k]
        positions = torch.nonzero(derived[k]).flatten()
        sel = positions[torch.as_tensor(at, device=positions.device)]
        picked.update(zip(
            (int(i) for i in idx[owner == k]),
            ((pred, tuple(r)) for r in rows[sel].tolist()),
        ))
    return [picked[int(i)] for i in idx]


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


#: how long an MVCC client waits for an answer: a request can queue behind
#: a micro-batch and a writer's apply and checkpoint, which take tens of
#: seconds each at ``--scale 10000`` (the tier's own default is 60 s)
CLIENT_TIMEOUT_S = 600.0

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
    ap.add_argument("--mvcc", action="store_true",
                    help="serve through the epoch-based MVCC tier "
                         "(repro_torch.serving): concurrent client threads, "
                         "micro-batched admission, single writer thread")
    ap.add_argument("--concurrency", type=int, default=1, metavar="N",
                    help="closed-loop client threads in --mvcc mode")
    ap.add_argument("--distributed", action="store_true",
                    help="shadow the KB on the distributed engine (one shard on "
                         "--device); with --live, updates also go through its "
                         "apply and the final state is checked against the host "
                         "store")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="durable storage root: WAL + periodic snapshots")
    ap.add_argument("--checkpoint-every", type=int, default=5,
                    help="checkpoint every N applied update batches (--live; a "
                         "final checkpoint always runs)")
    ap.add_argument("--restore", action="store_true",
                    help="warm-start from the latest snapshot (+ WAL replay in "
                         "--live mode) instead of materialising")
    ap.add_argument("--provenance", action="store_true",
                    help="record the derivation journal during "
                         "materialisation/updates (implied by --explain, "
                         "--explain-sample, --hot-rules)")
    ap.add_argument("--explain", action="append", default=[], metavar="FACT",
                    help="explain one materialised fact, e.g. "
                         "'path(v000000, v000003)' (repeatable; terms resolve "
                         "through the KB dictionary, or raw ids)")
    ap.add_argument("--explain-sample", type=int, default=0, metavar="N",
                    help="explain N randomly sampled derived (non-explicit) "
                         "facts and verify their proofs")
    ap.add_argument("--hot-rules", action="store_true",
                    help="render the per-rule cost table (derived/redundant/"
                         "host time) from the journal")
    return ap


def _wants_provenance(args) -> bool:
    return bool(args.provenance or args.explain or args.explain_sample or args.hot_rules)


@dataclass
class ServeRun:
    """What one run served: its exit code, the KB, the store (``source``;
    ``inc`` under ``--live``, ``--mvcc`` or a live restore), the query
    engine (``tier`` under ``--mvcc``), the stream, the update batches and
    how many were applied, the measured walls, the checkpoint manager and
    the recovery it did, and the distributed engine.  A caller can drive
    the same state further (one more batch, one more pass)."""

    rc: int
    program: Program
    dataset: dict
    dictionary: Dictionary
    source: CMatEngine | IncrementalStore | FrozenFacts
    inc: IncrementalStore | None = None
    qe: QueryEngine | None = None
    tier: ServingTier | None = None
    stream: list[str] = field(default_factory=list)
    batches: list = field(default_factory=list)
    applied: int = 0
    latencies_s: np.ndarray | None = None
    apply_s: list[float] = field(default_factory=list)
    ckpt: CheckpointManager | None = None
    recovery: RecoveryStats | None = None
    dist: DistributedEngine | None = None
    dist_materialise_s: float = 0.0
    dist_apply_s: list[float] = field(default_factory=list)


def _live_verify(report, program, inc) -> bool:
    """``[live-verify]``: the store against ``flat_seminaive`` of its
    explicit set, on the store's device."""
    want = {
        p: r
        for p, r in flat_seminaive(program, inc.explicit, device=inc.device).items()
        if r.shape[0]
    }
    got = inc.to_dict()
    ok = set(want) == set(got) and all(torch.equal(want[p], got[p]) for p in want)
    n_facts = sum(int(r.shape[0]) for r in want.values())
    report.emit(
        "live-verify",
        f"{'OK' if ok else 'MISMATCH'} ({n_facts} facts)",
        {"ok": ok, "facts": n_facts},
    )
    return ok


def _emit_storage(report, args, ckpt, tail: str = ")") -> None:
    reg = get_registry()
    reg.gauge("storage.disk_bytes").set(ckpt.disk_nbytes())
    reg.gauge("storage.wal_bytes").set(ckpt.wal.nbytes())
    st_snap = reg.snapshot("storage.")
    report.emit(
        "storage",
        f"{int(st_snap.get('storage.checkpoints', 0))} checkpoints "
        f"under {args.checkpoint_dir} "
        f"({st_snap['storage.disk_bytes'] / 1024:.1f}KiB on disk{tail}",
        st_snap,
    )


def _dist_verify(report, dist, host, what: str) -> bool:
    """``[dist-verify]``: the sharded state against the host's."""
    reg = get_registry()
    try:
        dist.check_integrity(host)
    except AssertionError as e:
        reg.counter("dist.verify_mismatch").inc()
        report.emit("dist-verify", f"MISMATCH: {e}",
                    {**reg.snapshot("dist.verify"), "error": str(e)})
        return False
    reg.counter("dist.verify_ok").inc()
    report.emit("dist-verify", f"OK ({what})", reg.snapshot("dist.verify"))
    return True


def _serve_mvcc(args, report, served, flush_telemetry, update_at) -> int:
    """Concurrent MVCC serving loop: ``--concurrency`` closed-loop client
    threads answer through the :class:`ServingTier` (micro-batched
    admission over pinned epochs) while update batches flow through the
    tier's writer thread every ``update_at`` served queries.  An error in
    a client thread is raised here once the threads are joined."""
    inc, ckpt, stream, batches = served.inc, served.ckpt, served.stream, served.batches
    tier = served.tier = ServingTier(
        inc,
        served.dictionary,
        result_cache_size=0 if args.no_result_cache else 1024,
        checkpoint=ckpt if args.live else None,
        checkpoint_every=args.checkpoint_every if args.live else 0,
        compact_threshold=args.compact_threshold if args.live else 0.0,
    )
    n_clients = max(args.concurrency, 1)
    lat_lock = threading.Lock()
    latencies: list[float] = []
    totals = {"answers": 0, "stale": 0, "served": 0}
    errors: list[BaseException] = []
    apply_lat: list[float] = []
    try:
        # warmup off the measured path: snapshots, plans, caches
        with span("serve.warmup"):
            for text in dict.fromkeys(stream[: min(50, len(stream))]):
                tier.answer(text)
        tier.reset_counters()
        tier.start()

        shards = [stream[i::n_clients] for i in range(n_clients)]

        def client(shard):
            local_lat = []
            answers = stale = 0
            try:
                for text in shard:
                    t0 = time.perf_counter()
                    resp = tier.answer(text, timeout=CLIENT_TIMEOUT_S)
                    local_lat.append(time.perf_counter() - t0)
                    answers += resp.n_answers
                    stale += int(resp.stale)
                    with lat_lock:
                        totals["served"] += 1
            except BaseException as e:  # noqa: BLE001 — raised by the main thread
                with lat_lock:
                    errors.append(e)
            with lat_lock:
                latencies.extend(local_lat)
                totals["answers"] += answers
                totals["stale"] += stale

        threads = [
            threading.Thread(target=client, args=(s,), daemon=True) for s in shards if s
        ]
        t_serve0 = time.perf_counter()
        for th in threads:
            th.start()
        # the main thread feeds the writer: one update batch per
        # `update_at` served queries, applied through the writer thread
        # and published as a fresh epoch
        next_batch = 0
        while any(th.is_alive() for th in threads):
            if (
                args.live
                and next_batch < len(batches)
                and totals["served"] >= (next_batch + 1) * update_at
            ):
                deletions, additions = batches[next_batch]
                next_batch += 1
                t0 = time.perf_counter()
                tier.apply_sync(additions=additions, deletions=deletions)
                apply_lat.append(time.perf_counter() - t0)
                sample_memory(phase="serve_batch", rss=False)
                flush_telemetry()
            else:
                time.sleep(0.001)
        for th in threads:
            th.join()
        t_serve = time.perf_counter() - t_serve0
    finally:
        tier.close()
    if errors:
        raise errors[0]
    served.applied, served.apply_s = next_batch, apply_lat
    served.latencies_s = np.asarray(latencies)
    if args.live and ckpt is not None:
        ckpt.checkpoint(inc)  # final durable state via the LATEST pointer

    reg = get_registry()
    lat_ms = (np.asarray(latencies) if latencies else np.zeros(1)) * 1e3
    lat_hist = reg.histogram("serve.query_s")
    for v in latencies:
        lat_hist.observe(float(v))
    publish_serving(tier)
    st = tier.stats()
    qps = len(latencies) / max(t_serve, 1e-9)
    report.emit(
        "serve",
        f"{len(latencies)} queries in {t_serve:.2f}s ({qps:.0f} q/s), "
        f"{totals['answers']} answers total",
        {"queries": len(latencies), "seconds": t_serve, "qps": qps,
         "answers": totals["answers"]},
    )
    report.emit(
        "latency",
        f"p50={np.percentile(lat_ms, 50):.3f}ms "
        f"p90={np.percentile(lat_ms, 90):.3f}ms "
        f"p99={np.percentile(lat_ms, 99):.3f}ms "
        f"max={lat_ms.max():.3f}ms",
        reg.snapshot("serve.query_s"),
    )
    report.emit(
        "serving",
        f"mvcc concurrency={n_clients}: {qps:.0f} q/s, "
        f"p99={np.percentile(lat_ms, 99):.3f}ms; "
        f"{st['batches']} micro-batches "
        f"(mean {st['mean_batch']:.1f}, max {st['max_batch']}, "
        f"{st['dedup_hits']} dedup / {st['grouped_queries']} grouped / "
        f"{st['cache_hits']} cached), "
        f"epochs: {st['epochs_published']} published, "
        f"{st['epochs_retired']} retired, {st['epochs_live']} live, "
        f"lag<={st['epoch_lag_max']}; {st['stale_reads']} stale reads, "
        f"{st['compactions']} compactions "
        f"({st['compactions_deferred']} deferred)",
        {
            "concurrency": n_clients,
            "qps": qps,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            **st,
        },
    )
    if st["stale_reads"]:
        report.emit(
            "serving-verify",
            f"FAILED: {st['stale_reads']} stale reads (must be 0)",
            {"stale_reads": st["stale_reads"]},
        )
        return 1
    report.emit("store", f"{inc.store.n_nodes()} mu-nodes", {"mu_nodes": inc.store.n_nodes()})
    if args.live:
        ap_ms = (np.asarray(apply_lat) if apply_lat else np.zeros(1)) * 1e3
        inc_snap = reg.snapshot("inc.")
        report.emit(
            "live",
            f"{len(apply_lat)} update batches through the writer thread "
            f"(epoch {inc.epoch}), apply p50={np.percentile(ap_ms, 50):.2f}ms "
            f"p99={np.percentile(ap_ms, 99):.2f}ms; "
            f"{int(inc_snap.get('inc.n_deleted', 0))} deleted / "
            f"{int(inc_snap.get('inc.n_inserted', 0))} inserted facts",
            {**inc_snap, "apply_batches": len(apply_lat)},
        )
        if ckpt is not None:
            _emit_storage(report, args, ckpt)
        if args.live_verify and not _live_verify(report, inc.program, inc):
            return 1
    return 0


def _start(args, report, program, dataset, device, ckpt, kb_label):
    """Load and materialise, or restore: ``(source, inc, stats,
    recovery)``, reported as ``[materialise]`` + ``[fixpoint]`` or
    ``[restore]``; the wall ends in a synchronisation of the device."""
    static_snap = os.path.join(args.checkpoint_dir, "frozen") if args.checkpoint_dir else None
    t0 = time.perf_counter()
    inc = recovery = stats = None
    if args.live or args.mvcc:
        # --mvcc always serves from an IncrementalStore: the tier publishes
        # epochs by freezing it (a static KB just never applies)
        if ckpt is not None and args.restore and ckpt.has_snapshot():
            inc, recovery = ckpt.restore(program, device=device)
        else:
            inc = IncrementalStore(program, device=device)
            stats = inc.load(dataset)
            if ckpt is not None:
                # a cold start owns the directory: a previous run's
                # snapshots and WAL must not interleave with fresh epochs
                ckpt.reset()
                inc.attach_wal(ckpt.wal)
        source = inc
    elif (
        args.restore
        and static_snap is not None
        and os.path.exists(os.path.join(static_snap, "manifest.json"))
    ):
        source = load_frozen(static_snap, expected_label=kb_label, device=device)
    else:
        eng = CMatEngine(program, dedup_index=True, device=device)
        eng.load(dataset)
        stats = eng.materialise()
        source = eng
        if static_snap is not None:
            frozen = eng.facts.freeze()
            rows = {p: frozen.snapshot(p) for p in frozen.predicates()}
            write_snapshot(static_snap, eng.facts, kind="frozen", label=kb_label, rows=rows)
    synchronize(device)
    t_mat = time.perf_counter() - t0
    if stats is not None:
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
    elif recovery is not None:
        # rendered from the registry scope the restore published into
        snap = get_registry().snapshot("storage.")
        report.emit(
            "restore",
            f"warm start from {recovery.snapshot}: snapshot "
            f"{snap['storage.restore_snapshot_s']:.3f}s + "
            f"{int(snap['storage.wal_replayed'])} WAL "
            f"batches {snap['storage.restore_replay_s']:.3f}s (epoch "
            f"{recovery.snapshot_epoch} -> {recovery.final_epoch}), "
            f"{inc.facts.n_facts()} facts in "
            f"{inc.facts.n_meta_facts()} meta-facts; total {t_mat:.3f}s",
            {**snap, "snapshot": recovery.snapshot,
             "snapshot_epoch": recovery.snapshot_epoch,
             "final_epoch": recovery.final_epoch, "seconds": t_mat},
        )
    else:
        report.emit(
            "restore",
            f"frozen snapshot served from {static_snap}, {t_mat:.3f}s",
            {"snapshot": static_snap, "seconds": t_mat},
        )
    # high-water mark of the load/materialise/restore phase; the
    # per-predicate compression gauges start from the fresh store
    sample_memory(phase="restore" if stats is None else "materialise")
    publish_predicate_effectiveness(inc.facts if inc is not None else source.facts)
    return source, inc, recovery


def _sync_shards(dist) -> None:
    for dev in dict.fromkeys(dist.devices):
        synchronize(dev)


def _start_distributed(report, served, device) -> bool:
    """``--distributed``: the KB hash-partitioned over one shard per
    visible device of ``device``'s type (``visible_devices``), materialised
    from the host store's explicit set (the restored one after a warm
    start) with buffers sized from the host materialisation; a static run
    is checked against the host here.  False when that check failed."""
    program, inc, source = served.program, served.inc, served.source
    dprog = DistributedEngine.supported_program(program)
    mat_rows = (
        inc.to_dict() if inc is not None
        else source.materialisation() if hasattr(source, "materialisation")
        else None
    )
    # 2x headroom over the biggest predicate: every device op scales with
    # capacity, not live rows
    cap = 1 << 14
    if mat_rows:
        biggest = max((int(r.shape[0]) for r in mat_rows.values()), default=0)
        cap = max(1 << 10, 1 << int(np.ceil(np.log2(max(2 * biggest, 2)))))
    dist = served.dist = DistributedEngine(
        dprog, devices=visible_devices(device), capacity=cap
    )
    t0 = time.perf_counter()
    dist.materialise(inc.explicit if inc is not None else served.dataset)
    _sync_shards(dist)
    served.dist_materialise_s = time.perf_counter() - t0
    ds = dist.stats
    report.emit(
        "distributed",
        f"{dist.n_shards} shard(s), {dist.rounds} "
        f"rounds over {ds.n_strata} strata in {served.dist_materialise_s:.2f}s; "
        f"{ds.n_rule_applications} rule applications "
        f"({ds.rule_applications_skipped} skipped), "
        f"{ds.rows_joined} rows joined, {ds.exchanges} exchanges "
        f"({ds.exchanges_skipped} elided by planner keys, "
        f"{ds.exchange_regrows} regrows)",
        get_registry().snapshot("dist."),
    )
    if len(dprog) != len(program):
        report.emit(
            "distributed",
            f"{len(program) - len(dprog)} rule(s) outside the distributed "
            f"fragment — differential checks disabled",
            {"unsupported_rules": len(program) - len(dprog)},
        )
    elif inc is None and mat_rows is not None:
        return _dist_verify(report, dist, mat_rows, "sharded materialisation == host")
    return True


def run(argv=None) -> ServeRun:
    """Parse ``argv``, serve, report; returns the :class:`ServeRun`."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mvcc and args.distributed:
        ap.error("--mvcc and --distributed are mutually exclusive")
    device = resolve_device(args.device)
    if _wants_provenance(args):
        journal = get_journal()
        journal.enabled = True
        journal.clear()

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

    kb_label = f"{args.kb}:scale{args.scale}"
    ckpt = CheckpointManager(args.checkpoint_dir, label=kb_label) if args.checkpoint_dir else None
    source, inc, recovery = _start(args, report, program, dataset, device, ckpt, kb_label)
    served = ServeRun(0, program, dataset, dictionary, source, inc, ckpt=ckpt,
                      recovery=recovery)
    if args.distributed and not _start_distributed(report, served, device):
        served.rc = 1
        return served

    stream = served.stream = make_stream(
        args.kb, args.scale, args.n_queries, args.zipf, args.seed)
    if not stream:
        print("[serve] empty query stream (--n-queries 0); nothing to do")
        return served

    update_at = max(args.update_every, 1)
    served.batches = batches = (
        make_update_batches(
            dataset, len(stream) // update_at + 1, args.update_size, args.seed
        )
        if args.live
        else []
    )

    if args.mvcc:
        served.rc = _serve_mvcc(args, report, served, flush_telemetry, update_at)
        if not served.rc:
            _emit_tail(args, report, served, flush_telemetry)
        return served

    dist = served.dist
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
    synchronize(device)
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
                synchronize(device)
                apply_lat.append(time.perf_counter() - t0)
                if dist is not None:
                    # the same batch through the distributed engine
                    t0 = time.perf_counter()
                    dist.apply(additions=additions, deletions=deletions)
                    _sync_shards(dist)
                    served.dist_apply_s.append(time.perf_counter() - t0)
                if (
                    ckpt is not None
                    and args.checkpoint_every > 0
                    and next_batch % args.checkpoint_every == 0
                ):
                    ckpt.checkpoint(inc)
                sample_memory(phase="serve_batch", rss=False)
            # live telemetry: the files track the loop batch by batch
            flush_telemetry()
        t0 = time.perf_counter()
        res = qe.answer(text)
        synchronize(device)
        latencies[i] = time.perf_counter() - t0
        n_answers += res.n_answers
    t_serve = time.perf_counter() - t_serve0
    served.applied, served.latencies_s, served.apply_s = next_batch, latencies, apply_lat
    if args.live and ckpt is not None:
        ckpt.checkpoint(inc)  # final durable state for the next restore

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
        if ckpt is not None:
            _emit_storage(
                report, args, ckpt,
                f", WAL {ckpt.wal.nbytes()}B), journal "
                f"{int(inc_snap.get('inc.journal_bytes', 0))}B resident",
            )
        if dist is not None and served.dist_apply_s:
            dl_ms = np.asarray(served.dist_apply_s) * 1e3
            ds = dist.stats
            report.emit(
                "distributed",
                f"{len(served.dist_apply_s)} update batches through the "
                f"exchange, apply p50={np.percentile(dl_ms, 50):.2f}ms "
                f"p99={np.percentile(dl_ms, 99):.2f}ms "
                f"(last batch: {ds.n_overdeleted} overdeleted, "
                f"{ds.n_rederived} rederived, {ds.n_inserted} inserted)",
                reg.snapshot("dist."),
            )
            if len(dist.program) == len(program) and not _dist_verify(
                    report, dist, inc, "sharded state == host store"):
                served.rc = 1
                return served
        if args.live_verify and not _live_verify(report, program, inc):
            served.rc = 1
            return served
    _emit_tail(args, report, served, flush_telemetry)
    return served


def _emit_provenance(args, report, served) -> None:
    """``[provenance]``: the journal's size, the explanations of the
    ``--explain`` facts and ``--explain-sample`` draws (each a verified
    proof tree, or not found), and the ``--hot-rules`` table."""
    journal = get_journal()
    inc, source, dictionary = served.inc, served.source, served.dictionary
    explain_src = (
        inc if inc is not None
        else source if hasattr(source, "explain_fact") else None
    )

    def _decode(tid):
        try:
            return dictionary.term_of(int(tid))
        except (KeyError, IndexError):  # an id outside the dictionary
            return int(tid)

    targets, parse_errors = [], []
    for spec in args.explain:
        try:
            targets.append(_parse_fact_spec(spec, dictionary))
        except ValueError as e:
            parse_errors.append(str(e))
    if args.explain_sample and explain_src is not None:
        mat = inc.to_dict() if inc is not None else source.materialisation()
        explicit = inc.explicit if inc is not None else source._explicit
        targets += _sample_derived(mat, explicit, args.explain_sample, args.seed)

    explanations = []
    if explain_src is not None:
        for pred, terms in targets:
            node = explain_src.explain_fact(pred, terms, decode=_decode)
            if node is None:
                shown = ", ".join(str(_decode(t)) for t in terms)
                explanations.append(
                    {"fact": f"{pred}({shown})", "found": False, "verified": False})
            else:
                explanations.append(
                    {"fact": node["fact"], "found": True, **_proof_summary(node)})
    hot = journal.hot_rules(10) if args.hot_rules else []
    n_ok = sum(1 for e in explanations if e["verified"])
    prov_bytes = journal.memory_report()["journal_bytes"]
    text = (
        f"journal {len(journal.records)} records "
        f"({journal.dropped} dropped, {prov_bytes / 1024:.1f}KiB)"
    )
    if explanations:
        text += f"; {n_ok}/{len(explanations)} explanations verified"
    elif targets and explain_src is None:
        text += "; explain skipped (frozen snapshot serving, no engine)"
    report.emit(
        "provenance", text,
        {"records": len(journal.records), "dropped": journal.dropped,
         "journal_bytes": prov_bytes, "explanations": explanations,
         "hot_rules": hot, "parse_errors": parse_errors,
         "explain_available": explain_src is not None},
    )
    for e in explanations:
        mark = "ok" if e["verified"] else ("NOT FOUND" if not e["found"] else "UNVERIFIED")
        extra = f" depth={e['depth']} nodes={e['nodes']}" if e["found"] else ""
        print(f"  explain {e['fact']}: {mark}{extra}")
    if hot:
        print("  hot rules (by recorded host time):")
        for h in hot:
            print(
                f"    R{h['rule_id']:<3} {h['time_ns'] / 1e6:8.2f}ms  "
                f"derived={h['derived']:<8} redundant={h['redundant']:<8} "
                f"rounds={h['rounds_active']:<3} {h['rule']}"
            )


def _emit_tail(args, report, served, flush_telemetry) -> None:
    """Trailing report blocks: provenance, kernels, memory, trace,
    metrics."""
    if _wants_provenance(args):
        _emit_provenance(args, report, served)
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
    # --trace-out enables the process tracer and the provenance flags the
    # journal: restore both on every exit path so in-process callers see
    # no state leak
    tr = get_tracer()
    was_enabled = tr.enabled
    journal = get_journal()
    prov_was = journal.enabled
    try:
        return run(argv).rc
    finally:
        if not was_enabled:
            tr.disable()
        if not prov_was:
            journal.enabled = False
            journal.clear()


if __name__ == "__main__":
    raise SystemExit(main())
