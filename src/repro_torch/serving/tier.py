"""ServingTier: epoch-based MVCC serving over an IncrementalStore.

Thread roles:

* **clients** call :meth:`ServingTier.answer`: enqueue a request into the
  admission queue and wait on its event.  They never touch the store.
* the **batch executor** (one thread) drains micro-batches, pins the
  current epoch, and answers the whole batch against that one pinned
  snapshot through the epoch's :class:`~repro_torch.query.QueryEngine`
  with shared-plan grouping (:mod:`repro_torch.query.batch`).
* the **writer** (one thread) applies :meth:`IncrementalStore.apply`
  batches; the store's publish-after-apply hook freezes a pinned snapshot
  and publishes a new epoch entry; checkpoints go through the
  :class:`~repro_torch.storage.CheckpointManager`'s ``LATEST`` pointer.

All threads share one device and its default stream.  All store access
(scratch ``mark``/``release`` regions, appends, compaction, the kernels'
launches) is serialised by one re-entrant store mutex; epoch pins are
refcounts in the :class:`~repro_torch.serving.epochs.EpochRegistry` and
cost O(1).  Readers holding a lease never block the writer: old epochs are
retired only when their last lease is released.  A lease's
:class:`FrozenFacts` is seeded from :meth:`RowIndex.views`, which is safe
because the index replaces a predicate's tensor on every mutation instead
of writing into it.  Compaction swaps the mu-node table (pinned meta-facts
would hold dangling node ids), so it is **deferred while any epoch is
pinned**, and the post-compaction state is republished under a fresh
registry version.  The executor and the writer synchronise the device
before they hand a result back, so a wall taken by another thread covers
the device work.

Without :meth:`start` the tier runs degenerate-synchronously (submit ->
execute inline on the calling thread): the same code path, deterministic.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass

import torch

from ..core.util import synchronize
from ..obs import get_registry, span
from ..obs.memory import register_reporter
from ..query import QueryEngine
from .admission import AdmissionQueue, Request
from .epochs import EpochLease, EpochRegistry

__all__ = ["ServeResponse", "ServingLease", "ServingTier"]


@dataclass
class ServeResponse:
    """What a client gets back: answers (a tensor on the store's device)
    and the epoch that served them."""

    answers: torch.Tensor
    version: int        # registry version pinned during execution
    epoch: int          # store epoch of that version
    from_cache: bool
    stale: bool         # version < version current at admission (never)

    @property
    def n_answers(self) -> int:
        return int(self.answers.shape[0])


class ServingLease:
    """A reader's pinned epoch: answer any number of queries against one
    immutable snapshot while the writer keeps publishing new epochs."""

    def __init__(self, tier: ServingTier, lease: EpochLease):
        self._tier = tier
        self._lease = lease

    @property
    def version(self) -> int:
        return self._lease.version

    @property
    def epoch(self) -> int:
        return self._lease.epoch

    @property
    def engine(self):
        return self._lease.engine

    def answer(self, text: str):
        """Answer against the pinned snapshot (store access serialised
        with the writer)."""
        with self._tier._store_lock:
            return self._lease.engine.answer(text)

    def release(self) -> None:
        self._lease.release()

    def __enter__(self) -> ServingLease:
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class ServingTier:
    """Concurrent MVCC serving facade over one IncrementalStore."""

    def __init__(
        self,
        inc,
        dictionary=None,
        *,
        max_batch: int = 64,
        min_group: int = 2,
        plan_cache_size: int = 256,
        result_cache_size: int = 1024,
        checkpoint=None,
        checkpoint_every: int = 0,
        compact_threshold: float = 0.0,
        drain_timeout: float = 0.02,
    ):
        self.inc = inc
        self.dictionary = dictionary
        self.max_batch = max(int(max_batch), 1)
        self.min_group = max(int(min_group), 2)
        self.plan_cache_size = plan_cache_size
        self.result_cache_size = result_cache_size
        self.checkpoint = checkpoint
        self.checkpoint_every = checkpoint_every
        self.compact_threshold = compact_threshold
        self.drain_timeout = drain_timeout

        #: one mutex serialises every store touch: query scratch regions,
        #: apply mutations, compaction, and epoch pins (pinning under the
        #: lock closes the pin-vs-compaction race)
        self._store_lock = threading.RLock()
        self.registry = EpochRegistry(on_retire=self._on_retire)
        self.queue = AdmissionQueue()
        self._writer_q: _queue.Queue = _queue.Queue()
        self._executor: threading.Thread | None = None
        self._writer: threading.Thread | None = None
        self._started = False

        # plain counters (reported via obs.publish_serving and the
        # server's ``serving`` block; registry metrics mirror them live)
        self.n_queries = 0
        self.n_batches = 0
        self.n_batched_queries = 0   # answered via a generalised group
        self.n_single_queries = 0
        self.n_cache_hits = 0
        self.n_dedup_hits = 0        # exact duplicates folded per batch
        self.n_groups = 0
        self.stale_reads = 0
        self.n_applies = 0
        self.n_checkpoints = 0
        self.compactions = 0
        self.compactions_deferred = 0
        self.batch_sizes_sum = 0
        self.max_batch_seen = 0
        self.lag_max = 0

        if checkpoint is not None:
            checkpoint.attach_epoch_source(self.registry.pinned_epochs)
        # epochs stay in sync with any apply path, not only tier.apply
        self._publish_cb = self._on_store_publish
        inc.subscribe_publish(self._publish_cb)
        register_reporter("serving", self)
        with self._store_lock:
            self._publish()

    # ------------------------------------------------------------------ #
    # epoch publication
    # ------------------------------------------------------------------ #
    def _on_store_publish(self, store, stats) -> None:
        # runs inside IncrementalStore.apply; the writer (or apply_sync)
        # already holds the store mutex: re-entrant, so direct
        # single-threaded inc.apply() use works too
        with self._store_lock:
            self._publish()

    def _publish(self) -> None:
        with span("serve.publish", epoch=self.inc.epoch):
            frozen = self.inc.freeze(pin_meta=True)
            engine = QueryEngine(
                frozen,
                self.dictionary,
                plan_cache_size=self.plan_cache_size,
                result_cache_size=self.result_cache_size,
            )
            self.registry.publish(self.inc.epoch, frozen, engine)
        reg = get_registry()
        reg.counter("serve.epoch.published").inc()
        reg.gauge("serve.epoch.current").set(self.inc.epoch)
        reg.gauge("serve.epoch.live").set(self.registry.n_live())

    def _on_retire(self, entry) -> None:
        reg = get_registry()
        reg.counter("serve.epoch.retired").inc()
        reg.gauge("serve.epoch.live").set(self.registry.n_live())

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._executor = threading.Thread(
            target=self._executor_loop, name="serving-executor", daemon=True
        )
        self._writer = threading.Thread(
            target=self._writer_loop, name="serving-writer", daemon=True
        )
        self._executor.start()
        self._writer.start()

    def stop(self) -> None:
        """Drain outstanding work and join both threads (idempotent)."""
        if not self._started:
            return
        self.queue.close()
        self._executor.join()
        self._writer_q.put(None)
        self._writer.join()
        self._executor = self._writer = None
        self._started = False

    def close(self) -> None:
        """Stop threads and detach from the store's publish hook."""
        self.stop()
        self.inc.unsubscribe_publish(self._publish_cb)

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #
    def submit(self, text: str) -> Request:
        req = Request(text, self.registry.version)
        if self._started:
            self.queue.submit(req)
            get_registry().gauge("serve.queue.depth").set(self.queue.depth())
        else:
            self._execute_batch([req])
        return req

    def answer(self, text: str, timeout: float | None = 60.0) -> ServeResponse:
        return self.submit(text).wait(timeout)

    def pin(self) -> ServingLease:
        """Pin the current epoch for repeatable reads (O(1); only an
        in-flight writer apply can delay it, never other readers)."""
        with self._store_lock:
            lease = self.registry.pin()
        get_registry().gauge("serve.epoch.pinned").set(self.registry.n_pinned())
        return ServingLease(self, lease)

    # ------------------------------------------------------------------ #
    # write path
    # ------------------------------------------------------------------ #
    def apply(self, additions=None, deletions=None) -> Request:
        """Hand an update batch to the writer; returns a ticket whose
        ``wait()`` yields the IncrementalStats or raises the writer's
        error.  Synchronous (inline) when the tier is not started."""
        ticket = Request("<apply>", self.registry.version)
        if self._started:
            self._writer_q.put((additions, deletions, ticket))
        else:
            try:
                ticket.resolve(self._apply_impl(additions, deletions))
            except BaseException as e:  # noqa: BLE001 — ticket carries it
                ticket.fail(e)
        return ticket

    def apply_sync(self, additions=None, deletions=None):
        return self.apply(additions, deletions).wait(timeout=600.0)

    def _apply_impl(self, additions, deletions):
        with span("serve.writer.apply", epoch=self.inc.epoch + 1):
            with self._store_lock:
                st = self.inc.apply(additions=additions, deletions=deletions)
                self.n_applies += 1
                if self.compact_threshold > 0:
                    if self.registry.n_pinned() == 0:
                        cs = self.inc.maybe_compact(self.compact_threshold)
                        if cs is not None:
                            self.compactions += 1
                            # pinned meta-fact lists of the pre-compaction
                            # view hold dead node ids: republish the same
                            # store epoch under a fresh registry version
                            self._publish()
                    else:
                        self.compactions_deferred += 1
                        get_registry().counter("serve.compactions_deferred").inc()
                if (
                    self.checkpoint is not None
                    and self.checkpoint_every > 0
                    and self.n_applies % self.checkpoint_every == 0
                ):
                    self.checkpoint.checkpoint(self.inc)
                    self.n_checkpoints += 1
                synchronize(self.inc.device)
        return st

    def _writer_loop(self) -> None:
        while True:
            item = self._writer_q.get()
            if item is None:
                return
            additions, deletions, ticket = item
            try:
                ticket.resolve(self._apply_impl(additions, deletions))
            except BaseException as e:  # noqa: BLE001 — ticket carries it
                ticket.fail(e)

    # ------------------------------------------------------------------ #
    # executor
    # ------------------------------------------------------------------ #
    def _executor_loop(self) -> None:
        while True:
            batch = self.queue.drain(self.max_batch, self.drain_timeout)
            if not batch:
                if self.queue.closed:
                    return
                continue
            try:
                self._execute_batch(batch)
            except BaseException as e:  # noqa: BLE001 — the requests carry it
                for req in batch:
                    if not req.event.is_set():
                        req.fail(e)

    def _execute_batch(self, batch: list[Request]) -> None:
        reg = get_registry()
        try:
            with span("serve.batch", size=len(batch)):
                with self._store_lock:
                    with self.registry.pin() as lease:
                        # parse per request, so one malformed query fails
                        # alone instead of poisoning its co-batch
                        good, parsed = [], []
                        for req in batch:
                            try:
                                parsed.append(lease.engine.parse(req.text))
                                good.append(req)
                            except Exception as e:  # noqa: BLE001
                                req.fail(e)
                        batch = good
                        results, bstats = lease.engine.answer_batch(
                            parsed, min_group=self.min_group,
                        ) if batch else ([], None)
                        synchronize(self.inc.device)
        except BaseException as e:  # noqa: BLE001 — fail the whole batch
            for req in batch:
                req.fail(e)
            return
        if not batch:
            return

        now = time.perf_counter()
        self.n_batches += 1
        self.batch_sizes_sum += len(batch)
        self.max_batch_seen = max(self.max_batch_seen, len(batch))
        self.n_queries += len(batch)
        self.n_groups += bstats.n_groups
        self.n_batched_queries += bstats.n_grouped
        self.n_single_queries += bstats.n_single
        self.n_cache_hits += bstats.n_cached
        self.n_dedup_hits += len(batch) - bstats.n_queries
        reg.counter("serve.queries").inc(len(batch))
        reg.counter("serve.batch.count").inc()
        reg.histogram("serve.batch.size").observe(len(batch))
        reg.counter("serve.batch.grouped").inc(bstats.n_grouped)
        reg.counter("serve.batch.single").inc(bstats.n_single)
        reg.counter("serve.batch.cached").inc(bstats.n_cached)
        reg.counter("serve.batch.dedup_hits").inc(len(batch) - bstats.n_queries)
        adm = reg.histogram("serve.admission_s")
        lag = self.registry.version - lease.version
        self.lag_max = max(self.lag_max, lag)
        reg.histogram("serve.epoch.lag").observe(lag)
        for req, res in zip(batch, results):
            stale = lease.version < req.admit_version
            if stale:
                self.stale_reads += 1
                reg.counter("serve.stale_reads").inc()
            adm.observe(now - req.t_submit)
            req.resolve(ServeResponse(
                answers=res.answers,
                version=lease.version,
                epoch=lease.epoch,
                from_cache=res.from_cache,
                stale=stale,
            ))

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def reset_counters(self) -> None:
        """Zero the measurement-window counters (warmup discard); epoch
        bookkeeping and the registry's live metrics are untouched."""
        self.n_queries = self.n_batches = 0
        self.n_batched_queries = self.n_single_queries = 0
        self.n_cache_hits = self.n_dedup_hits = self.n_groups = 0
        self.stale_reads = 0
        self.batch_sizes_sum = self.max_batch_seen = 0
        self.lag_max = 0
        self.queue.max_depth = 0

    def stats(self) -> dict:
        epochs = self.registry.stats()
        return {
            "queries": self.n_queries,
            "batches": self.n_batches,
            "mean_batch": self.batch_sizes_sum / max(self.n_batches, 1),
            "max_batch": self.max_batch_seen,
            "grouped_queries": self.n_batched_queries,
            "single_queries": self.n_single_queries,
            "cache_hits": self.n_cache_hits,
            "dedup_hits": self.n_dedup_hits,
            "groups": self.n_groups,
            "stale_reads": self.stale_reads,
            "applies": self.n_applies,
            "checkpoints": self.n_checkpoints,
            "compactions": self.compactions,
            "compactions_deferred": self.compactions_deferred,
            "max_queue_depth": self.queue.max_depth,
            "epoch_lag_max": self.lag_max,
            "epochs_published": epochs["published"],
            "epochs_retired": epochs["retired"],
            "epochs_live": epochs["live"],
            "epochs_pinned": epochs["pinned"],
            "epoch": epochs["epoch"],
        }

    def memory_report(self) -> dict[str, int]:
        """obs.memory reporter.  No ``*_bytes`` parts on purpose: every
        live epoch's FrozenFacts reports its snapshot bytes under
        ``mem.frozen.*`` and the store's bytes belong to ``mem.inc.*`` and
        the ColumnStore; counting them here would count them twice."""
        s = self.registry.stats()
        return {
            "n_live_epochs": s["live"],
            "n_pinned_leases": s["pinned"],
            "n_queued_requests": self.queue.depth(),
        }
