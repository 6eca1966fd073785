"""Refcounted epoch registry: the MVCC core of the serving tier.

One *epoch entry* is an immutable read view of the KB at a published
store epoch: a pinned :class:`~repro_torch.core.frozen.FrozenFacts` snapshot
plus the :class:`~repro_torch.query.QueryEngine` serving it (with its own
epoch-stamped plan/result caches).  The registry holds every entry that
is either *current* or still pinned by a reader:

* :meth:`publish` installs a new current entry; the previous one is
  retired immediately if unpinned, otherwise it survives until its last
  lease is released,
* :meth:`pin` hands out an :class:`EpochLease` on the current entry —
  an O(1) refcount bump under a mutex, never blocking on readers or the
  writer's apply work,
* retirement runs the ``on_retire`` callback (the tier counts it and
  drops the snapshot, letting GC reclaim the epoch's arrays).

Registry *versions* increase by one per publish and are decoupled from
store epochs: a compaction republishes the same store epoch under a new
version because the old entry's pinned meta-facts hold pre-compaction
node ids.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

__all__ = ["EpochEntry", "EpochLease", "EpochRegistry"]


@dataclass
class EpochEntry:
    """One published read view (identity: registry ``version``)."""

    version: int
    epoch: int            # IncrementalStore.epoch at publish time
    frozen: object        # pinned FrozenFacts snapshot
    engine: object        # QueryEngine over ``frozen``
    refs: int = 0
    retired: bool = False
    payload: dict = field(default_factory=dict)


class EpochLease:
    """Context-managed pin on one epoch entry (release-once)."""

    def __init__(self, registry: EpochRegistry, entry: EpochEntry):
        self._registry = registry
        self._entry = entry
        self._released = False

    @property
    def version(self) -> int:
        return self._entry.version

    @property
    def epoch(self) -> int:
        return self._entry.epoch

    @property
    def frozen(self):
        return self._entry.frozen

    @property
    def engine(self):
        return self._entry.engine

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._registry._unpin(self._entry)

    def __enter__(self) -> EpochLease:
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class EpochRegistry:
    """Never-blocking refcounted registry of live epoch entries."""

    def __init__(self, on_retire=None):
        self._lock = threading.Lock()
        self._entries: dict[int, EpochEntry] = {}
        self._current: EpochEntry | None = None
        self._next_version = 0
        self._on_retire = on_retire
        self.published = 0
        self.retired = 0
        #: the most leases outstanding at once
        self.max_pinned = 0

    # ------------------------------------------------------------------ #
    @property
    def version(self) -> int:
        """Version of the current entry (-1 before the first publish)."""
        with self._lock:
            return self._current.version if self._current else -1

    @property
    def current(self) -> EpochEntry | None:
        with self._lock:
            return self._current

    def publish(self, epoch: int, frozen, engine, **payload) -> EpochEntry:
        """Install a new current read view; retire the previous one if
        (and only if) no lease still pins it."""
        to_retire = None
        with self._lock:
            entry = EpochEntry(
                version=self._next_version,
                epoch=epoch,
                frozen=frozen,
                engine=engine,
                payload=dict(payload),
            )
            self._next_version += 1
            self._entries[entry.version] = entry
            prev, self._current = self._current, entry
            self.published += 1
            if prev is not None and prev.refs == 0:
                to_retire = self._retire_locked(prev)
        self._run_retire(to_retire)
        return entry

    def pin(self) -> EpochLease:
        """Lease the current entry (O(1); raises before first publish)."""
        with self._lock:
            if self._current is None:
                raise RuntimeError("no epoch published yet")
            self._current.refs += 1
            self.max_pinned = max(
                self.max_pinned, sum(e.refs for e in self._entries.values())
            )
            return EpochLease(self, self._current)

    def _unpin(self, entry: EpochEntry) -> None:
        to_retire = None
        with self._lock:
            entry.refs -= 1
            if (
                entry.refs == 0
                and entry is not self._current
                and not entry.retired
            ):
                to_retire = self._retire_locked(entry)
        self._run_retire(to_retire)

    def _retire_locked(self, entry: EpochEntry) -> EpochEntry:
        entry.retired = True
        del self._entries[entry.version]
        self.retired += 1
        return entry

    def _run_retire(self, entry: EpochEntry | None) -> None:
        # run callbacks outside the lock: they may take other locks
        if entry is not None and self._on_retire is not None:
            self._on_retire(entry)

    # ------------------------------------------------------------------ #
    def n_live(self) -> int:
        with self._lock:
            return len(self._entries)

    def n_pinned(self) -> int:
        """Total outstanding leases across all live entries."""
        with self._lock:
            return sum(e.refs for e in self._entries.values())

    def pinned_epochs(self) -> set[int]:
        """Store epochs still pinned by at least one lease (the storage
        layer keeps their snapshots/WAL suffix alive; see
        ``CheckpointManager.attach_epoch_source``)."""
        with self._lock:
            return {e.epoch for e in self._entries.values() if e.refs > 0}

    def live_versions(self) -> list[int]:
        with self._lock:
            return sorted(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "published": self.published,
                "retired": self.retired,
                "live": len(self._entries),
                "pinned": sum(e.refs for e in self._entries.values()),
                "version": self._current.version if self._current else -1,
                "epoch": self._current.epoch if self._current else -1,
            }
