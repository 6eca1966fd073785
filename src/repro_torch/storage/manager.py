"""Checkpoint orchestration: snapshot directories + the WAL + pruning.

Directory layout under one checkpoint root (the JAX package's)::

    ckpt/
      LATEST              name of the newest complete snapshot
      snap-00000004/      one snapshot per checkpoint epoch
      snap-00000019/
      wal.jsonl           update batches since the newest snapshot

Protocol (crash-safe at every step):

1. ``checkpoint(inc)`` writes ``snap-<epoch>.tmp`` fully (manifest
   last), renames it to ``snap-<epoch>``, then atomically rewrites
   ``LATEST``: a crash anywhere leaves either the old or the new snapshot
   current, never a torn one.
2. Only then is the WAL truncated (records ``<= epoch`` are redundant)
   and the in-memory journal cleared; old snapshots beyond ``keep`` are
   pruned.
3. ``restore(program)`` loads the snapshot named by ``LATEST`` onto the
   store's device, replays newer WAL records through
   ``IncrementalStore.apply``, and only then attaches the WAL.

With the derivation journal on (:mod:`repro_torch.obs.provenance`),
``checkpoint`` also writes its payload into the snapshot as
``provenance.json`` before the rename, and ``restore`` loads it back.  The
sidecar is optional: a restore without one still explains (rounds live in
the snapshot), and a journal that is off ignores one.  Its JSON is the JAX
package's, so each package loads the other's.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass

from ..core.util import synchronize
from ..obs import get_registry, span
from ..obs.memory import register_reporter
from .format import (
    SnapshotError,
    fsync_dir,
    read_manifest,
    restore_incremental,
    snapshot_nbytes,
    write_snapshot,
)
from .wal import WriteAheadLog

__all__ = ["CheckpointManager", "RecoveryStats"]

_LATEST = "LATEST"
_WAL = "wal.jsonl"


@dataclass
class RecoveryStats:
    snapshot: str
    snapshot_epoch: int
    final_epoch: int
    wal_batches: int
    wal_dropped: int
    t_snapshot_s: float
    t_replay_s: float
    verified: bool


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 2, label: str = ""):
        self.root = root
        self.keep = max(keep, 1)
        #: provenance tag stamped into manifests and checked on restore
        #: (a labelled manager refuses a differently-labelled snapshot)
        self.label = label
        os.makedirs(root, exist_ok=True)
        self.wal = WriteAheadLog(os.path.join(root, _WAL))
        #: MVCC pin hooks: epochs pinned here (refcounted) or reported by
        #: the attached source keep their snapshot directory out of
        #: pruning and their WAL suffix out of truncation
        self._pins: dict[int, int] = {}
        self._epoch_source = None
        register_reporter("storage", self)

    # ------------------------------------------------------------------ #
    # epoch pin hooks (serving tier MVCC)
    # ------------------------------------------------------------------ #
    def attach_epoch_source(self, fn) -> None:
        """Register a zero-arg callable yielding the store epochs some
        reader currently pins (the serving tier passes its epoch
        registry's ``pinned_epochs``)."""
        self._epoch_source = fn

    def pin_epoch(self, epoch: int) -> None:
        """Refcounted manual pin: keep ``snap-<epoch>`` and the WAL
        records after it until :meth:`unpin_epoch`."""
        self._pins[epoch] = self._pins.get(epoch, 0) + 1

    def unpin_epoch(self, epoch: int) -> None:
        n = self._pins.get(epoch, 0) - 1
        if n <= 0:
            self._pins.pop(epoch, None)
        else:
            self._pins[epoch] = n

    def pinned_epochs(self) -> set[int]:
        pinned = set(self._pins)
        if self._epoch_source is not None:
            pinned.update(self._epoch_source())
        return pinned

    @staticmethod
    def _snap_epoch(name: str) -> int:
        try:
            return int(name.split("-", 1)[1])
        except (IndexError, ValueError):
            return -1

    def reset(self) -> None:
        """Wipe the checkpoint root: all snapshots, the LATEST pointer and
        the WAL.  A cold (non-restore) run over a reused directory calls
        this before logging, or a later restore would stitch two
        histories together."""
        for name in self.snapshots():
            shutil.rmtree(os.path.join(self.root, name))
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if name.endswith(".tmp"):
                shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        ptr = os.path.join(self.root, _LATEST)
        if os.path.exists(ptr):
            os.remove(ptr)
        self.wal.truncate()

    # ------------------------------------------------------------------ #
    def _snap_name(self, epoch: int) -> str:
        return f"snap-{epoch:08d}"

    def snapshots(self) -> list[str]:
        """Complete snapshot names, oldest first (none once the root is
        gone)."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if (
                name.startswith("snap-")
                and not name.endswith(".tmp")
                and os.path.isdir(path)
                and os.path.exists(os.path.join(path, "manifest.json"))
            ):
                out.append(name)
        return out

    def latest(self) -> str | None:
        """Path of the current snapshot (via LATEST, falling back to the
        newest complete directory if the pointer is missing)."""
        ptr = os.path.join(self.root, _LATEST)
        if os.path.exists(ptr):
            with open(ptr) as fh:
                name = fh.read().strip()
            path = os.path.join(self.root, name)
            if os.path.exists(os.path.join(path, "manifest.json")):
                return path
        snaps = self.snapshots()
        return os.path.join(self.root, snaps[-1]) if snaps else None

    def has_snapshot(self) -> bool:
        return self.latest() is not None

    # ------------------------------------------------------------------ #
    def checkpoint(self, inc) -> dict:
        """Write a snapshot of the incremental store's current epoch,
        publish it, and drop the now-redundant WAL/journal prefix."""
        with span("storage.checkpoint", epoch=inc.epoch) as sp:
            name = self._snap_name(inc.epoch)
            final = os.path.join(self.root, name)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            manifest = write_snapshot(
                tmp,
                inc.facts,
                kind="incremental",
                label=self.label,
                epoch=inc.epoch,
                round_tag=inc._round,
                rows=inc.rows.views(),
                counts={p: c for p, c in inc.counts.items() if c.numel()},
                explicit={p: r for p, r in inc.explicit.items() if r.numel()},
                arities=inc.arities,
            )
            self._write_provenance(tmp)
            if os.path.exists(final):  # re-checkpoint, unchanged epoch
                shutil.rmtree(final)
            os.rename(tmp, final)
            ptr_tmp = os.path.join(self.root, _LATEST + ".tmp")
            with open(ptr_tmp, "w") as fh:
                fh.write(name + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(ptr_tmp, os.path.join(self.root, _LATEST))
            fsync_dir(self.root)
            # the snapshot is durable and published: WAL records and
            # journal entries at or below its epoch are redundant, except
            # the suffix after the oldest pinned epoch, which a pinned
            # reader's snapshot still needs to replay forward
            pinned = self.pinned_epochs()
            keep_after = min([inc.epoch, *pinned]) if pinned else inc.epoch
            self.wal.truncate(keep_after_epoch=keep_after)
            inc.truncate_journal()
            # never prune the snapshot LATEST points at, whatever its name
            # sorts as, nor any snapshot whose epoch is pinned
            for old in self.snapshots()[: -self.keep]:
                if old != name and self._snap_epoch(old) not in pinned:
                    shutil.rmtree(os.path.join(self.root, old))
            sp.set(snapshot=name, pinned_epochs=len(pinned))
        reg = get_registry()
        reg.counter("storage.checkpoints").inc()
        reg.gauge("storage.checkpoint_epoch").set(inc.epoch)
        reg.gauge("storage.disk_bytes").set(self.disk_nbytes())
        return manifest

    def _write_provenance(self, snap_dir: str) -> None:
        """Sidecar the derivation journal into the snapshot directory
        (before the rename, under the same atomicity), only when the
        journal is on."""
        from ..obs.provenance import get_journal

        journal = get_journal()
        if not journal.enabled:
            return
        with open(os.path.join(snap_dir, "provenance.json"), "w") as fh:
            json.dump(journal.to_payload(), fh)
            fh.flush()
            os.fsync(fh.fileno())

    def _load_provenance(self, snap_dir: str) -> bool:
        """Load a snapshot's provenance sidecar into the live journal when
        both the sidecar exists and the journal is on."""
        from ..obs.provenance import get_journal

        journal = get_journal()
        path = os.path.join(snap_dir, "provenance.json")
        if not journal.enabled or not os.path.exists(path):
            return False
        with open(path) as fh:
            journal.load_payload(json.load(fh))
        return True

    # ------------------------------------------------------------------ #
    def restore(self, program, *, verify: bool = False, **store_kwargs):
        """Warm start: latest snapshot + WAL replay, onto the device that
        ``store_kwargs`` name (``device``; default the card).  Returns
        ``(inc, RecoveryStats)``; the WAL is attached afterwards so new
        batches keep logging to the same file.  Both walls end in a
        synchronisation of the store's device."""
        snap = self.latest()
        if snap is None:
            raise SnapshotError(f"no snapshot under {self.root!r}")
        with span("storage.restore") as sp:
            t0 = time.perf_counter()
            inc, meta = restore_incremental(
                program, snap, verify=False, expected_label=self.label, **store_kwargs,
            )
            synchronize(inc.device)
            t_snap = time.perf_counter() - t0
            self._load_provenance(snap)
            t0 = time.perf_counter()
            n_replayed = self.wal.replay(inc, after_epoch=meta.epoch)
            synchronize(inc.device)
            t_replay = time.perf_counter() - t0
            if verify:
                inc.check_integrity()
            inc.attach_wal(self.wal)
            sp.set(snapshot_epoch=meta.epoch, final_epoch=inc.epoch, wal_batches=n_replayed)
        reg = get_registry()
        reg.counter("storage.restores").inc()
        reg.counter("storage.wal_replayed").inc(n_replayed)
        reg.counter("storage.wal_dropped").inc(self.wal.n_dropped)
        reg.counter("storage.restore_snapshot_s").inc(t_snap)
        reg.counter("storage.restore_replay_s").inc(t_replay)
        return inc, RecoveryStats(
            snapshot=snap,
            snapshot_epoch=meta.epoch,
            final_epoch=inc.epoch,
            wal_batches=n_replayed,
            wal_dropped=self.wal.n_dropped,
            t_snapshot_s=t_snap,
            t_replay_s=t_replay,
            verified=verify,
        )

    # ------------------------------------------------------------------ #
    def latest_manifest(self) -> dict | None:
        snap = self.latest()
        return read_manifest(snap) if snap else None

    def disk_nbytes(self) -> int:
        """Bytes across all snapshots + the WAL."""
        total = self.wal.nbytes()
        for name in self.snapshots():
            total += snapshot_nbytes(os.path.join(self.root, name))
        return total

    def memory_report(self) -> dict[str, int]:
        """obs.memory reporter.  Everything here is on disk, so the
        ``_disk_bytes`` suffix keeps it out of the resident roll-up while
        still publishing under ``mem.storage.*``."""
        snaps = self.snapshots()
        snap_bytes = sum(snapshot_nbytes(os.path.join(self.root, name)) for name in snaps)
        return {
            "wal_disk_bytes": self.wal.nbytes(),
            "snapshots_disk_bytes": snap_bytes,
            "n_snapshots": len(snaps),
        }
