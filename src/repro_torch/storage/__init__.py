"""Durable storage for the compressed store.

Snapshots that serialise the ``<M, mu>`` representation with its
structure sharing intact, in the JAX package's byte format
(:mod:`.format`), a write-ahead log over incremental update batches
(:mod:`.wal`), checkpoint/restore orchestration (:mod:`.manager`), and
GC/compaction epochs that reclaim dead mu-nodes under churn
(:mod:`.compact`)::

    ckpt = CheckpointManager("ckpt/")
    inc.attach_wal(ckpt.wal)                   # batches logged before applied
    ...
    ckpt.checkpoint(inc)                       # durable snapshot, WAL truncated
    ...
    inc, rec = ckpt.restore(program, device=d) # snapshot + WAL replay
"""

from .compact import CompactionStats, MuUsage, compact_store, mu_usage
from .format import (
    FORMAT_VERSION,
    SnapshotError,
    SnapshotMeta,
    load_frozen,
    load_into,
    read_manifest,
    restore_incremental,
    snapshot_nbytes,
    write_snapshot,
)
from .manager import CheckpointManager, RecoveryStats
from .wal import WriteAheadLog

__all__ = [
    "FORMAT_VERSION",
    "CheckpointManager",
    "CompactionStats",
    "MuUsage",
    "RecoveryStats",
    "SnapshotError",
    "SnapshotMeta",
    "WriteAheadLog",
    "compact_store",
    "load_frozen",
    "load_into",
    "mu_usage",
    "read_manifest",
    "restore_incremental",
    "snapshot_nbytes",
    "write_snapshot",
]
