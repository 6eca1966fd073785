"""Storage for the compressed store: the GC/compaction epochs
(:mod:`.compact`).  Snapshots, the write-ahead log and the checkpoint
manager are not ported yet (see ``ROADMAP.md`` queue 1 item 8)."""

from .compact import CompactionStats, MuUsage, compact_store, mu_usage

__all__ = ["CompactionStats", "MuUsage", "compact_store", "mu_usage"]
