"""Incremental maintenance over the compressed store.

Keeps ``mat(Pi, E)`` up to date in place under explicit insert/delete
batches instead of re-running the fixpoint (:class:`IncrementalStore`).
Recursive strata run Delete/Rederive with a backward/forward rederivation
check (:mod:`.dred`); non-recursive strata maintain exact derivation
counts.  Rows and counts are int64 tensors on the store's device; the
maintained row index is :class:`RowIndex`.  The update contract
(:func:`normalise_batch`, :func:`effective_updates`) and the row-set
helpers are shared with the distributed engine's ``apply``.
"""

from .dred import explicit_restores
from .index import RowIndex, merge_rows, setdiff_rows
from .store import IncrementalStats, IncrementalStore, effective_updates, normalise_batch

__all__ = [
    "IncrementalStats",
    "IncrementalStore",
    "RowIndex",
    "effective_updates",
    "explicit_restores",
    "merge_rows",
    "normalise_batch",
    "setdiff_rows",
]
