"""Incremental maintenance — the part the distributed engine's ``apply``
needs: batch normalisation and clamping against the explicit set
(:mod:`.store`), the explicit-restore step of DRed (:mod:`.dred`) and row
set differences (:mod:`.index`).  Row sets are int64 ``(n, arity)``
tensors on the host.
"""

from .dred import explicit_restores
from .index import merge_rows, setdiff_rows
from .store import effective_updates, normalise_batch

__all__ = [
    "effective_updates",
    "explicit_restores",
    "merge_rows",
    "normalise_batch",
    "setdiff_rows",
]
