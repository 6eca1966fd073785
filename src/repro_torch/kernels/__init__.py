"""Hand-written CUDA kernels for the compressed and distributed engines.

Each kernel has a wrapper module (:mod:`.sorted_member`, :mod:`.join_bounds`,
:mod:`.rle_expand`, :mod:`.fused` for ``fused_join_dedup`` and
``merge_sorted_unique``), a plain PyTorch version in :mod:`.ref`, and a
launch count in :mod:`.ops`; :mod:`.build` compiles the sources in
``csrc/`` at first use; :mod:`.tune` picks ``join_bounds``' path on a
card.  :mod:`.buffers` holds the per-predicate sorted code buffers
(int64 for the fused engine, int32 for 16-bit pair codes).
"""

from .fused import fused_join_dedup, merge_sorted_unique
from .join_bounds import join_bounds
from .rle_expand import rle_expand
from .sorted_member import sorted_member

__all__ = [
    "fused_join_dedup",
    "join_bounds",
    "merge_sorted_unique",
    "rle_expand",
    "sorted_member",
]
