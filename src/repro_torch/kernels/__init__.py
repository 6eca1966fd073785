"""Hand-written CUDA kernels for the compressed materialisation path.

Each kernel has a wrapper module (:mod:`.sorted_member`, :mod:`.join_bounds`,
:mod:`.rle_expand`, :mod:`.fused`), a plain PyTorch version in :mod:`.ref`,
and a launch count in :mod:`.ops`; :mod:`.build` compiles the sources in
``csrc/`` at first use.  :mod:`.buffers` holds the fused engine's dedup
index.
"""

from .fused import merge_sorted_unique
from .join_bounds import join_bounds
from .rle_expand import rle_expand
from .sorted_member import sorted_member

__all__ = ["join_bounds", "merge_sorted_unique", "rle_expand", "sorted_member"]
