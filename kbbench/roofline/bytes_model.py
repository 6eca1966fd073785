"""The bytes each hand kernel's launch needs, from its operand lengths.

Each input byte these inputs need is counted read once, and each output
byte written once, whatever the kernel reads again.  Where a kernel
searches a sorted side, what it needs depends on the data, and the model
counts the least any launch of those lengths needs: one key of the sorted
side per probe, and never more than the side holds.  So a share of the
bytes-bound time can read low, never above what the device allows.

``shape`` is what the program's launch meter keeps per launch
(``repro_torch.kernels.ops.launch_shapes``); ``key`` the width of a key
in bytes (8 for int64, 4 for int32).
"""

from __future__ import annotations

__all__ = ["launch_bytes"]

_SPAN = 4    # an int32 bound of a span
_MASK = 1    # a bool of a membership mask
_END = 8     # an int64 run end


def _sorted_member(s: dict, key: int) -> tuple[int, int]:
    # probes read; a key of the sorted side per probe; one mask byte each
    n, m = s.get("n", 0), s.get("m", 0)
    return key * (n + min(n, m)), _MASK * n


def _join_bounds(s: dict, key: int) -> tuple[int, int]:
    # left keys read; a right key per left key; lo and hi written
    n, m = s["n"], s["m"]
    return key * (n + min(n, m)), 2 * _SPAN * n


def _rle_expand(s: dict, key: int) -> tuple[int, int]:
    # run values and run ends read; every expanded key written
    return (key + _END) * s["runs"], key * s["total"]


def _merge_sorted_unique(s: dict, key: int) -> tuple[int, int]:
    # the buffer's codes below its watermark (when the call names it) and
    # the fresh codes read; the whole sentinel-padded buffer written
    return key * (s.get("count", 0) + s["fresh"]), key * s["cap"]


def _fused_join_dedup(s: dict, key: int) -> tuple[int, int]:
    # left keys and payloads read; a right key and payload per emitted
    # pair, never more than the right side; the survivors are not known
    n, m, pairs = s["n"], s["m"], s["pairs"]
    return 2 * key * (n + min(m, pairs)), 0


_MODELS = {
    "sorted_member": _sorted_member,
    "join_bounds": _join_bounds,
    "rle_expand": _rle_expand,
    "merge_sorted_unique": _merge_sorted_unique,
    "fused_join_dedup": _fused_join_dedup,
}


def launch_bytes(kernel: str, shape: dict, key: int) -> tuple[int, int]:
    """``(read, written)`` bytes one launch of ``kernel`` needs."""
    return _MODELS[kernel](shape, key)
