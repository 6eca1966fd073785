"""Plain PyTorch versions of the kernels (the correctness references).

The wrappers use these for tensors on the CPU; ``chip_smoke.py`` holds each
kernel against them on the card.  Nothing on the main path calls them while
its tensors are on a card.  Key tensors are int32 (the TPU contract, with
int32 max as the pad sentinel) or int64 (packed row codes, int64 max).
"""

from __future__ import annotations

import torch

__all__ = [
    "join_bounds",
    "merge_sorted_unique",
    "rle_expand",
    "sentinel",
    "sorted_member",
]


def sentinel(dtype: torch.dtype) -> int:
    """Pad value of a key type: larger than every real key."""
    return torch.iinfo(dtype).max


def sorted_member(a: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    """``out[i] = a[i] in b_sorted`` (``b_sorted`` ascending)."""
    m = b_sorted.shape[0]
    if m == 0:
        return torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    idx = torch.searchsorted(b_sorted, a).clamp_(max=m - 1)
    return b_sorted[idx] == a


def join_bounds(l_keys: torch.Tensor, r_sorted: torch.Tensor):
    """``(lo, hi)`` int32: ``lo[i] = #{r < l[i]}``, ``hi[i] = #{r <= l[i]}``."""
    lo = torch.searchsorted(r_sorted, l_keys, right=False)
    hi = torch.searchsorted(r_sorted, l_keys, right=True)
    return lo.to(torch.int32), hi.to(torch.int32)


def rle_expand(values: torch.Tensor, counts: torch.Tensor, total: int):
    """Run-length decode: each ``values[k]`` repeated ``counts[k]`` times."""
    if total == 0 or values.shape[0] == 0:
        return torch.zeros(0, dtype=values.dtype, device=values.device)
    out = torch.repeat_interleave(values, counts.to(torch.int64))
    if out.shape[0] != total:
        raise ValueError(f"rle_expand: counts sum to {out.shape[0]}, not {total}")
    return out


def merge_sorted_unique(buf: torch.Tensor, fresh: torch.Tensor,
                        out: torch.Tensor | None = None):
    """Merge ``fresh`` into the sorted-unique, sentinel-padded ``buf``.

    Returns ``(merged, count, n_new)``: ``merged`` has ``buf``'s length
    (sorted unique, cut there, sentinel-padded), ``count`` is the uncapped
    unique total and ``n_new`` the number of values not already in
    ``buf`` (both int64, shape ``(1,)``).  With ``out`` the result is
    written there."""
    big = sentinel(buf.dtype)
    cap = buf.shape[0]
    old = buf[buf != big]
    merged = torch.unique(torch.cat([old, fresh[fresh != big]]))
    res = torch.full((cap,), big, dtype=buf.dtype, device=buf.device)
    k = min(cap, merged.shape[0])
    res[:k] = merged[:k]
    if out is not None:
        out.copy_(res)
        res = out
    dev = buf.device
    count = torch.tensor([merged.shape[0]], dtype=torch.int64, device=dev)
    n_new = torch.tensor(
        [merged.shape[0] - old.shape[0]], dtype=torch.int64, device=dev
    )
    return res, count, n_new
