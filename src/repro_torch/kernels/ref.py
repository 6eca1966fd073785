"""Plain PyTorch versions of the kernels (the correctness references).

The wrappers use these for tensors on the CPU; ``chip_smoke.py`` holds each
kernel against them on the card.  Nothing on the main path calls them while
its tensors are on a card.  Key tensors are int32 (the TPU contract, with
int32 max as the pad sentinel) or int64 (packed row codes, int64 max).
"""

from __future__ import annotations

import torch

__all__ = [
    "fused_join_dedup",
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


def pack_pairs16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``(hi << 16) | (lo & 0xFFFF)`` with int32 wrap-around, as the TPU's
    int32 arithmetic gives it (computed in int64, cut to 32 bits)."""
    code = ((hi.to(torch.int64) << 16) | (lo.to(torch.int64) & 0xFFFF)) & 0xFFFFFFFF
    return torch.where(code >= 2**31, code - 2**32, code).to(torch.int32)


def join_pairs16(l_keys: torch.Tensor, l_payload: torch.Tensor,
                 r_keys_sorted: torch.Tensor, r_payload: torch.Tensor,
                 capacity: int):
    """The first ``capacity`` matching pairs of ``l`` against sorted ``r``
    in left-major order, packed by :func:`pack_pairs16` (not sorted, not
    deduplicated), and the exact number of pairs.  A left key equal to the
    int32 sentinel matches nothing."""
    dev = l_keys.device
    if l_keys.shape[0] == 0 or r_keys_sorted.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), 0
    lo = torch.searchsorted(r_keys_sorted, l_keys)
    hi = torch.searchsorted(r_keys_sorted, l_keys, right=True)
    cnt = torch.where(l_keys != sentinel(torch.int32), hi - lo, 0)
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1])
    t = torch.arange(min(total, capacity), device=dev)
    li = torch.searchsorted(ends, t, right=True)
    rj = lo[li] + (t - (ends[li] - cnt[li]))
    return pack_pairs16(l_payload[li], r_payload[rj]), total


def fused_join_dedup(l_keys: torch.Tensor, l_payload: torch.Tensor,
                     r_keys_sorted: torch.Tensor, r_payload: torch.Tensor,
                     capacity: int):
    """Join ``l`` against sorted ``r`` on key, pack each matching pair as
    ``(l_payload << 16) | (r_payload & 0xFFFF)``, sort and drop duplicates.

    Follows the TPU body ``_fused_join_dedup_kernel``: a left key equal to
    the int32 sentinel matches nothing; pairs are enumerated left-major
    and cut at ``capacity`` *before* the dedup; a code equal to the
    sentinel is never kept.  Returns ``(out, count, total)``: ``out`` is
    ``(capacity,)`` int32, sorted unique, sentinel-padded; ``count`` the
    unique codes kept (int32, shape ``(1,)``); ``total`` the exact number
    of pairs before the cut and the dedup (a host int).  An empty side or
    a zero capacity gives an all-sentinel ``out``, count 0 and total 0."""
    big = sentinel(torch.int32)
    dev = l_keys.device
    out = torch.full((capacity,), big, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if capacity == 0:
        return out, count, 0
    codes, total = join_pairs16(l_keys, l_payload, r_keys_sorted, r_payload, capacity)
    codes = torch.unique(codes)
    codes = codes[codes != big]
    out[: codes.shape[0]] = codes
    count[0] = codes.shape[0]
    return out, count, total


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
