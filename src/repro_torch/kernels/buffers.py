"""Per-predicate fact buffers with watermarks — sorted code indexes on a device.

Two modes, chosen by ``dtype``:

* **int64** (the default; the fused engine's dedup index): packed codes
  (arity 1: the id; arity 2: ``(a << 32) | b``), with the
  ``DedupIndex``-compatible :meth:`seed` / :meth:`fresh_mask` surface.
* **int32** (the reference's ``FactBuffers(device=True)``): the 16-bit-halves
  pair codes of the distributed engine's ``pack_pairs``, folded in with
  :meth:`merge` — for example a ``fused_join_dedup`` output.  The caller
  packs; there is no row surface.

Codes are kept sorted-unique in sentinel-padded power-of-two buffers on
the buffers' device, with a host ``count`` watermark.  The same layout
serves the CPU (with the plain merge) and the card (with the
``merge_sorted_unique`` kernel), so the CPU tests exercise the
grow-before-merge logic the card runs.

Invariants:

1. ``front[:count]`` is strictly increasing; every slot at or beyond
   ``count`` holds the sentinel (the key type's max).
2. ``count <= capacity``; capacity is a power of two, at least 128 (so
   a multiple of 128, as the TPU merge requires).
3. Growth happens *before* every merge: :meth:`merge` regrows whenever
   ``count + len(fresh)`` could exceed the capacity, so the merge never
   cuts a value off.

Each predicate owns a pair of equal-capacity buffers: the merge writes
into the back buffer (the kernel never writes over the buffer it reads)
and the pair is swapped, so a steady-state round allocates no buffer.
:meth:`fresh_mask` keeps the ``DedupIndex`` contract of the reference
(``kernels/buffers.py:165-188``).
"""

from __future__ import annotations

import torch

from ..core.dedup import DedupIndex
from ..core.util import first_occurrence_mask, resolve_device, sorted_member
from ..obs import get_registry
from ..obs.memory import register_reporter
from .fused import merge_sorted_unique

__all__ = ["BIG", "FactBuffers"]

_SCOPE = "kernels.buffers."

#: pad sentinel of the int64 mode: larger than any packed code
BIG = torch.iinfo(torch.int64).max

_MIN_CAPACITY = 128


def _round_capacity(n: int) -> int:
    """Next power of two >= n (floor 128): doubling keeps regrows
    logarithmic."""
    n = max(int(n), _MIN_CAPACITY)
    return 1 << (n - 1).bit_length()


class FactBuffers:
    """Sorted per-predicate fact code buffers on one device
    (``device=None``: the card)."""

    def __init__(self, device: torch.device | str | None = None,
                 initial_capacity: int = 1024, dtype: torch.dtype = torch.int64):
        if dtype not in (torch.int32, torch.int64):
            raise TypeError(f"FactBuffers: int32 or int64 codes, not {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self._big = torch.iinfo(dtype).max
        self._initial_capacity = _round_capacity(initial_capacity)
        self._reg = get_registry()
        self.regrows = 0
        self._peak_occupied_bytes = 0
        self._front: dict[str, torch.Tensor] = {}
        self._back: dict[str, torch.Tensor] = {}
        self._count: dict[str, int] = {}
        register_reporter("buffers", self)

    # ------------------------------------------------------------------ #
    # byte accounting (obs.memory reporter protocol)
    # ------------------------------------------------------------------ #
    def occupied_bytes(self) -> int:
        """Bytes of live codes (below the watermarks)."""
        return self.dtype.itemsize * sum(self._count.values())

    def capacity_bytes(self) -> int:
        """Bytes allocated: both buffers of every predicate."""
        return 2 * self.dtype.itemsize * sum(int(b.shape[0]) for b in self._front.values())

    def memory_report(self) -> dict[str, int]:
        occ = self.occupied_bytes()
        self._peak_occupied_bytes = max(self._peak_occupied_bytes, occ)
        return {
            "occupied_bytes": occ,
            "padding_bytes": self.capacity_bytes() - occ,
            "peak_occupied": self._peak_occupied_bytes,
            "regrows": self.regrows,
            "n_predicates": len(self._front),
        }

    # ------------------------------------------------------------------ #
    # the DedupIndex-compatible surface
    # ------------------------------------------------------------------ #
    def pack(self, rows: torch.Tensor) -> torch.Tensor | None:
        """int64 mode: arity 1 packs to the id, arity 2 to ``(a << 32) |
        b``; wider rows give None and the caller falls back."""
        if self.dtype != torch.int64:
            raise RuntimeError("FactBuffers: rows are packed by the caller in int32 mode")
        return DedupIndex.pack(rows)

    def seed(self, pred: str, rows: torch.Tensor) -> None:
        """Fold already-known facts in without producing a mask."""
        packed = self.pack(rows)
        if packed is None:
            return
        self.merge(pred, torch.unique(packed))

    def fresh_mask(self, pred: str, rows: torch.Tensor) -> torch.Tensor | None:
        """Keep-mask over ``rows``: not already buffered AND first
        occurrence in the block; survivors are merged in.  None when the
        arity is unpackable (caller falls back to factorisation)."""
        packed = self.pack(rows)
        if packed is None:
            return None
        count = self._count.get(pred, 0)
        if count == 0:
            not_in = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        else:
            not_in = ~sorted_member(packed, self._front[pred][:count])
        keep = not_in & first_occurrence_mask(packed)
        survivors = packed[keep]
        if survivors.shape[0]:
            self.merge(pred, torch.sort(survivors).values)
        return keep

    def codes(self, pred: str) -> torch.Tensor:
        buf = self._front.get(pred)
        if buf is None:
            return torch.zeros(0, dtype=self.dtype, device=self.device)
        return buf[: self._count[pred]]

    def count(self, pred: str) -> int:
        return self._count.get(pred, 0)

    def capacity(self, pred: str) -> int:
        buf = self._front.get(pred)
        return 0 if buf is None else int(buf.shape[0])

    # ------------------------------------------------------------------ #
    # growth and the kernel merge
    # ------------------------------------------------------------------ #
    def ensure(self, pred: str, min_capacity: int | None = None) -> torch.Tensor:
        """Front buffer of ``pred``, (re)allocated to hold at least
        ``min_capacity`` codes and never fewer than the initial capacity
        (invariant 3: grow before merging)."""
        need = max(self._initial_capacity, min_capacity or 0)
        old = self._front.get(pred)
        if old is not None and old.shape[0] >= need:
            return old
        cap = _round_capacity(need)
        front = torch.full((cap,), self._big, dtype=self.dtype, device=self.device)
        if old is not None:
            front[: old.shape[0]] = old
            self.regrows += 1
            self._reg.counter(f"{_SCOPE}regrows").inc()
        self._front[pred] = front
        self._back[pred] = torch.empty_like(front)
        self._count.setdefault(pred, 0)
        self._reg.counter(f"{_SCOPE}allocations").inc()
        return front

    def merge(self, pred: str, fresh: torch.Tensor) -> int:
        """Merge an ascending block of codes (sentinel-padded or exact,
        e.g. a ``fused_join_dedup`` output in int32 mode) into ``pred``'s
        buffer through ``merge_sorted_unique``, after growing it to fit.
        Returns the number of genuinely new codes."""
        fresh = fresh.to(device=self.device, dtype=self.dtype).contiguous()
        count = self._count.get(pred, 0)
        front = self.ensure(pred, count + int(fresh.shape[0]))
        merged, cnt, n_new = merge_sorted_unique(
            front, fresh, out=self._back[pred], count=count
        )
        new_count, added = torch.cat([cnt, n_new]).tolist()
        if new_count > merged.shape[0]:
            raise RuntimeError("merge overflowed the buffer's capacity")
        self._back[pred], self._front[pred] = front, merged
        self._count[pred] = new_count
        self._reg.counter(f"{_SCOPE}merges").inc()
        self._reg.counter(f"{_SCOPE}rows_merged").inc(int(fresh.shape[0]))
        return added
