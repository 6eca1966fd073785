"""Process-wide memory accountant (the subset the engine reports through).

Every byte-holding object implements ``memory_report() -> dict[str, int]``
and registers itself, weakly, under a *kind* (``columns``, ``buffers``,
``cmat``, ``flat``).  Keys ending ``_bytes`` are resident payload bytes;
other keys are auxiliary integers.  Tensor bytes are ``numel *
element_size`` wherever the tensor lives; a tensor that views a larger
storage than its own elements (a slice of a bigger block) is reported as
*backed*, so the block it views is not counted once per view-holder.
"""

from __future__ import annotations

import weakref
from typing import Protocol, runtime_checkable

import torch

__all__ = [
    "MemoryAccountant",
    "MemoryReporter",
    "get_accountant",
    "register_reporter",
    "split_owned_backed",
    "tensor_is_backed",
    "tensor_nbytes",
]


@runtime_checkable
class MemoryReporter(Protocol):
    """Anything that can say where its bytes live."""

    def memory_report(self) -> dict[str, int]:  # pragma: no cover - protocol
        ...


def tensor_nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def tensor_is_backed(t: torch.Tensor) -> bool:
    """True when ``t`` views a storage larger than its own elements."""
    return t.untyped_storage().nbytes() > tensor_nbytes(t)


def split_owned_backed(tensors) -> tuple[int, int]:
    """Sum ``(owned_bytes, backed_bytes)`` over tensors (``None`` skipped)."""
    owned = backed = 0
    for t in tensors:
        if t is None:
            continue
        if tensor_is_backed(t):
            backed += tensor_nbytes(t)
        else:
            owned += tensor_nbytes(t)
    return owned, backed


class MemoryAccountant:
    """Weak registry of reporters grouped by kind; :meth:`collect` sums
    the reports of the live instances of each kind part-wise."""

    def __init__(self):
        self._kinds: dict[str, list[weakref.ref]] = {}

    def register(self, kind: str, reporter: MemoryReporter) -> None:
        refs = self._kinds.setdefault(kind, [])
        if not any(r() is reporter for r in refs):
            refs.append(weakref.ref(reporter))

    def live(self) -> dict[str, list]:
        """Live reporters per kind (prunes dead weakrefs in place)."""
        out: dict[str, list] = {}
        for kind, refs in self._kinds.items():
            objs = [o for o in (r() for r in refs) if o is not None]
            self._kinds[kind] = [weakref.ref(o) for o in objs]
            out[kind] = objs
        return out

    def collect(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for kind, objs in self.live().items():
            merged: dict[str, int] = {}
            for obj in objs:
                for key, val in obj.memory_report().items():
                    merged[key] = merged.get(key, 0) + int(val)
            out[kind] = merged
        return out


#: the process-wide accountant every subsystem registers with
_ACCOUNTANT = MemoryAccountant()


def get_accountant() -> MemoryAccountant:
    return _ACCOUNTANT


def register_reporter(kind: str, reporter: MemoryReporter) -> None:
    """Register with the process-wide accountant (weakly)."""
    _ACCOUNTANT.register(kind, reporter)
