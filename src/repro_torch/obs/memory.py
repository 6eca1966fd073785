"""Process-wide memory accountant, its roll-up, and per-predicate
compression effectiveness.

Every byte-holding object implements ``memory_report() -> dict[str, int]``
and registers itself, weakly, under a *kind* (``columns``, ``buffers``,
``cmat``, ``flat``, ``frozen``, ``inc``).  Keys ending ``_bytes`` are
resident payload bytes; other keys are auxiliary integers.  Tensor bytes
are ``numel * element_size`` wherever the tensor lives; a tensor that
views a larger storage than its own elements (a slice of a bigger block)
is reported as *backed*, so the block it views is not counted once per
view-holder.  :func:`sample_memory` rolls the reports up into ``mem.*``
gauges with peak watermarks; :func:`publish_predicate_effectiveness`
publishes the ``mem.pred.*`` compression gauges.  (The span-driven peak
sampler is not ported yet; see ``ROADMAP.md`` queue 1 item 9.)
"""

from __future__ import annotations

import os
import weakref
from typing import Protocol, runtime_checkable

import torch

from .metrics import MetricsRegistry, get_registry

__all__ = [
    "MemoryAccountant",
    "MemoryReporter",
    "get_accountant",
    "predicate_effectiveness",
    "publish_predicate_effectiveness",
    "register_reporter",
    "rss_bytes",
    "sample_memory",
    "split_owned_backed",
    "tensor_is_backed",
    "tensor_nbytes",
]

_PAGE_SIZE = None


def rss_bytes() -> int:
    """Current resident set size of the process: ``/proc/self/statm`` on
    Linux, else the peak ``ru_maxrss``; 0 if neither works."""
    global _PAGE_SIZE
    try:
        with open("/proc/self/statm", "rb") as f:
            resident_pages = int(f.read().split()[1])
        if _PAGE_SIZE is None:
            _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
        return resident_pages * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # pragma: no cover - platforms without either
            return 0


def _is_resident_key(key: str) -> bool:
    """``*_bytes`` parts roll into ``mem.resident_bytes``, except disk
    bytes and backed bytes (views of a larger block, summed apart into
    ``mem.snapshot_backed_bytes`` so a block is not counted per view)."""
    return (
        key.endswith("_bytes")
        and not key.endswith("_disk_bytes")
        and not key.endswith("_backed_bytes")
    )


def _gauge_max(reg: MetricsRegistry, name: str, value) -> None:
    g = reg.gauge(name)
    if value > g.value:
        g.set(value)


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
        #: parts seen per kind, so the gauges of parts gone are zeroed
        self._parts_seen: dict[str, set[str]] = {}

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

    def resident_bytes(self, collected: dict | None = None) -> int:
        if collected is None:
            collected = self.collect()
        return sum(
            val
            for parts in collected.values()
            for key, val in parts.items()
            if _is_resident_key(key)
        )

    def sample(
        self,
        registry: MetricsRegistry | None = None,
        phase: str | None = None,
        rss: bool = True,
    ) -> dict[str, int]:
        """One roll-up: ``mem.<kind>.<part>`` gauges, the
        ``mem.resident_bytes`` total, RSS, and the peak gauges (globally
        and, when ``phase`` is given, per phase)."""
        reg = registry if registry is not None else get_registry()
        collected = self.collect()
        flat: dict[str, int] = {}
        for kind, parts in collected.items():
            seen = self._parts_seen.setdefault(kind, set())
            for key in seen - parts.keys():
                reg.gauge(f"mem.{kind}.{key}").set(0)
            for key, val in parts.items():
                reg.gauge(f"mem.{kind}.{key}").set(val)
                flat[f"{kind}.{key}"] = val
            seen.update(parts.keys())
        resident = self.resident_bytes(collected)
        backed = sum(
            val
            for parts in collected.values()
            for key, val in parts.items()
            if key.endswith("_backed_bytes")
        )
        reg.gauge("mem.resident_bytes").set(resident)
        reg.gauge("mem.snapshot_backed_bytes").set(backed)
        _gauge_max(reg, "mem.peak_resident_bytes", resident)
        flat["resident_bytes"] = resident
        flat["snapshot_backed_bytes"] = backed
        if phase:
            _gauge_max(reg, f"mem.peak.{phase}.resident_bytes", resident)
        if rss:
            r = rss_bytes()
            reg.gauge("mem.rss_bytes").set(r)
            _gauge_max(reg, "mem.peak_rss_bytes", r)
            if phase:
                _gauge_max(reg, f"mem.peak.{phase}.rss_bytes", r)
            flat["rss_bytes"] = r
        return flat


#: the process-wide accountant every subsystem registers with
_ACCOUNTANT = MemoryAccountant()


def get_accountant() -> MemoryAccountant:
    return _ACCOUNTANT


def register_reporter(kind: str, reporter: MemoryReporter) -> None:
    """Register with the process-wide accountant (weakly)."""
    _ACCOUNTANT.register(kind, reporter)


def sample_memory(phase: str | None = None, rss: bool = True) -> dict:
    """One roll-up on the process-wide accountant and registry."""
    return _ACCOUNTANT.sample(phase=phase, rss=rss)


def predicate_effectiveness(facts) -> dict[str, dict[str, float]]:
    """Per-predicate compression statistics over a ``FactStore``:
    ``flat_bytes`` (rows x arity x 8), ``mu_bytes`` (bytes of the nodes
    reachable from the predicate's columns, each once),
    ``compression_ratio`` (flat / mu), ``sharing_factor`` (tree-expanded
    bytes / mu bytes) and ``rle_ratio`` (cells per run over the reachable
    leaves).  ``_total`` summarises the whole store, each shared node
    counted once; its ``sharing_factor`` is the sum of the per-predicate
    ``mu_bytes`` over the store's.  Host only: node sizes are known
    without a device read."""
    store = facts.store
    out: dict[str, dict[str, float]] = {}
    all_roots: list[int] = []
    sum_pred_mu = 0
    for pred in facts.predicates():
        mfs = facts.all(pred)
        if not mfs:
            continue
        arity = mfs[0].arity
        n_rows = sum(mf.length for mf in mfs)
        flat_bytes = n_rows * arity * 8
        roots = [c for mf in mfs for c in mf.columns]
        all_roots.extend(roots)
        reach = store.reachable(roots)
        mu_bytes = sum(store.node_nbytes(c) for c in reach)
        sum_pred_mu += mu_bytes
        cells, runs = store.leaf_rle_stats(reach)
        tree_bytes = store.expanded_nbytes(roots)
        out[pred] = {
            "flat_bytes": flat_bytes,
            "mu_bytes": mu_bytes,
            "compression_ratio": flat_bytes / mu_bytes if mu_bytes else 0.0,
            "sharing_factor": tree_bytes / mu_bytes if mu_bytes else 0.0,
            "rle_ratio": cells / runs if runs else 0.0,
        }
    if out:
        reach = store.reachable(all_roots)
        mu_total = sum(store.node_nbytes(c) for c in reach)
        cells, runs = store.leaf_rle_stats(reach)
        flat_total = sum(int(p["flat_bytes"]) for p in out.values())
        out["_total"] = {
            "flat_bytes": flat_total,
            "mu_bytes": mu_total,
            "compression_ratio": flat_total / mu_total if mu_total else 0.0,
            "sharing_factor": sum_pred_mu / mu_total if mu_total else 0.0,
            "rle_ratio": cells / runs if runs else 0.0,
        }
    return out


def publish_predicate_effectiveness(
    facts, registry: MetricsRegistry | None = None
) -> dict[str, dict[str, float]]:
    """Publish :func:`predicate_effectiveness` as ``mem.pred.*`` gauges."""
    reg = registry if registry is not None else get_registry()
    stats = predicate_effectiveness(facts)
    for pred, parts in stats.items():
        for key, val in parts.items():
            reg.gauge(f"mem.pred.{pred}.{key}").set(
                round(val, 4) if isinstance(val, float) else val
            )
    return stats
