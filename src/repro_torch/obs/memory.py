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
publishes the ``mem.pred.*`` compression gauges.

:class:`MemorySampler` is the opt-in peak tracker: a tracer hook that
re-samples the accountant (and RSS) at phase and round span boundaries,
keeping per-phase high-water marks (``mem.peak.<phase>.*``), metering its
own cost and throttling itself to a budget share of the wall time.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Protocol, runtime_checkable

import torch

from .metrics import MetricsRegistry, get_registry
from .trace import Tracer, get_tracer

__all__ = [
    "PHASE_SPANS",
    "ROUND_SPANS",
    "MemoryAccountant",
    "MemoryReporter",
    "MemorySampler",
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


# --------------------------------------------------------------------- #
# the peak sampler (tracer-hook driven)
# --------------------------------------------------------------------- #
#: span names that are a phase: sampling at their exit records the
#: phase's closing watermark under ``mem.peak.<phase>.*``
PHASE_SPANS: dict[str, str] = {
    "cmat.materialise": "materialise",
    "flat.materialise": "materialise",
    "dist.stratum": "materialise",
    "inc.seminaive_insert": "apply",
    "inc.insertion_sweep": "apply",
    "inc.deletion_sweep": "apply",
    "inc.counting_insert": "apply",
    "inc.counting_delete": "apply",
    "inc.dred_stratum": "apply",
    "storage.restore": "restore",
    "storage.compact": "compact",
    "serve.update_batch": "serve_batch",
}

#: intra-phase boundaries, sampled too (peaks live inside a fixpoint),
#: attributed to the innermost enclosing phase span
ROUND_SPANS: frozenset = frozenset({"cmat.round", "flat.round", "cmat.recompress"})


class MemorySampler:
    """Opt-in peak tracker riding span boundaries.

    ``attach()`` registers a hook on the tracer (enabling it if it was
    off; ``detach()`` restores the flag and publishes).  The hook fires
    only for ``PHASE_SPANS`` / ``ROUND_SPANS`` names; it folds the
    accountant's resident total (and RSS) into in-memory peaks, with no
    gauge traffic per round, and meters itself into ``time_ns`` /
    ``samples``.  It throttles itself: after a sample that cost ``c`` ns,
    the next is allowed no sooner than ``c / budget`` ns later (skips
    counted in ``throttled``), so its share of the wall stays within
    ``budget``."""

    def __init__(
        self,
        accountant: MemoryAccountant | None = None,
        registry: MetricsRegistry | None = None,
        extra_spans: dict[str, str] | None = None,
        rss: bool = True,
        budget: float = 0.01,
    ):
        self._accountant = accountant
        self._registry = registry
        self._rss = rss
        self._budget = budget
        self._next_ns = 0
        self._phases = dict(PHASE_SPANS)
        if extra_spans:
            self._phases.update(extra_spans)
        self._watch = frozenset(self._phases) | ROUND_SPANS
        self.samples = 0
        self.throttled = 0
        self.time_ns = 0
        self.peaks: dict[str, int] = {}
        self._rss_peaks: dict[str, int] = {}
        self._tracer: Tracer | None = None
        self._was_enabled = False

    # ------------------------------------------------------------------ #
    def attach(self, tracer: Tracer | None = None) -> MemorySampler:
        self._tracer = tracer if tracer is not None else get_tracer()
        self._was_enabled = self._tracer.enabled
        self._tracer.enable()
        self._tracer.add_hook(self._hook)
        self.sample()  # baseline watermark before any phase runs
        return self

    def detach(self) -> None:
        if self._tracer is None:
            return
        self._tracer.remove_hook(self._hook)
        if not self._was_enabled:
            self._tracer.disable()
        self._tracer = None
        self._publish()

    def __enter__(self) -> MemorySampler:
        return self.attach()

    def __exit__(self, *exc) -> bool:
        self.detach()
        return False

    # ------------------------------------------------------------------ #
    def _acc(self) -> MemoryAccountant:
        return self._accountant if self._accountant is not None else get_accountant()

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def _hook(self, tracer: Tracer, rec) -> None:
        name = rec.name
        if name not in self._watch:
            return
        t0 = time.perf_counter_ns()
        if t0 < self._next_ns:
            self.throttled += 1
            return
        phase = self._phases.get(name)
        if phase is None:
            # round boundary: attribute to the innermost open phase
            # (children exit before parents, so it is still on the stack)
            for live in reversed(tracer._stack()):
                phase = self._phases.get(live.name)
                if phase is not None:
                    break
        self._sample_light(phase)
        cost = time.perf_counter_ns() - t0
        self.time_ns += cost
        if self._budget > 0:
            self._next_ns = t0 + cost + int(cost / self._budget)

    def _note(self, key: str, resident: int, rss: int | None) -> None:
        if resident > self.peaks.get(key, -1):
            self.peaks[key] = resident
        if rss is not None and rss > self._rss_peaks.get(key, -1):
            self._rss_peaks[key] = rss

    def _sample_light(self, phase: str | None) -> None:
        """Hook-path sample: peaks only, no per-part gauges."""
        self.samples += 1
        self._note(phase or "(unphased)", self._acc().resident_bytes(),
                   rss_bytes() if self._rss else None)

    def sample(self, phase: str | None = None) -> dict:
        """Full roll-up (gauges included), the explicit-call path."""
        reg = self._reg()
        flat = self._acc().sample(registry=reg, phase=phase, rss=self._rss)
        self.samples += 1
        self._note(phase or "(unphased)", flat.get("resident_bytes", 0),
                   flat.get("rss_bytes", 0) if self._rss else None)
        self._publish_counts(reg)
        return flat

    def _publish_counts(self, reg: MetricsRegistry) -> None:
        reg.gauge("mem.sampler.samples").set(self.samples)
        reg.gauge("mem.sampler.throttled").set(self.throttled)
        reg.gauge("mem.sampler.time_s").set(self.time_ns / 1e9)

    def _publish(self) -> None:
        """One full roll-up plus the accumulated per-phase watermarks."""
        reg = self._reg()
        self._acc().sample(registry=reg, rss=self._rss)
        for key, v in self.peaks.items():
            _gauge_max(reg, "mem.peak_resident_bytes", v)
            if key != "(unphased)":
                _gauge_max(reg, f"mem.peak.{key}.resident_bytes", v)
        for key, v in self._rss_peaks.items():
            _gauge_max(reg, "mem.peak_rss_bytes", v)
            if key != "(unphased)":
                _gauge_max(reg, f"mem.peak.{key}.rss_bytes", v)
        self._publish_counts(reg)


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
