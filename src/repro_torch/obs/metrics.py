"""Metrics registry: named counters, gauges, and fixed-bucket histograms.

One process-wide :class:`MetricsRegistry` gives every number in the
system a single canonical name, one snapshot call, and one reset path —
the engines' stats dataclasses and the kernel meter publish into it
through the thin adapters in :mod:`repro_torch.obs.adapters`.

Naming scheme (DESIGN.md §Observability): dotted lowercase paths,
``<subsystem>.<metric>`` — e.g. ``cmat.rounds``,
``dist.exchanges_skipped``, ``kernels.member.calls``,
``storage.checkpoints``.  The prefix is the reset scope:
``registry.reset("kernels.")`` zeroes the kernel meter without touching
anything else (the per-suite isolation ``benchmarks/run.py`` relies on).

* **Counter** — monotonic within a scope; ``inc(n)``.
* **Gauge** — last-write-wins level; ``set(v)``.
* **Histogram** — fixed log-spaced buckets; ``observe(v)`` is one
  ``bisect`` + two adds, quantiles (p50/p95/p99) are interpolated from
  the bucket counts at snapshot time, exact to bucket resolution
  (~±12% with the default 10-buckets-per-decade bounds; the min/max
  tracks tighten the edge buckets).

Snapshots are *flat dicts of scalars* — the same shape the bench
artifact schema enforces — with histograms expanded to
``name.count`` / ``name.sum`` / ``name.p50`` / ``name.p95`` /
``name.p99`` / ``name.max``.
"""

from __future__ import annotations

from bisect import bisect_left

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "default_buckets",
]


def default_buckets() -> list[float]:
    """Log-spaced bucket upper bounds, 10 per decade over 1e-7..1e4 —
    wide enough for latencies in seconds and row/byte counts alike."""
    return [10.0 ** (-7 + i / 10.0) for i in range(111)]


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram; bucket ``i`` counts observations ``v``
    with ``bounds[i-1] < v <= bounds[i]`` (bucket 0: ``v <= bounds[0]``,
    the last bucket: ``v > bounds[-1]``)."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: list[float] | None = None):
        self.bounds = list(bounds) if bounds is not None else default_buckets()
        if sorted(self.bounds) != self.bounds:
            raise ValueError("histogram bounds must be sorted ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def quantile(self, q: float) -> float:
        """Interpolated quantile from the bucket counts (0 with no
        observations).  Matches ``numpy.percentile`` to within one
        bucket's width."""
        if self.count == 0:
            return 0.0
        target = q * (self.count - 1) + 1  # 1-based rank, linear method
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                # interpolate inside bucket i; clamp the open edges with
                # the observed min/max so single-bucket histograms and
                # the overflow bucket stay finite
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.max


class MetricsRegistry:
    """Get-or-create registry of named metrics (see module docstring)."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    # ------------------------------------------------------------------ #
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._check_fresh(name)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._check_fresh(name)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(
        self, name: str, bounds: list[float] | None = None
    ) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            self._check_fresh(name)
            h = self._hists[name] = Histogram(bounds)
        return h

    def _check_fresh(self, name: str) -> None:
        if (
            name in self._counters
            or name in self._gauges
            or name in self._hists
        ):
            raise ValueError(
                f"metric {name!r} already registered with a different type"
            )

    # ------------------------------------------------------------------ #
    def snapshot(self, prefix: str = "") -> dict[str, float | int]:
        """Flat ``{name: scalar}`` view of every metric under ``prefix``
        (histograms expand to count/sum/p50/p95/p99/max)."""
        out: dict[str, float | int] = {}
        for name, c in self._counters.items():
            if name.startswith(prefix):
                out[name] = c.value
        for name, g in self._gauges.items():
            if name.startswith(prefix):
                out[name] = g.value
        for name, h in self._hists.items():
            if not name.startswith(prefix):
                continue
            out[f"{name}.count"] = h.count
            out[f"{name}.sum"] = h.sum
            out[f"{name}.p50"] = h.quantile(0.50)
            out[f"{name}.p95"] = h.quantile(0.95)
            out[f"{name}.p99"] = h.quantile(0.99)
            out[f"{name}.max"] = h.max if h.count else 0.0
        return out

    def reset(self, prefix: str = "") -> None:
        """Zero every metric under ``prefix`` (all of them by default).
        Metrics stay registered — adapters and report renderers keep
        their handles."""
        for name, c in self._counters.items():
            if name.startswith(prefix):
                c.reset()
        for name, g in self._gauges.items():
            if name.startswith(prefix):
                g.reset()
        for name, h in self._hists.items():
            if name.startswith(prefix):
                h.reset()


#: the process-wide registry every adapter publishes into
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (returns the previous one)."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = registry
    return prev
