"""What a run records besides its end-to-end numbers.

* :class:`Spans`: the harness's own spans, on the host's clock
  (``perf_counter_ns``), around the calls it makes into the program.
* :class:`SyncCounter`: host synchronisations of the device, counted
  under CUDA's sync debug mode, which warns once per synchronising call
  (the pattern of ``chip_smoke._count_syncs``).  A warning is caught in
  whichever thread raises it.
* :class:`DeviceTrace`: every operation the device ran, from
  ``torch.profiler`` with CUDA activity only, moved onto the host clock
  of the spans; the union of its intervals is the device's busy time.

:func:`breakdown` reduces them to the longest device operations and the
idle time of the device by the innermost span open on the host.
"""

from __future__ import annotations

import threading
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = ["DeviceTrace", "Span", "Spans", "SyncCounter", "breakdown", "busy_ns"]


@dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    dur_ns: int
    depth: int
    tid: int

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


class Spans:
    """Spans the harness records around its calls into the program."""

    def __init__(self):
        self.spans: list[Span] = []
        self._local = threading.local()

    @contextmanager
    def span(self, name: str):
        stack = self._local.__dict__.setdefault("stack", [])
        depth = len(stack)
        stack.append(name)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur = time.perf_counter_ns() - t0
            stack.pop()
            self.spans.append(Span(name, t0, dur, depth, threading.get_ident()))


class SyncCounter:
    """Counts host synchronisations between :meth:`start` and
    :meth:`stop` (``count``)."""

    def __init__(self):
        self.count = 0
        self._cm = None
        self._caught = None

    def start(self) -> None:
        import torch

        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> None:
        import torch

        torch.cuda.set_sync_debug_mode("default")
        caught = list(self._caught)
        self._cm.__exit__(None, None, None)
        self.count = sum("synchroniz" in str(w.message) for w in caught)


class DeviceTrace:
    """The device's operations between :meth:`start` and :meth:`stop`:
    ``events``, ``(name, start_ns, dur_ns)`` on the ``perf_counter_ns``
    clock."""

    def __init__(self):
        self.events: list[tuple[str, int, int]] = []
        self._prof = None
        self._offset = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        # the profiler's events are stamped on the wall clock (ns)
        self._offset = time.perf_counter_ns() - time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                out.append((e.name(), e.start_ns() + self._offset, e.duration_ns()))
        out.sort(key=lambda x: x[1])
        self.events = out
        self._prof = None


def _merged(events, t0: int, t1: int) -> list[tuple[int, int]]:
    """The union of the events' intervals, cut to ``[t0, t1]``."""
    out: list[list[int]] = []
    for _, s, d in events:
        s, e = max(s, t0), min(s + d, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(events, t0: int, t1: int) -> int:
    return sum(e - s for s, e in _merged(events, t0, t1))


def breakdown(events, spans: list[Span], t0: int, t1: int, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time in all,
    by name; ``idle_gaps``: the device's idle time in ``[t0, t1]`` by the
    innermost span open on the host when each gap began (``none`` where
    no span was open); each list ``[name, seconds]``, longest first."""
    by_op: dict[str, int] = {}
    for name, s, d in events:
        if s < t1 and s + d > t0:
            by_op[name] = by_op.get(name, 0) + d
    busy = _merged(events, t0, t1)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if t1 > prev:
        gaps.append((prev, t1))
    spans = sorted(spans, key=lambda s: s.start_ns)
    idle: dict[str, int] = {}
    active: list[Span] = []
    k = 0
    for g0, g1 in gaps:  # in time order: a sweep over the span starts
        while k < len(spans) and spans[k].start_ns <= g0:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s.end_ns > g0]
        name = max(active, key=lambda s: (s.depth, s.start_ns)).name if active else "none"
        idle[name] = idle.get(name, 0) + (g1 - g0)

    def top_of(d):
        return [[n[:160], v / 1e9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(idle)}
