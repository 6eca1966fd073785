"""Span tracer: nested, low-overhead, host-side only.

One process-wide :class:`Tracer` (swap it with :func:`set_tracer`)
records *complete* spans — name, start, duration, nesting depth, and a
flat attribute dict — with ``time.perf_counter_ns`` timestamps.  Spans
are context managers::

    from repro_torch.obs import span

    with span("cmat.round", round=3, stratum=0):
        ...work...

Design constraints (DESIGN.md §Observability):

* **Disabled is free.**  The default tracer is disabled;
  ``tracer.span(...)`` then returns a shared no-op singleton — no event
  allocation, no timestamp read, no stack push.  Engines can leave
  their instrumentation unguarded in host-side loops.
* **Host boundaries only.**  Spans read the wall clock and append to a
  Python list; they must never execute inside traced/jitted code, where
  the side effect would fire once per trace instead of per execution
  (the same rule the kernel meter and ``DistributedStats`` follow).
  Instrument where the engines already count rounds.
* **Bounded.**  At ``max_events`` the tracer stops recording (and
  counts the drops) instead of growing without bound under a serving
  loop left tracing for hours.

The recorded span list converts losslessly to the Chrome trace-event /
Perfetto JSON format (``repro.obs.export`` in the reference package) — open the file in
``chrome://tracing`` or https://ui.perfetto.dev.
"""

from __future__ import annotations

import threading
import time

__all__ = [
    "Tracer",
    "SpanRecord",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
]


class SpanRecord:
    """One closed span: ``name``, ``start_ns``/``dur_ns`` (perf-counter
    clock), ``depth`` (0 = root), ``tid``, and ``args``."""

    __slots__ = ("name", "start_ns", "dur_ns", "depth", "tid", "args")

    def __init__(self, name, start_ns, dur_ns, depth, tid, args):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.depth = depth
        self.tid = tid
        self.args = args

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"SpanRecord({self.name!r}, dur={self.dur_ns / 1e6:.3f}ms, "
            f"depth={self.depth}, args={self.args!r})"
        )


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        """No-op twin of :meth:`_Span.set`."""
        return self


_NOOP = _NoopSpan()


class _Span:
    """Live span handle; records itself into the tracer on ``__exit__``.

    The record is appended at *exit* (Chrome 'X' complete events carry
    start + duration), so children appear before their parent in the
    event list; ordering by ``start_ns`` recovers program order and the
    exporter does not care.
    """

    __slots__ = ("_tracer", "name", "args", "_start", "_depth")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **kw):
        """Attach attributes discovered mid-span (e.g. cache hit/miss)."""
        self.args.update(kw)
        return self

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._start
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # mis-nested exit: recover rather than corrupt the stack
            try:
                stack.remove(self)
            except ValueError:
                pass
            tracer.misnested += 1
        tracer._record(
            SpanRecord(
                self.name,
                self._start,
                dur,
                self._depth,
                threading.get_ident(),
                self.args,
            )
        )
        return False


class Tracer:
    """Process-wide span recorder (see module docstring)."""

    def __init__(self, enabled: bool = False, max_events: int = 1_000_000):
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self.events: list[SpanRecord] = []
        #: spans/instants not recorded because ``max_events`` was hit
        self.dropped = 0
        #: spans exited out of LIFO order (a bug in instrumentation)
        self.misnested = 0
        #: observers called as ``hook(tracer, record)`` on every span
        #: close / instant — the attachment point for samplers that need
        #: span *boundaries* (e.g. memory watermarks) without touching
        #: the instrumentation sites.  Hooks run on the recording thread
        #: and must be cheap; exceptions are swallowed and counted so a
        #: broken observer can never take an engine down.
        self.hooks: list = []
        self.hook_errors = 0
        self._local = threading.local()
        #: perf-counter origin for relative timestamps in exports
        self.origin_ns = time.perf_counter_ns()
        #: wall-clock at origin (Perfetto UIs show absolute times)
        self.origin_unix_s = time.time()

    # ------------------------------------------------------------------ #
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
        else:
            self.events.append(rec)
        # hooks still see boundaries once the event buffer is full —
        # watermark samplers must not stop with the recording.
        if self.hooks:
            for hook in tuple(self.hooks):
                try:
                    hook(self, rec)
                except Exception:
                    self.hook_errors += 1

    def add_hook(self, hook) -> None:
        """Register a ``hook(tracer, record)`` span-boundary observer."""
        if hook not in self.hooks:
            self.hooks.append(hook)

    def remove_hook(self, hook) -> None:
        if hook in self.hooks:
            self.hooks.remove(hook)

    # ------------------------------------------------------------------ #
    def span(self, name: str, **args):
        """Context manager timing one named span.  Disabled tracers
        return a shared no-op singleton (the zero-cost fast path)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (regrows, WAL appends, ...).
        Recorded with ``dur_ns == -1`` so the exporter can tell a marker
        from a genuinely sub-resolution span."""
        if not self.enabled:
            return
        self._record(
            SpanRecord(
                name,
                time.perf_counter_ns(),
                -1,
                len(self._stack()),
                threading.get_ident(),
                args,
            )
        )

    # ------------------------------------------------------------------ #
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop recorded events (the enabled flag is unchanged)."""
        self.events = []
        self.dropped = 0
        self.misnested = 0
        self.origin_ns = time.perf_counter_ns()
        self.origin_unix_s = time.time()

    def sorted_events(self) -> list[SpanRecord]:
        """Events in program (start-time) order — exits append children
        before parents, so the raw list is end-time ordered."""
        return sorted(self.events, key=lambda r: (r.start_ns, -r.dur_ns))


#: the process-wide tracer every ``repro_torch.obs.span(...)`` call hits
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (returns the previous one)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def span(name: str, **args):
    """Span on the process-wide tracer (the call every instrumentation
    site uses — re-reads the global, so enabling mid-process works)."""
    return _TRACER.span(name, **args)


def instant(name: str, **args) -> None:
    """Instant event on the process-wide tracer."""
    _TRACER.instant(name, **args)
