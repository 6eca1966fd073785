"""The run of one cell: its context, measured window and outcome.

A driver (``kbbench/drivers/<kind>.py``) builds the system under test in
set-up, calls :meth:`Context.open_window`, drives the traffic, calls
:meth:`Context.close_window` the moment the window's work is done, frees
the program's state, runs the reference and returns an :class:`Outcome`.
The window resets the device's memory peak and the program's launch and
tuner meters at its start; with ``--trace 1`` it also counts host
synchronisations, records the program's spans and traces the device.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

from .data import KB
from .trace import DeviceTrace, Span, Spans, SyncCounter, busy_ns

__all__ = ["Context", "Outcome", "Record"]


@dataclass
class Record:
    """What a window recorded, for the per-layer metrics' readers."""

    t0_ns: int
    t1_ns: int
    #: the harness's and the program's spans that began in the window
    spans: list[Span]
    #: the program's launch meter: launches and operand lengths per kernel
    launches: dict[str, int]
    launch_shapes: dict[str, list]
    #: the tuner's sweeps in the window (sweeps, launches, seconds)
    tuning: dict
    #: with ``--trace 1``: host synchronisations, device operations
    syncs: int | None = None
    device_events: list = field(default_factory=list)
    #: the driver's own counts (jobs, closure facts, resident bytes)
    counters: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def busy_s(self) -> float | None:
        if not self.device_events:
            return None
        return busy_ns(self.device_events, self.t0_ns, self.t1_ns) / 1e9


@dataclass
class Outcome:
    """A driver's result: its end-to-end readings by metric name, the work
    attempted and failed, and each number compared with its limit."""

    end_to_end: dict[str, float]
    attempted: int
    failed: int
    checks: dict[str, tuple[float, float]]


class Context:
    def __init__(self, spec, seed: int, seconds: float, trace: bool, device,
                 t_start_ns: int):
        import torch

        self.spec = spec
        self.config = spec.config
        self.traffic = spec.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start_ns = t_start_ns
        self.spans = Spans()
        self.record: Record | None = None
        self.setup_s: float | None = None
        self.peak_bytes = 0
        self.window_peak_bytes = 0
        self._t0 = 0
        self._syncs = SyncCounter() if self.trace and self.device.type == "cuda" else None
        self._dev = DeviceTrace() if self.trace and self.device.type == "cuda" else None

    # ------------------------------------------------------------------ #
    def kb(self) -> KB:
        """The configuration's KB and program, generated from the seed by
        the generator its ``kb.generator`` names."""
        return self.spec.generator.generate(
            self.config["kb"], self.seed, (self.spec.root / self.config["program"]).read_text())

    def log(self, what: str) -> None:
        """One line on standard error: ``what``, at seconds since start."""
        t = (time.perf_counter_ns() - self.t_start_ns) / 1e9
        print(f"[{t:9.3f} s] {what}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    def open_window(self) -> int:
        """Start the measured window; returns its start (``perf_counter_ns``)."""
        import torch
        from repro_torch.kernels import ops
        from repro_torch.obs import get_tracer

        self.sync()
        gc.collect()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        ops.reset_launch_counts()
        if self.trace:
            tracer = get_tracer()
            tracer.reset()
            tracer.enable()
            if self._dev is not None:
                self._dev.start()
                self._syncs.start()
        self._t0 = time.perf_counter_ns()
        self.setup_s = (self._t0 - self.t_start_ns) / 1e9
        return self._t0

    def close_window(self, end_ns: int | None = None, **counters) -> Record:
        """End the window at ``end_ns`` (default: now, once the device is
        done) and keep what it recorded; ``counters`` are the driver's."""
        import torch
        from repro_torch.kernels import ops
        from repro_torch.obs import get_tracer

        self.sync()
        t1 = time.perf_counter_ns() if end_ns is None else end_ns
        if self.device.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            self.peak_bytes = max(self.peak_bytes, self.window_peak_bytes)
        syncs = None
        spans = [s for s in self.spans.spans if self._t0 <= s.start_ns < t1]
        if self.trace:
            if self._dev is not None:
                self._syncs.stop()
                syncs = self._syncs.count
                self._dev.stop()
            tracer = get_tracer()
            tracer.disable()
            spans += [Span(f"{r.name}", r.start_ns, r.dur_ns, r.depth, r.tid)
                      for r in tracer.sorted_events() if self._t0 <= r.start_ns < t1]
            tracer.reset()
        self.record = Record(
            t0_ns=self._t0,
            t1_ns=t1,
            spans=spans,
            launches=ops.launch_counts(),
            launch_shapes={k: ops.launch_shapes(k) for k in ops.KERNELS},
            tuning=ops.tuning_counts(),
            syncs=syncs,
            device_events=self._dev.events if self._dev is not None else [],
            counters=counters,
        )
        return self.record
