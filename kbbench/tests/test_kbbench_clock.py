"""The program's spans and the device's operations share one clock, as
``DeviceTrace`` moves the profiler's events onto ``perf_counter_ns``.

Inside one profiler session, each try launches a sleep kernel inside a
span and polls the stream until the host sees it complete, stamping the
clock before each poll.  On the shared clock the kernel must lie inside
its span and after its launch call began (``EDGE_NS`` of slack), and its
end must lie within ``EDGE_NS`` of the poll that first saw the stream
done.  A kernel ends before that poll returns and after the stamp of the
last poll that found it running (less the few microseconds the device
takes to signal completion), so a try whose two stamps lie within
``POLL_NS`` bounds an error of ``DeviceTrace``'s mapping to about
``EDGE_NS`` either way.
The kernel's start follows its launch by the launch latency, a host
cost, and is printed, not bounded.  On the card only.

On an H100 most profiler sessions map a kernel's end 2-17 us before the
host sees it done, and the test passes; about one session in three maps
every kernel 100-330 us early, sometimes drifting by tens of microseconds
a millisecond, while the profiler's host-side launch events stay within
a few microseconds of ``perf_counter_ns``.  The test fails in such a
session: the profiler's device timestamps are off there, and
``DeviceTrace`` takes them as they come."""

from __future__ import annotations

import time

import pytest

#: how far a kernel's edge may lie from the host stamp that bounds it (ns)
EDGE_NS = 50_000
#: the sleep kernel's length in clock cycles: about 1.5 ms on an H100
CYCLES = 3_000_000
#: polls this close bound a kernel's end (ns); a try polled more loosely
#: (the host was held) bounds only containment
POLL_NS = 20_000
#: tries in the session; every one polled closely must meet ``EDGE_NS``
TRIES = 5


def _session(torch):
    """``(tracer's spans, device events, [(launched, last_running, seen)])``."""
    from kbbench.trace import DeviceTrace
    from repro_torch.obs import Tracer

    stream = torch.cuda.current_stream()
    tracer = Tracer(enabled=True)
    dev = DeviceTrace()
    stamps = []
    dev.start()
    try:
        # a session's first launch holds the host for milliseconds
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(TRIES):
            with tracer.span("clock.device"):
                launched = time.perf_counter_ns()
                torch.cuda._sleep(CYCLES)
                running = None
                while True:
                    before = time.perf_counter_ns()
                    if stream.query():
                        seen = time.perf_counter_ns()
                        break
                    running = before
            stamps.append((launched, running, seen))
        with tracer.span("clock.host"):
            time.sleep(0.002)
    finally:
        dev.stop()
        tracer.disable()
    return tracer.sorted_events(), dev.events, stamps


@pytest.mark.card
def test_device_events_lie_inside_the_program_span_that_awaits_them(cuda_device):
    import torch

    torch.cuda._sleep(1000)  # the context and the kernel, before the trace
    torch.cuda.synchronize()
    spans, events, stamps = _session(torch)
    kernels = [e for e in events if e[2] > 1_000_000]
    assert len(kernels) == TRIES, events
    tries = [r for r in spans if r.name == "clock.device"]
    close, outside = [], []
    for span, (name, k0, dur), (launched, running, seen) in zip(tries, kernels, stamps):
        k1 = k0 + dur
        s0, s1 = span.start_ns, span.start_ns + span.dur_ns
        print(f"\nclock skew: kernel {name} {dur / 1e6:.6f} ms begins "
              f"{(k0 - launched) / 1e3:.3f} us after its launch, "
              f"{(k0 - s0) / 1e3:.3f} us after its span; ends "
              f"{(seen - k1) / 1e3:.3f} us before the host saw it done, "
              + (f"{(k1 - running) / 1e3:.3f} us after the last poll that found it "
                 f"running; " if running is not None else "")
              + f"{(s1 - k1) / 1e3:.3f} us before its span ends")
        if not (k0 >= max(s0, launched) - EDGE_NS and k1 <= min(s1, seen) + EDGE_NS):
            outside.append((k0 - s0, k0 - launched, s1 - k1, seen - k1))
        if running is not None and seen - running <= POLL_NS:
            close.append(seen - k1)
    assert not outside, outside
    assert close, "no try polled the stream closely: the host was held throughout"
    assert max(close) <= EDGE_NS, close
    (host,) = [r for r in spans if r.name == "clock.host"]
    h0, h1 = host.start_ns, host.start_ns + host.dur_ns
    inside = [e for e in events if e[1] < h1 and e[1] + e[2] > h0]
    assert not inside, inside
