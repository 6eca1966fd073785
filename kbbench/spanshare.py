"""Shares of the program's spans, for the per-layer metrics' readers."""

from __future__ import annotations

from bisect import bisect_right

__all__ = ["share_pct"]


def share_pct(record, inner: str, outer: str) -> float | None:
    """Percent of the time of the ``outer`` spans spent in ``inner`` spans
    that lie inside one of them (same thread, contained in time); None
    where the record holds no ``inner`` span or no ``outer`` span, as from
    a program that has no such span."""
    outers: dict[int, list] = {}
    for s in sorted(record.spans, key=lambda s: s.start_ns):
        if s.name == outer:
            outers.setdefault(s.tid, []).append(s)
    inners = [s for s in record.spans if s.name == inner]
    total = sum(s.dur_ns for ss in outers.values() for s in ss)
    if not inners or not total:
        return None
    starts = {tid: [s.start_ns for s in ss] for tid, ss in outers.items()}
    inside = 0
    for s in inners:
        k = bisect_right(starts.get(s.tid, []), s.start_ns) - 1
        if k >= 0 and s.end_ns <= outers[s.tid][k].end_ns:
            inside += s.dur_ns
    return 100.0 * inside / total
