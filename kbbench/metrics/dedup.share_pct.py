"""Percent of the materialisations' host time spent in dedup: the self
time of the program's ``cmat.dedup`` spans over the time of its
``cmat.materialise`` spans, both on the host clock (device waits are
charged to the span that synchronises)."""


def read(record):
    spans = [s for s in record.spans if s.name.startswith("cmat.")]
    total = sum(s.dur_ns for s in spans if s.name == "cmat.materialise")
    if not total:
        return None
    dedup = 0
    for d in (s for s in spans if s.name == "cmat.dedup"):
        inner = sum(c.dur_ns for c in spans
                    if c.tid == d.tid and c.depth == d.depth + 1
                    and d.start_ns <= c.start_ns and c.end_ns <= d.end_ns)
        dedup += d.dur_ns - inner
    return 100.0 * dedup / total
