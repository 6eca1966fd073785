"""The readers of the program's span shares, on records built by hand:
``host.gc_share_pct``, ``repr.compress_share_pct`` and
``dedup.split_share_pct``."""

from __future__ import annotations

import pytest

from kbbench.harness import Record
from kbbench.spec import load_reader
from kbbench.trace import Span

MS = 1_000_000
MAIN, OTHER = 1, 2


def _record(*spans: Span) -> Record:
    return Record(t0_ns=0, t1_ns=1000 * MS, spans=list(spans), launches={},
                  launch_shapes={}, tuning={})


def _span(name, start_ms, dur_ms, depth=0, tid=MAIN) -> Span:
    return Span(name, start_ms * MS, dur_ms * MS, depth, tid)


JOBS = (_span("job.free", 0, 10), _span("job", 10, 100), _span("job", 120, 100))


def test_gc_share_counts_collections_inside_jobs_only():
    rec = _record(
        *JOBS,
        _span("host.gc", 2, 5),  # job.free's forced collection: outside any job
        _span("host.gc", 20, 10, depth=2),
        _span("host.gc", 150, 30, depth=3),
        _span("host.gc", 215, 10),  # runs past the job's end
        _span("host.gc", 50, 40, tid=OTHER),  # another thread
    )
    assert load_reader("host.gc_share_pct")(rec) == pytest.approx(100.0 * 40 / 200)


def test_gc_share_is_zero_where_no_collection_fell_in_a_job():
    rec = _record(*JOBS, _span("host.gc", 2, 5))
    assert load_reader("host.gc_share_pct")(rec) == 0.0


@pytest.mark.parametrize("metric", ["host.gc_share_pct", "repr.compress_share_pct",
                                    "dedup.split_share_pct"])
def test_a_program_without_the_span_reads_nothing(metric):
    # the spans a program without this instrumentation records
    rec = _record(*JOBS, _span("job.load", 10, 60, 1), _span("cmat.dedup", 80, 20, 2))
    assert load_reader(metric)(rec) is None
    assert load_reader(metric)(_record()) is None


def test_compress_share_counts_compress_rows_inside_jobs():
    rec = _record(
        *JOBS,
        _span("cmat.load", 12, 50),
        _span("compress.rows", 15, 20, 1),
        _span("compress.sort", 15, 5, 2),  # a child: not counted again
        _span("compress.rows", 130, 30, 3),
        _span("compress.rows", 300, 30),  # outside the jobs
    )
    assert load_reader("repr.compress_share_pct")(rec) == pytest.approx(100.0 * 50 / 200)


def test_split_share_is_dedup_split_over_dedup():
    rec = _record(
        _span("cmat.dedup", 0, 40, 2),
        _span("dedup.unfold", 1, 5, 3),
        _span("dedup.split", 6, 10, 3),
        _span("host.gc", 8, 2, 4),
        _span("dedup.split", 20, 6, 3),
        _span("cmat.dedup", 100, 10, 2),
        _span("dedup.split", 101, 4, 3),
    )
    assert load_reader("dedup.split_share_pct")(rec) == pytest.approx(100.0 * 20 / 50)
