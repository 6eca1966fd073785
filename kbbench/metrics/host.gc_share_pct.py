"""Percent of the jobs' time spent in Python's garbage collector: the
program's ``host.gc`` spans inside the harness's ``job`` spans, over the
``job`` spans' time.  The full collection the harness forces in
``job.free`` falls outside ``job`` and is not counted; 0.0 where no
collection fell in a job."""

from kbbench.spanshare import share_pct


def read(record):
    return share_pct(record, "host.gc", "job")
