"""Percent of the jobs' time spent compressing rows into meta-facts: the
program's ``compress.rows`` spans (in the load, in dedup and in the
re-compression of singletons) inside the harness's ``job`` spans, over
the ``job`` spans' time."""

from kbbench.spanshare import share_pct


def read(record):
    return share_pct(record, "compress.rows", "job")
