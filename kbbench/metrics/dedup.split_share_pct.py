"""Percent of dedup's time spent splitting survivors: the program's
``dedup.split`` spans (survivor counts, ``split_survivors`` and the new
meta-facts) over its ``cmat.dedup`` spans."""

from kbbench.spanshare import share_pct


def read(record):
    return share_pct(record, "dedup.split", "cmat.dedup")
