"""The five hand kernels' share of their bytes-bound roofline over the
window (``kbbench/roofline/share.py``)."""

from kbbench.roofline.share import kernels_share


def read(record):
    return kernels_share(record)
