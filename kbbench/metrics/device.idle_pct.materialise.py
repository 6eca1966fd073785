"""Percent of the traced window in which the device ran no operation: one
minus the union of the profiler's device intervals over the window."""


def read(record):
    busy = record.busy_s
    if busy is None or record.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / record.window_s)
