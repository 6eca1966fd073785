"""The hand kernels' share of their bytes-bound roofline over a window.

Every launch the program's meter counted in the window gets its
bytes-bound time: the bytes it needs (:mod:`.bytes_model`) over the HBM
peak of ``peaks.json``.  The device time is that of every operation in
the profiler's trace whose name carries one of the kernel's CUDA symbols
(``symbols.json``).  The share is the sum of the first over the sum of
the second, over the kernels that both launched and ran in the window.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from .bytes_model import launch_bytes

__all__ = ["kernels_share", "peaks"]

_HERE = Path(__file__).resolve().parent
_KEY_TYPES = {"long": 8, "long long": 8, "int": 4, "unsigned int": 4}


def peaks() -> dict:
    return json.loads((_HERE / "peaks.json").read_text())


def _symbols() -> dict:
    return json.loads((_HERE / "symbols.json").read_text())["kernels"]


def _match(name: str, symbols: list[str]) -> str | None:
    """The key type in the template of the symbol ``name`` carries
    (``""`` where it carries none), or None where it carries no symbol."""
    for sym in symbols:
        m = re.search(rf"(?<![A-Za-z0-9_]){re.escape(sym)}(?:<([^<>]*)>)?(?=\(|$|<)", name)
        if m:
            return m.group(1) or ""
    return None


def kernels_share(record) -> float | None:
    """Percent of the bytes-bound time over the kernels' device time, or
    None where no kernel both launched and ran on the device."""
    if not record.device_events:
        return None
    bw = float(peaks()["hbm_bytes_per_s"])
    bound_s = device_s = 0.0
    for kernel, spec in _symbols().items():
        launches = record.launch_shapes.get(kernel) or []
        dev_ns, widths = 0, set()
        for name, _, dur in record.device_events:
            arg = _match(name, spec["symbols"])
            if arg is None:
                continue
            dev_ns += dur
            widths.add(_KEY_TYPES.get(arg, spec["key_bytes"]) if arg else spec["key_bytes"])
        if not launches or not dev_ns:
            continue
        if len(widths) != 1:
            return None  # launches of two key widths: the meter cannot tell them apart
        key = widths.pop()
        bound_s += sum(n * sum(launch_bytes(kernel, shape, key)) for shape, n in launches) / bw
        device_s += dev_ns / 1e9
    return 100.0 * bound_s / device_s if device_s else None
