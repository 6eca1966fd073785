"""What the host did around a stretch of work, for the log lines that tell
a slow job's cause: the process's CPU time and the collector's runs over a
job, and the machine's age.

On the card's machine ``/proc``'s counters of steal, iowait, run delay and
page faults all read 0, so a slow job shows only as more CPU time for the
same collections.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

__all__ = ["Snapshot", "snapshot", "uptime_s"]


def uptime_s() -> float:
    """Seconds since the machine booted (0 where unreadable)."""
    try:
        with open("/proc/uptime") as fh:
            return float(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass(frozen=True)
class Snapshot:
    wall_ns: int
    cpu_s: float
    collections: int

    def since(self, before: "Snapshot") -> str:
        """This snapshot less ``before``, as one line's fields."""
        return (f"host cpu {self.cpu_s - before.cpu_s:.3f} s; "
                f"collections {self.collections - before.collections}")


def snapshot() -> Snapshot:
    return Snapshot(
        wall_ns=time.perf_counter_ns(),
        cpu_s=time.process_time(),
        collections=sum(s["collections"] for s in gc.get_stats()),
    )
