"""The host readings the jobs driver logs: a job's CPU time and collections,
and the machine's age."""

from __future__ import annotations

import gc

from kbbench.hostload import snapshot, uptime_s


def test_a_snapshot_counts_the_cpu_time_and_collections_between_two_reads():
    before = snapshot()
    sum(i * i for i in range(200_000))
    gc.collect()
    after = snapshot()
    assert after.wall_ns > before.wall_ns
    assert after.cpu_s >= before.cpu_s
    assert after.collections - before.collections >= 1
    line = after.since(before)
    assert line.startswith("host cpu ") and line.endswith(
        f"collections {after.collections - before.collections}")


def test_the_machine_has_an_age():
    assert uptime_s() >= 0
