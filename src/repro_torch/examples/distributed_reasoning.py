"""Distributed datalog materialisation, one shard per visible device.

    python -m repro_torch.examples.distributed_reasoning [--device cpu]

Runs the hash-partitioned semi-naive engine with one shard on each
visible device of the chosen type (every card, or the one CPU) and
checks the result against the flat oracle, predicate by predicate.
"""

from __future__ import annotations

import argparse

from ..core import flat_seminaive
from ..core.distributed import DistributedEngine, visible_devices
from ..core.generators import lubm_like
from ..core.util import resolve_device


def main(argv=None) -> DistributedEngine:
    """Run the example; returns the materialised engine."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    program, dataset, _ = lubm_like(n_dept=8, n_students=120, n_courses=16)
    program = DistributedEngine.supported_program(program)

    devices = visible_devices(device)
    print(f"{len(devices)} shard(s), one on each of {[str(d) for d in devices]}")

    eng = DistributedEngine(program, devices=devices, capacity=1 << 13)
    result = eng.materialise(dataset)
    st = eng.stats
    print(f"fixpoint after {eng.rounds} rounds; {st.exchanges} exchanges "
          f"({st.exchanges_skipped} elided by planner keys, "
          f"{st.exchange_regrows} regrows)")

    expected = flat_seminaive(program, dataset, device=device)
    for pred, rows in sorted(expected.items()):
        got = result[pred]
        ok = set(map(tuple, got.tolist())) == set(map(tuple, rows.cpu().tolist()))
        print(f"    {pred:<20} {got.shape[0]:6d} facts  "
              f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{pred}: distributed result != flat oracle")
    print("distributed result == flat oracle")
    return eng


if __name__ == "__main__":
    main()
