#!/usr/bin/env python3
"""Trace the distributed engine's full-size materialise and 1 % delete on the card.

    python3 tools/trace_distributed.py

Builds the kernels, then runs ``chip_smoke.py``'s phase 7
(:func:`chip_smoke.run_full_distributed`: ``lubm_like(500, 30_000,
1_000)`` at ``capacity`` 2**18 a shard, the stats against the JAX
reference's, the facts against the flat oracle after the materialise, a
1 % delete and its re-add) at 1 shard and at 4 shards on the first card
and, where four or more cards are visible, at one shard on each of the
first four.  For each of these it then

* traces a fresh engine's materialise and the same delete under
  ``torch.profiler`` (:func:`chip_smoke._profile_call`: the wall, the
  device-busy time and its share, the launches, the top device and host
  operators, the hand kernels' device time);
* counts, in a run of its own, the exchanges of the materialise and of
  the delete, the rows they delivered to the destinations, and the valid
  rows among them (what is left is the buckets' padding).

Prints the card's name and power limit last.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def exchange_rows(eng, call) -> dict:
    """Run ``call()`` with ``eng``'s exchange counted: calls, rows
    delivered to the destinations, valid rows among them."""
    counts = {"exchanges": 0, "delivered": 0, "valid": 0}
    inner = eng._exchange

    def counted(side, length, factor, col=0):
        out, dropped = inner(side, length, factor, col)
        counts["exchanges"] += 1
        for rows, valid in out:
            counts["delivered"] += int(rows.shape[0])
            counts["valid"] += int(valid.sum())
        return out, dropped

    eng._exchange = counted
    try:
        call()
    finally:
        del eng._exchange
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_distributed: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.generators import lubm_like
    from repro_torch.kernels import build

    cs.log(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
           f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build()
    program, dataset, _ = lubm_like(**cs.DIST_KB)
    program = DistributedEngine.supported_program(program)

    configs = [("1 shard", 1, None), ("4 shards, one card", 4, None)]
    if torch.cuda.device_count() >= 4:
        configs.append(("4 shards, four cards", 4,
                        [torch.device("cuda", i) for i in range(4)]))
    oracles = None
    for label, n_shards, devices in configs:
        res = cs.run_full_distributed(n_shards, oracles, devices)
        oracles = res["oracles"]
        dels = oracles["dels"]

        def engine():
            return DistributedEngine(program, capacity=cs.DIST_CAPACITY,
                                     join_capacity=cs.DIST_CAPACITY,
                                     n_shards=n_shards, devices=devices)

        def synced(eng, call):
            def run():
                call()
                for d in eng.devices:
                    torch.cuda.synchronize(d)
            return run

        eng = engine()
        cs._profile_call(f"{label} materialise",
                         synced(eng, lambda: eng.materialise(dataset)))
        cs._profile_call(f"{label} delete",
                         synced(eng, lambda: eng.apply(deletions=dels)))
        eng = engine()
        for phase, call in (("materialise", lambda: eng.materialise(dataset)),
                            ("delete", lambda: eng.apply(deletions=dels))):
            c = exchange_rows(eng, call)
            share = c["valid"] / c["delivered"] if c["delivered"] else float("nan")
            cs.log(f"[exchange] {label} {phase}: {c['exchanges']} exchanges delivered "
                   f"{c['delivered']} rows, {c['valid']} valid (share {share:.4f})")
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
