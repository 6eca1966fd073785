"""Dry-run the distributed datalog round on production-scale shard counts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_datalog

Materialises the reference dry run's program and KB (``lubm_like(8,
200, 32)``, the rules of at most two body atoms) with the port's
hash-partitioned engine at 256 and 512 logical shards, on the CPU, under
:func:`~repro_torch.roofline.op_cost.count_ops`, and records the cost of
a reasoning round as a cluster workload: the facts must equal the
one-shard run's.  One process runs every shard, so what one device would
do is the whole count over the shards; the exchange, a host-side copy
here, is counted as the all-to-all the reference issues (the rows each
destination receives from the other shards, padding included).

Each record holds ``n_shards``, ``capacity``, ``n_rules``, ``wall_s``,
``flops_per_device`` (the engine runs no floating-point products: 0),
the run's ``rounds``, ``facts``, ``exchanges`` and ``exchanges_skipped``,
and, for the largest round (by bytes moved) and for the whole
materialise, ``hbm_bytes_per_device`` (the op bytes counted over all
shards, over ``n_shards``), ``collective_bytes_per_device`` (the largest
destination's received rows) and ``temp_bytes`` (the largest shard's
state buffers).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..core.distributed import DistributedEngine
from ..core.generators import lubm_like
from ..roofline.op_cost import count_ops

__all__ = ["round_cost", "main"]

_INT32 = 4


def _program_and_kb():
    program, dataset, _ = lubm_like(n_dept=8, n_students=200, n_courses=32)
    rules = [r for r in program if len(r.body) <= 2]
    return type(program)(rules), dataset


def _facts_equal(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(torch.equal(got[p], want[p]) for p in want)


def _state_bytes(eng) -> int:
    """The largest shard's state buffers (every predicate's rows)."""
    per_shard = [0] * eng.n_shards
    for rows, _cnt, _lo in eng._state.values():
        for s, r in enumerate(rows):
            per_shard[s] += r.numel() * r.element_size()
    return max(per_shard)


def round_cost(n_shards: int, capacity: int = 1 << 12) -> dict:
    """Materialise the dry run's KB at ``n_shards`` logical shards on the
    CPU under :func:`count_ops`; the record (see the module docstring).
    Raises if the facts differ from the one-shard run's."""
    program, dataset = _program_and_kb()
    one = DistributedEngine(program, device="cpu", capacity=capacity)
    one.materialise(dataset)
    want = one.to_dict()

    eng = DistributedEngine(program, device="cpu", capacity=capacity, n_shards=n_shards)
    rounds: list[dict] = []
    received = [0] * n_shards
    deliver, mat_round = eng._deliver, eng._mat_round

    def counted_deliver(sent):
        # destination d receives bucket d of every other source
        for d in range(n_shards):
            received[d] += sum(b[d].numel() * _INT32 for s, b in enumerate(sent) if s != d)
        return deliver(sent)

    def counted_round(pairs):
        before = list(received)
        out, cost = count_ops(mat_round, pairs)
        rounds.append({
            "hbm_bytes_per_device": cost.hbm_bytes / n_shards,
            "collective_bytes_per_device": {
                "all-to-all": float(max(a - b for a, b in zip(received, before)))},
            "temp_bytes": _state_bytes(eng),
        })
        return out

    eng._deliver, eng._mat_round = counted_deliver, counted_round
    t0 = time.time()
    _, cost = count_ops(eng.materialise, {p: torch.as_tensor(np.asarray(r))
                                          for p, r in dataset.items()})
    wall = time.time() - t0
    got = eng.to_dict()
    if not _facts_equal(got, want):
        raise AssertionError(f"{n_shards} shards: the facts differ from the one-shard run's")
    largest = max(rounds, key=lambda r: r["hbm_bytes_per_device"])
    return {
        "n_shards": n_shards,
        "capacity": capacity,
        "n_rules": len(program.rules),
        "wall_s": round(wall, 1),
        "flops_per_device": cost.flops / n_shards,
        "rounds": eng.stats.rounds,
        "facts": sum(int(r.shape[0]) for r in got.values()),
        "exchanges": eng.stats.exchanges,
        "exchanges_skipped": eng.stats.exchanges_skipped,
        "round": {"index": rounds.index(largest) + 1, **largest},
        "materialise": {
            "hbm_bytes_per_device": cost.hbm_bytes / n_shards,
            "collective_bytes_per_device": {"all-to-all": float(max(received))},
            "temp_bytes": max(r["temp_bytes"] for r in rounds),
        },
    }


def main():
    out_dir = "experiments/dryrun_datalog"
    os.makedirs(out_dir, exist_ok=True)
    for shards in (256, 512):
        rec = round_cost(shards)
        path = os.path.join(out_dir, f"round_{shards}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        colls = rec["round"]["collective_bytes_per_device"]
        print(
            f"[OK] datalog round @ {shards} shards: wall {rec['wall_s']}s, "
            f"collective/dev {sum(colls.values()):.2e} B "
            f"({', '.join(f'{k}={v:.1e}' for k, v in colls.items())})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
