#!/usr/bin/env python3
"""Time one checkout's kernels on the inputs that ``chip_smoke.py`` times.

    python3 tools/kernel_designs.py --smoke-log FILE [--tree DIR]

Imports the package ``repro_torch`` from ``DIR/src`` (default: this
checkout), with its own wrappers, sources and build, and for every case
that the kernel line of ``FILE`` (a saved standard output of
``chip_smoke.py``) timed for :data:`KERNELS`, makes the same seeded inputs
with this checkout's ``chip_smoke.py`` builders and calls the tree's
wrapper as the main path does.  One JSON line per case: the event-timed
median of five :func:`chip_smoke.cuda_ms` runs, the device-only time from
``torch.profiler``, and a digest of the outputs (the join's host total
included); then the card's name and power limit.

Two designs are compared in one call on one card by running this for each
tree in turns (earlier, this, this, earlier): equal digests say that their
outputs agree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("sorted_member", "join_bounds", "merge_sorted_unique", "fused_join_dedup")


def timed_cases(smoke_log: Path):
    """``(kernel, label, dtype name, shape)`` of every case the kernel line
    of a ``chip_smoke.py`` output timed for :data:`KERNELS`."""
    line = next(ln for ln in smoke_log.read_text().splitlines() if ln.startswith('{"kernels"'))
    for k in json.loads(line)["kernels"]:
        if k["name"] in KERNELS:
            for t in k["timings"]:
                yield k["name"], t["case"], t["dtype"], t["shape"]


def digest(outputs) -> str:
    """A digest of a call's outputs: tensors by their bytes, host values
    (the join's pair total) by their text."""
    h = hashlib.sha256()
    for x in outputs:
        h.update(x.cpu().numpy().tobytes() if hasattr(x, "cpu") else repr(x).encode())
    return h.hexdigest()[:16]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--smoke-log", type=Path, required=True,
                        help="saved standard output of chip_smoke.py")
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="checkout whose repro_torch is timed (default: this one)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_designs: no CUDA device; nothing run", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch
    from repro_torch import kernels
    from repro_torch.kernels import build, ops

    if not Path(repro_torch.__file__).is_relative_to(tree):
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}, not {tree}")
    build.build()
    dev = torch.device("cuda")
    for name, label, dtype_name, shape in timed_cases(args.smoke_log):
        dtype = getattr(torch, dtype_name)
        rng = np.random.default_rng([ops.KERNELS.index(name), dtype.itemsize, 2])
        case = cs._timed_args(name, label, shape, dtype, dev, rng)
        call = cs.main_path_call(name, getattr(kernels, name), case)
        print(json.dumps({
            "tree": str(args.tree), "kernel": name, "case": label, "dtype": dtype_name,
            "shape": shape, "digest": digest(cs._as_list(call())),
            "ms": statistics.median(cs.cuda_ms(call) for _ in range(5)),
            "device_ms": cs.device_ms(call)[0],
        }), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
