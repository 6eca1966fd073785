"""Multi-pod dry run: trace every (arch x shape x mesh) cell and count it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--sp] [--microbatches N]
        [--remat full|dots] [--strategy fsdp_tp|pure_fsdp|fsdp_ep] [--out DIR]

Each cell runs under a fake process group of 256 or 512 ranks
(``make_production_mesh``) in which this one process plays rank 0: the
state, the batch and the caches are ``meta``-device DTensors placed by
the sharding rules (:mod:`.sharding`), and the cell's step runs once
under :func:`~repro_torch.roofline.op_cost.count_ops`.  Nothing is
allocated, no card is touched and no value is computed; the group is
destroyed when the cell ends.  This is the twin of the reference's 512
forced host devices, not a CPU fallback.

The record keeps the reference's keys where they mean the same thing:
``status`` (OK/SKIP/FAIL), ``reason`` / ``error``, ``n_devices``, and per
device ``flops_per_device``, ``hbm_bytes_per_device`` (every op's result
written and every argument read once: eager PyTorch does not fuse),
``collective_bytes_per_device`` by kind, ``collective_total_per_device``
and ``memory``: ``argument_bytes`` (the local shards of the step's
arguments), ``output_bytes`` (the local bytes it returns) and
``temp_bytes`` (the peak of live intermediate bytes).  ``trace_s``, the
wall of placing and counting the cell, stands in for ``compile_s``.  The
reference's ``xla_*_body_once`` and ``loop_trip_counts`` have no twin:
they describe XLA's loop bodies, and the port runs its loops in Python,
so every iteration is dispatched and counted
(:mod:`repro_torch.roofline.op_cost`).

:func:`repro_torch.roofline.analysis.full_table` reads the records.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import SHAPES, get_config, list_configs
from ..models import transformer
from ..models.model import input_specs
from ..models.sharding_policy import axis_sizes, clear_policy, set_policy_from_mesh
from ..optim import adamw_init
from ..roofline.op_cost import count_ops
from ..train import TrainConfig, make_prefill_step, make_serve_step, make_train_step
from ..train import reshard_state
from .mesh import make_production_mesh
from .sharding import (
    NamedSharding,
    batch_shardings,
    cache_shardings,
    named_leaves,
    param_shardings,
)

__all__ = ["argument_bytes", "cell_skipped", "fake_group", "lower_cell", "main", "trace_cell"]


#: cells skipped per DESIGN.md §Arch-applicability: long_500k requires a
#: sub-quadratic architecture (SSM / hybrid).
def cell_skipped(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k skipped: pure full-attention arch (DESIGN.md)"
    return None


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of ``world_size`` ranks that communicates
    nothing, this process rank 0 (``torch``'s fake backend); destroyed
    on exit.  Raises if a process group is already running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the dry run starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# the cell's arguments: layouts, placement, per-device bytes
# --------------------------------------------------------------------- #
def _shard_shape(shape, sharding: NamedSharding) -> tuple[int, ...]:
    """The local shape of a tensor of ``shape`` under ``sharding`` (its
    mesh a ``DeviceMesh`` or an ``AbstractMesh``)."""
    sizes = axis_sizes(sharding.mesh)
    out = []
    for dim, axis in zip(shape, sharding.spec):
        axes = () if axis is None else axis if isinstance(axis, tuple) else (axis,)
        out.append(dim // math.prod(sizes[a] for a in axes))
    return (*out, *shape[len(sharding.spec):])


def _state_shardings(strategy: str):
    """The train state's layout as the reference's dry run gives it: the
    parameters and both moments by ``param_shardings(strategy=...)``, the
    step replicated."""
    def shardings(state, mesh):
        return {
            "params": param_shardings(state["params"], mesh, strategy=strategy),
            "opt": {"mu": param_shardings(state["opt"]["mu"], mesh, strategy=strategy),
                    "nu": param_shardings(state["opt"]["nu"], mesh, strategy=strategy),
                    "step": NamedSharding(mesh, ())},
        }
    return shardings


def _arguments(cfg, shape, mesh, strategy: str) -> tuple[dict, dict]:
    """The step's meta arguments and their layouts on ``mesh``, as two
    trees of one structure (``None`` where an argument is not a tensor
    or has no layout of its own)."""
    params = transformer.Transformer(cfg, "meta")
    p_sh = param_shardings(params, mesh, strategy=strategy)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        state = {"params": params, "opt": adamw_init(dict(params.named_parameters()))}
        return ({"state": state, "batch": specs},
                {"state": _state_shardings(strategy)(state, mesh),
                 "batch": batch_shardings(specs, mesh)})
    if shape.kind == "prefill":
        return ({"params": params, "batch": specs},
                {"params": p_sh, "batch": batch_shardings(specs, mesh)})
    args = {"params": params, "token": specs["token"], "cache": specs["cache"]}
    sh = {"params": p_sh, "token": batch_shardings({"t": specs["token"]}, mesh)["t"],
          "cache": cache_shardings(specs["cache"], mesh, shape.global_batch)}
    if cfg.family == "encdec":
        args["memory"] = specs["memory"]
        sh["memory"] = batch_shardings({"m": specs["memory"]}, mesh)["m"]
    return args, sh


def _pairs(args, shardings):
    """(tensor, sharding) of every tensor leaf of ``args``."""
    if isinstance(args, torch.nn.Module):
        leaves = named_leaves(args)
        return [(leaves[k], shardings[k]) for k in leaves]
    if isinstance(args, dict):
        return [p for k in args for p in _pairs(args[k], shardings[k])]
    if isinstance(args, (list, tuple)):
        return [p for a, s in zip(args, shardings) for p in _pairs(a, s)]
    return [] if args is None else [(args, shardings)]


def _shard_bytes(args, shardings) -> int:
    return sum(math.prod(_shard_shape(t.shape, sh)) * t.element_size()
               for t, sh in _pairs(args, shardings))


def argument_bytes(cfg, shape, mesh, strategy: str = "fsdp_tp") -> int:
    """Per-device bytes of the step's arguments on ``mesh`` (a
    ``DeviceMesh`` or an ``AbstractMesh``): the local shards of every
    leaf, from the sharding rules alone."""
    return _shard_bytes(*_arguments(cfg, shape, mesh, strategy))


def _place(args, shardings, mesh):
    """``args`` as DTensors of their layouts (a module's parameters
    replaced in place)."""
    if isinstance(args, torch.nn.Module) or (isinstance(args, dict) and "opt" in args):
        return reshard_state(args, mesh, lambda *_: shardings)
    if isinstance(args, dict):
        return {k: _place(v, shardings[k], mesh) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return [_place(a, s, mesh) for a, s in zip(args, shardings)]
    return None if args is None else shardings.place(args)


# --------------------------------------------------------------------- #
# cells
# --------------------------------------------------------------------- #
def trace_cell(cfg, shape, make_mesh, n_ranks: int, *, mesh: str = "single",
               sequence_parallel: bool = False, microbatches: int = 1,
               remat: str = "full", strategy: str = "fsdp_tp") -> dict:
    """Place and count one cell of model ``cfg`` at ``shape`` on the mesh
    that ``make_mesh()`` builds over a fake group of ``n_ranks``; the
    record (``mesh`` names the layout in it)."""
    t0 = time.time()
    with fake_group(n_ranks):
        dmesh = make_mesh()
        set_policy_from_mesh(dmesh, sequence_parallel=sequence_parallel, strategy=strategy)
        transformer.set_remat_policy(remat)
        try:
            args, shardings = _arguments(cfg, shape, dmesh, strategy)
            want_bytes = _shard_bytes(args, shardings)
            placed = _place(args, shardings, dmesh)
            if shape.kind == "train":
                step = make_train_step(cfg, TrainConfig(microbatches=microbatches))
                call = (step, placed["state"], placed["batch"])
            elif shape.kind == "prefill":
                call = (make_prefill_step(cfg), placed["params"], placed["batch"])
            else:
                # the cache full but for the new token's slot
                call = (make_serve_step(cfg), placed["params"], placed["token"],
                        placed["cache"], shape.seq_len - 1, placed.get("memory"))
            _, cost = count_ops(*call)
        finally:
            clear_policy()
            transformer.set_remat_policy("full")
    if cost.input_bytes != want_bytes:
        raise AssertionError(f"placed arguments hold {cost.input_bytes} B a device, the "
                             f"sharding rules give {want_bytes}")
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh,
        "status": "OK",
        "n_devices": n_ranks,
        "trace_s": round(time.time() - t0, 1),
        "flops_per_device": cost.flops,
        "hbm_bytes_per_device": cost.hbm_bytes,
        "collective_bytes_per_device": dict(cost.collective_bytes),
        "collective_total_per_device": cost.total_collective_bytes,
        "memory": {
            "argument_bytes": cost.input_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": cost.temp_bytes,
        },
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               sequence_parallel: bool = False, microbatches: int = 1,
               remat: str = "full", strategy: str = "fsdp_tp"):
    """Trace and count one production cell; returns the result record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = "multi" if multi_pod else "single"
    skip = cell_skipped(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "SKIP", "reason": skip}
    return trace_cell(cfg, shape, lambda: make_production_mesh(multi_pod=multi_pod),
                      512 if multi_pod else 256, mesh=mesh,
                      sequence_parallel=sequence_parallel, microbatches=microbatches,
                      remat=remat, strategy=strategy)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--sp", action="store_true", help="sequence parallelism")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--strategy", default="fsdp_tp",
                    choices=["fsdp_tp", "pure_fsdp", "fsdp_ep"])
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    print(f"[cached] {tag}: {rec['status']}")
                    results.append(rec)
                    continue
                try:
                    rec = lower_cell(arch, shape, multi,
                                     sequence_parallel=args.sp,
                                     microbatches=args.microbatches,
                                     remat=args.remat,
                                     strategy=args.strategy)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "multi" if multi else "single",
                        "status": "FAIL",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                status = rec["status"]
                extra = (
                    f"trace={rec.get('trace_s')}s"
                    if status == "OK"
                    else rec.get("reason", rec.get("error", ""))[:100]
                )
                print(f"[{status}] {tag}: {extra}", flush=True)
                results.append(rec)

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\ndry-run complete: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
