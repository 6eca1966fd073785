"""Run one cell of the benchmark once.

    python3 -m kbbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell, its configuration, traffic mix and metrics come from
``BENCHMARK.json`` and the files under ``kbbench/`` it names; the system
under test is the PyTorch/CUDA port ``repro_torch``, reached through the
checkout's ``src/``.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
traced window, with the device's busy time and a breakdown.

The last line of standard output is the result, one JSON object; the
numbers compared to decide ``correct`` are the last lines of standard
error, and the result's last key.  Without a card (or with fewer than the
cell's), or with the JAX package loaded once the window has closed, the
run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from .spec import HERE, Spec, load_driver, load_reader  # noqa: E402

#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: where the program's caches go, inside the checkout, at fixed paths
CACHE = HERE / ".cache"


def _process_start_ns() -> int:
    """The process's start on the ``perf_counter_ns`` clock (the kernel's
    record of it, to its tick), or this module's import where unreadable."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return min(T_START_NS, time.perf_counter_ns() - int(age * 1e9))
    except (OSError, ValueError, IndexError):
        return T_START_NS


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _set_caches() -> None:
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(CACHE / "cuda_tune.json")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def measure(argv, *, device: str = "cuda", root: Path | None = None,
            t_start_ns: int | None = None, config: dict | None = None):
    """Run the cell: ``(ctx, outcome)``.  ``device``, ``root`` (a checkout
    whose ``BENCHMARK.json`` names the cell) and ``config`` (a
    configuration in place of the cell's own) serve the CPU tests."""
    args = _parser().parse_args(argv)
    root = HERE.parent if root is None else root
    spec = Spec.load(root, args.workload)
    if config is not None:
        spec = spec.with_config(config)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from .harness import Context

    ctx = Context(spec, args.seed, args.seconds, bool(args.trace), device,
                  _process_start_ns() if t_start_ns is None else t_start_ns)
    outcome = load_driver(spec.traffic["kind"]).run(ctx)
    return ctx, outcome


def result(ctx, outcome) -> dict:
    """The result line's object."""
    import torch

    units = {m["name"]: m["unit"] for m in ctx.spec.end_to_end + ctx.spec.per_layer}
    if ctx.trace:
        values = {m["name"]: load_reader(m["name"])(ctx.record) for m in ctx.spec.per_layer}
    else:
        e2e = dict(outcome.end_to_end, setup_s=ctx.setup_s,
                   peak_device_gib=ctx.window_peak_bytes / 2**30)
        values = {m["name"]: e2e.get(m["name"]) for m in ctx.spec.end_to_end}
    metrics = {k: {"value": float(v), "unit": units[k]} for k, v in values.items() if v is not None}
    cuda = ctx.device.type == "cuda"
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
        "count": int(ctx.spec.cell["chips"]),
        "memory_peak_bytes": int(ctx.peak_bytes),
    }
    rec = ctx.record
    out = {
        "correct": all(v <= lim for v, lim in outcome.checks.values()) and not outcome.failed,
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": dev,
    }
    if ctx.trace and rec.device_events:
        from .trace import breakdown

        dev["busy_s"] = rec.busy_s
        dev["window_s"] = rec.window_s
        out["breakdown"] = breakdown(rec.device_events, rec.spans, rec.t0_ns, rec.t1_ns)
    checks = dict(outcome.checks, failed=(outcome.failed, 0))
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def run_cell(argv, *, device: str = "cuda", root: Path | None = None,
             config: dict | None = None, t_start_ns: int | None = None) -> int:
    """Run the cell and print its result (0), or print no result where the
    JAX package was loaded in the run (3)."""
    ctx, outcome = measure(argv, device=device, root=root, config=config,
                           t_start_ns=t_start_ns)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)} (JAX or the JAX package)", file=sys.stderr)
        return 3
    out = result(ctx, outcome)
    rec = ctx.record
    print(f"tuner sweeps in the window: {int(rec.tuning['sweeps'])} "
          f"({int(rec.tuning['launches'])} launches, {rec.tuning['seconds']:.6f} s)", flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    t_start_ns = _process_start_ns()
    _set_caches()
    import torch

    args = _parser().parse_args(argv)
    spec = Spec.load(HERE.parent, args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{spec.name} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    print(f"card: {_power_limit()}; cores {sorted(os.sched_getaffinity(0))}, "
          f"intra-op threads {torch.get_num_threads()}", flush=True)
    return run_cell(argv, t_start_ns=t_start_ns)


if __name__ == "__main__":
    sys.exit(main())
