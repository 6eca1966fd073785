#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

Phases (progress on stdout, any failure raises and exits non-zero):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one ``nvcc`` per source, all in parallel);
2. small   — ``CMatEngine(fused=True)`` on the card against the same engine
             on the CPU, on five small workloads;
3. full    — ``lubm_like(n_dept=500, n_students=1_000_000,
             n_courses=10_000)`` loaded and materialised on the card with
             ``fused=True`` (launch counts zeroed just before, read just
             after: every kernel must have launched), its fact set held
             against the flat oracle on the CPU;
4. kernels — each kernel, in int32 and int64, against its plain PyTorch
             version on the card: seeded inputs at the operand lengths of
             its largest launch in phase 3 (read from the launch meter)
             plus edge cases, exact equality; kernel, plain and
             library-call times at those lengths;
5. syncs   — the same materialisation once more with CUDA's sync debug
             mode on, counting host synchronisations;
6. profile — only with ``--profile``: one more load and materialise under
             ``torch.profiler``, with device-busy time, launch counts and
             the top device and host operators.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line the device JSON object.  Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

N_DEPT, N_STUDENTS, N_COURSES = 500, 1_000_000, 10_000

REPLACES = {
    "sorted_member": "src/repro/kernels/sorted_member.py:55",
    "join_bounds": "src/repro/kernels/join_bounds.py:65",
    "rle_expand": "src/repro/kernels/rle_expand.py:43",
    "merge_sorted_unique": "src/repro/kernels/fused.py:215",
}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, stamped with the seconds since the start."""
    print(f"{time.perf_counter() - _T0:7.1f} s {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def _distinct(rng, n, hi):
    """Exactly ``n`` distinct integers in ``[0, hi)``, in random order."""
    x = np.unique(rng.integers(0, hi, size=n + n // 8 + 16))
    while x.shape[0] < n:
        x = np.unique(np.concatenate([x, rng.integers(0, hi, size=n)]))
    return rng.permutation(x)[:n]


def _cases(name, shape, dtype, dev, rng):
    """``(label, args, timed)`` cases of one kernel: seeded inputs at the
    operand lengths ``shape`` of its largest main-path launch (timed) and
    the edge cases."""
    import torch

    from repro_torch.kernels import ref

    big = ref.sentinel(dtype)
    hi = 2**31 - 2 if dtype == torch.int32 else 2**62

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(dtype=dtype, device=dev)

    def sorted_t(x):
        return t(np.sort(x))

    def pad(x, k):
        return torch.cat([x, torch.full((k,), big, dtype=dtype, device=dev)])

    empty = t(np.zeros(0, dtype=np.int64))
    if name in ("sorted_member", "join_bounds"):
        n, m = shape["n"], shape["m"]
        b = sorted_t(_distinct(rng, m, hi))
        # half the probes hit b, half are random
        a = torch.cat([b[torch.randint(0, m, (n // 2,), device=dev)],
                       t(rng.integers(0, hi, size=n - n // 2))])
        a = a[torch.randperm(n, device=dev)]
        small_b = sorted_t(_distinct(rng, 100, 1000))
        small_a = t(rng.integers(0, 1000, size=300))
        return [
            ("full", (a, b), True),
            ("empty-a", (empty, small_b), False),
            ("empty-b", (small_a, empty), False),
            ("sentinel-padding", (pad(small_a, 64), pad(small_b, 29)), False),
            ("all-sentinel", (pad(empty, 50), pad(empty, 7)), False),
        ]
    if name == "rle_expand":
        r = shape["runs"]
        vals = sorted_t(rng.integers(0, hi, size=r))
        counts = torch.as_tensor(rng.multinomial(shape["total"], [1 / r] * r)).to(dev)
        small_v = t(rng.integers(0, 1000, size=50))
        small_c = torch.as_tensor(rng.integers(0, 5, size=50)).to(dev)
        return [
            ("full", (vals, counts, shape["total"]), True),
            ("zero-runs", (small_v, small_c, int(small_c.sum())), False),
            ("one-run", (small_v[:1], small_c[:1] + 7, int(small_c[0]) + 7), False),
            ("empty", (empty, empty.to(torch.int64), 0), False),
        ]
    # merge_sorted_unique: ``count`` codes already buffered, ``fresh``
    # distinct codes disjoint from them, as the fused tail's survivors are
    cap, nb, nf = shape["cap"], shape["count"], shape["fresh"]
    pool = _distinct(rng, nb + nf, hi)
    buf = pad(sorted_t(pool[:nb]), cap - nb)
    fresh = sorted_t(pool[nb:])
    small_old = sorted_t(_distinct(rng, 100, 1000))
    small_buf = pad(small_old, 128 - small_old.shape[0])
    # 20 values already in buf plus exactly enough new ones to fill it
    n_room = 128 - small_old.shape[0]
    exact_fill = torch.unique(
        torch.cat([small_old[:20], t(np.arange(1000, 1000 + n_room))])
    )
    return [
        ("full", (buf, fresh), True),
        ("empty-buf-empty-fresh", (pad(empty, 128), empty), False),
        ("all-sentinel-buf", (pad(empty, 128), small_old), False),
        ("duplicates", (small_buf, small_old[::3].contiguous()), False),
        ("fills-exactly", (small_buf, exact_fill), False),
        ("truncates", (small_buf, t(np.arange(2000, 2200))), False),
        ("padded-fresh", (small_buf, pad(small_old[1::2].contiguous(), 9)), False),
    ]


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def _bytes(name, args, dtype_size):
    """Bytes the function must move: each input read once, each output
    written once."""
    if name == "sorted_member":
        a, b = args
        return (a.shape[0] + b.shape[0]) * dtype_size + a.shape[0]
    if name == "join_bounds":
        a, b = args
        return (a.shape[0] + b.shape[0]) * dtype_size + 8 * a.shape[0]
    if name == "rle_expand":
        vals, counts, total = args
        return vals.shape[0] * (dtype_size + counts.element_size()) + total * dtype_size
    # only buf's occupied prefix is read; the merge writes all of buf's
    # length and two int64 stats
    buf, fresh = args
    from repro_torch.kernels import ref

    nb = int((buf != ref.sentinel(buf.dtype)).sum())
    return (nb + fresh.shape[0] + buf.shape[0]) * dtype_size + 16


def _library_call(name, args):
    """The one PyTorch call that computes the same function (timed as a
    yardstick only; the port never calls it)."""
    import torch

    if name == "sorted_member":
        a, b = args
        return lambda: torch.searchsorted(b, a)
    if name == "join_bounds":
        a, b = args
        return lambda: (torch.searchsorted(b, a), torch.searchsorted(b, a, right=True))
    if name == "rle_expand":
        vals, counts, total = args
        return lambda: torch.repeat_interleave(vals, counts, output_size=total)
    buf, fresh = args
    return lambda: torch.unique(torch.cat([buf, fresh]))


def check_kernels(dev, shapes: dict[str, dict[str, int]]) -> dict[str, dict]:
    """Every kernel against its plain version; ``shapes`` are the operand
    lengths of each kernel's largest launch on the full-size run."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops, ref

    wrappers = {
        "sorted_member": (kernels.sorted_member, ref.sorted_member),
        "join_bounds": (kernels.join_bounds, ref.join_bounds),
        "rle_expand": (kernels.rle_expand, ref.rle_expand),
        "merge_sorted_unique": (kernels.merge_sorted_unique, ref.merge_sorted_unique),
    }
    results = {}
    for name, (kernel, plain) in wrappers.items():
        err = 0
        entry = {}
        for dtype in (torch.int32, torch.int64):
            rng = np.random.default_rng(
                [ops.KERNELS.index(name), dtype.itemsize]
            )
            for label, args, timed in _cases(name, shapes[name], dtype, dev, rng):
                got = _as_list(kernel(*args))
                want = _as_list(plain(*args))
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
                        raise AssertionError(
                            f"{name} {dtype} {label}: kernel != plain version"
                        )
                    if g.numel():
                        diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
                        err = max(err, int(diff))
                log(f"[kernels] {name} {str(dtype)[6:]} {label}: equal")
                if timed and dtype == torch.int64:
                    entry = {
                        "ms": cuda_ms(lambda: kernel(*args)),
                        "plain_ms": cuda_ms(lambda: plain(*args)),
                        "library_ms": cuda_ms(_library_call(name, args)),
                        "bound_ms": _bytes(name, args, 8) / HBM_BYTES_PER_S * 1e3,
                        "bound_by": "bytes",
                    }
                    log(f"[kernels] {name} int64 full {shapes[name]}: {entry}")
        entry["max_abs_err"] = err
        results[name] = entry
    return results


# --------------------------------------------------------------------- #
# phases 2, 3, 5, 6: the engine
# --------------------------------------------------------------------- #
def _facts_equal(got: dict, want: dict) -> bool:
    import torch

    return set(got) == set(want) and all(
        torch.equal(got[p].cpu(), want[p].cpu()) for p in want
    )


def check_small_workloads() -> None:
    from repro_torch.core import CMatEngine
    from repro_torch.core.generators import bipartite, chain, lubm_like, paper_example, star

    workloads = [
        ("paper", lambda: paper_example(n=30, m=20)),
        ("chain", lambda: chain(n=60)),
        ("lubm", lambda: lubm_like(n_dept=4, n_students=60, n_courses=10)),
        ("star", lambda: star(n_spokes=80, n_hubs=3)),
        ("bipartite", lambda: bipartite(n_left=30, n_right=30)),
    ]
    fields = ("rounds", "n_meta_facts", "n_facts", "rule_applications_skipped")
    for name, gen in workloads:
        program, dataset, _ = gen()
        runs = {}
        for device in ("cuda", "cpu"):
            eng = CMatEngine(program, fused=True, device=device)
            eng.load(dataset)
            stats = eng.materialise()
            runs[device] = (eng.materialisation(), [getattr(stats, f) for f in fields])
        if not _facts_equal(runs["cuda"][0], runs["cpu"][0]):
            raise AssertionError(f"small {name}: fact sets differ (card vs CPU)")
        if runs["cuda"][1] != runs["cpu"][1]:
            raise AssertionError(f"small {name}: stats differ {runs['cuda'][1]} vs {runs['cpu'][1]}")
        log(f"[small] {name}: equal, {dict(zip(fields, runs['cuda'][1]))}")


def run_full(program, dataset) -> dict:
    import torch

    from repro_torch.core import CMatEngine
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = CMatEngine(program, fused=True)  # the default device: the card
    eng.load(dataset)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = eng.materialise()
    torch.cuda.synchronize()
    t_mat = time.perf_counter() - t0
    launches = ops.launch_counts()
    largest = ops.largest_launches()
    out = {
        "load_s": t_load,
        "materialise_s": t_mat,
        "rounds": stats.rounds,
        "n_meta_facts": stats.n_meta_facts,
        "n_facts": stats.n_facts,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "largest_launch": largest,
        "engine": eng,
    }
    log(f"[full] load {t_load:.3f} s, materialise {t_mat:.3f} s, rounds "
        f"{stats.rounds}, n_meta_facts {stats.n_meta_facts}, n_facts "
        f"{stats.n_facts}, max_memory_allocated {out['max_memory_allocated']}")
    log(f"[full] materialise host time by phase (s): compress "
        f"{stats.time_compress:.3f}, match {stats.time_match:.3f}, join "
        f"{stats.time_join:.3f}, dedup {stats.time_dedup:.3f}")
    log(f"[full] launches {launches}")
    log(f"[full] largest launch per kernel (operand lengths) {largest}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"full run never launched: {missing}")
    if "count" not in largest["merge_sorted_unique"]:
        raise AssertionError("the merge's launch meter lacks the buffered count")
    return out


def count_syncs(program, dataset) -> int:
    """Host synchronisations of one more full-size load + materialise,
    as CUDA's sync debug mode reports them."""
    import torch

    from repro_torch.core import CMatEngine

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng = CMatEngine(program, fused=True)
            eng.load(dataset)
            eng.materialise()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0
    )


def profile_run(program, dataset) -> None:
    """Trace one load and one materialise with ``torch.profiler``: wall,
    device-busy time (kernels and copies as the card ran them) and its
    share of the wall, CUDA kernel launches issued, the top device and
    host operators, and the hand-written kernels' own device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import CMatEngine

    hand = ("sorted_member_kernel", "join_bounds_kernel", "rle_expand_kernel",
            "merge_rank_kernel", "merge_scatter_kernel")
    for phase in ("load", "materialise"):
        eng = CMatEngine(program, fused=True)
        if phase == "materialise":
            eng.load(dataset)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.load(dataset) if phase == "load" else eng.materialise()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        # host operators carry their kernels' device time too: count only
        # the device's own events, or it is counted twice
        dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                     key=_device_us, reverse=True)
        busy = sum(_device_us(e) for e in dev) / 1e6
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        log(f"[profile] {phase}: wall {wall:.3f} s under the profiler, device "
            f"busy {busy:.3f} s, busy share {busy / wall:.3f}, "
            f"cudaLaunchKernel {launches}")
        for e in dev[:8]:
            log(f"[profile] {phase} device: {_device_us(e) / 1e3:.1f} ms "
                f"{e.count} x {e.key[:70]}")
        for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
            log(f"[profile] {phase} host: {e.self_cpu_time_total / 1e3:.1f} ms "
                f"{e.count} x {e.key[:70]}")
        for e in dev:
            if any(k in e.key for k in hand):
                log(f"[profile] {phase} hand kernel: {_device_us(e) / 1e3:.3f} ms "
                    f"{e.count} x {e.key[:90]}")
        del eng, prof


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one more load and materialise with torch.profiler")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.flat import flat_seminaive
    from repro_torch.core.generators import lubm_like
    from repro_torch.kernels import build, ops

    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_build = build.build()
    log(f"[build] {len(build.SOURCES)} libraries in {t_build:.1f} s")

    check_small_workloads()

    program, dataset, _ = lubm_like(
        n_dept=N_DEPT, n_students=N_STUDENTS, n_courses=N_COURSES
    )
    n_explicit = sum(int(v.shape[0]) for v in dataset.values())
    log(f"[full] lubm_like({N_DEPT}, {N_STUDENTS}, {N_COURSES}): "
        f"{n_explicit} explicit triples")
    full = run_full(program, dataset)
    t0 = time.perf_counter()
    oracle = flat_seminaive(program, dataset, device="cpu")
    log(f"[full] flat oracle on the CPU: {time.perf_counter() - t0:.1f} s, "
        f"{sum(int(v.shape[0]) for v in oracle.values())} facts")
    if not _facts_equal(full["engine"].materialisation(), oracle):
        raise AssertionError("full run: fact set differs from flat_seminaive")
    log("[full] fact set equals flat_seminaive")
    del full["engine"], oracle
    torch.cuda.empty_cache()

    kernel_numbers = check_kernels(torch.device("cuda"), full["largest_launch"])

    syncs = count_syncs(program, dataset)
    log(f"[syncs] host synchronisations in load + materialise: {syncs}")
    if args.profile:
        profile_run(program, dataset)

    kernels_line = []
    for name in ops.KERNELS:
        num = kernel_numbers[name]
        kernels_line.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": full["launches"][name],
            "max_abs_err": num["max_abs_err"],
            "ms": num["ms"],
            "plain_ms": num["plain_ms"],
            "bound_ms": num["bound_ms"],
            "bound_by": num["bound_by"],
            "library_ms": num["library_ms"],
        })
    log("[total] done")
    print(json.dumps({"kernels": kernels_line}))
    print(nvidia_smi())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
