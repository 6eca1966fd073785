"""Launch-path autotuner for the CUDA kernels.

The counterpart of the TPU package's block-size tuner.  The port's one
tunable is ``join_bounds``' path (:data:`.join_bounds.PATHS`): which of
the table, warp and thread searches serves a call.  ``sorted_member`` and
``rle_expand`` have fixed launch shapes and nothing to tune.  The path is
picked per ``(kernel, dtype, size buckets)`` from a one-shot timing sweep:

* **buckets**: each side's count is bucketed to the next power of two
  (floor 256), the left keys' and the right keys' apart, so one sweep
  covers every call whose two sides fall in those buckets;
* **sweep**: operands of the call's key type at both bucket sizes, in two
  layouts (:data:`LAYOUTS`): random keys, and distinct left keys that
  each head a run of equal right keys (the CMat cross join's spans).
  Each candidate path is timed best of 3 with CUDA events on each
  layout, the card's L2 flushed before every timed launch (the hand-set
  limits came from a cold-L2 launch).  A path displaces the hand-set
  rule's only where it takes at most :data:`DISPLACE_SHARE` of that
  path's time on every layout (the fastest in sum of those that do), so
  timing noise alone never moves a call off the hand-set path.  The
  sweep's launches and wall are metered apart from the main path's
  (:func:`.ops.tuning_counts`), and a path that fails to launch raises;
* **cache**: winners persist to a JSON file (:func:`cache_path`;
  ``REPRO_TORCH_TUNE_CACHE`` overrides it) keyed by
  ``kernel|dtype|n bucket x m bucket|device name``, written whole through
  a temporary file; one lock serialises lookups and sweeps across the
  process's threads.

Invalidation rules: the file carries ``{"version", "torch", "cuda"}``; a
version bump or another PyTorch or CUDA build discards the whole cache;
the card's name lives in every entry key, so a cache written on one card
never serves another.  Corrupt or unreadable files are treated as empty,
never an error.

On CPU tensors there is no sweep: the plain versions run there, and the
defaults (the hand-set ``route`` rule, :data:`DEFAULTS`) are returned.
Traffic is surfaced through the ``kernels.`` metrics scope:
``kernels.tune.cache_hits`` / ``kernels.tune.sweeps`` /
``kernels.tune.defaults``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import torch

from ..obs import get_registry, span
from . import ops
from .join_bounds import PATHS, THREAD_KEYS, WARP_KEYS

__all__ = [
    "CACHE_VERSION",
    "CANDIDATES",
    "DEFAULTS",
    "DISPLACE_SHARE",
    "LAYOUTS",
    "cache_path",
    "clear_cache",
    "default_blocks",
    "get_blocks",
    "size_bucket",
]

CACHE_VERSION = 2

#: the hand-set rule, returned without a sweep on the CPU: a call with at
#: most ``warp_keys`` left keys takes the warp path, with at most
#: ``thread_keys`` the thread path, with more the table
DEFAULTS: dict[str, dict[str, int]] = {
    "join_bounds": {"warp_keys": WARP_KEYS, "thread_keys": THREAD_KEYS},
}

#: candidate launches swept per kernel
CANDIDATES: dict[str, list[dict[str, str]]] = {
    "join_bounds": [{"path": p} for p in PATHS],
}

#: the key layouts each candidate is timed on
LAYOUTS = ("random", "runs")
#: a candidate displaces the hand-set path only where it takes at most
#: this share of that path's time on every layout
DISPLACE_SHARE = 0.8

#: timed launches per candidate and layout (the best is kept), after one
#: warm-up
_REPEATS = 3
#: bytes written between timed launches to evict the operands from L2
#: (the H100's L2 holds 50 MB)
_FLUSH_BYTES = 256 << 20

_cache: dict[str, dict] | None = None  # in-process mirror
_device_names: dict[int, str] = {}
_lock = threading.Lock()


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "cuda_tune.json")


def size_bucket(n: int) -> int:
    """Power-of-two bucket (floor 256) a size-``n`` operand tunes in."""
    n = max(int(n), 1)
    return max(256, 1 << (n - 1).bit_length())


def _stamp() -> dict:
    return {"version": CACHE_VERSION, "torch": torch.__version__, "cuda": torch.version.cuda}


def _load_cache() -> dict[str, dict]:
    global _cache
    if _cache is not None:
        return _cache
    _cache = {}
    try:
        with open(cache_path()) as fh:
            raw = json.load(fh)
        if isinstance(raw, dict) and all(raw.get(k) == v for k, v in _stamp().items()):
            entries = raw.get("entries", {})
            _cache = {k: v for k, v in entries.items() if isinstance(v, dict)}
    except (OSError, ValueError, AttributeError):
        pass  # missing/corrupt cache is just a cold cache
    return _cache


def _save_cache() -> None:
    path = cache_path()
    folder = os.path.dirname(path) or "."
    try:
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".cuda_tune.", dir=folder)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({**_stamp(), "entries": _cache or {}}, fh, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass  # read-only FS: tuning still works, it just re-sweeps


def clear_cache() -> None:
    """Drop the in-process mirror and the disk file (tests)."""
    global _cache
    with _lock:
        _cache = None
        try:
            os.unlink(cache_path())
        except OSError:
            pass


def _device_name(device: torch.device) -> str:
    index = torch.cuda.current_device() if device.index is None else device.index
    name = _device_names.get(index)
    if name is None:
        name = _device_names[index] = torch.cuda.get_device_name(index)
    return name


def default_blocks(kernel: str, n: int) -> dict[str, str]:
    """The launch the hand-set rule gives ``n`` left keys."""
    if kernel != "join_bounds":
        raise KeyError(f"no tuning table for kernel {kernel!r}")
    rule = DEFAULTS[kernel]
    if n <= rule["warp_keys"]:
        return {"path": "warp"}
    return {"path": "thread" if n <= rule["thread_keys"] else "table"}


# ------------------------------------------------------------------ #
# the sweep: operands of both bucket sizes, in each layout, event-timed
# ------------------------------------------------------------------ #
def _operands(layout: str, n: int, m: int, dtype: torch.dtype, device: torch.device,
              gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``(l_keys, r_sorted)``: ``n`` left and ``m`` right keys."""
    if layout == "random":
        hi = 4 * max(n, m)
        r = torch.randint(0, hi, (m,), generator=gen, device=device).sort().values
        l = torch.randint(0, hi, (n,), generator=gen, device=device)
    else:  # runs: n distinct left keys, the right keys runs of them
        keys = torch.randperm(10 * n, generator=gen, device=device)[:n]
        r = keys[torch.randint(0, n, (m,), generator=gen, device=device)].sort().values
        l = keys
    return l.to(dtype), r.to(dtype)


def _pick(times: dict[str, list[float]], default: str) -> str:
    """The path of ``times`` (each candidate's time on each layout) that
    serves: of those that take at most :data:`DISPLACE_SHARE` of the
    ``default`` path's time on every layout, the fastest in sum; else
    ``default``."""
    base = times[default]
    displacing = [p for p, t in times.items()
                  if all(a <= DISPLACE_SHARE * b for a, b in zip(t, base))]
    return min(displacing, key=lambda p: sum(times[p])) if displacing else default


def _sweep(kernel: str, dtype: torch.dtype, n: int, m: int, device: torch.device) -> dict:
    from .join_bounds import join_bounds_by

    default = default_blocks(kernel, n)["path"]
    with span("kernels.tune.sweep", kernel=kernel, n=n, m=m,
              candidates=len(CANDIDATES[kernel])) as sp:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(n * 131 + m)
        flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = {c["path"]: [] for c in CANDIDATES[kernel]}
        launches = 0
        for layout in LAYOUTS:
            l, r = _operands(layout, n, m, dtype, device, gen)
            for path, ms_by_layout in times.items():
                join_bounds_by(l, r, path, meter=False)  # load + warm
                ms = float("inf")
                for _ in range(_REPEATS):
                    flush.zero_()
                    start.record()
                    join_bounds_by(l, r, path, meter=False)
                    end.record()
                    end.synchronize()
                    ms = min(ms, start.elapsed_time(end))
                ms_by_layout.append(ms)
                launches += 1 + _REPEATS
        best = _pick(times, default)
        del flush
        seconds = time.perf_counter() - t0
        ops.note_tuning(launches, seconds)
        sp.set(best=best, default=default, times=str(times))
    return {"path": best}


def get_blocks(kernel: str, dtype: torch.dtype = torch.int32, n: int = 0, *,
               m: int | None = None, device="cpu") -> dict:
    """Best-known launch for ``kernel`` on ``n`` left and ``m`` right keys
    (``None``: as many as left) of ``dtype`` on ``device``: on a card the
    cached sweep result (sweeping once on a miss), on the CPU the
    hand-set rule's launch."""
    reg = get_registry()
    if kernel not in DEFAULTS:
        raise KeyError(f"no tuning table for kernel {kernel!r}")
    device = torch.device(device)
    if device.type != "cuda":
        reg.counter("kernels.tune.defaults").inc()
        return default_blocks(kernel, n)
    nb, mb = size_bucket(n), size_bucket(n if m is None else m)
    key = f"{kernel}|{str(dtype).removeprefix('torch.')}|{nb}x{mb}|{_device_name(device)}"
    with _lock:
        cache = _load_cache()
        hit = cache.get(key)
        if hit is not None:
            reg.counter("kernels.tune.cache_hits").inc()
            return dict(hit)
        blocks = _sweep(kernel, dtype, nb, mb, device)
        cache[key] = blocks
        _save_cache()
    reg.counter("kernels.tune.sweeps").inc()
    return dict(blocks)
