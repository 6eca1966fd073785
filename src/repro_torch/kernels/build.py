"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  All missing libraries are compiled in
parallel, one ``nvcc`` process per source.  Libraries land in ``_build/``
next to this file, named by a digest of their sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing is compiled or loaded at import time: the first wrapper call on a
CUDA tensor (or an explicit :func:`build`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "KernelBuildError", "SOURCES", "build", "library"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
#: one shared library per source file
SOURCES = (
    "sorted_member", "join_bounds", "rle_expand", "merge_sorted_unique",
    "fused_join_dedup",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
#: C entry points of each library (each exists with an ``_i32`` and an
#: ``_i64`` suffix, unless ``KEY_TYPES`` names fewer); the last argument of
#: every one is the CUDA stream
SIGNATURES: dict[str, dict[str, tuple]] = {
    "sorted_member": {"repro_sorted_member": (_P, _I, _P, _I, _P, _P, _I, _P)},
    "join_bounds": {"repro_join_bounds": (_P, _I, _P, _I, _P, _P, _P, _I, _P)},
    "rle_expand": {"repro_rle_expand": (_P, _P, _I, _P, _I, _P)},
    "merge_sorted_unique": {
        "repro_merge_sorted_unique": (_P, _I, _I, _P, _I, _P, _P, _I, _P),
    },
    "fused_join_dedup": {
        "repro_fused_join_dedup": (_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P),
    },
}
#: libraries built for fewer key types than both
KEY_TYPES = {"fused_join_dedup": ("i32",)}

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """The CUDA kernels cannot be built or loaded here."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        for suffix in KEY_TYPES.get(name, ("i32", "i64")):
            f = getattr(lib, f"{fn}_{suffix}")
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build(names=SOURCES) -> float:
    """Compile (in parallel) and load every named library not yet loaded;
    returns the wall seconds spent.  Raises :class:`KernelBuildError`
    when CUDA or ``nvcc`` is missing or a compile fails."""
    t0 = time.perf_counter()
    names = [n for n in names if n not in _LIBS]
    if not names:
        return 0.0
    if not torch.cuda.is_available():
        raise KernelBuildError("CUDA is not available: the kernels need a card")
    missing = [n for n in names if not _lib_path(n).exists()]
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for n in missing:
            out = _lib_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            )
            jobs.append((n, proc, tmp, out))
        errors = []
        for n, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{n}.cu:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
        if errors:
            raise KernelBuildError("nvcc failed\n" + "\n".join(errors))
    for n in names:
        _LIBS[n] = _load(n)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name]
    return lib
