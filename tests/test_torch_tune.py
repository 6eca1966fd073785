"""The port's launch-path tuner (``repro_torch.kernels.tune``) against the
JAX package's block-size tuner (``repro.kernels.tune``), as its tests
(``tests/test_fused_kernels.py``'s ``TestTuneCache``) hold it:

* on the CPU, the defaults (``route``'s hand-set rule), no sweep and no
  cache file;
* a stamp mismatch or a corrupt file leaves the cache empty;
* a planted entry for a named card changes ``route``'s choice there;
* the counters move as the reference's do: a sweep, then cache hits.

No card here: the sweep itself is stood in for (its timing runs on the
card only, in ``chip_smoke.py``'s phase 9).
"""

from __future__ import annotations

import importlib
import json
import os
import threading

import pytest
import torch

from repro.kernels import tune as jtune
from repro_torch.kernels import tune
from repro_torch.obs import get_registry

join_bounds = importlib.import_module("repro_torch.kernels.join_bounds")
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setattr(tune, "_device_names", {0: CARD})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tune._cache = None
    get_registry().reset("kernels.tune.")
    yield
    tune._cache = None


def _counts() -> dict:
    snap = get_registry().snapshot("kernels.tune.")
    return {k.rsplit(".", 1)[1]: int(v) for k, v in snap.items() if v}


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 5000, 1 << 14, (1 << 14) + 1, 10**7])
def test_size_bucket_matches_reference(n):
    assert tune.size_bucket(n) == jtune.size_bucket(n)


def test_cache_path_default_and_override(monkeypatch):
    assert tune.cache_path().endswith("tune.json")
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert tune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "cuda_tune.json")


def test_candidates_are_the_paths():
    assert [c["path"] for c in tune.CANDIDATES["join_bounds"]] == list(join_bounds.PATHS)
    assert tune.DEFAULTS["join_bounds"] == {"warp_keys": join_bounds.WARP_KEYS,
                                           "thread_keys": join_bounds.THREAD_KEYS}
    with pytest.raises(KeyError):
        tune.get_blocks("sorted_member", n=5000)


@pytest.mark.parametrize("n,path", [(1, "warp"), (1 << 14, "warp"), ((1 << 14) + 1, "thread"),
                                    (1 << 18, "thread"), ((1 << 18) + 1, "table")])
def test_cpu_returns_defaults_without_cache(n, path):
    assert tune.get_blocks("join_bounds", torch.int32, n, device="cpu") == {"path": path}
    assert join_bounds.route(n, 10) == path
    assert not os.path.exists(tune.cache_path())  # no sweep, no file
    assert _counts() == {"defaults": 1}


def test_cpu_join_bounds_never_tunes():
    l = torch.tensor([1, 3, 5], dtype=torch.int64)
    r = torch.tensor([0, 1, 1, 5], dtype=torch.int64)
    lo, hi = join_bounds.join_bounds(l, r)
    assert lo.tolist() == [1, 3, 3] and hi.tolist() == [3, 3, 4]
    assert _counts() == {} and not os.path.exists(tune.cache_path())


def _write(raw) -> None:
    with open(tune.cache_path(), "w") as fh:
        fh.write(raw if isinstance(raw, str) else json.dumps(raw))


def _entry(n: int, m: int, dtype: str = "int32", card: str = CARD) -> str:
    return f"join_bounds|{dtype}|{tune.size_bucket(n)}x{tune.size_bucket(m)}|{card}"


def _stamped(**entries) -> dict:
    return {"version": tune.CACHE_VERSION, "torch": torch.__version__,
            "cuda": torch.version.cuda, "entries": entries}


@pytest.mark.parametrize("stale", ["version", "torch", "cuda"])
def test_stamp_mismatch_discards_cache(stale):
    raw = _stamped(**{_entry(1000, 10): {"path": "table"}})
    raw[stale] = "other"
    _write(raw)
    assert tune._load_cache() == {}


@pytest.mark.parametrize("raw", ["{not json", "[1, 2]", '{"entries": 3}', ""])
def test_corrupt_cache_is_empty(raw):
    _write(raw)
    assert tune._load_cache() == {}


def test_planted_entry_changes_route():
    n = 1000
    assert join_bounds.route(n, 10) == "warp"  # the hand-set rule
    _write(_stamped(**{_entry(n, 10): {"path": "table"},
                       _entry(n, 1 << 20): {"path": "thread"},
                       _entry(n, 10, card="Another Card"): {"path": "thread"}}))
    assert join_bounds.route(n, 10, torch.int32, torch.device("cuda")) == "table"
    assert _counts() == {"cache_hits": 1}
    # the right side's bucket is part of the key
    assert join_bounds.route(n, 1 << 20, torch.int32, torch.device("cuda")) == "thread"
    assert _counts() == {"cache_hits": 2}
    # an empty right side is the warp path whatever the cache says
    assert join_bounds.route(n, 0, torch.int32, torch.device("cuda")) == "warp"
    assert _counts() == {"cache_hits": 2}


def test_sweep_writes_cache_then_hits(monkeypatch):
    swept = []

    def fake_sweep(kernel, dtype, n, m, device):
        swept.append((kernel, dtype, n, m, device.type))
        return {"path": "thread"}

    monkeypatch.setattr(tune, "_sweep", fake_sweep)
    cuda = torch.device("cuda")
    b1 = tune.get_blocks("join_bounds", torch.int64, 300, m=5000, device=cuda)
    assert os.path.exists(tune.cache_path())
    b2 = tune.get_blocks("join_bounds", torch.int64, 500, m=8000, device=cuda)  # same buckets
    assert b1 == b2 == {"path": "thread"}
    assert swept == [("join_bounds", torch.int64, 512, 8192, "cuda")]
    assert _counts() == {"sweeps": 1, "cache_hits": 1}
    raw = json.load(open(tune.cache_path()))
    assert raw["version"] == tune.CACHE_VERSION and raw["torch"] == torch.__version__
    assert raw["entries"] == {_entry(300, 5000, "int64"): {"path": "thread"}}
    assert not [f for f in os.listdir(os.path.dirname(tune.cache_path()))
                if f.startswith(".cuda_tune.")]  # written through a temporary file
    # a new process reads the file back
    tune._cache = None
    assert tune.get_blocks("join_bounds", torch.int64, 512, m=8192,
                           device=cuda) == {"path": "thread"}
    assert _counts() == {"sweeps": 1, "cache_hits": 2}
    # m defaults to n: another bucket pair, another sweep
    tune.get_blocks("join_bounds", torch.int64, 300, device=cuda)
    assert swept[-1] == ("join_bounds", torch.int64, 512, 512, "cuda")
    tune.clear_cache()
    assert not os.path.exists(tune.cache_path()) and tune._cache is None


def test_threads_sweep_a_bucket_once(monkeypatch):
    swept = []
    gate = threading.Event()

    def slow_sweep(kernel, dtype, n, m, device):
        swept.append((n, m))
        gate.wait(5)
        return {"path": "table"}

    monkeypatch.setattr(tune, "_sweep", slow_sweep)
    cuda = torch.device("cuda")
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        tune.get_blocks("join_bounds", torch.int32, 3000, m=1 << 16, device=cuda)))
        for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert swept == [(4096, 1 << 16)]
    assert got == [{"path": "table"}] * 4
    assert _counts() == {"sweeps": 1, "cache_hits": 3}


@pytest.mark.parametrize("times,default,want", [
    # noise: a path a little faster never displaces the hand-set one
    ({"table": [1.0, 1.0], "warp": [0.9, 0.85], "thread": [1.2, 1.1]}, "table", "table"),
    # faster on one layout only: kept
    ({"table": [1.0, 1.0], "warp": [0.5, 1.1], "thread": [2.0, 2.0]}, "table", "table"),
    # faster by the share on both: the fastest in sum of those that are
    ({"table": [1.0, 1.0], "warp": [0.5, 0.8], "thread": [0.7, 0.5]}, "table", "thread"),
    ({"table": [2.0, 2.0], "warp": [1.0, 1.0], "thread": [1.0, 1.6]}, "warp", "warp"),
])
def test_pick_keeps_the_hand_set_path_unless_clearly_beaten(times, default, want):
    assert tune._pick(times, default) == want


@pytest.mark.parametrize("layout", tune.LAYOUTS)
def test_sweep_operands(layout):
    gen = torch.Generator().manual_seed(0)
    l, r = tune._operands(layout, 256, 4096, torch.int64, torch.device("cpu"), gen)
    assert l.shape == (256,) and r.shape == (4096,) and l.dtype == r.dtype == torch.int64
    assert bool((r[1:] >= r[:-1]).all())
    if layout == "runs":  # distinct left keys, every right key one of them
        assert l.unique().numel() == 256 and bool(torch.isin(r, l).all())
