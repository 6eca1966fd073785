"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name:

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``kbbench/traffic/<mix>.json``, whose ``kind`` names the
  driver ``kbbench/drivers/<kind>.py``;
* a per-layer metric: the reader ``kbbench/metrics/<metric>.py``.

So a later change adds a configuration, a mix, a cell or a metric by new
files and entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HERE", "Spec", "load_driver", "load_reader"]

#: the benchmark's own folder
HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


@dataclass(frozen=True)
class Spec:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    #: the end-to-end and per-layer metric entries this cell reports
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def name(self) -> str:
        return self.cell["name"]

    @classmethod
    def load(cls, root: Path, workload: str) -> Spec:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cell = _named(bench["workloads"], workload, "workload")
        entry = _named(bench["configs"], cell["config"], "config")
        config = json.loads((root / entry["file"]).read_text())
        traffic = json.loads(_file("traffic", cell["traffic"], ".json").read_text())

        e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        e2e_names = {m["name"] for m in e2e}

        def layer_reported(m: dict) -> bool:
            # without a list, wherever the end-to-end metric it moves is
            if "workloads" in m:
                return workload in m["workloads"]
            return m["moves"] in e2e_names

        per_layer = [m for m in bench["per_layer"] if layer_reported(m)]
        return cls(root, cell, config, traffic, e2e, per_layer)


def _file(folder: str, name: str, suffix: str) -> Path:
    if not _NAME.fullmatch(name):
        raise ValueError(f"{folder}: bad name {name!r}")
    path = HERE / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path.relative_to(HERE.parent)}")
    return path


def load_driver(kind: str):
    """The module ``kbbench/drivers/<kind>.py``; its ``run(ctx)`` drives
    a cell from set-up to the check."""
    _file("drivers", kind, ".py")
    return importlib.import_module(f"kbbench.drivers.{kind}")


def load_reader(metric: str):
    """``read(record)`` of ``kbbench/metrics/<metric>.py``: the metric's
    value, or None where the record holds nothing for it to read."""
    path = _file("metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(
        "kbbench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
