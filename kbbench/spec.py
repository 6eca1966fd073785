"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name:

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``kbbench/traffic/<mix>.json``, whose ``kind`` names the
  driver ``kbbench/drivers/<kind>.py``;
* a per-layer metric: the reader ``kbbench/metrics/<metric>.py``;
* a configuration's KB generator: the module ``kbbench/data/<name>.py``
  that its ``kb.generator`` names, and its engine: the attribute of
  ``repro_torch.core`` that its ``engine.class`` names.

So a later change adds a configuration, a mix, a cell, a metric or a KB
generator by new files and entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, replace
from pathlib import Path
from types import ModuleType

__all__ = ["HERE", "Spec", "engine_name", "load_driver", "load_generator", "load_reader"]

#: the benchmark's own folder
HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_ENGINE = re.compile(r"repro_torch\.core\.([A-Za-z_][A-Za-z0-9_]*)")
#: what a KB generator module exports (``kbbench/data/__init__.py``)
GENERATOR_NAMES = ("generate", "TINY", "WIDE")


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
    #: the module of the configuration's ``kb.generator``
    generator: ModuleType

    @property
    def name(self) -> str:
        return self.cell["name"]

    @classmethod
    def load(cls, root: Path, workload: str) -> Spec:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cell = _named(bench["workloads"], workload, "workload")
        entry = _named(bench["configs"], cell["config"], "config")
        config = json.loads((root / entry["file"]).read_text())
        generator = _checked(entry["name"], config)
        traffic = json.loads(_file("traffic", cell["traffic"], ".json").read_text())

        e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        e2e_names = {m["name"] for m in e2e}

        def layer_reported(m: dict) -> bool:
            # without a list, wherever the end-to-end metric it moves is
            if "workloads" in m:
                return workload in m["workloads"]
            return m["moves"] in e2e_names

        per_layer = [m for m in bench["per_layer"] if layer_reported(m)]
        return cls(root, cell, config, traffic, e2e, per_layer, generator)

    def with_config(self, config: dict) -> Spec:
        """This cell with ``config`` in place of its configuration."""
        return replace(self, config=config, generator=_checked(self.cell["config"], config))


def _checked(name: str, config: dict) -> ModuleType:
    """The configuration's KB generator, once its engine's name has the
    right form; a ValueError that names the configuration where not."""
    try:
        engine_name(config)
        return load_generator(config.get("kb", {}).get("generator"))
    except (ValueError, FileNotFoundError) as e:
        raise ValueError(f"configuration {name!r}: {e}") from e


def _file(folder: str, name: str, suffix: str, base: Path = HERE) -> Path:
    if not _NAME.fullmatch(name):
        raise ValueError(f"{folder}: bad name {name!r}")
    path = base / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path.relative_to(base.parent)}")
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


def load_generator(path: str, base: Path = HERE) -> ModuleType:
    """The KB generator module a configuration's ``kb.generator`` names,
    as written there: ``kbbench/data/<name>.py``, exporting
    :data:`GENERATOR_NAMES`.  ``base`` is the ``kbbench`` folder it is
    found in (a test's checkout; by default this one)."""
    folder, _, file = str(path).rpartition("/")
    stem = file[: -len(".py")] if file.endswith(".py") else ""
    if folder != "kbbench/data" or not _NAME.fullmatch(stem):
        raise ValueError(f"kb.generator {path!r} is no file kbbench/data/<name>.py")
    found = _file("data", stem, ".py", base)
    name = "kbbench.data." + re.sub(r"[.-]", "_", found.stem)
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, found)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    missing = [n for n in GENERATOR_NAMES if not hasattr(mod, n)]
    if missing:
        raise ValueError(f"kb.generator {path!r} lacks {', '.join(missing)}")
    return mod


def engine_name(config: dict) -> str:
    """The attribute of ``repro_torch.core`` that the configuration's
    ``engine.class`` names, given in full as ``repro_torch.core.<Name>``.
    Only the form is checked here: the drivers look the name up."""
    full = config.get("engine", {}).get("class")
    m = _ENGINE.fullmatch(str(full))
    if m is None:
        raise ValueError(f"engine.class {full!r} is no repro_torch.core.<Name>")
    return m.group(1)
