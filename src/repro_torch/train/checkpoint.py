"""Checkpointing: atomic, double-buffered, async, restart-safe, in the
JAX package's format on disk.

``step_%010d/arrays.npz`` holds the state's leaves as ``leaf_{i}`` in
``jax.tree_util``'s order (dict keys sorted at every level, lists by
index: ``error_feedback``, then ``opt`` with ``mu``, ``nu`` and ``step``,
then ``params``), beside ``manifest.json``; so either package restores a
checkpoint the other wrote.

* a save writes to ``.tmp-<step>`` and renames it (a crash mid-write can
  never corrupt the latest checkpoint);
* ``keep`` checkpoints are retained (two: double buffering), so a
  failure during the newest save still leaves a loadable previous step;
* :class:`AsyncCheckpointer` copies the state to the host in the train
  loop and writes it on a worker thread; the loop blocks only while a
  previous save is still in flight.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn

from ..models.layers import path_key

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "state_leaves",
           "AsyncCheckpointer"]

_MANIFEST = "manifest.json"


def state_leaves(state) -> list[tuple[str, torch.Tensor]]:
    """``(dotted path, leaf)`` of every leaf of a state tree (dicts, lists,
    modules' parameters), in ``jax.tree_util``'s order."""
    flat: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, nn.Module):
            node = dict(node.named_parameters())
        if isinstance(node, (dict, list, tuple)):
            items = node.items() if isinstance(node, dict) else enumerate(node)
            for key, child in items:
                walk(f"{prefix}.{key}" if prefix else str(key), child)
        else:
            flat[prefix] = node

    walk("", state)
    return sorted(flat.items(), key=lambda kv: path_key(kv[0]))


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf, which later in-place updates do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _write(directory: str, step: int, leaves: list[np.ndarray], keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(directory, keep)
    return final


def save_checkpoint(directory: str, step: int, state, keep: int = 2) -> str:
    return _write(directory, step, [_host(leaf) for _, leaf in state_leaves(state)], keep)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")
    )
    return steps[-1] if steps else None


@torch.no_grad()
def load_checkpoint(directory: str, state_like, step: int | None = None):
    """Restore into ``state_like``'s leaves in place, each in its own dtype
    and on its own device (shapes must match); returns ``(state_like,
    step)``.  In place because a full-width state has no room for a
    second copy on the card."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = state_leaves(state_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError("checkpoint/state structure mismatch")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, leaf) in enumerate(leaves):
            value = np.asarray(data[f"leaf_{i}"])
            if value.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {i} ({name}): shape {value.shape}, the "
                                 f"state's {tuple(leaf.shape)}")
            leaf.copy_(torch.from_numpy(np.array(value)))
    return state_like, step


class AsyncCheckpointer:
    """Background-thread checkpoint writer (double-buffered)."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_saved: int | None = None

    def save(self, step: int, state) -> None:
        self.wait()
        # the device->host copy happens here (blocking, cheap relative to
        # the write); the file I/O runs on the worker thread
        leaves = [_host(leaf) for _, leaf in state_leaves(state)]

        def work():
            try:
                _write(self.directory, step, leaves, self.keep)
                self.last_saved = step
            except Exception as exc:  # handed to the train loop by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
