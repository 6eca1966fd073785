"""Fault tolerance: heartbeats, straggler mitigation, elastic re-meshing.

At 1000+ nodes the framework must assume per-step failure probability is
non-trivial.  Components (all host-side; hardware-agnostic, testable on
CPU):

* :class:`HeartbeatMonitor` — per-host liveness with a deadline; a missed
  deadline marks the host failed and triggers the restart path.
* :class:`StragglerMonitor` — robust step-time statistics (median + MAD);
  a host persistently above ``threshold x median`` is flagged so the
  launcher can migrate its shard (on TPU pods the usual cause is an ECC-
  throttled chip or a slow host NIC).
* :class:`ElasticPlan` — given surviving host count, picks the largest
  mesh that divides the global batch; ``reshard_state`` re-places a state
  onto the new mesh.
* :func:`run_with_recovery` — the supervision loop: step, checkpoint every
  N, on simulated/real failure restore latest checkpoint and continue —
  the integration test kills a step mid-run and asserts bit-exact
  continuation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
from torch import nn

from .checkpoint import AsyncCheckpointer, latest_step, load_checkpoint

__all__ = [
    "HeartbeatMonitor",
    "StragglerMonitor",
    "ElasticPlan",
    "reshard_state",
    "run_with_recovery",
]


class HeartbeatMonitor:
    def __init__(self, hosts: list[int], deadline_s: float = 60.0,
                 clock=time.monotonic):
        self.deadline = deadline_s
        self.clock = clock
        self.last_beat = {h: clock() for h in hosts}

    def beat(self, host: int) -> None:
        self.last_beat[host] = self.clock()

    def failed_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, t in self.last_beat.items()
                if now - t > self.deadline]


class StragglerMonitor:
    """Flags hosts whose step time is persistently above threshold x median."""

    def __init__(self, threshold: float = 1.5, window: int = 16,
                 min_flags: int = 8):
        self.threshold = threshold
        self.window = window
        self.min_flags = min_flags
        self.times: dict[int, list[float]] = {}
        self.flags: dict[int, int] = {}

    def record(self, host: int, step_time: float) -> None:
        self.times.setdefault(host, []).append(step_time)
        self.times[host] = self.times[host][-self.window :]

    def stragglers(self) -> list[int]:
        if len(self.times) < 2:
            return []
        recents = {h: np.median(t) for h, t in self.times.items() if t}
        med = float(np.median(list(recents.values())))
        out = []
        for h, t in recents.items():
            if t > self.threshold * med:
                self.flags[h] = self.flags.get(h, 0) + 1
                if self.flags[h] >= self.min_flags:
                    out.append(h)
            else:
                self.flags[h] = 0
        return out


@dataclass
class ElasticPlan:
    """Mesh downsizing plan after host loss."""

    total_hosts: int
    chips_per_host: int = 4
    model_parallel: int = 16
    candidates: list[int] = field(default_factory=list)

    def viable_meshes(self, surviving_hosts: int) -> list[tuple[int, int]]:
        """(data, model) meshes that fit on the surviving chips, largest
        first.  Model parallelism is kept fixed (weight layout survives);
        the data axis shrinks to the largest power-of-two that fits."""
        chips = surviving_hosts * self.chips_per_host
        data = chips // self.model_parallel
        if data < 1:
            return []  # not enough chips for even one model replica
        out = []
        p = 1
        while p * 2 <= data:
            p *= 2
        while p >= 1:
            out.append((p, self.model_parallel))
            p //= 2
        return out

    def pick(self, surviving_hosts: int) -> tuple[int, int]:
        meshes = self.viable_meshes(surviving_hosts)
        if not meshes:
            raise RuntimeError("not enough chips for model parallelism")
        return meshes[0]


def reshard_state(state, mesh, sharding_fn):
    """Re-place a host-side state tree onto a (new) mesh.

    ``sharding_fn(state, mesh)`` (``launch.sharding.state_shardings``,
    say) gives each leaf its ``NamedSharding``; every tensor or numpy
    leaf becomes a DTensor of that layout (a DTensor of an old mesh is
    gathered first), and a module's parameters are replaced in place by
    such DTensors.  Every rank of the mesh calls it with the same state."""
    shardings = sharding_fn(state, mesh)

    def place(node, sh):
        if isinstance(node, nn.Module):
            for mod_name, mod in node.named_modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    key = f"{mod_name}.{name}" if mod_name else name
                    setattr(mod, name, nn.Parameter(sh[key].place(p.detach()),
                                                    requires_grad=p.requires_grad))
            return node
        if isinstance(node, dict):
            return {k: place(v, sh[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [place(v, s) for v, s in zip(node, sh)]
        return sh.place(node)

    return place(state, shardings)


def run_with_recovery(
    train_step,
    state,
    batches,
    *,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_failures: int = 10,
    fail_at: set[int] | None = None,
    start_step: int = 0,
):
    """Supervised training loop with checkpoint/restart.

    ``fail_at``: steps at which to inject a simulated failure (testing).
    Returns (final_state, last_step, n_recoveries).
    """
    ckpt = AsyncCheckpointer(ckpt_dir)
    failures = 0
    step = start_step
    restored = latest_step(ckpt_dir)
    if restored is not None:
        state, step = load_checkpoint(ckpt_dir, state)
        step += 1
    n = len(batches)
    while step < n:
        try:
            if fail_at and step in fail_at:
                fail_at.discard(step)
                raise RuntimeError(f"injected failure at step {step}")
            state, metrics = train_step(state, batches[step])
            if step % ckpt_every == 0:
                ckpt.wait()
                ckpt.save(step, state)
            step += 1
        except RuntimeError:
            failures += 1
            if failures > max_failures:
                raise
            ckpt.wait()
            restored = latest_step(ckpt_dir)
            if restored is None:
                step = start_step
            else:
                state, rstep = load_checkpoint(ckpt_dir, state)
                step = rstep + 1
    ckpt.wait()
    return state, step, failures
