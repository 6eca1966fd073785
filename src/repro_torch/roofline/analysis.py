"""Three-term roofline model over dry-run records.

Hardware model: one NVIDIA H100 SXM (``DEVICE``), at the rates of its
published data sheet, which assume the card's full 700 W power limit
(``POWER_LIMIT_W``):

    PEAK_FLOPS = 989e12  dense bf16 FLOP/s per card
    HBM_BW     = 3.35e12 B/s per card
    LINK_BW    = 450e9   B/s per NVLink 4 direction

These are published peaks, not measurements.  A card may be set below
700 W and then runs slower under load, so a share computed against them
is stated with the card's measured power limit beside it (``nvidia-smi
--query-gpu=name,power.limit``).

Terms (seconds, per step, per device; the dry-run records are already
per device, :mod:`repro_torch.launch.dryrun`):

    compute    = counted FLOPs / PEAK_FLOPS
    memory     = counted bytes / HBM_BW
    collective = collective bytes / LINK_BW

``collective bytes`` counts each collective's *result* bytes once (a ring
all-reduce moves about twice that on the wire; the constant factor does
not change which term dominates).

MODEL_FLOPS (the "useful" floor) is ``6 * N * D`` for training (N = total
params for dense, active params for MoE; D = tokens per step),
``2 * N * D`` for a prefill and ``2 * N * batch`` for a decode step.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..configs import SHAPES, get_config

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
DEVICE = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700

__all__ = ["DEVICE", "HBM_BW", "LINK_BW", "PEAK_FLOPS", "POWER_LIMIT_W", "RooflineRow",
           "model_flops_per_device", "roofline_row", "load_dryrun", "full_table",
           "format_table"]


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_dev: float
    hlo_flops_per_dev: float
    temp_bytes: float

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much dispatched compute is useful."""
        return (
            self.model_flops_per_dev / self.hlo_flops_per_dev
            if self.hlo_flops_per_dev
            else 0.0
        )

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput vs peak, given the *dominant* term paces
        the step: (MODEL_FLOPS/peak) / max(term)."""
        dom = max(self.compute_s, self.memory_s, self.collective_s)
        if dom <= 0:
            return 0.0
        return (self.model_flops_per_dev / PEAK_FLOPS) / dom


def model_flops_per_device(arch: str, shape_name: str, n_devices: int) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens / n_devices
    # decode / prefill-step: forward only
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens / n_devices
    return 2.0 * n * shape.global_batch / n_devices


def roofline_row(rec: dict) -> RooflineRow | None:
    if rec.get("status") != "OK":
        return None
    mf = model_flops_per_device(rec["arch"], rec["shape"], rec["n_devices"])
    return RooflineRow(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        compute_s=rec["flops_per_device"] / PEAK_FLOPS,
        memory_s=rec["hbm_bytes_per_device"] / HBM_BW,
        collective_s=rec["collective_total_per_device"] / LINK_BW,
        model_flops_per_dev=mf,
        hlo_flops_per_dev=rec["flops_per_device"],
        temp_bytes=rec["memory"]["temp_bytes"] or 0,
    )


def load_dryrun(directory: str = "experiments/dryrun") -> list[dict]:
    recs = []
    for fname in sorted(os.listdir(directory)):
        if fname.endswith(".json"):
            with open(os.path.join(directory, fname)) as f:
                recs.append(json.load(f))
    return recs


def full_table(directory: str = "experiments/dryrun", mesh: str = "single"):
    rows = []
    for rec in load_dryrun(directory):
        if rec.get("mesh") != mesh:
            continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: list[RooflineRow]) -> str:
    hdr = (
        f"{'arch':<22}{'shape':<13}{'compute_s':>11}{'memory_s':>11}"
        f"{'coll_s':>10}{'bottleneck':>12}{'useful':>8}{'roofl%':>8}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<22}{r.shape:<13}{r.compute_s:>11.4f}"
            f"{r.memory_s:>11.4f}{r.collective_s:>10.4f}"
            f"{r.bottleneck:>12}{r.useful_ratio:>8.2f}"
            f"{100*r.roofline_fraction:>7.1f}%"
        )
    return "\n".join(lines)
