#!/usr/bin/env python3
"""Where a full-width train step's time goes on the card.

    python3 tools/trace_train.py [--arch llama3.2-1b] [--steps 5] [--remat full|dots]

Builds the training driver's state for ``--arch`` at its published
widths on the first card (``repro_torch.launch.train``'s batch 8,
sequence 128, lr 3e-3, synthetic tokens), runs two warm-up steps, then
``--steps`` steps timed with CUDA events, each split into the model's
forward and backward (``forward_train`` and ``torch.autograd.grad``) and
the optimizer (``adamw_update``); then the same number of steps under
``torch.profiler`` (``chip_smoke._profile_call``: wall, device-busy
share, launches, the top device and host operators).  Beside the
medians it prints the step's bounds on one H100: the model's bf16
products (6 N T for the non-embedding parameters, the tied head's 6 d V
T, the remat's second forward 2 N T) over 989 TFLOP/s, and the
optimizer's bytes (read parameter, gradient and both moments, write
parameter and moments: 28 B a parameter) over 3.35 TB/s (the peaks of
``repro_torch.roofline.analysis``).  The card's
name and power limit print last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", default="full", choices=("full", "dots"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("trace_train: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step, train_step

    transformer.set_remat_policy(args.remat)
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3), warmup_steps=1, total_steps=100)
    state = init_train_state(torch.Generator(dev).manual_seed(0), cfg, tcfg)
    step_fn = make_train_step(cfg, tcfg)
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, args.seq, args.batch))

    def batch(i):
        return {"tokens": torch.from_numpy(corpus.batch(i)["tokens"]).to(dev)}

    # CUDA events around the optimizer split each step in two
    update, marks = train_step.adamw_update, []

    def timed_update(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(*a, **kw)
        end.record()
        marks.append((start, end))
        return out

    train_step.adamw_update = timed_update
    for i in range(2):
        step_fn(state, batch(i))
    torch.cuda.synchronize()
    marks.clear()
    steps, models, optims = [], [], []
    for i in range(args.steps):
        b = batch(2 + i)
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        step_fn(state, b)
        end.record()
        torch.cuda.synchronize()
        o_start, o_end = marks.pop()
        steps.append(begin.elapsed_time(end))
        models.append(begin.elapsed_time(o_start))
        optims.append(o_start.elapsed_time(o_end))
    train_step.adamw_update = update
    chip_smoke._profile_call(
        f"{cfg.name} train steps x {args.steps}",
        lambda: [step_fn(state, batch(10 + i)) for i in range(args.steps)])

    n_params = sum(p.numel() for p in state["params"].parameters())
    embed = cfg.vocab_size * cfg.d_model
    tokens = args.batch * args.seq
    model_flops = 8 * (n_params - embed) * tokens + 6 * embed * tokens
    out = {
        "arch": cfg.name, "remat": args.remat, "params": n_params, "tokens": tokens,
        "step_ms": statistics.median(steps), "model_ms": statistics.median(models),
        "optimizer_ms": statistics.median(optims),
        "model_bound_ms": model_flops / PEAK_FLOPS * 1e3,
        "optimizer_bound_ms": 28 * n_params / HBM_BW * 1e3,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "steps_ms": steps,
    }
    print(json.dumps(out))
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
