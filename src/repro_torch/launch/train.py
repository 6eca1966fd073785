"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        [--smoke] --steps 300 --batch 8 --seq 128 [--kb-corpus] \\
        [--ckpt-dir DIR] [--device cuda|cpu]

Wires every substrate together: config -> model -> data pipeline
(synthetic, or the KB that the port's ``CMatEngine`` materialises on the
driver's device, linearised) -> train step -> checkpointing.  Everything
runs on ``--device`` (default ``cuda``; without a card the driver
raises, it never falls back) as one rank: the driver starts a process
group of one (NCCL on the card, gloo on the CPU), builds the 1x1 mesh
and installs its sharding policy, as the JAX package does; the state
stays plain tensors, as the JAX package's stays unplaced, so the
policy's anchors are no-ops.  :func:`run` returns
the run for drivers; :func:`main` prints the JAX package's lines and
returns 0 when the loss fell (the mean of the last tenth of the steps
below that of the first tenth).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.util import resolve_device, synchronize
from ..data import DataConfig, SyntheticCorpus, TokenStream, linearise_materialisation
from ..models.layers import COMPUTE_DTYPE
from ..models.sharding_policy import set_policy_from_mesh
from ..optim import AdamWConfig
from ..train import (
    AsyncCheckpointer,
    TrainConfig,
    init_train_state,
    latest_step,
    load_checkpoint,
    make_train_step,
)
from .mesh import init_process_group, make_host_mesh

__all__ = ["KB_SHAPE", "TrainRun", "build_kb_stream", "run", "main"]

#: the KB the ``--kb-corpus`` stream is linearised from: ``lubm_like``'s
#: departments, students and courses
KB_SHAPE = {"n_dept": 20, "n_students": 400, "n_courses": 40}


def build_kb_stream(cfg, data_cfg: DataConfig, device=None) -> TokenStream:
    """Materialise a synthetic KB with the CompMat engine on ``device``
    and linearise it into the training stream (the paper's engine as the
    data substrate)."""
    from ..core import CMatEngine
    from ..core.generators import lubm_like

    program, dataset, _ = lubm_like(**KB_SHAPE)
    engine = CMatEngine(program, device=device)
    engine.load(dataset)
    engine.materialise()
    tokens = linearise_materialisation(engine, cfg.vocab_size)
    return TokenStream(tokens, data_cfg)


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` trained: the config, the final state, the corpus,
    the first step run (past a restored checkpoint), each step's loss and
    host wall (from the end of the previous step to the read of its loss,
    batch copy included), and the corpus build's wall."""

    cfg: object
    state: dict
    corpus: object
    start: int
    losses: list[float]
    step_s: list[float]
    corpus_s: float

    def loss_trend(self) -> tuple[float, float]:
        """The mean loss of the first and of the last tenth of the steps."""
        k = max(len(self.losses) // 10, 1)
        return float(np.mean(self.losses[:k])), float(np.mean(self.losses[-k:]))

    @property
    def loss_fell(self) -> bool:
        first, last = self.loss_trend()
        return last < first


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--kb-corpus", action="store_true",
                    help="train on the CompMat-materialised KB stream")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(argv=None) -> TrainRun:
    args = _parse(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    init_process_group(1, device=device)
    set_policy_from_mesh(make_host_mesh(1, 1))
    train_cfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
    )
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        global_batch=args.batch,
        seed=args.seed,
    )
    synchronize(device)
    t0 = time.perf_counter()
    corpus = (
        build_kb_stream(cfg, data_cfg, device)
        if args.kb_corpus
        else SyntheticCorpus(data_cfg)
    )
    synchronize(device)
    corpus_s = time.perf_counter() - t0

    state = init_train_state(torch.Generator(device).manual_seed(args.seed), cfg, train_cfg)
    step_fn = make_train_step(cfg, train_cfg)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if latest_step(args.ckpt_dir) is not None:
            state, start = load_checkpoint(args.ckpt_dir, state)
            start += 1
            print(f"restored checkpoint, resuming at step {start}")

    losses: list[float] = []
    step_s: list[float] = []
    synchronize(device)
    t0 = t_prev = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in corpus.batch(step).items()}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (args.batch, 16, cfg.d_model), dtype=COMPUTE_DTYPE, device=device)
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.zeros(
                (args.batch, 2 * args.seq, cfg.d_model), dtype=COMPUTE_DTYPE, device=device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        now = time.perf_counter()
        step_s.append(now - t_prev)
        t_prev = now
        if step % args.log_every == 0:
            print(
                f"step {step:5d}  loss {losses[-1]:8.4f}  "
                f"gnorm {float(metrics['grad_norm']):7.3f}  "
                f"({now - t0:.1f}s)", flush=True,
            )
        if ckpt and step % args.ckpt_every == 0 and step > start:
            ckpt.save(step, state)
    if ckpt:
        ckpt.wait()
        ckpt.save(args.steps - 1, state)
        ckpt.wait()
    return TrainRun(cfg, state, corpus, start, losses, step_s, corpus_s)


def main(argv=None) -> int:
    res = run(argv)
    first, last = res.loss_trend()
    print(f"\ndone: loss {first:.4f} -> {last:.4f} over {len(res.losses)} steps")
    return 0 if res.loss_fell else 1


if __name__ == "__main__":
    raise SystemExit(main())
