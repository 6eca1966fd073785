"""Fault tolerance demo: failure injection, checkpoint/restart, and
elastic re-mesh planning.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]

1. trains a smoke model with failures injected at steps 7 and 15; the
   supervision loop restores the latest checkpoint and continues;
2. shows the ElasticPlan choosing a smaller mesh after losing hosts;
3. flags a slow host with the StragglerMonitor.

On the card unless ``--device`` says otherwise.  :func:`main` returns
the trained state, the last step and the failures survived.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..configs import get_config
from ..core.util import resolve_device
from ..data import DataConfig, SyntheticCorpus
from ..train import (
    ElasticPlan,
    StragglerMonitor,
    TrainConfig,
    init_train_state,
    make_train_step,
    run_with_recovery,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("llama3.2-1b", smoke=True)
    train_cfg = TrainConfig(total_steps=24, warmup_steps=2)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    corpus = SyntheticCorpus(data_cfg)

    state = init_train_state(torch.Generator(device).manual_seed(0), cfg, train_cfg)
    step_fn = make_train_step(cfg, train_cfg)
    batches = [
        {k: torch.from_numpy(v).to(device) for k, v in corpus.batch(s).items()}
        for s in range(24)
    ]

    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, last, failures = run_with_recovery(
            step_fn, state, batches,
            ckpt_dir=ckpt_dir, ckpt_every=5,
            fail_at={7, 15},
        )
        print(f"trained to step {last} surviving {failures} injected failures")

    # --- elastic re-mesh planning --- #
    plan = ElasticPlan(total_hosts=128, chips_per_host=4, model_parallel=16)
    for surviving in (128, 120, 96, 65):
        data, model = plan.pick(surviving)
        print(f"hosts={surviving:4d}  -> mesh (data={data}, model={model}) "
              f"= {data*model} chips")

    # --- straggler detection (flags accrue per periodic check) --- #
    mon = StragglerMonitor(threshold=1.5, min_flags=3)
    rng = np.random.default_rng(0)
    flagged = []
    for step in range(12):
        for host in range(8):
            t = 1.0 + 0.05 * rng.standard_normal()
            if host == 3:
                t *= 2.2  # host 3 is slow
            mon.record(host, t)
        flagged = mon.stragglers()
    print("stragglers detected:", flagged)
    return state, last, failures


if __name__ == "__main__":
    main()
