"""End-to-end driver: materialise a KB with the paper's engine, linearise
it into tokens, and train an LM on the stream for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.kb_train [--steps 300] \\
        [--full] [--device cpu]

This is the 'train a small model for a few hundred steps' example: with
``--full`` it uses the architecture's published config; the smoke
config exercises the identical code path.  On the card unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse

from ..launch import train as train_driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    argv = [
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--batch", "8",
        "--seq", "64",
        "--lr", "3e-3",
        "--kb-corpus",
        "--log-every", "20",
        "--device", args.device,
    ]
    if not args.full:
        argv.append("--smoke")
    return train_driver.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
