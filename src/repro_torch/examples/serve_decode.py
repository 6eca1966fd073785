"""Serve a small model with batched requests (prefill + greedy decode).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        [--arch zamba2-1.2b] [--device cpu]

Exercises the KV-cache / SSM-state decode path of the smoke configs
through :mod:`repro_torch.launch.serve`, on the card unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse

from ..launch import serve as serve_driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return serve_driver.main([
        "--arch", args.arch, "--smoke", "--batch", str(args.batch),
        "--prompt-len", "16", "--gen-len", "16", "--device", args.device,
    ])


if __name__ == "__main__":
    raise SystemExit(main())
