"""Batched serving driver: prefill + decode with a KV/SSM cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        [--smoke] --batch 4 --prompt-len 32 --gen-len 32 [--device cuda|cpu]

Implements the standard serving loop: a batch of requests is prefilled
token-by-token into the cache (teacher-forced), then decoded greedily.
Weights and prompts are drawn from ``--seed`` with a generator on the
device.  Everything runs on ``--device`` (default ``cuda``; without a card
the driver raises, it never falls back) as one rank, under the 1x1 mesh's
sharding policy (see :mod:`.train`).  :func:`run` returns the served
state for drivers; :func:`main` prints the JAX package's three lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config
from ..core.util import resolve_device, synchronize
from ..models.model import Model
from ..models.sharding_policy import set_policy_from_mesh
from .mesh import init_process_group, make_host_mesh

__all__ = ["ServeRun", "run", "report", "main"]


@dataclasses.dataclass
class ServeRun:
    """What :func:`run` served: the model and its parameters, the prompts
    ``(batch, prompt_len)``, the prefill's decode logits at each prompt
    position ``(batch, prompt_len, vocab)``, the generated tokens
    ``(batch, gen_len)``, and the host walls (each ending in a
    synchronisation) of the prefill and the decode."""

    model: Model
    params: torch.nn.Module
    prompts: torch.Tensor
    prefill_logits: torch.Tensor
    generated: torch.Tensor
    prefill_s: float
    decode_s: float


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return ap.parse_args(argv)


@torch.inference_mode()
def run(argv=None) -> ServeRun:
    args = _parse(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    init_process_group(1, device=device)
    set_policy_from_mesh(make_host_mesh(1, 1))
    model = Model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    max_len = args.prompt_len + args.gen_len
    cache = model.init_cache(args.batch, max_len)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=torch.int32,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1), device=device,
    )

    # prefill: feed prompt tokens through the decode path
    synchronize(device)
    t0 = time.perf_counter()
    prefill = []
    for t in range(args.prompt_len):
        logits, cache = model.decode_step(params, prompts[:, t : t + 1], cache, t)
        prefill.append(logits)
    synchronize(device)
    t_prefill = time.perf_counter() - t0

    # greedy decode
    t0 = time.perf_counter()
    token = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    generated = [token]
    for t in range(args.prompt_len, max_len - 1):
        logits, cache = model.decode_step(params, token, cache, t)
        token = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        generated.append(token)
    out = torch.cat(generated, dim=1)
    synchronize(device)
    t_decode = time.perf_counter() - t0
    return ServeRun(model, params, prompts, torch.cat(prefill, dim=1), out, t_prefill, t_decode)


def report(res: ServeRun) -> list[str]:
    """The JAX package's three lines about a run."""
    b, n_steps = res.generated.shape
    n_tok = b * n_steps
    return [
        f"prefill: {res.prompts.shape[1]} steps in {res.prefill_s:.2f}s",
        f"decode:  {n_steps} steps x batch {b} = {n_tok} tokens "
        f"in {res.decode_s:.2f}s ({n_tok / max(res.decode_s, 1e-9):.1f} tok/s)",
        f"sample token ids: {res.generated[0, :16].tolist()}",
    ]


def main(argv=None) -> int:
    for line in report(run(argv)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
