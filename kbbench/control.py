"""The control: the reference put in the program's place, with the
configuration's guarantee broken, run through the harness as the program
is run.

    python3 -m kbbench.control --workload <cell> --seed <n> [<n> ...]

The configuration states that the materialisation is exact.  The control's
engine materialises with the plain reference, deduplicating facts under
32-bit codes (16-bit halves of a pair, the narrower code a faster dedup
would be tempted by).  It stands in for the program's engine inside the
cell's own driver, at the cell's own size, for a one-second window, and
the run's result decides ``correct`` as every run's does: it must come out
false.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import functools
import sys
from contextlib import contextmanager
from types import SimpleNamespace

from .reference import flat
from .spec import HERE, Spec, engine_name


class ControlEngine:
    """The engine's calls the jobs driver makes, answered by the
    reference with 32-bit fact codes."""

    def __init__(self, rules: str, program, device=None, **_):
        self.rules, self.device = rules, device
        self.dataset, self.facts = None, {}

    def load(self, dataset) -> None:
        self.dataset = dataset

    def materialise(self):
        self.facts = flat.closure(self.rules, self.dataset, self.device, key_bits=32)
        return SimpleNamespace(n_facts=sum(int(r.shape[0]) for r in self.facts.values()))

    def materialisation(self) -> dict:
        return self.facts


@contextmanager
def in_place(spec: Spec):
    """Within the block, the jobs driver builds a :class:`ControlEngine`
    where it would build the program's engine: the attribute of
    ``repro_torch.core`` that the configuration's ``engine.class`` names."""
    import repro_torch.core as core

    rules = (spec.root / spec.config["program"]).read_text()
    name = engine_name(spec.config)
    saved = getattr(core, name)
    setattr(core, name, functools.partial(ControlEngine, rules))
    try:
        yield
    finally:
        setattr(core, name, saved)


def control(argv: list[str], *, device: str = "cuda", root=None, config=None) -> dict:
    """The result of the cell's run (``kbbench.run`` arguments ``argv``)
    with the control in the program's place."""
    from .run import measure, result

    cell = argv[argv.index("--workload") + 1]
    spec = Spec.load(HERE.parent if root is None else root, cell)
    if config is not None:
        spec = spec.with_config(config)
    src = str(spec.root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    with in_place(spec):
        ctx, outcome = measure(argv, device=device, root=spec.root, config=spec.config)
    return result(ctx, outcome)


def main(argv=None) -> int:
    from .run import _set_caches

    _set_caches()
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seed:
        out = control(["--workload", args.workload, "--seed", str(seed), "--seconds", "1"],
                      device=device)
        checks = ", ".join(f"{k} {c['value']} (limit {c['limit']})" for k, c in out["checks"].items())
        print(f"control {args.workload} seed {seed} on {device}: correct {out['correct']}; {checks}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
