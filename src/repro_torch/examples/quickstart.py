"""Quickstart: the paper's running example (Section 3), end to end.

Builds the facts (1)-(4) and rules (5)-(6), materialises them with the
compressed engine on the card (or ``--device cpu``), and prints the
meta-facts and their columns to compare with the paper's equations
(7)-(13), and the representation sizes behind its O(n) vs O(n^2) claim.
The result is checked against the flat semi-naive oracle.

    python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from ..core import CMatEngine, flat_seminaive
from ..core.generators import paper_example
from ..core.util import resolve_device


def main(argv=None) -> dict:
    """Run the example; returns the engine's ``report()``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n, m = 4, 3
    program, dataset, dictionary = paper_example(n=n, m=m)

    print("Rules (paper (5)-(6)):")
    for rule in program:
        print("   ", rule)

    print(f"\nExplicit facts: P:{dataset['P'].shape[0]} R:{dataset['R'].shape[0]} "
          f"T:{dataset['T'].shape[0]}  (n={n}, m={m})  on {device}")

    eng = CMatEngine(program, device=device)
    eng.load(dataset)
    stats = eng.materialise()
    print(f"\nmaterialised in {stats.rounds} rounds, "
          f"{stats.n_meta_facts} meta-facts for {stats.n_facts} facts")

    print("\nMeta-facts (compare paper eq. (7) + derived S/P):")
    for pred in sorted(eng.facts.predicates()):
        for mf in eng.facts.all(pred):
            cols = ", ".join(
                _render_column(eng.store, c, dictionary) for c in mf.columns
            )
            print(f"    {pred}({cols})   [{mf.length} facts, round {mf.round}]")

    rep = eng.report()
    print("\nRepresentation sizes (paper Section 4 metric):")
    print(f"    ||E||        = {rep['flat_size_E']}")
    print(f"    ||I||        = {rep['flat_size_I']}")
    print(f"    ||<M, mu>||  = {rep['compressed_size']}")
    print(f"    derived flat = {rep['flat_size_I'] - rep['flat_size_E']}, "
          f"derived compressed = "
          f"{rep['compressed_size'] - rep['flat_size_E']}")

    # cross-check against the flat oracle
    flat = flat_seminaive(program, dataset, device=device)
    mat = eng.materialisation()
    if set(mat) != set(flat) or any(
        _rows(mat[p]) != _rows(flat[p]) for p in flat
    ):
        raise AssertionError("compressed materialisation != flat oracle")
    print("\nOK: compressed materialisation == flat semi-naive oracle")
    return rep


def _rows(t) -> set[tuple[int, ...]]:
    return set(map(tuple, t.cpu().tolist()))


def _render_column(store, cid, dictionary, limit=8):
    vals = store.unfold(cid).cpu().tolist()
    names = [dictionary.term_of(int(v)) for v in vals[:limit]]
    body = ".".join(names) + ("..." if len(vals) > limit else "")
    return f"[{body}]"


if __name__ == "__main__":
    main()
