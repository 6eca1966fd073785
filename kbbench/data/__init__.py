"""The benchmark's own data: the KB generators and the datalog programs.

A configuration's ``kb.generator`` names a generator module,
``kbbench/data/<name>.py``, that exports three names:

* ``generate(kb: dict, seed: int, program: str) -> KB``: the KB of the
  configuration's ``kb`` group, drawn from ``seed``, with the datalog
  ``program`` (its text) to materialise it under;
* ``TINY: dict``: overrides of the ``kb`` group that give a KB of about
  10**5 facts, for the CPU tests;
* ``WIDE: dict``: overrides whose ids pass 2**16, where the control's
  32-bit fact codes collide.

A generator imports nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["KB"]


@dataclass(frozen=True)
class KB:
    """One generated knowledge base."""

    program: str
    #: predicate -> (n, arity) int64 ids, each relation's rows unique
    dataset: dict[str, np.ndarray]
    n_terms: int
    #: entities of each kind (``department``, ``faculty``, ...)
    counts: dict[str, int]

    @property
    def n_triples(self) -> int:
        return sum(int(r.shape[0]) for r in self.dataset.values())
