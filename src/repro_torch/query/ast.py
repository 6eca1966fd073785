"""Conjunctive (BGP-style) query AST + text parser.

A query is a projection list over a conjunction of body atoms, written
with the same atom syntax as :mod:`repro_torch.core.datalog` rules::

    ?s, ?c <- memberOf(?s, "dept3"), takesCourse(?s, ?c)

The head may equivalently be written atom-style (``Q(?s, ?c) <- ...``);
an empty head (``<- body``) is a boolean/ASK query.  Constants are
interned into the supplied :class:`~repro_torch.core.terms.Dictionary`, exactly
as in rule parsing — note the atom grammar's convention: lowercase
multi-character bare tokens are *variables*, so constants must be
quoted (``"dept3"``), capitalised, or prefixed (``ex:dept3``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.datalog import Atom, _parse_atom, _split_atoms
from ..core.terms import Dictionary

__all__ = ["Query", "parse_query"]


@dataclass(frozen=True)
class Query:
    """``projection <- body`` with every projected variable bound in the body."""

    projection: tuple[str, ...]
    body: tuple[Atom, ...]

    def __post_init__(self):
        body_vars = {v for a in self.body for v in a.variables()}
        for v in self.projection:
            if v not in body_vars:
                raise ValueError(f"projected variable {v!r} unbound in body")
        if not self.body:
            raise ValueError("query needs at least one body atom")

    def variables(self) -> tuple[str, ...]:
        seen: list[str] = []
        for a in self.body:
            for v in a.variables():
                if v not in seen:
                    seen.append(v)
        return tuple(seen)

    @property
    def is_ask(self) -> bool:
        return not self.projection

    def __str__(self) -> str:
        """Round-trippable text form with constants as numeric id
        literals (``parse_query(str(q)) == q``); use :meth:`to_text` for
        the term-name rendering."""
        head = ", ".join(f"?{v}" for v in self.projection)
        return head + " <- " + ", ".join(_atom_str(a, None) for a in self.body)

    def to_text(self, dictionary: Dictionary) -> str:
        """Parseable text form, constants quoted back through the
        dictionary (``parse_query(q.to_text(d), d) == q``)."""
        head = ", ".join(f"?{v}" for v in self.projection)
        return head + " <- " + ", ".join(
            _atom_str(a, dictionary) for a in self.body
        )


def _atom_str(atom: Atom, dictionary: Dictionary | None) -> str:
    terms = []
    for t in atom.terms:
        if isinstance(t, int):
            # negative ids are unknown-constant sentinels with no term
            # name; render as id literals (still round-trippable)
            if dictionary is not None and t >= 0:
                terms.append(f'"{dictionary.term_of(t)}"')
            else:
                terms.append(str(t))
        else:
            terms.append(f"?{t}")
    return f"{atom.predicate}({', '.join(terms)})"


def parse_query(text: str, dictionary: Dictionary | None = None) -> Query:
    """Parse ``?x, ?y <- P(?x, ?y), R(?x)`` (or ``Q(?x, ?y) <- ...``)."""
    if "<-" not in text:
        raise ValueError(f"query missing '<-': {text!r}")
    head_text, body_text = text.split("<-", 1)
    body = tuple(
        _parse_atom(a, dictionary) for a in _split_atoms(body_text) if a.strip()
    )
    head_text = head_text.strip()
    if not head_text:
        projection: tuple[str, ...] = ()
    elif "(" in head_text:
        head = _parse_atom(head_text, dictionary)
        if any(not isinstance(t, str) for t in head.terms):
            raise ValueError(f"projection must be variables only: {head_text!r}")
        projection = tuple(head.terms)
    else:
        projection = tuple(
            tok.strip().lstrip("?") for tok in head_text.split(",") if tok.strip()
        )
    return Query(projection, body)
