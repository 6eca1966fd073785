"""Datalog rules, programs, parsing, and RDF vertical partitioning.

Vertical partitioning (Section 2): a triple ``<s, rdf:type, C>`` becomes a
unary fact ``C(s)``; any other triple ``<s, P, o>`` becomes ``P(s, o)``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .terms import RDF_TYPE, Dictionary

__all__ = ["Atom", "Rule", "Program", "parse_program", "vertical_partition"]


@dataclass(frozen=True)
class Atom:
    """``P(t1, ..., tn)``; terms are variable names (str) or constant ids (int)."""

    predicate: str
    terms: tuple

    @property
    def arity(self) -> int:
        return len(self.terms)

    def variables(self) -> tuple[str, ...]:
        # unique, in order of first occurrence
        seen: list[str] = []
        for t in self.terms:
            if isinstance(t, str) and t not in seen:
                seen.append(t)
        return tuple(seen)

    def __str__(self) -> str:
        return f"{self.predicate}({', '.join(map(str, self.terms))})"


@dataclass(frozen=True)
class Rule:
    """``B1 ∧ ... ∧ Bn -> H`` with every head variable bound in the body."""

    body: tuple[Atom, ...]
    head: Atom

    def __post_init__(self):
        body_vars = {v for b in self.body for v in b.variables()}
        for v in self.head.variables():
            if v not in body_vars:
                raise ValueError(f"unsafe rule: head variable {v!r} unbound")

    def __str__(self) -> str:
        return " , ".join(map(str, self.body)) + " -> " + str(self.head)


@dataclass
class Program:
    rules: list[Rule] = field(default_factory=list)

    def __iter__(self):
        return iter(self.rules)

    def __len__(self) -> int:
        return len(self.rules)

    def predicates(self) -> set[str]:
        preds = set()
        for r in self.rules:
            preds.add(r.head.predicate)
            for b in r.body:
                preds.add(b.predicate)
        return preds


_ATOM_RE = re.compile(r"\s*([A-Za-z_][\w:.\-]*)\s*\(([^)]*)\)\s*")


def _parse_atom(text: str, dictionary: Dictionary | None) -> Atom:
    m = _ATOM_RE.fullmatch(text)
    if m is None:
        raise ValueError(f"cannot parse atom: {text!r}")
    pred = m.group(1)
    terms: list = []
    for raw in m.group(2).split(","):
        raw = raw.strip()
        if not raw:
            continue
        if raw[0] == "?" or (raw[0].islower() and raw.isidentifier() and len(raw) <= 3):
            # variables: ?x style, or short lowercase identifiers (x, y, zz)
            terms.append(raw.lstrip("?"))
        elif raw.startswith('"') or raw[0] == "<" or raw[0].isupper() or ":" in raw:
            if dictionary is None:
                raise ValueError(f"constant {raw!r} needs a dictionary")
            terms.append(dictionary.intern(raw.strip('"<>')))
        elif raw.lstrip("-").isdigit():
            # numeric literal: a raw constant id (negative ids occur only
            # as unknown-constant sentinels; they match no stored fact)
            terms.append(int(raw))
        elif raw.isidentifier():
            terms.append(raw)  # treat as variable
        else:
            raise ValueError(f"cannot interpret term {raw!r} in {text!r}")
    return Atom(pred, tuple(terms))


def parse_program(text: str, dictionary: Dictionary | None = None) -> Program:
    """Parse rules of the form ``P(x,y), R(x) -> S(x,y)`` (one per line).

    ``#``-prefixed lines are comments.  Constants (capitalised / quoted /
    prefixed tokens) are interned into ``dictionary``.
    """
    rules = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "->" not in line:
            raise ValueError(f"rule missing '->': {line!r}")
        body_text, head_text = line.split("->")
        body = tuple(
            _parse_atom(a, dictionary) for a in _split_atoms(body_text) if a.strip()
        )
        head = _parse_atom(head_text, dictionary)
        rules.append(Rule(body, head))
    return Program(rules)


def _split_atoms(text: str) -> list[str]:
    """Split a conjunction on commas that are outside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def vertical_partition(
    triples, dictionary: Dictionary
) -> dict[str, np.ndarray]:
    """Convert ``(s, p, o)`` string triples into per-predicate fact arrays.

    Returns ``{predicate: (n, arity) int64 array}`` with arity 1 for
    ``rdf:type`` triples (predicate = class name) and arity 2 otherwise.
    """
    unary: dict[str, list[int]] = {}
    binary: dict[str, list[tuple[int, int]]] = {}
    for s, p, o in triples:
        if p == RDF_TYPE:
            unary.setdefault(o, []).append(dictionary.intern(s))
        else:
            binary.setdefault(p, []).append(
                (dictionary.intern(s), dictionary.intern(o))
            )
    out: dict[str, np.ndarray] = {}
    for pred, subs in unary.items():
        out[pred] = np.asarray(subs, dtype=np.int64).reshape(-1, 1)
    for pred, pairs in binary.items():
        out[pred] = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return out
