"""The plain reference: flat semi-naive evaluation.

Straightforward PyTorch over flat id rows, on whatever device the caller
names, written apart from the system under test: it parses the rule
text itself, keeps every relation as flat rows with a sorted key per row, and derives the closure by semi-naive rounds until no rule gives
a new fact.  It imports nothing of the program.

A relation's rows are deduplicated by a key per row.  ``key_bits=64``
packs a pair exactly (``a << 32 | b``, ids below 2**31); ``key_bits=32``
is the control: a pair packed into 16-bit halves, the narrower code that
a faster dedup would be tempted by, which merges distinct facts once ids
pass 2**16.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

__all__ = ["Atom", "Rule", "closure", "parse_rules"]

_I64 = torch.int64
_ATOM = re.compile(r"\s*([A-Za-z_][A-Za-z0-9_]*)\s*\(([^()]*)\)\s*")


@dataclass(frozen=True)
class Atom:
    pred: str
    #: each term a variable name
    terms: tuple


@dataclass(frozen=True)
class Rule:
    head: Atom
    body: tuple


def _atoms(text: str, term) -> list[Atom]:
    out, pos = [], 0
    text = text.strip()
    while pos < len(text):
        m = _ATOM.match(text, pos)
        if m is None:
            raise ValueError(f"cannot parse atoms at {text[pos:]!r}")
        out.append(Atom(m.group(1), tuple(term(t.strip()) for t in m.group(2).split(","))))
        pos = m.end()
        if pos < len(text):
            if text[pos] != ",":
                raise ValueError(f"expected ',' at {text[pos:]!r}")
            pos += 1
    return out


def parse_rules(text: str) -> list[Rule]:
    """``body, body -> head`` rules, one a line; ``#`` starts a comment.
    Terms are variables."""

    def term(tok: str):
        if not re.fullmatch(r"[a-z_][A-Za-z0-9_]*", tok):
            raise ValueError(f"rule term {tok!r}: only variables are supported")
        return tok

    rules = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        body, head = line.split("->")
        (h,) = _atoms(head, term)
        rules.append(Rule(h, tuple(_atoms(body, term))))
    return rules


# ---------------------------------------------------------------------- #
# relations: rows with a sorted key
# ---------------------------------------------------------------------- #
def _key(rows: torch.Tensor, key_bits: int) -> torch.Tensor:
    if rows.shape[1] == 1:
        return rows[:, 0] if key_bits == 64 else rows[:, 0] & 0xFFFFFFFF
    if rows.shape[1] != 2:
        raise ValueError("relations of arity 1 or 2 only")
    if key_bits == 64:
        return (rows[:, 0] << 32) | rows[:, 1]
    return ((rows[:, 0] & 0xFFFF) << 16) | (rows[:, 1] & 0xFFFF)


class _Relation:
    """Rows unique by key, sorted by key."""

    def __init__(self, rows: torch.Tensor, key_bits: int):
        self.key_bits = key_bits
        rows, keys = _unique_by_key(rows, key_bits)
        self.rows, self.keys = rows, keys

    def add(self, rows: torch.Tensor) -> torch.Tensor:
        """Fold ``rows`` in; the rows that were new (the delta)."""
        rows, keys = _unique_by_key(rows, self.key_bits)
        if self.keys.numel():
            pos = torch.searchsorted(self.keys, keys).clamp_(max=self.keys.numel() - 1)
            rows, keys = rows[self.keys[pos] != keys], keys[self.keys[pos] != keys]
        if rows.shape[0]:
            all_keys, order = torch.sort(torch.cat([self.keys, keys]))
            self.rows = torch.cat([self.rows, rows])[order]
            self.keys = all_keys
        return rows


def _unique_by_key(rows: torch.Tensor, key_bits: int):
    keys = _key(rows, key_bits)
    keys, order = torch.sort(keys, stable=True)
    rows = rows[order]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return rows[first], keys[first]


# ---------------------------------------------------------------------- #
# conjunctive bodies over bindings
# ---------------------------------------------------------------------- #
def _match(atom: Atom, rows: torch.Tensor) -> dict[str, torch.Tensor]:
    """Bindings of ``atom``'s variables over ``rows``: a repeated variable
    filters."""
    keep = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    cols: dict[str, torch.Tensor] = {}
    for j, t in enumerate(atom.terms):
        if t in cols:
            keep &= rows[:, j] == cols[t]
        else:
            cols[t] = rows[:, j]
    return {v: c[keep] for v, c in cols.items()}


def _size(b: dict[str, torch.Tensor]) -> int:
    return next(iter(b.values())).shape[0] if b else 1


def _keys(b: dict, shared: list[str]) -> torch.Tensor:
    """One int64 key per binding over the shared variables (ids below
    2**31: a pair packs exactly)."""
    if len(shared) == 1:
        return b[shared[0]]
    if len(shared) == 2:
        return (b[shared[0]] << 32) | b[shared[1]]
    raise ValueError("joins on at most two shared variables")


def _probe(left: dict, right: dict):
    """``(shared, lo, counts, order)`` of a join: each left binding's span
    ``[lo, lo + counts)`` in the right side sorted by key (``order``)."""
    shared = [v for v in left if v in right]
    if not shared:
        raise ValueError("a cross product: every atom of a body must share a variable")
    rk, order = torch.sort(_keys(right, shared))
    lk = _keys(left, shared)
    lo = torch.searchsorted(rk, lk)
    return shared, lo, torch.searchsorted(rk, lk, right=True) - lo, order


def _join(left: dict, right: dict, probe) -> dict:
    """Natural join of two binding tables, from their :func:`_probe`."""
    _, lo, counts, order = probe
    dev = counts.device
    li = torch.arange(counts.shape[0], device=dev).repeat_interleave(counts)
    start = torch.cumsum(counts, 0) - counts
    ri = order[lo[li] + torch.arange(li.shape[0], device=dev) - start[li]]
    out = {v: c[li] for v, c in left.items()}
    out.update({v: c[ri] for v, c in right.items() if v not in out})
    return out


def _body(atoms: list[Atom], sources: list[torch.Tensor]) -> dict:
    """Bindings of a body, each atom over its rows: the atom over the
    fewest rows first, then always the atom sharing a variable with those
    joined whose join is smallest."""
    matched = [_match(a, s) for a, s in zip(atoms, sources)]
    todo = list(range(len(atoms)))
    first = min(todo, key=lambda i: _size(matched[i]))
    todo.remove(first)
    bound = matched[first]
    while todo:
        probes = {i: _probe(bound, matched[i]) for i in todo
                  if any(v in bound for v in matched[i])}
        if not probes:
            raise ValueError("a cross product: every atom of a body must share a variable")
        nxt = min(probes, key=lambda i: int(probes[i][2].sum()))
        todo.remove(nxt)
        bound = _join(bound, matched[nxt], probes[nxt])
    return bound


def _project(terms, bound: dict, device) -> torch.Tensor:
    n = _size(bound)
    cols = [bound[t] for t in terms]
    return torch.stack(cols, 1) if cols else torch.zeros(n, 0, dtype=_I64, device=device)


# ---------------------------------------------------------------------- #
# the closure
# ---------------------------------------------------------------------- #
def closure(program: str, dataset: dict, device, key_bits: int = 64) -> dict[str, torch.Tensor]:
    """Every predicate's facts in the closure of ``dataset`` (numpy or
    tensor id rows per predicate) under the rules of ``program``, as
    ``(n, arity)`` int64 rows on ``device``, sorted by key."""
    if key_bits not in (32, 64):
        raise ValueError("key_bits: 64, or 32 for the control")
    rules = parse_rules(program)
    device = torch.device(device)
    arity = {}
    for r in rules:
        for a in (r.head, *r.body):
            arity.setdefault(a.pred, len(a.terms))
    rels: dict[str, _Relation] = {}
    delta: dict[str, torch.Tensor] = {}
    for pred, rows in dataset.items():
        rows = torch.as_tensor(rows, dtype=_I64).to(device).reshape(len(rows), -1)
        if rows.numel() and int(rows.max()) >= 2**31:
            raise ValueError("ids must lie below 2**31")
        arity.setdefault(pred, rows.shape[1])
        rels[pred] = _Relation(rows, key_bits)
        delta[pred] = rels[pred].rows
    for pred, k in arity.items():
        rels.setdefault(pred, _Relation(torch.zeros(0, k, dtype=_I64, device=device), key_bits))
    while delta:
        fresh: dict[str, list[torch.Tensor]] = {}
        for rule in rules:
            for i, atom in enumerate(rule.body):
                d = delta.get(atom.pred)
                if d is None or not d.shape[0]:
                    continue
                sources = [d if j == i else rels[a.pred].rows for j, a in enumerate(rule.body)]
                if any(not s.shape[0] for s in sources):
                    continue
                bound = _body(list(rule.body), sources)
                if _size(bound):
                    fresh.setdefault(rule.head.pred, []).append(
                        _project(rule.head.terms, bound, device))
        delta = {}
        for pred, parts in fresh.items():
            new = rels[pred].add(torch.cat(parts))
            if new.shape[0]:
                delta[pred] = new
    return {p: r.rows for p, r in rels.items()}

