"""Shared-plan micro-batch execution for the serving tier.

Concurrent query streams are heavily templated: the same BGP shape with
different constants (``memberOf(?s, "dept0")`` vs ``"dept3"``).  The
planner already dedups *plans* by query shape; this module goes one step
further and dedups the *scan/join work* across a micro-batch:

1. :func:`plan_signature` abstracts every constant occurrence in a query
   to a reserved slot variable (``__b0``, ``__b1``, ...) — queries with
   the same signature share a plan shape and differ only in constants.
2. A signature group with exactly one constant slot is executed as one
   **generalised query**: the slot variable is appended to the
   projection and the group runs as a single batched scan/join through
   the engine (hitting its epoch-stamped caches).
3. The generalised answer set is split back per constant with one
   stable sort and one ``join_bounds`` launch for every constant's span —
   exact equivalence with per-query execution (filtering ``slot == c``
   then dropping the slot column preserves sort order and uniqueness).

Groups that do not batch (no constants, several slots, fewer than
``min_group`` distinct constants) fall back to per-query ``answer()``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.datalog import Atom
from ..kernels import join_bounds
from .ast import Query

__all__ = ["BatchStats", "abstract_query", "answer_group", "plan_signature"]

#: reserved variable-name prefix for constant slots; queries whose own
#: variables collide with it are served per-query (never batched)
SLOT_PREFIX = "__b"


@dataclass
class BatchStats:
    """What one micro-batch execution did (feeds ``serve.batch.*``)."""

    n_queries: int = 0       # distinct queries answered
    n_groups: int = 0        # signature groups executed generalised
    n_grouped: int = 0       # queries answered via a generalised plan
    n_single: int = 0        # queries answered individually
    n_cached: int = 0        # queries answered from the result cache


def abstract_query(query: Query):
    """``(signature, constants)``: the query with every constant occurrence
    replaced by a slot variable, plus the constants in slot order.
    Returns ``(None, ())`` when the query cannot be abstracted (a user
    variable collides with the reserved slot prefix)."""
    consts: list[int] = []
    new_body: list[Atom] = []
    for atom in query.body:
        terms: list = []
        for t in atom.terms:
            if isinstance(t, int):
                terms.append(f"{SLOT_PREFIX}{len(consts)}")
                consts.append(int(t))
            else:
                if t.startswith(SLOT_PREFIX):
                    return None, ()
                terms.append(t)
        new_body.append(Atom(atom.predicate, tuple(terms)))
    return Query(query.projection, tuple(new_body)), tuple(consts)


def plan_signature(query: Query) -> Query | None:
    """Hashable shared-plan key: the constant-abstracted query shape."""
    sig, _ = abstract_query(query)
    return sig


def _split_generalised(gen_answers: torch.Tensor, wanted: list[int], ask: bool):
    """Per-constant answer tensors from one generalised answer set.

    ``gen_answers`` is sorted unique over ``projection + (slot,)``; for
    each wanted constant the rows with ``slot == c`` are gathered (one
    shared stable sort, then one ``join_bounds`` launch giving every
    constant's span, ``lo = #{slot < c}``, ``hi = #{slot <= c}``, read to
    the host at once) and the slot column dropped — the result is sorted
    unique over the original projection."""
    device = gen_answers.device
    svals, order = torch.sort(gen_answers[:, -1].contiguous(), stable=True)
    values = torch.tensor(wanted, dtype=svals.dtype).to(device)
    los, his = join_bounds(values, svals)
    los, his = torch.stack([los, his]).tolist()
    out = []
    for lo, hi in zip(los, his):
        if ask:
            n = 1 if hi > lo else 0
            out.append(torch.zeros((n, 0), dtype=torch.int64, device=device))
        else:
            # the stable sort keeps equal-slot rows in their original
            # (lexicographic) order, so the projected rows stay sorted
            # and unique
            out.append(gen_answers[order[lo:hi], :-1])
    return out


def answer_group(engine, queries, *, min_group: int = 2):
    """Answer a micro-batch of (pre-parsed) queries through ``engine``.

    Returns ``(results, stats)`` where ``results`` maps each distinct
    query to its :class:`~repro_torch.query.engine.QueryResult` and ``stats``
    is a :class:`BatchStats`.  Exact-duplicate queries in the batch are
    answered once; single-slot signature groups with at least
    ``min_group`` distinct constants run as one generalised query."""
    from .engine import QueryResult

    stats = BatchStats()
    distinct = list(dict.fromkeys(queries))
    stats.n_queries = len(distinct)

    groups: dict[Query, list[tuple[Query, int]]] = {}
    singles: list[Query] = []
    out: dict[Query, QueryResult] = {}
    for q in distinct:
        sig, consts = abstract_query(q)
        if sig is None or len(consts) != 1:
            singles.append(q)
            continue
        groups.setdefault(sig, []).append((q, consts[0]))

    for sig, members in groups.items():
        pending = []
        for q, c in members:
            hit = engine.cached(q)
            if hit is not None:
                out[q] = hit
                stats.n_cached += 1
            else:
                pending.append((q, c))
        if not pending:
            continue
        if len({c for _, c in pending}) < min_group:
            singles.extend(q for q, _ in pending)
            continue
        gen = Query(sig.projection + (f"{SLOT_PREFIX}0",), sig.body)
        res = engine.answer(gen)
        stats.n_groups += 1
        stats.n_grouped += len(pending)
        per_const = _split_generalised(
            res.answers, [c for _, c in pending],
            ask=not sig.projection,
        )
        for (q, _), answers in zip(pending, per_const):
            result = QueryResult(q, answers, res.plan, res.stats,
                                 from_cache=res.from_cache)
            engine.seed_result(result)
            # the caller's copy: the cached tensor stays the engine's
            out[q] = QueryResult(q, answers.clone(), res.plan, res.stats,
                                 from_cache=res.from_cache)

    for q in singles:
        res = engine.answer(q)
        if res.from_cache:
            stats.n_cached += 1
        else:
            stats.n_single += 1
        out[q] = res
    return out, stats
