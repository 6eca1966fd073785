"""Source-mapped rule-body evaluation for incremental maintenance.

Every phase of Delete/Rederive and of counting maintenance is "evaluate
a rule body with one atom pinned to a delta", the semi-naive shape the
shared body compiler (:mod:`repro_torch.core.compile`) plans.  Phases
differ only in which meta-fact lists the plan's ``old`` / ``delta`` /
``all`` source labels resolve to:

=============================  =============  =============  ==========
phase                          ``old``        ``all``        ``delta``
=============================  =============  =============  ==========
overdelete                     pre-deletion   pre-deletion   ΔO
counting, deletion sweep       post-deletion  pre-deletion   Δdeleted
counting, insertion sweep      post-insert    pre-insert     Δinserted
rederive forward / insertion   current        current        Δrestored
=============================  =============  =============  ==========

(The counting rows implement the telescoping identity
``old^n − new^n = Σ_i new^{<i} × Δ_i × old^{>i}``; the compiler tags
sources by original body position, so the mapping stays exact under plan
reordering.)

This module holds what the phases share: the evaluator driving
``match`` / ``sjoin`` / ``xjoin`` over a source mapping, head projection
with or without derivation multiplicity, rows to meta-facts, the
backward-bounding head filter, and :class:`PhaseStats`, planner
statistics that never shortcut a plan to empty.  Rows are int64 tensors
on the store's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.columns import ColumnStore
from ..core.compile import PlanCache, compile_body, stats_bucket
from ..core.compress import compress_rows
from ..core.datalog import Atom, Rule
from ..core.joins import SubstSet, match, sjoin, xjoin
from ..core.metafacts import FactStore, MetaFact
from ..core.util import unique_rows

__all__ = [
    "PhaseStats",
    "Sources",
    "evaluate_rule",
    "head_binding_filter",
    "project_head",
    "rows_to_metafacts",
]

_I64 = torch.int64

#: a source mapping: (predicate, src-label) -> meta-fact list
Sources = Callable[[str, str], list]


class PhaseStats:
    """Planner statistics for incremental phases.

    Cardinalities come from the live store, clamped to ``>= 1``, and
    arities from the program and dataset schema: a maintenance plan must
    never compile to the empty plan because the current partition is
    empty, since the phase may read a pre-update view that is not.  Host
    only (meta-fact lengths and run counts)."""

    def __init__(self, facts: FactStore, arities: dict[str, int]):
        self.facts = facts
        self.arities = arities
        self._n_rows: dict[str, int] = {}
        self._runs: dict[tuple[str, int], int] = {}

    def n_rows(self, pred: str) -> int:
        cached = self._n_rows.get(pred)
        if cached is None:
            cached = max(sum(mf.length for mf in self.facts.all(pred)), 1)
            self._n_rows[pred] = cached
        return cached

    def arity(self, pred: str) -> int:
        known = self.arities.get(pred)
        if known is not None:
            return known
        mfs = self.facts.all(pred)
        return mfs[0].arity if mfs else 0

    def selectivity(self, pred: str, pos: int, value: int) -> float:
        key = (pred, pos)
        runs = self._runs.get(key)
        if runs is None:
            store = self.facts.store
            runs = max(
                sum(
                    store.n_runs(mf.columns[pos])
                    for mf in self.facts.all(pred)
                    if pos < mf.arity
                ),
                1,
            )
            self._runs[key] = runs
        return 1.0 / runs

    def refresh(self) -> None:
        self._n_rows.clear()
        self._runs.clear()


# --------------------------------------------------------------------- #
def rows_to_metafacts(
    pred: str, rows: torch.Tensor, store: ColumnStore, round_tag: int = 0
) -> list[MetaFact]:
    """Compress flat rows into meta-facts (Algorithm 2 segmentation)."""
    return [
        MetaFact(pred, cols, length, round_tag)
        for cols, length in compress_rows(rows.to(store.device), store)
    ]


def head_binding_filter(
    head: Atom, rows: torch.Tensor, store: ColumnStore
) -> SubstSet | None:
    """A :class:`SubstSet` binding the head's variables to the given head
    tuples: the backward bound of the rederivation check (any body
    substitution rederiving one of ``rows`` agrees with some row on every
    shared variable, so atom scans are semi-joined against it first)."""
    vars_ = head.variables()
    if not vars_ or rows.shape[0] == 0:
        return None
    first_pos = {v: head.terms.index(v) for v in vars_}
    mask = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    for pos, t in enumerate(head.terms):
        if isinstance(t, int):
            mask &= rows[:, pos] == t
        elif pos != first_pos[t]:
            mask &= rows[:, pos] == rows[:, first_pos[t]]
    sel = rows[mask][:, [first_pos[v] for v in vars_]]
    if sel.shape[0] == 0:
        return SubstSet(vars_)
    return SubstSet(vars_, compress_rows(unique_rows(sel), store))


# --------------------------------------------------------------------- #
def evaluate_rule(
    rule: Rule,
    pivot: int | None,
    sources: Sources,
    store: ColumnStore,
    stats: PhaseStats,
    plan_cache: PlanCache,
    *,
    match_cache: dict | None = None,
    head_filter: SubstSet | None = None,
) -> SubstSet | None:
    """Evaluate one (rule, pivot) body over a phase's source mapping.

    Returns the body-substitution :class:`SubstSet` (``None`` when any
    partition comes up empty).  ``head_filter`` bounds every atom scan by
    the deleted-head bindings (backward rederivation); it is
    rule-specific, so the shared ``match_cache`` is bypassed then."""
    plan = plan_cache.get(
        (rule, pivot),
        stats_bucket(stats, rule.body),
        lambda: compile_body(rule.body, stats, pivot=pivot),
    )
    if plan.is_empty:  # unreachable under PhaseStats; kept for safety
        return None

    filter_vars = set(head_filter.vars) if head_filter is not None else set()

    def scan(step) -> SubstSet:
        key = (step.atom, step.source)
        if head_filter is None and match_cache is not None:
            hit = match_cache.get(key)
            if hit is not None:
                return hit
        out = match(
            step.atom, sources(step.atom.predicate, step.source), store, False
        )
        if head_filter is not None and not out.is_empty():
            shared = tuple(v for v in out.vars if v in filter_vars)
            if shared:
                out = sjoin(head_filter, out, shared, store, False)
        if head_filter is None and match_cache is not None:
            match_cache[key] = out
        return out

    L = scan(plan.first)
    if L.is_empty():
        return None
    if head_filter is None:
        # feedback only for unfiltered scans: a head-filtered first scan
        # is deliberately tiny and says nothing about the estimate
        plan_cache.note_actual(
            (rule, pivot), plan.first.est_rows, L.n_substitutions()
        )
    for step in plan.joins:
        R = scan(step.scan)
        if R.is_empty():
            return None
        if step.kind == "sjoin":
            if step.filter_left:
                L = sjoin(R, L, step.key_vars, store, False)
            else:
                L = sjoin(L, R, step.key_vars, store, False)
        else:
            L = xjoin(L, R, step.key_vars, store)
        if L.is_empty():
            return None
    return L


def project_head(
    head: Atom,
    L: SubstSet,
    store: ColumnStore,
    *,
    multiplicity: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Project body substitutions onto the head.

    Returns ``(rows, counts)``: sorted unique head tuples and, with
    ``multiplicity=True``, how many distinct body substitutions derive
    each (the store is duplicate-free, so the per-row count is exact)."""
    var_idx = {v: L.vars.index(v) for v in head.variables()}
    n = L.n_substitutions()
    cols = []
    for t in head.terms:
        if isinstance(t, int):
            cols.append(torch.full((n,), t, dtype=_I64, device=store.device))
        else:
            cols.append(
                store.unfold_cat([ids[var_idx[t]] for ids, _ in L.items])
            )
    rows = torch.stack(cols, dim=1)
    if multiplicity:
        uniq, inv = unique_rows(rows, return_inverse=True)
        counts = torch.bincount(inv, minlength=uniq.shape[0]).to(_I64)
        return uniq, counts
    return unique_rows(rows), None
