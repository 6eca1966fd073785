"""One body compiler: rule bodies and query bodies are the same problem.

A rule body under semi-naive evaluation and a BGP query body are both
conjunctions of atoms to be joined in some order; the only differences
are (a) a rule evaluation is anchored on a *delta pivot* — the atom that
must match the facts derived in the previous round, which is the small
side and therefore the right anchor — and (b) each rule atom reads a
*source partition* of the fact store (``old`` / ``delta`` / ``all``,
Algorithm 1's ``M \\ Delta`` bookkeeping) determined by its original
position relative to the pivot.

This module owns the pieces both sides share (column-oriented VLog,
arXiv 1511.08915, makes the same rule-body-as-query move):

* :class:`ScanStep` / :class:`JoinStep` / :class:`Plan` — the ordered,
  ``explain()``-able physical plan,
* :func:`estimate_rows` — per-atom cardinality estimation from cheap
  per-predicate statistics,
* :func:`compile_body` — greedy connected-selectivity ordering with
  per-step join-kind selection (semi-join when one side's variables
  cover the other's, structure-sharing cross-join otherwise) and, for
  single-key equi-joins, a *partition key* annotation telling the
  distributed executor which variable to co-partition the join on (a
  side whose stored first column already is that variable skips its
  pre-join ``all_to_all``),
* :func:`stats_bucket` / :class:`PlanCache` — plans are cached per
  (rule, pivot) and re-planned only when a body predicate's cardinality
  moves to a different power-of-two bucket,
* :class:`ArrayStats` / :class:`FactStoreStats` — statistics adapters so
  the flat, compressed, and distributed engines feed the same planner
  that ``FrozenFacts`` feeds at query time.

Any statistics provider must offer ``n_rows(pred)``, ``arity(pred)``,
and ``selectivity(pred, pos, value)`` — the ``FrozenFacts`` contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .datalog import Atom

__all__ = [
    "SCAN_SHARE",
    "SCAN_INDEX",
    "SRC_ALL",
    "SRC_DELTA",
    "SRC_OLD",
    "ScanStep",
    "JoinStep",
    "Plan",
    "estimate_rows",
    "compile_body",
    "stats_bucket",
    "PlanCache",
    "ArrayStats",
    "FactStoreStats",
]

#: selectivity discount for a repeated variable inside one atom
_REPEAT_DISCOUNT = 0.1

# scan modes ------------------------------------------------------------- #
#: share meta-fact columns wholesale (pure-variable atom, zero unfolding)
SCAN_SHARE = "share"
#: binary-search the frozen snapshot on the most selective constant
SCAN_INDEX = "index"

# fact-store source partitions (semi-naive bookkeeping) ------------------ #
SRC_ALL = "all"
SRC_DELTA = "delta"
SRC_OLD = "old"


def _atom_str(atom: Atom) -> str:
    terms = (f"?{t}" if isinstance(t, str) else str(t) for t in atom.terms)
    return f"{atom.predicate}({', '.join(terms)})"


@dataclass(frozen=True)
class ScanStep:
    atom: Atom
    mode: str  # SCAN_SHARE | SCAN_INDEX
    est_rows: float
    #: which partition of the fact store this atom reads (semi-naive);
    #: queries always read SRC_ALL
    source: str = SRC_ALL
    #: original position of the atom in the conjunction (-1: unknown)
    body_index: int = -1

    def __str__(self) -> str:
        src = "" if self.source == SRC_ALL else f" {self.source}"
        return (
            f"scan[{self.mode}]{src} {_atom_str(self.atom)} "
            f"(~{self.est_rows:.0f} rows)"
        )


@dataclass(frozen=True)
class JoinStep:
    scan: ScanStep
    kind: str  # "sjoin" | "xjoin"
    key_vars: tuple[str, ...]
    #: semi-join direction: True = the new atom filters the pipeline,
    #: False = the pipeline filters the new atom
    filter_left: bool = False
    #: the variable a distributed executor should co-partition both sides
    #: on for this join (the single equi-join key; ``None`` for cartesian
    #: or multi-key steps).  A side whose relation is already stored
    #: partitioned on this variable — it owns the atom's first term —
    #: needs no exchange before the local join.
    partition_key: str | None = None

    def __str__(self) -> str:
        key = ", ".join(self.key_vars) if self.key_vars else "(cartesian)"
        direction = ""
        if self.kind == "sjoin":
            direction = " filter=atom" if self.filter_left else " filter=pipeline"
        return f"{self.kind} on [{key}]{direction} <- {self.scan}"


@dataclass
class Plan:
    """Ordered physical plan over a conjunction of atoms.

    Shared by the query executor and all three materialisation engines;
    ``query``/``projection`` are populated on the request path only.
    """

    atoms: tuple[Atom, ...]  # the conjunction in original order
    first: ScanStep | None  # None => provably empty under current stats
    joins: list[JoinStep] = field(default_factory=list)
    pivot: int | None = None  # delta-anchored rule plans only
    projection: tuple[str, ...] | None = None
    query: object | None = None  # the Query on the request path

    @property
    def is_empty(self) -> bool:
        return self.first is None

    def atom_order(self) -> list[Atom]:
        if self.first is None:
            return []
        return [self.first.atom] + [j.scan.atom for j in self.joins]

    def explain(self) -> str:
        if self.query is not None:
            header = f"plan for: {self.query}"
        else:
            body = ", ".join(_atom_str(a) for a in self.atoms)
            pivot = f" [pivot={self.pivot}]" if self.pivot is not None else ""
            header = f"plan for body: {body}{pivot}"
        lines = [header]
        if self.first is None:
            lines.append("  <empty: body atom over an empty/unknown predicate>")
            return "\n".join(lines)
        lines.append(f"  1. {self.first}")
        for i, j in enumerate(self.joins, start=2):
            lines.append(f"  {i}. {j}")
        if self.projection is not None:
            lines.append(
                f"  {len(self.joins) + 2}. project ["
                + ", ".join(self.projection)
                + "]"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.explain()


# --------------------------------------------------------------------- #
# estimation
# --------------------------------------------------------------------- #
def estimate_rows(stats, atom: Atom) -> float:
    """Estimated matching rows for one atom (0 if the predicate is absent
    or its stored arity disagrees with the atom's)."""
    n = stats.n_rows(atom.predicate)
    if n == 0 or stats.arity(atom.predicate) != atom.arity:
        return 0.0
    est = float(n)
    vars_seen: set[str] = set()
    for pos, t in enumerate(atom.terms):
        if isinstance(t, int):
            est *= stats.selectivity(atom.predicate, pos, t)
        elif t in vars_seen:
            est *= _REPEAT_DISCOUNT
        else:
            vars_seen.add(t)
    return est


def _scan_step(atom: Atom, est: float, source: str, body_index: int) -> ScanStep:
    constrained = any(isinstance(t, int) for t in atom.terms) or len(
        set(atom.variables())
    ) != len(atom.terms)
    mode = SCAN_INDEX if constrained else SCAN_SHARE
    return ScanStep(atom, mode, est, source, body_index)


def _join_kind(bound: set[str], atom_vars: set[str]) -> tuple[str, bool]:
    """The join-kind dispatch shared by queries and rule evaluation."""
    if bound <= atom_vars:
        # the pipeline's vars are all in the new atom: pipeline filters
        # the atom's substitutions (semi-join keeps the atom side)
        return "sjoin", False
    if atom_vars <= bound:
        # the new atom only restricts existing bindings
        return "sjoin", True
    return "xjoin", False


# --------------------------------------------------------------------- #
# compilation
# --------------------------------------------------------------------- #
def compile_body(
    atoms: tuple[Atom, ...],
    stats,
    *,
    pivot: int | None = None,
    reorder: bool = True,
    projection: tuple[str, ...] | None = None,
    query=None,
) -> Plan:
    """Compile a conjunction of atoms into an ordered :class:`Plan`.

    ``pivot`` marks the delta atom of a semi-naive rule evaluation: it
    anchors the plan (the delta is the small side) and fixes each atom's
    source partition from its original position (``old`` before the
    pivot, ``delta`` at it, ``all`` after — Algorithm 1 lines 9-19).
    ``reorder=False`` keeps the original left-to-right order (the
    reference evaluation for differential testing) while still using the
    shared join-kind dispatch.
    """
    atoms = tuple(atoms)

    def source_of(j: int) -> str:
        if pivot is None:
            return SRC_ALL
        if j == pivot:
            return SRC_DELTA
        return SRC_OLD if j < pivot else SRC_ALL

    estimates = {i: estimate_rows(stats, a) for i, a in enumerate(atoms)}
    plan = Plan(atoms, None, pivot=pivot, projection=projection, query=query)
    if not atoms or any(
        stats.n_rows(a.predicate) == 0 or stats.arity(a.predicate) != a.arity
        for a in atoms
    ):
        return plan

    remaining = list(enumerate(atoms))
    if pivot is not None and reorder:
        # the delta atom anchors the plan: under semi-naive it is the
        # small side, so everything else joins against it
        first_idx, first_atom = remaining.pop(pivot)
    elif not reorder:
        first_idx, first_atom = remaining.pop(0)
    else:
        # constant-bound atoms outrank pure-variable ones (an indexed
        # scan touches only matching rows whatever the predicate size),
        # then most selective first (ties by body position)
        def _anchor_key(ia):
            i, a = ia
            has_const = any(isinstance(t, int) for t in a.terms)
            return (0 if has_const else 1, estimates[i], i)

        remaining.sort(key=_anchor_key)
        first_idx, first_atom = remaining.pop(0)

    plan.first = _scan_step(
        first_atom, estimates[first_idx], source_of(first_idx), first_idx
    )
    bound: set[str] = set(first_atom.variables())

    while remaining:
        if reorder:
            connected = [
                (i, a) for i, a in remaining if bound & set(a.variables())
            ]
            pool = connected if connected else remaining
            pool.sort(key=lambda ia: (estimates[ia[0]], ia[0]))
            idx, atom = pool[0]
            remaining.remove((idx, atom))
        else:
            idx, atom = remaining.pop(0)

        atom_vars = set(atom.variables())
        shared = tuple(v for v in atom.variables() if v in bound)
        kind, filter_left = _join_kind(bound, atom_vars)
        plan.joins.append(
            JoinStep(
                _scan_step(atom, estimates[idx], source_of(idx), idx),
                kind,
                shared,
                filter_left,
                partition_key=shared[0] if len(shared) == 1 else None,
            )
        )
        bound |= atom_vars
    return plan


# --------------------------------------------------------------------- #
# plan caching
# --------------------------------------------------------------------- #
def stats_bucket(stats, atoms) -> tuple[int, ...]:
    """Power-of-two cardinality bucket per body atom's predicate.  Plans
    stay valid while every predicate stays inside its bucket; a bucket
    shift (cardinalities moved materially) triggers a re-plan."""
    return tuple(int(stats.n_rows(a.predicate)).bit_length() for a in atoms)


#: estimated-vs-actual cardinality ratio beyond which a cached plan is
#: recalibrated (dropped, so the next ``get`` re-plans with fresh stats)
_FEEDBACK_RATIO = 4.0


class PlanCache:
    """Plans keyed by (rule, pivot), guarded by a statistics bucket.

    ``get`` returns the cached plan while the bucket matches; a changed
    bucket re-plans in place (counted as ``replans``).  Shareable across
    engines — the differential tests drive a warm cache through a second
    engine to prove cache hits cannot change results.

    **Feedback recalibration.**  Executors report per-plan actuals via
    :meth:`note_actual` (today: the first scan's matched substitutions
    against its ``est_rows``).  When the estimate is off by more than
    ``_FEEDBACK_RATIO`` in either direction, the entry is dropped so the
    next ``get`` re-plans against current statistics — catching drift
    *within* a power-of-two bucket, which the bucket guard cannot see.
    Each key recalibrates at most once per bucket (re-planning with
    unchanged stats reproduces the estimate, so repeating would thrash);
    the observed log2 ratio is kept in ``est_log2_ratio`` for reporting.
    """

    def __init__(self):
        self._plans: dict = {}
        self._calibrated: dict = {}  # key -> bucket already recalibrated
        self.est_log2_ratio: dict = {}  # key -> last observed log2 ratio
        self.hits = 0
        self.misses = 0
        self.replans = 0
        self.feedback_replans = 0

    def get(self, key, bucket: tuple[int, ...], build) -> Plan:
        entry = self._plans.get(key)
        if entry is not None and entry[0] == bucket:
            self.hits += 1
            return entry[1]
        if entry is None:
            self.misses += 1
        else:
            self.replans += 1
        plan = build()
        self._plans[key] = (bucket, plan)
        return plan

    def note_actual(self, key, est_rows: float, actual_rows: int) -> None:
        """Record a plan's estimated-vs-actual first-scan cardinality;
        drop the cached entry when the estimate is off by more than
        ``_FEEDBACK_RATIO`` (once per statistics bucket)."""
        entry = self._plans.get(key)
        if entry is None:
            return
        ratio = max(float(actual_rows), 1.0) / max(float(est_rows), 1.0)
        self.est_log2_ratio[key] = float(np.log2(ratio))
        if 1.0 / _FEEDBACK_RATIO <= ratio <= _FEEDBACK_RATIO:
            return
        bucket = entry[0]
        if self._calibrated.get(key) == bucket:
            return  # already recalibrated in this bucket; don't thrash
        self._calibrated[key] = bucket
        del self._plans[key]
        self.feedback_replans += 1

    def __len__(self) -> int:
        return len(self._plans)

    def counters(self) -> dict:
        return {
            "plan_hits": self.hits,
            "plan_misses": self.misses,
            "plan_replans": self.replans,
            "plan_feedback_replans": self.feedback_replans,
            "plans": len(self._plans),
        }


# --------------------------------------------------------------------- #
# statistics adapters (the FrozenFacts contract for the other engines)
# --------------------------------------------------------------------- #
class ArrayStats:
    """Planner statistics over flat ``{pred: (n, arity) tensor}`` facts
    (the FlatEngine working set)."""

    def __init__(self, facts: dict[str, np.ndarray]):
        self.facts = facts
        self._distinct: dict[tuple[str, int], int] = {}

    def n_rows(self, pred: str) -> int:
        rows = self.facts.get(pred)
        return 0 if rows is None else int(rows.shape[0])

    def arity(self, pred: str) -> int:
        rows = self.facts.get(pred)
        return 0 if rows is None or rows.shape[0] == 0 else int(rows.shape[1])

    def selectivity(self, pred: str, pos: int, value: int) -> float:
        n = self.n_rows(pred)
        if n == 0:
            return 0.0
        key = (pred, pos)
        distinct = self._distinct.get(key)
        if distinct is None:
            distinct = max(int(torch.unique(self.facts[pred][:, pos]).numel()), 1)
            self._distinct[key] = distinct
        return 1.0 / distinct

    def refresh(self) -> None:
        self._distinct.clear()


class FactStoreStats:
    """Planner statistics over a live (mid-materialisation)
    :class:`~repro_torch.core.metafacts.FactStore` — represented fact counts
    and RLE-run distinct estimates, computed without any unfolding
    (the same estimates ``FrozenFacts`` serves
    before a snapshot exists).  ``refresh()`` once per round."""

    def __init__(self, facts):
        self.facts = facts
        self._n_rows: dict[str, int] = {}
        self._runs: dict[tuple[str, int], int] = {}

    def n_rows(self, pred: str) -> int:
        cached = self._n_rows.get(pred)
        if cached is None:
            cached = sum(mf.length for mf in self.facts.all(pred))
            self._n_rows[pred] = cached
        return cached

    def arity(self, pred: str) -> int:
        mfs = self.facts.all(pred)
        return mfs[0].arity if mfs else 0

    def selectivity(self, pred: str, pos: int, value: int) -> float:
        if self.n_rows(pred) == 0:
            return 0.0
        key = (pred, pos)
        runs = self._runs.get(key)
        if runs is None:
            store = self.facts.store
            runs = max(
                sum(store.n_runs(mf.columns[pos]) for mf in self.facts.all(pred)),
                1,
            )
            self._runs[key] = runs
        return 1.0 / runs

    def refresh(self) -> None:
        self._n_rows.clear()
        self._runs.clear()
