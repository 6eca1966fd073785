"""Plan executor: evaluates BGP plans directly over the compressed store.

The pipeline state is a :class:`~repro_torch.core.joins.SubstSet` — the
same meta-substitution working set the materialisation engine uses —
driven by the ``match`` / ``sjoin`` / ``xjoin`` primitives.  Everything a
query allocates (split survivors, cross-join groups) lands in a scratch
region of the column store and is released when the answers have been
extracted, so the frozen store does not grow across a query stream.

Instrumentation (the evidence for compressed answering):
:class:`ExecStats` records, per predicate, how many *flat rows* the query
materialised whole (``rows_scanned``, from indexed scans) and how many
column cells it fed flat into joins (``join_cells``: key columns for a
semi-join, every atom column for a cross-join), both against the
predicate's distinct stored size (``pred_rows`` / ``pred_cells``).

Constant-bound scans take the indexed path: the frozen snapshot's
per-column sort order is searched with the ``join_bounds`` kernel, which
touches only matching rows; residual constants filter the candidate
slice through :func:`repro_torch.kernels.lookup.in_set` (the
``sorted_member`` kernel).  Answers are tensors on the store's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..core.compress import compress_rows
from ..core.datalog import Atom
from ..core.frozen import FrozenFacts
from ..core.joins import SubstSet, _unfold_cols, match, sjoin, xjoin
from ..core.util import unique_rows
from ..kernels.lookup import in_set
from .ast import Query
from .plan import SCAN_INDEX, Plan, ScanStep

__all__ = ["ExecStats", "execute"]

_I64 = torch.int64


@dataclass
class ExecStats:
    """Per-query evaluation actuals."""

    #: whole flat rows materialised per predicate (indexed scans)
    rows_scanned: dict[str, int] = field(default_factory=dict)
    #: atom column cells fed flat into joins, per predicate (key columns
    #: for sjoin, all columns for xjoin; includes unfold-cache hits)
    join_cells: dict[str, int] = field(default_factory=dict)
    #: distinct stored fact count of every predicate the query touched
    #: (falls back to the with-multiplicity count until a snapshot exists)
    pred_rows: dict[str, int] = field(default_factory=dict)
    #: pred_rows * arity — cell-count denominator for join_cells
    pred_cells: dict[str, int] = field(default_factory=dict)
    #: pipeline-side cells fed flat into joins (intermediate results,
    #: not attributable to a single stored predicate)
    pipeline_cells: int = 0
    cells_unfolded: int = 0  # fresh store.unfold cells during evaluation
    cells_cached: int = 0  # unfold cells served from the unfold cache
    n_answers: int = 0
    time_s: float = 0.0

    def unfold_fractions(self) -> dict[str, float]:
        """rows_scanned / pred_rows per predicate (0 when never scanned flat)."""
        return {
            p: self.rows_scanned.get(p, 0) / n if n else 0.0
            for p, n in self.pred_rows.items()
        }

    def join_cell_fractions(self) -> dict[str, float]:
        """join_cells / pred_cells per predicate."""
        return {
            p: self.join_cells.get(p, 0) / n if n else 0.0
            for p, n in self.pred_cells.items()
        }

    def fully_unfolded(self) -> list[str]:
        """Predicates fully materialised flat: every stored row scanned
        whole, or every cell fed into a join."""
        out = []
        for p, n in self.pred_rows.items():
            if not n:
                continue
            if self.rows_scanned.get(p, 0) >= n or (
                self.pred_cells.get(p, 0)
                and self.join_cells.get(p, 0) >= self.pred_cells[p]
            ):
                out.append(p)
        return out


class _CountingStore:
    """ColumnStore proxy that meters ``unfold`` traffic for ExecStats."""

    def __init__(self, store, stats: ExecStats):
        self._store = store
        self._stats = stats

    def unfold(self, cid: int) -> torch.Tensor:
        cached = self._store.is_cached(cid)
        out = self._store.unfold(cid)
        if cached:
            self._stats.cells_cached += out.numel()
        else:
            self._stats.cells_unfolded += out.numel()
        return out

    def unfold_cat(self, cids) -> torch.Tensor:
        """Batched :meth:`unfold`, metered as the calls one by one would
        be."""
        return self._store.unfold_cat(cids, meter=self._meter)

    def _meter(self, cached: int, fresh: int) -> None:
        self._stats.cells_cached += cached
        self._stats.cells_unfolded += fresh

    def __getattr__(self, name):
        return getattr(self._store, name)


# --------------------------------------------------------------------- #
def execute(plan: Plan, frozen: FrozenFacts) -> tuple[torch.Tensor, ExecStats]:
    """Evaluate a plan on the store's device; returns ``(answers, stats)``.

    ``answers`` is a sorted, duplicate-free ``(n, len(projection))`` int64
    tensor; for ASK queries the shape is ``(1, 0)`` (true) or ``(0, 0)``.
    """
    stats = ExecStats()
    t0 = time.perf_counter()
    device = frozen.store.device
    if plan.is_empty:
        stats.time_s = time.perf_counter() - t0
        return _empty_answers(plan.query, device), stats

    store = frozen.store
    mark = store.mark()
    counting = _CountingStore(store, stats)
    try:
        L = _scan(plan.first, frozen, counting, stats)
        for step in plan.joins:
            if L.is_empty():
                break
            R = _scan(step.scan, frozen, counting, stats)
            _meter_join(stats, step, L, R)
            if step.kind == "sjoin":
                if step.filter_left:
                    L = sjoin(R, L, step.key_vars, counting)
                else:
                    L = sjoin(L, R, step.key_vars, counting)
            else:
                L = xjoin(L, R, step.key_vars, counting)
        answers = _project(plan.query, L, counting)
        stats.n_answers = int(answers.shape[0])
        stats.time_s = time.perf_counter() - t0
        return answers, stats
    finally:
        store.release(mark)


# --------------------------------------------------------------------- #
def _meter_join(stats: ExecStats, step, L: SubstSet, R: SubstSet) -> None:
    """Account the flat cells the join will materialise from each side:
    key columns for a semi-join, every column for a cross-join."""
    n_cols_r = len(R.vars) if step.kind == "xjoin" else len(step.key_vars)
    n_cols_l = len(L.vars) if step.kind == "xjoin" else len(step.key_vars)
    pred = step.scan.atom.predicate
    stats.join_cells[pred] = (
        stats.join_cells.get(pred, 0) + R.n_substitutions() * n_cols_r
    )
    stats.pipeline_cells += L.n_substitutions() * n_cols_l


def _scan(
    step: ScanStep,
    frozen: FrozenFacts,
    counting: _CountingStore,
    stats: ExecStats,
) -> SubstSet:
    atom = step.atom
    pred = atom.predicate
    if step.mode != SCAN_INDEX:
        # pure-variable atom: share the meta-fact columns wholesale —
        # match() emits (cols, length) pairs without unfolding anything.
        out = match(atom, frozen.meta_facts(pred), counting, inplace_splits=False)
        _record_pred_size(stats, frozen, pred)
        return out

    rows = _indexed_rows(frozen, atom, stats)
    _record_pred_size(stats, frozen, pred)
    vars_ = atom.variables()
    if not vars_:
        items = [((), int(rows.shape[0]))] if rows.shape[0] else []
        return SubstSet((), items)
    first_pos = {v: atom.terms.index(v) for v in vars_}
    cols = rows[:, [first_pos[v] for v in vars_]]
    if cols.shape[0] == 0:
        return SubstSet(vars_)
    return SubstSet(vars_, compress_rows(cols, counting))


def _record_pred_size(stats: ExecStats, frozen: FrozenFacts, pred: str) -> None:
    """Denominators for the unfolding evidence: the *distinct* stored row
    count once a snapshot exists, the represented count before —
    computing it must never force an unfold."""
    if frozen.has_snapshot(pred):
        n = int(frozen.snapshot(pred).shape[0])
    else:
        n = frozen.n_rows(pred)
    stats.pred_rows[pred] = n
    stats.pred_cells[pred] = n * frozen.arity(pred)


def _indexed_rows(frozen: FrozenFacts, atom: Atom, stats: ExecStats) -> torch.Tensor:
    """Flat snapshot rows matching an atom's constants / repeated vars,
    touching only the candidate range of the most selective constant."""
    pred = atom.predicate
    const_pos = [(pos, t) for pos, t in enumerate(atom.terms) if isinstance(t, int)]
    if const_pos:
        best_pos, best_val = min(
            const_pos, key=lambda pt: frozen.count_eq(pred, pt[0], pt[1])
        )
        rows = frozen.eq_slice(pred, best_pos, best_val)
    else:
        best_pos = -1
        rows = frozen.snapshot(pred)
    stats.rows_scanned[pred] = stats.rows_scanned.get(pred, 0) + int(rows.shape[0])

    mask = None
    for pos, value in const_pos:
        if pos == best_pos:
            continue
        constant = torch.full((1,), value, dtype=_I64, device=rows.device)
        hit = in_set(rows[:, pos], constant)
        mask = hit if mask is None else mask & hit
    vars_ = atom.variables()
    first_pos = {v: atom.terms.index(v) for v in vars_}
    for pos, t in enumerate(atom.terms):
        if isinstance(t, str) and pos != first_pos[t]:
            same = rows[:, pos] == rows[:, first_pos[t]]
            mask = same if mask is None else mask & same
    # no residual constraint: the slice itself, with no mask to read
    return rows if mask is None else rows[mask]


def _project(query: Query, L: SubstSet | None, counting: _CountingStore) -> torch.Tensor:
    device = counting.device
    if L is None or L.is_empty():
        return _empty_answers(query, device)
    if query.is_ask:
        return torch.zeros((1, 0), dtype=_I64, device=device)
    idx = [L.vars.index(v) for v in query.projection]
    rows = _unfold_cols(counting, L.items, idx)
    return unique_rows(rows)


def _empty_answers(query: Query, device) -> torch.Tensor:
    return torch.zeros((0, len(query.projection)), dtype=_I64, device=device)
