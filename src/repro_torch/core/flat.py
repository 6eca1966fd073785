"""Flat semi-naive datalog engine (the RDFox/VLog-style baseline).

Facts are plain ``(n, arity)`` int64 tensors per predicate; joins enumerate
every matching pair.  This is the correctness oracle for the compressed
engine, so it runs on plain PyTorch operations only — never a hand kernel
(membership uses the plain ``sorted_member`` of :mod:`..kernels.ref`) —
and stays independent of the kernels it checks.

Rule bodies go through the same body compiler as the compressed engine;
only the atom order and the old/delta/all source partitions of the plan
are consumed here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..kernels import ref
from ..obs import get_registry, span
from ..obs.memory import register_reporter, tensor_nbytes
from .compile import ArrayStats, PlanCache, compile_body, stats_bucket
from .datalog import Program, Rule
from .util import (
    factorize_rows,
    merge_sorted_rows,
    multicol_member,
    resolve_device,
    unique_rows,
)

__all__ = ["FlatEngine", "flat_seminaive"]

_I64 = torch.int64


def _member(a_rows: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    return multicol_member(a_rows, b_rows, member=ref.sorted_member)


@dataclass
class _Table:
    """Substitution table: variable order + rows."""

    vars: tuple[str, ...]
    rows: torch.Tensor  # (n, len(vars))


def _match_flat(atom, rows: torch.Tensor) -> _Table | None:
    """Rows of a predicate matching an atom (constants / repeated vars)."""
    if rows.shape[0] == 0 or rows.shape[1] != len(atom.terms):
        return None
    mask = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    vars_ = atom.variables()
    first_pos = {v: atom.terms.index(v) for v in vars_}
    for pos, t in enumerate(atom.terms):
        if isinstance(t, int):
            mask &= rows[:, pos] == t
        elif pos != first_pos[t]:
            mask &= rows[:, pos] == rows[:, first_pos[t]]
    sel = rows[mask]
    if sel.shape[0] == 0:
        return None
    if not vars_:  # all-constant atom: an existence filter
        return _Table((), torch.zeros((sel.shape[0], 0), dtype=_I64,
                                      device=rows.device))
    cols = [sel[:, first_pos[v]] for v in vars_]
    return _Table(vars_, torch.stack(cols, dim=1))


def _join(left: _Table, right: _Table) -> _Table:
    """Vectorised equi-join on the shared variables."""
    dev = left.rows.device
    common = [v for v in left.vars if v in right.vars]
    out_vars = tuple(left.vars) + tuple(v for v in right.vars if v not in left.vars)
    l_idx = [left.vars.index(v) for v in common]
    r_idx = [right.vars.index(v) for v in common]
    r_extra_idx = [right.vars.index(v) for v in right.vars if v not in left.vars]

    l_keys = left.rows[:, l_idx]
    r_keys = right.rows[:, r_idx]
    codes_l, codes_r = factorize_rows(l_keys, r_keys)

    codes_r_s, r_perm = torch.sort(codes_r, stable=True)
    lo = torch.searchsorted(codes_r_s, codes_l, right=False)
    hi = torch.searchsorted(codes_r_s, codes_l, right=True)
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return _Table(out_vars, torch.zeros((0, len(out_vars)), dtype=_I64,
                                            device=dev))
    l_rep = torch.repeat_interleave(
        torch.arange(left.rows.shape[0], device=dev), counts
    )
    offsets = torch.cumsum(counts, 0) - counts
    within = torch.arange(total, device=dev) - torch.repeat_interleave(
        offsets, counts
    )
    r_sel = r_perm[torch.repeat_interleave(lo, counts) + within]
    out = torch.cat(
        [left.rows[l_rep], right.rows[r_sel][:, r_extra_idx]], dim=1
    )
    return _Table(out_vars, out)


class FlatEngine:
    """Semi-naive materialisation over flat fact tensors.

    ``device=None`` runs on the card and raises where there is none."""

    def __init__(
        self,
        program: Program,
        max_rounds: int = 10_000,
        plan_bodies: bool = True,
        plan_cache: PlanCache | None = None,
        fused: bool = True,
        device: torch.device | str | None = None,
    ):
        # ``fused=True`` (default): one joint factorisation per
        # (predicate, round) drives dedup and a positional merge of the
        # survivors; ``fused=False`` re-sorts the whole table per round.
        # Both keep ``facts[pred]`` lex-sorted unique.
        self.device = resolve_device(device)
        self.program = program
        self.max_rounds = max_rounds
        self.plan_bodies = plan_bodies
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.fused = fused
        self.facts: dict[str, torch.Tensor] = {}
        self.rounds = 0
        self.time_total = 0.0
        self._rule_ids: dict[Rule, int] = {}
        for k, rule in enumerate(program):
            self._rule_ids.setdefault(rule, k)
        self._journal = None  # bound per materialise when recording is on
        # provenance: per-predicate (round, fresh rows) log, the flat
        # engine's round tags (its tables carry no per-row round)
        self._prov_fresh: dict[str, list[tuple[int, torch.Tensor]]] = {}
        self._explicit: dict[str, torch.Tensor] = {}
        register_reporter("flat", self)

    def memory_report(self) -> dict[str, int]:
        return {
            "facts_bytes": sum(tensor_nbytes(r) for r in self.facts.values()),
            "n_predicates": len(self.facts),
        }

    def load(self, dataset) -> None:
        for pred, rows in dataset.items():
            rows = torch.as_tensor(rows, dtype=_I64).to(self.device)
            if rows.dim() == 1:
                rows = rows.reshape(-1, 1)
            self.facts[pred] = unique_rows(rows)
            self._explicit[pred] = self.facts[pred]

    def materialise(self) -> dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        from ..obs.provenance import get_journal

        journal = get_journal()
        self._journal = journal if journal.enabled else None
        if self._journal is not None:
            journal.attach_program(self.program)
            self._prov_fresh = {p: [(0, r)] for p, r in self.facts.items()}
        delta = dict(self.facts)
        rounds = 0
        with span("flat.materialise"):
            while delta and rounds < self.max_rounds:
                rounds += 1
                with span("flat.round", round=rounds):
                    stats_view = ArrayStats(self.facts)
                    derived: dict[str, list[torch.Tensor]] = {}
                    pending: list[dict] = []
                    for rule in self.program:
                        for i in range(len(rule.body)):
                            t_app = (
                                time.perf_counter_ns()
                                if self._journal is not None
                                else 0
                            )
                            rows = self._eval(rule, i, delta, stats_view)
                            if rows is not None and rows.shape[0]:
                                if self._journal is not None:
                                    pending.append({
                                        "rule_id": self._rule_ids.get(rule, -1),
                                        "pivot": i,
                                        "pred": rule.head.predicate,
                                        "rows": rows,
                                        "time_ns": time.perf_counter_ns() - t_app,
                                    })
                                derived.setdefault(
                                    rule.head.predicate, []
                                ).append(rows)
                    watermarks = (
                        {
                            p: int(self.facts[p].shape[0]) if p in self.facts else 0
                            for p in derived
                        }
                        if self._journal is not None
                        else {}
                    )
                    if self.fused:
                        delta = self._absorb_fused(derived)
                    else:
                        delta = self._absorb_per_step(derived)
                    if self._journal is not None:
                        self._record_round(pending, delta, watermarks, rounds)
        self.rounds = rounds
        self.time_total = time.perf_counter() - t0
        reg = get_registry()
        reg.counter("flat.rounds").inc(rounds)
        reg.counter("flat.time_total").inc(self.time_total)
        if self.fused:
            reg.counter("flat.fused_rounds").inc(rounds)
        if self._journal is not None:
            self._journal.publish()
        return self.facts

    def _record_round(
        self,
        pending: list[dict],
        fresh: dict[str, torch.Tensor],
        watermarks: dict[str, int],
        round_no: int,
    ) -> None:
        """Resolve the round's rule applications into journal records:
        ``n_new`` credits each application with the fresh rows it emitted
        (co-deriving rules both get credit); ``row_span`` carries the
        predicate's table watermarks across the absorb."""
        from ..obs.provenance import DerivationRecord

        for pred, rows in fresh.items():
            self._prov_fresh.setdefault(pred, []).append((round_no, rows))
        for p in pending:
            pred = p["pred"]
            f = fresh.get(pred)
            if f is None or f.shape[0] == 0:
                n_new = 0
            else:
                n_new = int(_member(f, p["rows"]).sum())
            after = self.facts.get(pred)
            self._journal.record(DerivationRecord(
                kind="apply",
                engine="flat",
                stratum=-1,  # the flat oracle runs unstratified
                round=round_no,
                rule_id=p["rule_id"],
                pivot=p["pivot"],
                pred=pred,
                n_emitted=int(p["rows"].shape[0]),
                n_new=n_new,
                row_span=(
                    watermarks.get(pred, 0),
                    0 if after is None else int(after.shape[0]),
                ),
                epoch=self._journal.epoch,
                time_ns=p["time_ns"],
            ))

    def explain_fact(self, pred: str, terms, decode=None) -> dict | None:
        """Verified proof tree over the flat materialisation (the
        per-round fresh log gives round tags when recording was on;
        without it every fact is at round 0 and recursive explanations
        may be unavailable)."""
        from ..obs.provenance import Explainer, get_journal

        ex = Explainer.from_flat(
            self.program, self.facts,
            fresh_log=self._prov_fresh or None,
            explicit=self._explicit,
            journal=get_journal(), decode=decode,
        )
        return ex.explain(pred, terms)

    def _absorb_per_step(self, derived: dict) -> dict[str, torch.Tensor]:
        """Round tail by re-sorting: unique candidates, anti-join, then
        a full-table unique per predicate."""
        new_delta: dict[str, torch.Tensor] = {}
        for pred, blocks in derived.items():
            cand = torch.unique(torch.cat(blocks), dim=0)
            old = self.facts.get(pred)
            if old is not None and old.shape[0]:
                fresh = cand[~_member(cand, old)]
            else:
                fresh = cand
            if fresh.shape[0]:
                new_delta[pred] = fresh
                self.facts[pred] = (
                    torch.cat([old, fresh])
                    if old is not None and old.numel()
                    else fresh
                )
        for pred in new_delta:
            self.facts[pred] = torch.unique(self.facts[pred], dim=0)
        return new_delta

    def _absorb_fused(self, derived: dict) -> dict[str, torch.Tensor]:
        """Fused round tail: the facts table stays lex-sorted unique, so
        one joint factorisation per predicate gives the anti-join (sorted
        membership against the already-sorted codes) and the placement of
        a positional merge of the survivors."""
        new_delta: dict[str, torch.Tensor] = {}
        rows_in = rows_fresh = 0
        with span("flat.fused_absorb", preds=len(derived)) as sp:
            for pred, blocks in derived.items():
                cand = unique_rows(
                    blocks[0] if len(blocks) == 1 else torch.cat(blocks)
                )
                rows_in += int(cand.shape[0])
                old = self.facts.get(pred)
                if old is None or old.shape[0] == 0:
                    if cand.shape[0]:
                        rows_fresh += int(cand.shape[0])
                        new_delta[pred] = cand
                        self.facts[pred] = cand
                    continue
                codes_cand, codes_old = factorize_rows(cand, old)
                # facts are lex-sorted and codes order-consistent, so
                # codes_old is already ascending
                keep = ~ref.sorted_member(codes_cand, codes_old)
                fresh = cand[keep]
                if fresh.shape[0] == 0:
                    continue
                rows_fresh += int(fresh.shape[0])
                new_delta[pred] = fresh
                self.facts[pred] = merge_sorted_rows(
                    old, fresh, codes_old, codes_cand[keep]
                )
            sp.set(rows_in=rows_in, rows_fresh=rows_fresh)
        return new_delta

    def _source_rows(self, pred: str, source: str, delta: dict):
        """The plan's old/delta/all partitions over flat tensors."""
        if source == "delta":
            return delta.get(pred)
        allr = self.facts.get(pred)
        if source == "all" or allr is None:
            return allr
        # old = M \ Delta: facts minus the delta rows
        d = delta.get(pred)
        if d is None or d.shape[0] == 0:
            return allr
        return allr[~_member(allr, d)]

    def _eval(
        self, rule: Rule, i: int, delta: dict, stats_view: ArrayStats
    ) -> torch.Tensor | None:
        plan = self.plan_cache.get(
            (rule, i),
            stats_bucket(stats_view, rule.body),
            lambda: compile_body(
                rule.body, stats_view, pivot=i, reorder=self.plan_bodies
            ),
        )
        if plan.is_empty:
            return None
        L: _Table | None = None
        for step in [plan.first] + [j.scan for j in plan.joins]:
            source = self._source_rows(step.atom.predicate, step.source, delta)
            if source is None or source.shape[0] == 0:
                return None
            R = _match_flat(step.atom, source)
            if R is None:
                return None
            L = R if L is None else _join(L, R)
            if L.rows.shape[0] == 0:
                return None
        cols = []
        for t in rule.head.terms:
            if isinstance(t, int):
                cols.append(torch.full((L.rows.shape[0],), t, dtype=_I64,
                                       device=L.rows.device))
            else:
                cols.append(L.rows[:, L.vars.index(t)])
        return torch.stack(cols, dim=1)


def flat_seminaive(program: Program, dataset, device: torch.device | str | None = None):
    """Convenience wrapper returning the deduplicated materialisation
    (``device=None``: the card; raises where there is none)."""
    eng = FlatEngine(program, device=device)
    eng.load(dataset)
    return eng.materialise()
