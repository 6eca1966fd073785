"""Algorithm 1: the CompMat semi-naive materialisation engine, on tensors.

The fixpoint loop runs on the host (the round count is data dependent and
small, as in the paper); per-round bulk work (compression, joins, dedup)
is column arithmetic on the engine's device.  On a card, the four steps
the TPU package wrote as Pallas kernels run as hand-written CUDA kernels
(:mod:`repro_torch.kernels`): leaf unfolds and pair enumeration through
``rle_expand``, membership through ``sorted_member``, span probes through
``join_bounds``, and the fused tail's fold into ``FactBuffers`` through
``merge_sorted_unique``.

Rule bodies are compiled through the shared body compiler
(:mod:`repro_torch.core.compile`); the fixpoint runs stratum by stratum
over the SCC condensation of the predicate dependency graph, and (rule,
pivot) pairs whose pivot predicate received no delta are skipped without
a match probe (``rule_applications_skipped``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..kernels import join_bounds, rle_expand
from ..obs import get_registry, publish_materialisation, span
from ..obs.memory import register_reporter, tensor_nbytes
from .columns import ColumnStore
from .compile import FactStoreStats, Plan, PlanCache, compile_body, stats_bucket
from .compress import compress_rows
from .datalog import Program, Rule
from .dedup import elim_dup
from .frozen import SortedRows
from .joins import SubstSet, _unfold_cols, match, sjoin, xjoin
from .metafacts import FactStore, MetaFact, flat_repr_size
from .program_graph import stratify
from .util import factorize_rows, resolve_device, unique_rows

__all__ = ["CMatEngine", "MaterialisationStats"]

#: below this many represented facts a constant-bound ``old`` scan just
#: re-matches the meta-fact lists; above it the sorted snapshot pays off
_OLD_SNAPSHOT_MIN_ROWS = 256

_I64 = torch.int64


class _OldPartitionSnapshots:
    """Sorted flat snapshots of per-predicate ``old`` partitions, merged
    forward one round at a time (a constant-bound scan is then one binary
    search + gather instead of unfolding and masking the partition)."""

    def __init__(self, store: ColumnStore):
        self.store = store
        self._snap: dict[str, SortedRows] = {}
        self._upto: dict[str, int] = {}  # rounds < upto are merged

    def get(self, facts: FactStore, pred: str) -> SortedRows:
        r = facts.current_round
        sr = self._snap.get(pred)
        upto = self._upto.get(pred, 0)
        if sr is None:
            sr = SortedRows(unique_rows(facts.unfold_pred(pred, "old")))
        elif upto < r:
            fresh = [mf for mf in facts.all(pred) if upto <= mf.round < r]
            if fresh:
                cols = [
                    self.store.unfold_cat([mf.columns[j] for mf in fresh])
                    for j in range(fresh[0].arity)
                ]
                merged = torch.cat([sr.rows, torch.stack(cols, dim=1)])
                sr = SortedRows(unique_rows(merged))
        self._snap[pred] = sr
        self._upto[pred] = r
        return sr


@dataclass
class MaterialisationStats:
    rounds: int = 0
    n_rule_applications: int = 0
    #: (rule, pivot) evaluations avoided without a match probe: the pivot
    #: predicate received no delta, or a body predicate is still empty
    rule_applications_skipped: int = 0
    n_strata: int = 0
    n_meta_facts: int = 0
    n_facts: int = 0
    #: constant-bound ``old`` scans served from sorted snapshots
    old_snapshot_scans: int = 0
    time_compress: float = 0.0
    time_match: float = 0.0
    time_join: float = 0.0
    time_dedup: float = 0.0
    time_total: float = 0.0
    per_round: list[dict] = field(default_factory=list)
    per_stratum: list[dict] = field(default_factory=list)
    plan_cache: dict = field(default_factory=dict)

    def dominant_phase(self) -> str:
        phases = {
            "compress": self.time_compress,
            "match": self.time_match,
            "join": self.time_join,
            "dedup": self.time_dedup,
        }
        return max(phases, key=phases.get)


class CMatEngine:
    """Compressed datalog materialisation (the paper's CMat, Algorithm 1).

    ``device=None`` runs on the card and raises where there is none; pass
    ``device="cpu"`` to run on the host with the kernels' plain versions.
    The other arguments keep the reference's meaning and defaults."""

    def __init__(
        self,
        program: Program,
        inplace_splits: bool = False,
        max_rounds: int = 10_000,
        dedup_index: bool = False,
        plan_bodies: bool = True,
        stratify_program: bool = True,
        plan_cache: PlanCache | None = None,
        snapshot_old_scans: bool = True,
        fused: bool = False,
        fused_max_pairs: int = 1 << 22,
        device: torch.device | str | None = None,
    ):
        # ``inplace_splits=True`` is the paper's Algorithm 4 accounting,
        # unsound in general (a split reaching a leaf shared with a
        # meta-fact whose other columns are not co-split permutes one
        # column); the default copies the survivors into fresh leaves.
        # ``plan_bodies=False`` keeps the strict left-to-right body order;
        # ``stratify_program=False`` runs every rule in every round.
        self.device = resolve_device(device)
        self.program = program
        self.store = ColumnStore(self.device)
        self.facts = FactStore(self.store)
        self.inplace_splits = inplace_splits
        self.max_rounds = max_rounds
        self.stats = MaterialisationStats()
        self.plan_bodies = plan_bodies
        self.stratify_program = stratify_program
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self._stats_view = FactStoreStats(self.facts)
        # snapshots record unfolding *values*; in-place splits redefine
        # node orderings mid-round, so the cache is only sound in copy mode
        self._old_snaps = (
            _OldPartitionSnapshots(self.store)
            if snapshot_old_scans and not inplace_splits
            else None
        )
        self._explicit: dict[str, torch.Tensor] = {}
        # ``fused=True``: rules whose plan ends in an xjoin (head arity
        # <= 2) emit flat head rows straight into a packed-code dedup
        # against a persistent ``FactBuffers`` index, and only the
        # genuinely-new survivors are compressed, once per predicate.
        # ``fused_max_pairs`` caps the transient flat join output; a wider
        # join falls back to the structure-shared xjoin.
        self.fused = fused
        self.fused_max_pairs = fused_max_pairs
        if fused:
            from ..kernels.buffers import FactBuffers

            self._dedup_index = FactBuffers(self.device)
        else:
            from .dedup import DedupIndex

            self._dedup_index = DedupIndex() if dedup_index else None
        # rule ids are program positions (shared by every engine and the
        # provenance journal); duplicates keep their first position
        self._rule_ids: dict[Rule, int] = {}
        for k, rule in enumerate(program):
            self._rule_ids.setdefault(rule, k)
        self._journal = None  # bound per materialise when recording is on
        #: the Explainer's tables, built at the first ``explain_fact`` and
        #: dropped by every mutation (``load``, ``materialise``)
        self._prov_tables = None
        register_reporter("cmat", self)

    def memory_report(self) -> dict[str, int]:
        """Explicit rows, lazy old-partition snapshots, and a
        ``DedupIndex`` (``FactBuffers`` reports itself)."""
        out = {
            "explicit_bytes": sum(
                tensor_nbytes(r) for r in self._explicit.values()
            ),
            "old_snapshot_bytes": (
                0
                if self._old_snaps is None
                else sum(sr.nbytes for sr in self._old_snaps._snap.values())
            ),
        }
        idx = self._dedup_index
        if idx is not None and not hasattr(idx, "memory_report"):
            out["dedup_index_bytes"] = idx.nbytes()
        return out

    # ------------------------------------------------------------------ #
    def load(self, dataset) -> None:
        """Compress the explicit dataset (numpy arrays or tensors, moved
        to the engine's device) into meta-facts (Alg. 1 lines 1-4)."""
        t0 = time.perf_counter()
        self._prov_tables = None
        for pred, rows in dataset.items():
            rows = torch.as_tensor(rows, dtype=_I64).to(self.device)
            if rows.dim() == 1:
                rows = rows.reshape(-1, 1)
            rows = unique_rows(rows)
            self._explicit[pred] = rows
            if self._dedup_index is not None:
                self._dedup_index.seed(pred, rows)
            for cols, length in compress_rows(rows, self.store):
                self.facts.add(MetaFact(pred, cols, length, round=0))
        self.stats.time_compress += time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    def materialise(self) -> MaterialisationStats:
        """Run the stratified semi-naive fixpoint (Alg. 1 lines 6-23):
        strata in dependency order; the first round of a stratum evaluates
        every rule over all facts, later rounds are delta-restricted."""
        t_start = time.perf_counter()
        from ..obs.provenance import get_journal

        journal = get_journal()
        self._journal = journal if journal.enabled else None
        if self._journal is not None:
            journal.attach_program(self.program)
        self._prov_tables = None
        strata = (
            stratify(self.program)
            if self.stratify_program
            else [list(self.program)]
        )
        self.stats.n_strata = len(strata)
        round_no = 0
        with span("cmat.materialise", n_strata=len(strata)):
            for si, stratum in enumerate(strata):
                naive = True
                s_rounds = 0
                s_round0 = len(self.stats.per_round)
                with span("cmat.stratum", stratum=si, rules=len(stratum)):
                    while round_no < self.max_rounds:
                        self.facts.current_round = round_no
                        if not naive and not self.facts.has_delta():
                            break
                        round_no += 1
                        s_rounds += 1
                        with span(
                            "cmat.round", round=round_no, stratum=si
                        ) as sp:
                            round_stats = self._round(
                                round_no, stratum, naive=naive,
                                stratum_idx=si,
                            )
                            sp.set(
                                new_facts=round_stats["new_facts"],
                                rule_applications=round_stats[
                                    "rule_applications"
                                ],
                            )
                        round_stats["stratum"] = si
                        self.stats.per_round.append(round_stats)
                        naive = False
                        if round_stats["new_meta_facts"] == 0:
                            break
                self.stats.per_stratum.append(
                    {
                        "stratum": si,
                        "rounds": s_rounds,
                        "rules": len(stratum),
                        "heads": sorted({r.head.predicate for r in stratum}),
                        "rule_applications": sum(
                            r["rule_applications"]
                            for r in self.stats.per_round[s_round0:]
                        ),
                    }
                )
        self.stats.rounds = round_no
        self.stats.n_meta_facts = self.facts.n_meta_facts()
        self.stats.n_facts = self.facts.n_facts()
        self.stats.plan_cache = self.plan_cache.counters()
        self.stats.time_total = time.perf_counter() - t_start
        publish_materialisation(self.stats)
        if self._journal is not None:
            self._journal.publish()
        return self.stats

    # ------------------------------------------------------------------ #
    def _round(
        self,
        round_no: int,
        rules: list[Rule],
        naive: bool = False,
        stratum_idx: int = 0,
    ) -> dict:
        facts, store = self.facts, self.store
        candidates: dict[str, list[tuple[tuple[int, ...], int]]] = {}
        flat_candidates: dict[str, list[torch.Tensor]] = {}
        match_cache: dict = {}
        n_apps = 0
        n_skipped = 0
        # provenance: one pending entry per rule application, resolved
        # into records once dedup has counted the survivors
        prov: list[dict] | None = [] if self._journal is not None else None
        self._stats_view.refresh()
        if naive:
            delta_preds = {p for p in facts.predicates() if facts.all(p)}
        else:
            delta_preds = {p for p in facts.predicates() if facts.delta(p)}

        def cached_match(atom, which: str) -> SubstSet:
            # naive-round plans are compiled with pivot=None, so every
            # scan reads "all"
            key = (atom.predicate, atom.terms, which)
            hit = match_cache.get(key)
            if hit is None:
                t0 = time.perf_counter()
                hit = self._snapshot_old_match(atom) if which == "old" else None
                if hit is None:
                    hit = match(
                        atom,
                        getattr(facts, which)(atom.predicate),
                        store,
                        self.inplace_splits,
                    )
                self.stats.time_match += time.perf_counter() - t0
                match_cache[key] = hit
            return hit

        for rule in rules:
            if not rule.body:  # body-less fact rule: nothing to evaluate
                continue
            # the naive round evaluates each rule once over all facts
            pivots = (0,) if naive else range(len(rule.body))
            for i in pivots:
                # semi-naive prefilter: no delta on the pivot predicate
                if rule.body[i].predicate not in delta_preds:
                    n_skipped += 1
                    continue
                plan = self._plan(rule, i, naive)
                if plan.is_empty:
                    n_skipped += 1
                    continue
                fused_tail = (
                    self.fused
                    and plan.joins
                    and plan.joins[-1].kind == "xjoin"
                    and len(rule.head.terms) <= 2
                )
                rid = self._rule_ids.get(rule, -1)
                t_app = time.perf_counter_ns() if prov is not None else 0
                with span(
                    "cmat.rule", head=rule.head.predicate, pivot=i,
                    rule_id=rid, stratum=stratum_idx,
                ):
                    if fused_tail:
                        result = self._eval_plan_fused(
                            plan, cached_match, rule,
                            (rule, None if naive else i),
                        )
                        if isinstance(result, torch.Tensor):
                            if result.shape[0]:
                                n_apps += 1
                                pred = rule.head.predicate
                                if prov is not None:
                                    prov.append({
                                        "rule_id": rid,
                                        "pivot": -1 if naive else i,
                                        "pred": pred,
                                        "path": "flat",
                                        "block": len(flat_candidates.get(pred, [])),
                                        "n_emitted": int(result.shape[0]),
                                        "in_ids": self._pivot_mf_ids(rule, i, naive),
                                        "time_ns": time.perf_counter_ns() - t_app,
                                    })
                                flat_candidates.setdefault(pred, []).append(result)
                            continue
                        # wide join fell back to the structure-shared path
                    else:
                        result = self._eval_plan(
                            plan, cached_match, (rule, None if naive else i)
                        )
                if result is None or result.is_empty():
                    continue
                n_apps += 1
                pred = rule.head.predicate
                g0 = len(candidates.get(pred, []))
                self._emit_head(rule, result, candidates)
                if prov is not None:
                    groups = candidates.get(pred, [])[g0:]
                    prov.append({
                        "rule_id": rid,
                        "pivot": -1 if naive else i,
                        "pred": pred,
                        "path": "mu",
                        "groups": (g0, g0 + len(groups)),
                        "n_emitted": int(sum(ln for _, ln in groups)),
                        "in_ids": self._pivot_mf_ids(rule, i, naive),
                        "time_ns": time.perf_counter_ns() - t_app,
                    })

        t0 = time.perf_counter()
        fresh_mu: dict[str, list[int]] | None = {} if prov is not None else None
        fresh_flat: dict[str, torch.Tensor] | None = {} if prov is not None else None
        with span("cmat.dedup", round=round_no):
            delta = elim_dup(candidates, facts, store, round_no,
                             self.inplace_splits, index=self._dedup_index,
                             fresh_counts=fresh_mu)
            if flat_candidates:
                delta.extend(self._dedup_flat(flat_candidates, round_no,
                                              fresh_counts=fresh_flat))
        self.stats.time_dedup += time.perf_counter() - t0

        # Alg. 1 line 23: re-compress length-one meta-facts
        t0 = time.perf_counter()
        with span("cmat.recompress", round=round_no):
            delta = self._recompress_singletons(delta, round_no)
        self.stats.time_compress += time.perf_counter() - t0

        for mf in delta:
            facts.add(mf)
        if prov:
            self._record_round(prov, fresh_mu, fresh_flat, delta, round_no, stratum_idx)
        self.stats.n_rule_applications += n_apps
        self.stats.rule_applications_skipped += n_skipped
        return {
            "round": round_no,
            "new_meta_facts": len(delta),
            "new_facts": sum(mf.length for mf in delta),
            "rule_applications": n_apps,
            "rule_applications_skipped": n_skipped,
        }

    # ------------------------------------------------------------------ #
    def _plan(self, rule: Rule, pivot: int, naive: bool) -> Plan:
        """Compile (rule, pivot) through the shared body compiler, cached
        per statistics bucket (naive rounds under their own key)."""
        sv = self._stats_view
        key = (rule, None if naive else pivot)
        bucket = stats_bucket(sv, rule.body)
        return self.plan_cache.get(
            key,
            bucket,
            lambda: compile_body(
                rule.body,
                sv,
                pivot=None if naive else pivot,
                reorder=self.plan_bodies,
            ),
        )

    # ------------------------------------------------------------------ #
    def _snapshot_old_match(self, atom) -> SubstSet | None:
        """Serve a constrained ``old``-partition scan from the sorted
        snapshot cache (``None``: take the meta-fact-list path)."""
        if self._old_snaps is None:
            return None
        vars_ = atom.variables()
        constrained = any(isinstance(t, int) for t in atom.terms) or len(
            vars_
        ) != len(atom.terms)
        if not constrained:
            return None  # pure-variable scans share columns for free
        pred = atom.predicate
        old = self.facts.old(pred)
        if not old or old[0].arity != len(atom.terms):
            return None
        if sum(mf.length for mf in old) < _OLD_SNAPSHOT_MIN_ROWS:
            return None
        rows = self._old_snaps.get(self.facts, pred).match_atom(atom)
        self.stats.old_snapshot_scans += 1
        if not vars_:
            items = [((), int(rows.shape[0]))] if rows.shape[0] else []
            return SubstSet((), items)
        first_pos = {v: atom.terms.index(v) for v in vars_}
        cols = rows[:, [first_pos[v] for v in vars_]]
        if cols.shape[0] == 0:
            return SubstSet(vars_)
        return SubstSet(vars_, compress_rows(cols, self.store))

    # ------------------------------------------------------------------ #
    def _join_step(self, L: SubstSet, step, cached_match) -> SubstSet | None:
        R = cached_match(step.scan.atom, step.scan.source)
        if R.is_empty():
            return None
        t0 = time.perf_counter()
        if step.kind == "sjoin":
            if step.filter_left:
                L = sjoin(R, L, step.key_vars, self.store, self.inplace_splits)
            else:
                L = sjoin(L, R, step.key_vars, self.store, self.inplace_splits)
        else:
            L = xjoin(L, R, step.key_vars, self.store)
        self.stats.time_join += time.perf_counter() - t0
        return None if L.is_empty() else L

    def _first_scan(self, plan: Plan, cached_match, plan_key) -> SubstSet | None:
        L = cached_match(plan.first.atom, plan.first.source)
        if L.is_empty():
            return None
        if plan_key is not None:
            # estimated-vs-actual feedback recalibrates the cached plan
            self.plan_cache.note_actual(
                plan_key, plan.first.est_rows, L.n_substitutions()
            )
        return L

    def _eval_plan(
        self, plan: Plan, cached_match, plan_key=None
    ) -> SubstSet | None:
        """Evaluate a compiled body plan (Alg. 1 lines 9-19, reordered)."""
        L = self._first_scan(plan, cached_match, plan_key)
        for step in plan.joins:
            if L is None:
                return None
            L = self._join_step(L, step, cached_match)
        return L

    # ------------------------------------------------------------------ #
    def _eval_plan_fused(
        self, plan: Plan, cached_match, rule: Rule, plan_key=None
    ) -> torch.Tensor | SubstSet | None:
        """Fused-tail evaluation: run the plan up to the final xjoin, then
        emit flat head rows (span probe -> pair gather -> head
        projection); the dedup half runs once per predicate in
        :meth:`_dedup_flat`.

        Returns an ``(n, arity)`` int64 tensor normally; a ``SubstSet``
        when the pair count exceeds ``fused_max_pairs`` (structure-shared
        fallback); ``None`` on an empty body."""
        L = self._first_scan(plan, cached_match, plan_key)
        for step in plan.joins[:-1]:
            if L is None:
                return None
            L = self._join_step(L, step, cached_match)
        if L is None:
            return None
        last = plan.joins[-1]
        R = cached_match(last.scan.atom, last.scan.source)
        if R.is_empty():
            return None
        t0 = time.perf_counter()
        with span("cmat.fused_tail", head=rule.head.predicate) as sp:
            rows = self._xjoin_head_rows(L, R, last.key_vars, rule.head, sp)
            sp.set(
                rows=0 if rows is None else int(rows.shape[0]),
                fallback=rows is None,
            )
        self.stats.time_join += time.perf_counter() - t0
        if rows is None:  # too wide: fall back to the compressed xjoin
            t0 = time.perf_counter()
            out = xjoin(L, R, last.key_vars, self.store)
            self.stats.time_join += time.perf_counter() - t0
            return None if out.is_empty() else out
        return rows

    def _xjoin_head_rows(
        self,
        left: SubstSet,
        right: SubstSet,
        key_vars: tuple[str, ...],
        head,
        sp=None,
    ) -> torch.Tensor | None:
        """Cross-join ``left`` x ``right`` on ``key_vars`` and project the
        rule head in one pass, returning flat ``(n, arity)`` rows.  The
        span probe is ``join_bounds``; the pair enumeration is two
        ``rle_expand`` launches.  ``None`` when the pair total exceeds
        ``fused_max_pairs`` (caller falls back to xjoin)."""
        store = self.store
        dev = self.device
        l_key_idx = [left.vars.index(v) for v in key_vars]
        r_key_idx = [right.vars.index(v) for v in key_vars]
        l_keys = _unfold_cols(store, left.items, l_key_idx)
        r_keys = _unfold_cols(store, right.items, r_key_idx)
        codes_l, codes_r = factorize_rows(l_keys, r_keys)
        codes_r_s, r_perm = torch.sort(codes_r, stable=True)
        lo, hi = join_bounds(codes_l.contiguous(), codes_r_s)
        counts = (hi - lo).to(_I64)
        total = int(counts.sum())
        if sp is not None:
            sp.set(pairs=total)
        if total == 0:
            return torch.zeros((0, len(head.terms)), dtype=_I64, device=dev)
        if total > self.fused_max_pairs:
            return None
        n_l = codes_l.shape[0]
        # pair t of left row i reads right row lo[i] + (t - offset[i])
        l_rep = rle_expand(torch.arange(n_l, device=dev), counts, total)
        offsets = torch.cumsum(counts, 0) - counts
        shift = rle_expand((lo.to(_I64) - offsets).contiguous(), counts, total)
        r_sel = r_perm[torch.arange(total, device=dev) + shift]
        # head projection straight from the unfolded sides
        head_vars = [t for t in head.terms if not isinstance(t, int)]
        l_need = [v for v in head_vars if v in left.vars]
        r_need = [v for v in head_vars if v not in left.vars]
        l_cols: dict[str, torch.Tensor] = {}
        r_cols: dict[str, torch.Tensor] = {}
        if l_need:
            unf = _unfold_cols(store, left.items,
                               [left.vars.index(v) for v in l_need])
            l_cols = {v: unf[:, j] for j, v in enumerate(l_need)}
        if r_need:
            unf = _unfold_cols(store, right.items,
                               [right.vars.index(v) for v in r_need])
            r_cols = {v: unf[:, j] for j, v in enumerate(r_need)}
        cols = []
        for t in head.terms:
            if isinstance(t, int):
                cols.append(torch.full((total,), t, dtype=_I64, device=dev))
            elif t in l_cols:
                cols.append(l_cols[t][l_rep])
            else:
                cols.append(r_cols[t][r_sel])
        return torch.stack(cols, dim=1)

    def _pivot_mf_ids(self, rule: Rule, pivot: int, naive: bool) -> tuple:
        """Input lineage of one application: the meta-fact ids of the
        pivot predicate's source partition (capped)."""
        pred = rule.body[pivot].predicate
        mfs = self.facts.all(pred) if naive else self.facts.delta(pred)
        return tuple(mf.mf_id for mf in mfs[:16])

    def _record_round(
        self,
        prov: list[dict],
        fresh_mu: dict[str, list[int]] | None,
        fresh_flat: dict[str, torch.Tensor] | None,
        delta: list[MetaFact],
        round_no: int,
        stratum_idx: int,
    ) -> None:
        """Resolve the round's pending applications into journal records:
        dedup's per-group (host) and per-block (device, read here in one
        transfer) survivor counts give each record its ``n_new``; the
        stored delta gives output meta-fact ids per head predicate."""
        from ..obs.provenance import DerivationRecord

        flat_counts: dict[str, list[int]] = {}
        if fresh_flat:
            preds = list(fresh_flat)
            sizes = [int(fresh_flat[p].shape[0]) for p in preds]
            every = torch.cat([fresh_flat[p] for p in preds]).tolist()
            off = 0
            for p, n in zip(preds, sizes):
                flat_counts[p] = every[off:off + n]
                off += n
        out_ids: dict[str, list[int]] = {}
        for mf in delta:
            out_ids.setdefault(mf.predicate, []).append(mf.mf_id)
        for p in prov:
            pred = p["pred"]
            if p["path"] == "mu":
                g0, g1 = p["groups"]
                n_new = int(sum((fresh_mu or {}).get(pred, [])[g0:g1]))
            else:
                counts = flat_counts.get(pred, [])
                b = p["block"]
                n_new = int(counts[b]) if b < len(counts) else 0
            self._journal.record(DerivationRecord(
                kind="apply",
                engine="cmat",
                stratum=stratum_idx,
                round=round_no,
                rule_id=p["rule_id"],
                pivot=p["pivot"],
                pred=pred,
                n_emitted=p["n_emitted"],
                n_new=n_new,
                in_mf_ids=p["in_ids"],
                out_mf_ids=tuple(out_ids.get(pred, [])[:16]),
                epoch=self._journal.epoch,
                time_ns=p["time_ns"],
            ))

    def _dedup_flat(
        self,
        flat_candidates: dict[str, list[torch.Tensor]],
        round_no: int,
        fresh_counts: dict[str, torch.Tensor] | None = None,
    ) -> list[MetaFact]:
        """Dedup the round's flat head rows against the persistent
        ``FactBuffers`` index (already updated by :func:`elim_dup` with
        this round's meta-fact survivors) and compress only the
        genuinely-new rows, once per predicate.  With ``fresh_counts``,
        each block's survivor count is stored per predicate as a device
        tensor (no host read here)."""
        delta: list[MetaFact] = []
        rows_in = rows_fresh = 0
        with span(
            "cmat.fused_dedup", round=round_no, preds=len(flat_candidates)
        ) as sp:
            for pred, blocks in sorted(flat_candidates.items()):
                rows = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
                rows_in += int(rows.shape[0])
                keep = self._dedup_index.fresh_mask(pred, rows)
                if keep is None:  # the fused-tail gate guarantees arity <= 2
                    raise RuntimeError("fused tail emitted unpackable arity")
                if fresh_counts is not None:
                    fresh_counts[pred] = torch.stack([
                        part.sum() for part in
                        torch.split(keep, [int(b.shape[0]) for b in blocks])
                    ])
                fresh = rows[keep]
                if fresh.shape[0] == 0:
                    continue
                rows_fresh += int(fresh.shape[0])
                # fresh_mask already dropped in-block duplicates
                for cols, length in compress_rows(fresh, self.store):
                    delta.append(MetaFact(pred, cols, length, round=round_no))
            sp.set(rows_in=rows_in, rows_fresh=rows_fresh)
        get_registry().counter("cmat.fused_rounds").inc()
        return delta

    # ------------------------------------------------------------------ #
    def explain(self, rule: Rule, pivot: int = 0) -> str:
        """Inspectable plan for one (rule, pivot) under current stats."""
        self._stats_view.refresh()
        return compile_body(
            rule.body, self._stats_view, pivot=pivot, reorder=self.plan_bodies
        ).explain()

    def explain_fact(self, pred: str, terms, decode=None) -> dict | None:
        """Verified proof tree for a materialised fact
        (:mod:`repro_torch.obs.provenance`): explicit facts are leaves,
        derived facts are re-derived step by step with the journal as a
        search accelerator.  The tables are kept until the next
        ``load`` or ``materialise``."""
        from ..obs.provenance import Explainer, get_journal

        if self._prov_tables is None:
            self._prov_tables = Explainer.build_tables(self.facts)
        ex = Explainer(self.program, self._prov_tables, self._explicit,
                       journal=get_journal(), decode=decode)
        return ex.explain(pred, terms)

    # ------------------------------------------------------------------ #
    def _emit_head(self, rule: Rule, L: SubstSet, candidates: dict) -> None:
        head = rule.head
        bucket = candidates.setdefault(head.predicate, [])
        var_idx = {v: L.vars.index(v) for v in head.variables()}
        for cols_ids, length in L.items:
            head_cols = []
            for t in head.terms:
                if isinstance(t, int):
                    head_cols.append(self.store.new_constant(t, length))
                else:
                    head_cols.append(cols_ids[var_idx[t]])
            bucket.append((tuple(head_cols), length))

    # ------------------------------------------------------------------ #
    def _recompress_singletons(
        self, delta: list[MetaFact], round_no: int
    ) -> list[MetaFact]:
        """Remove length-one meta-facts and re-compress them per predicate
        (Alg. 1 line 23) — critical for join speed in later rounds."""
        singles: dict[str, list[MetaFact]] = {}
        keep: list[MetaFact] = []
        for mf in delta:
            if mf.length == 1:
                singles.setdefault(mf.predicate, []).append(mf)
            else:
                keep.append(mf)
        for pred, mfs in singles.items():
            if len(mfs) == 1:
                keep.append(mfs[0])
                continue
            # one batched head-value gather per predicate
            cids = [c for mf in mfs for c in mf.columns]
            rows = self.store.head_values(cids).reshape(len(mfs), -1)
            for cols, length in compress_rows(rows, self.store):
                keep.append(MetaFact(pred, cols, length, round=round_no))
        return keep

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def materialisation(self) -> dict[str, torch.Tensor]:
        """Unfolded, deduplicated mat(Pi, E) — for testing/inspection."""
        return self.facts.to_dict()

    def report(self) -> dict:
        flat_mat = self.materialisation()
        explicit_size = flat_repr_size(
            {p: unique_rows(r) for p, r in self._explicit.items()}
        )
        return {
            "rounds": self.stats.rounds,
            "n_strata": self.stats.n_strata,
            "n_meta_facts": self.stats.n_meta_facts,
            "n_facts_explicit": int(sum(r.shape[0] for r in self._explicit.values())),
            "n_facts_materialised": int(
                sum(r.shape[0] for r in flat_mat.values())
            ),
            "flat_size_E": explicit_size,
            "flat_size_I": flat_repr_size(flat_mat),
            "compressed_size": self.facts.total_repr_size(),
            "mu_stats": self.facts.mu_stats(),
            "dominant_phase": self.stats.dominant_phase(),
            "rule_applications": self.stats.n_rule_applications,
            "rule_applications_skipped": self.stats.rule_applications_skipped,
            "old_snapshot_scans": self.stats.old_snapshot_scans,
            "plan_cache": dict(self.stats.plan_cache),
            "time_total": self.stats.time_total,
            "time_dedup": self.stats.time_dedup,
            "time_join": self.stats.time_join,
            "time_match": self.stats.time_match,
            "time_compress": self.stats.time_compress,
        }
