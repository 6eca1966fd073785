"""IncrementalStore: a live, updatable compressed materialisation.

``IncrementalStore`` wraps the compressed store built by
:class:`~repro_torch.core.engine.CMatEngine` and maintains ``mat(Pi, E)``
in place under explicit-fact update batches::

    inc = IncrementalStore(program)         # device=None: the card
    inc.load(dataset)                       # initial fixpoint (CMatEngine)
    stats = inc.apply(additions, deletions) # incremental maintenance
    frozen = inc.freeze()                   # epoch snapshot for queries

``apply`` runs a **deletion sweep** then an **insertion sweep**, each
stratum by stratum in the SCC topological order, so every stratum sees
final deltas from the strata below it.  Non-recursive strata maintain
exact per-fact **derivation counts** (the telescoping identity counts
every lost or gained rule instantiation once; facts whose count reaches
zero and are not explicit are deleted).  Recursive strata run
Delete/Rederive (:mod:`.dred`).

Derivation counts are int64 tensors aligned with the maintained
:class:`~repro_torch.incremental.index.RowIndex` rows and updated with
``index_add_``; rows, counts and the explicit set live on the store's
device.  All phase evaluation runs inside ``ColumnStore.mark`` /
``release`` scratch regions.  The host reads what the logic needs (the
sizes of masked row sets, one keep count per split predicate), never one
read per row.

Every batch appends to :attr:`journal` (bounded; entries hold Python
numbers, so :meth:`journal_bytes` counts what the JAX package's store
counts) and bumps :attr:`epoch`, which the serving layer stamps its
caches with.  :meth:`maybe_compact` runs GC/compaction epochs
(:mod:`repro_torch.storage.compact`).  With a write-ahead log attached
(:meth:`attach_wal`) every batch is logged before the store mutates.

This module also holds the update contract every maintenance engine
shares (:func:`normalise_batch`, :func:`effective_updates`).
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass

import torch

from ..core.compile import SRC_DELTA, SRC_OLD, PlanCache
from ..core.datalog import Program
from ..core.engine import CMatEngine, MaterialisationStats
from ..core.frozen import FrozenFacts
from ..core.joins import split_survivors
from ..core.metafacts import MetaFact
from ..core.program_graph import is_recursive, stratify, stratum_predicates
from ..core.util import multicol_member, resolve_device, segment_counts, unique_rows
from ..obs import publish_incremental, span
from ..obs.memory import register_reporter, split_owned_backed, tensor_nbytes
from .dred import dred_stratum
from .eval import PhaseStats, evaluate_rule, project_head, rows_to_metafacts
from .index import RowIndex, merge_rows

__all__ = [
    "IncrementalStats",
    "IncrementalStore",
    "effective_updates",
    "normalise_batch",
]

_I64 = torch.int64


@dataclass
class IncrementalStats(MaterialisationStats):
    """Per-``apply`` maintenance statistics (extends the engine stats)."""

    epoch: int = 0
    n_del_explicit: int = 0  # explicit facts removed from E
    n_add_explicit: int = 0  # explicit facts added to E
    n_overdeleted: int = 0   # facts entering the DRed overdeletion set
    n_rederived: int = 0     # overdeleted facts restored
    n_deleted: int = 0       # net facts removed from the materialisation
    n_inserted: int = 0      # net facts added to the materialisation
    n_count_updates: int = 0  # derivation-count entries updated
    counting_strata: int = 0  # strata maintained by exact count deltas
    dred_strata: int = 0      # strata maintained by Delete/Rederive
    time_overdelete: float = 0.0
    time_delete: float = 0.0
    time_rederive: float = 0.0
    time_counting: float = 0.0
    time_insert: float = 0.0
    journal_bytes: int = 0    # resident bytes of the (capped) journal


def normalise_batch(batch, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Canonical update batch: sorted-unique ``(n, arity)`` int64 rows per
    predicate on ``device`` (numpy arrays or tensors in), empty
    predicates dropped."""
    out: dict[str, torch.Tensor] = {}
    for pred, rows in (batch or {}).items():
        rows = torch.as_tensor(rows).to(device, torch.int64)
        if rows.dim() == 1:
            rows = rows.reshape(-1, 1)
        if rows.shape[0]:
            out[pred] = unique_rows(rows)
    return out


def effective_updates(
    explicit: dict[str, torch.Tensor],
    adds: dict[str, torch.Tensor],
    dels: dict[str, torch.Tensor],
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Clamp a normalised batch against the explicit set and update it in
    place (``E := (E \\ dels) ∪ adds``).

    Returns ``(eff_adds, eff_dels)``: deletions of non-explicit facts and
    additions of already-explicit facts are dropped, so batches are
    idempotent."""
    eff_dels: dict[str, torch.Tensor] = {}
    for pred, rows in dels.items():
        present = explicit.get(pred)
        if present is None or present.shape[0] == 0:
            continue
        rows = rows[multicol_member(rows, present)]
        if rows.shape[0]:
            eff_dels[pred] = rows
            explicit[pred] = present[~multicol_member(present, rows)]
    eff_adds: dict[str, torch.Tensor] = {}
    for pred, rows in adds.items():
        present = explicit.get(pred)
        if present is not None and present.shape[0]:
            rows = rows[~multicol_member(rows, present)]
        if rows.shape[0]:
            eff_adds[pred] = rows
            explicit[pred] = merge_rows(present, rows)
    return eff_adds, eff_dels


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=_I64, device=device)


def _weighted_unique(blocks):
    """Sorted unique rows of the ``(rows, counts)`` blocks, with the
    summed count of each."""
    all_rows = torch.cat([r for r, _ in blocks])
    all_cnts = torch.cat([c for _, c in blocks])
    uniq, inv = unique_rows(all_rows, return_inverse=True)
    summed = torch.zeros(uniq.shape[0], dtype=_I64, device=uniq.device)
    summed.index_add_(0, inv, all_cnts)
    return uniq, summed


class IncrementalStore:
    """Journalled insert/delete maintenance over the compressed store, on
    one device (``device=None``: the card; raises where there is none)."""

    def __init__(
        self,
        program: Program,
        *,
        counting: bool = True,
        plan_cache: PlanCache | None = None,
        journal_max: int = 1024,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self.program = program
        self.strata = stratify(program)
        self.engine = CMatEngine(program, device=self.device)
        self.facts = self.engine.facts
        self.store = self.engine.store
        self.rows = RowIndex(self.device)
        self.explicit: dict[str, torch.Tensor] = {}
        self.counting = counting
        #: derivation-count columns, aligned with ``rows`` (heads of
        #: non-recursive strata only; count = #one-step derivations from
        #: the current materialisation + 1 if explicit)
        self.counts: dict[str, torch.Tensor] = {}
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.epoch = 0
        #: bounded per-batch maintenance record
        self.journal: deque[dict] = deque(maxlen=max(journal_max, 1))
        self._journal_sizes: deque[int] = deque(maxlen=max(journal_max, 1))
        self._journal_nbytes = 0
        #: (n_nodes, MuUsage) of the last GC probe (see maybe_compact)
        self._gc_usage: tuple[int, object] | None = None
        self._round = 0
        self._head_preds = {r.head.predicate for r in program}
        self._counting_preds: set[str] = set()
        if counting:
            for stratum in self.strata:
                if not is_recursive(stratum):
                    self._counting_preds.update(r.head.predicate for r in stratum)
            # aligned-from-empty so apply() works on a never-loaded store
            self.counts = {
                p: torch.zeros(0, dtype=_I64, device=self.device)
                for p in self._counting_preds
            }
        self.arities: dict[str, int] = {}
        for rule in program:
            for atom in (rule.head, *rule.body):
                self.arities.setdefault(atom.predicate, atom.arity)
        self.stats_view = PhaseStats(self.facts, self.arities)
        #: write-ahead log every ``apply`` batch goes to before the store
        #: mutates (see :meth:`attach_wal`)
        self.wal = None
        #: publish-after-apply callbacks ``cb(store, stats)``, invoked at
        #: the end of every ``apply`` (after the epoch bump)
        self.publish_hooks: list = []
        # per-apply pre-update meta-fact snapshots (read by the phases)
        self.pre_mfs: dict[str, list] = {}
        # provenance (repro_torch.obs.provenance, distinct from the
        # maintenance journal above): bound per apply when recording is on
        self._pjournal = None
        self._cur_stratum = -1
        self._rule_ids = self.engine._rule_ids  # program positions
        #: the Explainer's tables, built at the first ``explain_fact`` and
        #: dropped by every mutation (``load``, ``apply``, ``compact``; a
        #: restore builds a new store)
        self._prov_tables = None
        # the store reports its side structures only; the ColumnStore
        # registers itself
        register_reporter("inc", self)

    # ------------------------------------------------------------------ #
    # initial build
    # ------------------------------------------------------------------ #
    def load(self, dataset) -> MaterialisationStats:
        """Compress and materialise the initial KB, then build the row
        index and derivation-count columns."""
        dataset = normalise_batch(dataset, self.device)
        self._drop_explain_tables()
        for pred, rows in dataset.items():
            self.explicit[pred] = rows
            self.arities.setdefault(pred, int(rows.shape[1]))
        self.engine.load(dataset)
        stats = self.engine.materialise()
        self._round = stats.rounds + 1
        for pred in list(self.facts.predicates()):
            self.rows.seed(pred, self.facts.unfold_pred(pred))
        if self.counting:
            self.counts = self.recompute_counts()
        return stats

    def recompute_counts(self) -> dict[str, torch.Tensor]:
        """Derivation counts from scratch (also the test oracle for the
        maintained ones)."""
        self.stats_view.refresh()
        counts = {
            p: torch.zeros(self.rows.n_rows(p), dtype=_I64, device=self.device)
            for p in self._counting_preds
        }

        def current(pred: str, src: str) -> list:
            return self.facts.all(pred)

        for stratum in self.strata:
            if is_recursive(stratum) or not self.counting:
                continue
            for rule in stratum:
                if not rule.body:
                    continue
                mark = self.store.mark()
                L = evaluate_rule(
                    rule, None, current, self.store, self.stats_view, self.plan_cache
                )
                if L is None:
                    self.store.release(mark)
                    continue
                rows, cnts = project_head(rule.head, L, self.store, multiplicity=True)
                self.store.release(mark)
                pred = rule.head.predicate
                counts[pred].index_add_(0, self.rows.positions(pred, rows), cnts)
        for pred in self._counting_preds:
            explicit = self.explicit.get(pred)
            if explicit is not None and explicit.shape[0]:
                present = explicit[self.rows.member_mask(pred, explicit)]
                if present.shape[0]:
                    counts[pred].index_add_(
                        0, self.rows.positions(pred, present),
                        _ones(present.shape[0], self.device),
                    )
        return counts

    # ------------------------------------------------------------------ #
    # store mutation primitives (shared by all phases)
    # ------------------------------------------------------------------ #
    def delete_rows(self, pred: str, rows: torch.Tensor) -> None:
        """Remove flat rows from the compressed store: one membership pass
        over the whole predicate (unfolds come from the cache), one host
        read of the keep count of every meta-fact; disjoint meta-facts
        stay shared, partially hit ones split copy-mode (one split per
        distinct column, all in one batch)."""
        mfs = self.facts.all(pred)
        if mfs:
            arity = mfs[0].arity
            all_rows = torch.stack(
                [
                    self.store.unfold_cat([mf.columns[j] for mf in mfs])
                    for j in range(arity)
                ],
                dim=1,
            )
            keep_all = ~multicol_member(all_rows, rows)
            kept = segment_counts(keep_all, [mf.length for mf in mfs])
            survivors = split_survivors(
                self.store, [(mf.columns, mf.length) for mf in mfs], keep_all, kept
            )
            new_list = []
            for mf, item in zip(mfs, survivors):
                if item is None:
                    continue
                if item[0] is mf.columns:  # untouched: shared as it is
                    new_list.append(mf)
                else:
                    new_list.append(MetaFact(pred, item[0], item[1], mf.round))
            self.facts.replace(pred, new_list)
        keep_mask = self.rows.remove(pred, rows)
        if pred in self.counts:
            self.counts[pred] = self.counts[pred][keep_mask]

    def add_rows(
        self,
        pred: str,
        rows: torch.Tensor,
        counts: torch.Tensor | None = None,
    ) -> list[MetaFact]:
        """Compress fresh rows into meta-facts, append them, and keep the
        row index (and count column, if any) aligned."""
        self._round += 1
        mfs = rows_to_metafacts(pred, rows, self.store, self._round)
        for mf in mfs:
            self.facts.add(mf)
        perm = self.rows.add(pred, rows)
        if pred in self.counts:
            new_counts = counts if counts is not None else _ones(rows.shape[0], self.device)
            self.counts[pred] = torch.cat([self.counts[pred], new_counts])[perm]
        return mfs

    # ------------------------------------------------------------------ #
    # the update entry point
    # ------------------------------------------------------------------ #
    def apply(self, additions=None, deletions=None) -> IncrementalStats:
        """Maintain ``mat(Pi, E)`` for ``E' = (E \\ deletions) ∪
        additions`` (numpy arrays or tensors per predicate); returns
        per-batch statistics.  Deletions of non-explicit facts and
        additions of already-explicit facts are ignored."""
        t_start = time.perf_counter()
        st = IncrementalStats()
        self._drop_explain_tables()
        from ..obs.provenance import get_journal

        pj = get_journal()
        self._pjournal = pj if pj.enabled else None
        if self._pjournal is not None:
            self._pjournal.begin_epoch(self.epoch + 1)
            self._pjournal.attach_program(self.program)
        adds = normalise_batch(additions, self.device)
        dels = normalise_batch(deletions, self.device)
        if self.wal is not None:
            # write-ahead: the record is durable before any mutation, so a
            # crash mid-apply recovers to the post-batch state
            self.wal.append(self.epoch + 1, adds, dels)

        with span(
            "inc.apply",
            epoch=self.epoch + 1,
            n_additions=sum(int(r.shape[0]) for r in adds.values()),
            n_deletions=sum(int(r.shape[0]) for r in dels.values()),
        ):
            # effective explicit deletions (E := E \ D), swept before the
            # additions clamp so a fact in both batches deletes then
            # re-adds
            _, eff_dels = effective_updates(self.explicit, {}, dels)
            st.n_del_explicit += sum(int(r.shape[0]) for r in eff_dels.values())
            if eff_dels:
                self.stats_view.refresh()
                with span("inc.deletion_sweep"):
                    self._deletion_sweep(eff_dels, st)

            # effective explicit additions (E := E ∪ A)
            for pred, rows in adds.items():
                self.arities.setdefault(pred, int(rows.shape[1]))
            eff_adds, _ = effective_updates(self.explicit, adds, {})
            st.n_add_explicit += sum(int(r.shape[0]) for r in eff_adds.values())
            if eff_adds:
                self.stats_view.refresh()
                with span("inc.insertion_sweep"):
                    self._insertion_sweep(eff_adds, st)

        self.epoch += 1
        st.epoch = self.epoch
        st.n_strata = len(self.strata)
        st.n_meta_facts = self.facts.n_meta_facts()
        st.n_facts = self.facts.n_facts()
        st.plan_cache = self.plan_cache.counters()
        st.time_total = time.perf_counter() - t_start
        self._journal_append(
            {
                "epoch": self.epoch,
                "del_explicit": st.n_del_explicit,
                "add_explicit": st.n_add_explicit,
                "overdeleted": st.n_overdeleted,
                "rederived": st.n_rederived,
                "deleted": st.n_deleted,
                "inserted": st.n_inserted,
                "counting_strata": st.counting_strata,
                "dred_strata": st.dred_strata,
                "time_s": st.time_total,
            }
        )
        st.journal_bytes = self.journal_bytes()
        publish_incremental(st)
        if self._pjournal is not None:
            self._pjournal.publish()
        for cb in self.publish_hooks:
            cb(self, st)
        return st

    def subscribe_publish(self, cb) -> None:
        """Register a publish-after-apply callback ``cb(store, stats)``."""
        self.publish_hooks.append(cb)

    def unsubscribe_publish(self, cb) -> None:
        if cb in self.publish_hooks:
            self.publish_hooks.remove(cb)

    def record_provenance(
        self,
        kind: str,
        pred: str,
        *,
        n_emitted: int = 0,
        n_new: int = 0,
        rule_id: int = -1,
        out_mfs=(),
        time_ns: int = 0,
    ) -> None:
        """Journal one maintenance-phase step (no-op unless recording is
        on).  The DRed phases call this to answer why a fact survived:
        ``survive_explicit`` / ``survive_backward`` / ``rederive`` records
        carry the restoring rule and the restored meta-facts."""
        j = self._pjournal
        if j is None:
            return
        from ..obs.provenance import DerivationRecord

        j.record(DerivationRecord(
            kind=kind,
            engine="inc",
            stratum=self._cur_stratum,
            round=self._round,
            rule_id=rule_id,
            pivot=-1,
            pred=pred,
            n_emitted=int(n_emitted),
            n_new=int(n_new),
            out_mf_ids=tuple(mf.mf_id for mf in list(out_mfs)[:16]),
            epoch=j.epoch,
            time_ns=time_ns,
        ))

    # ------------------------------------------------------------------ #
    # deletion sweep
    # ------------------------------------------------------------------ #
    def _deletion_sweep(self, dels: dict[str, torch.Tensor], st) -> None:
        # pre-deletion view: list snapshots are stable because deletion
        # splits copy (the original meta-facts keep their columns)
        self.pre_mfs = {p: list(self.facts.all(p)) for p in list(self.facts.predicates())}
        removed: dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        for pred, rows in dels.items():
            if pred in self._head_preds:
                continue  # handled by the predicate's stratum
            rows = rows[self.rows.member_mask(pred, rows)]
            if rows.shape[0]:
                self.delete_rows(pred, rows)
                removed[pred] = rows
                st.n_deleted += int(rows.shape[0])
                self.record_provenance("delete_explicit", pred, n_new=rows.shape[0])
        st.time_delete += time.perf_counter() - t0

        for s_idx, stratum in enumerate(self.strata):
            stratum_heads, body_preds = stratum_predicates(stratum)
            seeds = {p: removed[p] for p in body_preds if p in removed}
            head_dels = {p: dels[p] for p in stratum_heads if p in dels}
            if not seeds and not head_dels:
                continue
            self._cur_stratum = s_idx
            self.stats_view.refresh()
            if self.counting and not is_recursive(stratum):
                with span("inc.counting_delete", rules=len(stratum)):
                    net = self._counting_delete(stratum, seeds, head_dels, st)
                st.counting_strata += 1
            else:
                with span("inc.dred_stratum", rules=len(stratum)):
                    net = dred_stratum(self, stratum, seeds, head_dels, st)
                st.dred_strata += 1
            for pred, rows in net.items():
                removed[pred] = merge_rows(removed.get(pred), rows)

    def _delta_derivation_counts(self, stratum, seeds, st):
        """Per-head-predicate ``(rows, counts)`` blocks for the rule
        instantiations a delta gains or loses (the telescoping identity:
        pivot -> the delta, atoms before it -> the post-update view,
        atoms after -> the pre-update snapshot)."""
        acc: dict[str, list[tuple[torch.Tensor, torch.Tensor]]] = {}
        if not seeds:
            return acc
        mark = self.store.mark()
        delta_mfs = {p: rows_to_metafacts(p, r, self.store) for p, r in seeds.items()}

        def sources(pred: str, src: str) -> list:
            if src == SRC_DELTA:
                return delta_mfs.get(pred, [])
            if src == SRC_OLD:  # atoms before the pivot: new view
                return self.facts.all(pred)
            return self.pre_mfs.get(pred, [])  # after: old view

        match_cache: dict = {}
        for rule in stratum:
            if not rule.body:
                continue
            for i, atom in enumerate(rule.body):
                if atom.predicate not in delta_mfs:
                    continue
                L = evaluate_rule(
                    rule, i, sources, self.store, self.stats_view,
                    self.plan_cache, match_cache=match_cache,
                )
                st.n_rule_applications += 1
                if L is None:
                    continue
                rows, cnts = project_head(rule.head, L, self.store, multiplicity=True)
                acc.setdefault(rule.head.predicate, []).append((rows, cnts))
        self.store.release(mark)
        return acc

    def _counting_delete(self, stratum, seeds, head_dels, st):
        """Exact count-decrement maintenance for a non-recursive stratum:
        decrement by the lost derivations, delete facts reaching zero."""
        t0 = time.perf_counter()
        acc = self._delta_derivation_counts(stratum, seeds, st)
        for pred, rows in head_dels.items():
            rows = rows[self.rows.member_mask(pred, rows)]
            if rows.shape[0]:  # the fact loses its explicit support
                acc.setdefault(pred, []).append((rows, _ones(rows.shape[0], self.device)))

        net: dict[str, torch.Tensor] = {}
        for pred, blocks in acc.items():
            uniq, lost = _weighted_unique(blocks)
            pos = self.rows.positions(pred, uniq)
            self.counts[pred].index_add_(0, pos, -lost)
            st.n_count_updates += int(uniq.shape[0])
            dead = uniq[self.counts[pred][pos] <= 0]
            if dead.shape[0]:
                self.delete_rows(pred, dead)
                net[pred] = dead
                st.n_deleted += int(dead.shape[0])
            self.record_provenance(
                "count_delete", pred, n_emitted=uniq.shape[0], n_new=dead.shape[0]
            )
        st.time_counting += time.perf_counter() - t0
        return net

    # ------------------------------------------------------------------ #
    # insertion sweep
    # ------------------------------------------------------------------ #
    def _insertion_sweep(self, adds: dict[str, torch.Tensor], st) -> None:
        t_sweep = time.perf_counter()
        self.pre_mfs = {p: list(self.facts.all(p)) for p in list(self.facts.predicates())}
        added_mfs: dict[str, list] = {}
        added: dict[str, torch.Tensor] = {}

        def note_added(pred, rows, mfs):
            added[pred] = merge_rows(added.get(pred), rows)
            added_mfs.setdefault(pred, []).extend(mfs)
            st.n_inserted += int(rows.shape[0])

        for pred, rows in adds.items():
            if pred in self._head_preds:
                continue  # handled by the predicate's stratum
            mfs = self.add_rows(pred, rows)
            note_added(pred, rows, mfs)
            self.record_provenance(
                "insert_explicit", pred, n_new=rows.shape[0], out_mfs=mfs
            )

        for s_idx, stratum in enumerate(self.strata):
            stratum_heads, body_preds = stratum_predicates(stratum)
            seeds = {p: added_mfs[p] for p in body_preds if p in added_mfs}
            seed_rows = {p: added[p] for p in body_preds if p in added}
            head_adds = {p: adds[p] for p in stratum_heads if p in adds}
            if not seeds and not head_adds:
                continue
            self._cur_stratum = s_idx
            self.stats_view.refresh()
            if self.counting and not is_recursive(stratum):
                with span("inc.counting_insert", rules=len(stratum)):
                    self._counting_insert(stratum, seed_rows, head_adds, st, note_added)
                st.counting_strata += 1
            else:
                with span("inc.seminaive_insert", rules=len(stratum)):
                    self._seminaive_insert(stratum, seeds, head_adds, st, note_added)
                st.dred_strata += 1
        st.time_insert += time.perf_counter() - t_sweep

    def _counting_insert(self, stratum, seeds, head_adds, st, note_added):
        """Count-increment maintenance (the mirror of
        :meth:`_counting_delete`); facts whose count becomes positive
        enter the materialisation."""
        t0 = time.perf_counter()
        acc = self._delta_derivation_counts(stratum, seeds, st)
        for pred, rows in head_adds.items():
            acc.setdefault(pred, []).append((rows, _ones(rows.shape[0], self.device)))

        for pred, blocks in acc.items():
            uniq, gained = _weighted_unique(blocks)
            present = self.rows.member_mask(pred, uniq)
            n_present = int(present.sum())
            if n_present:
                pos = self.rows.positions(pred, uniq[present])
                self.counts[pred].index_add_(0, pos, gained[present])
            st.n_count_updates += int(uniq.shape[0])
            if n_present < uniq.shape[0]:
                fresh = uniq[~present]
                mfs = self.add_rows(pred, fresh, counts=gained[~present])
                note_added(pred, fresh, mfs)
                self.record_provenance(
                    "insert", pred, n_emitted=uniq.shape[0], n_new=fresh.shape[0],
                    out_mfs=mfs,
                )
        st.time_counting += time.perf_counter() - t0

    def _seminaive_insert(self, stratum, seeds, head_adds, st, note_added):
        """Semi-naive insertion for a recursive stratum: the added
        meta-facts are the delta; candidates are deduplicated against
        the row index."""
        delta_mfs: dict[str, list] = {p: list(m) for p, m in seeds.items()}
        for pred, rows in head_adds.items():
            fresh = rows[~self.rows.member_mask(pred, rows)]
            if fresh.shape[0]:
                mfs = self.add_rows(pred, fresh)
                delta_mfs.setdefault(pred, []).extend(mfs)
                note_added(pred, fresh, mfs)

        while delta_mfs:
            delta_ids = {id(mf) for lst in delta_mfs.values() for mf in lst}
            cur_delta = delta_mfs

            def sources(pred: str, src: str) -> list:
                if src == SRC_DELTA:
                    return cur_delta.get(pred, [])
                if src == SRC_OLD:
                    return [mf for mf in self.facts.all(pred) if id(mf) not in delta_ids]
                return self.facts.all(pred)

            mark = self.store.mark()
            match_cache: dict = {}
            derived: dict[str, list[torch.Tensor]] = {}
            for rule in stratum:
                if not rule.body:
                    continue
                for i, atom in enumerate(rule.body):
                    if atom.predicate not in delta_mfs:
                        continue
                    L = evaluate_rule(
                        rule, i, sources, self.store, self.stats_view,
                        self.plan_cache, match_cache=match_cache,
                    )
                    st.n_rule_applications += 1
                    if L is None:
                        continue
                    rows, _ = project_head(rule.head, L, self.store)
                    derived.setdefault(rule.head.predicate, []).append(rows)
                    self.record_provenance(
                        "apply", rule.head.predicate,
                        rule_id=self._rule_ids.get(rule, -1),
                        n_emitted=rows.shape[0],
                    )
            self.store.release(mark)

            new_delta: dict[str, list] = {}
            for pred, blocks in derived.items():
                cand = unique_rows(torch.cat(blocks))
                fresh = cand[~self.rows.member_mask(pred, cand)]
                if fresh.shape[0]:
                    mfs = self.add_rows(pred, fresh)
                    new_delta[pred] = mfs
                    note_added(pred, fresh, mfs)
                    self.record_provenance(
                        "insert", pred, n_emitted=cand.shape[0],
                        n_new=fresh.shape[0], out_mfs=mfs,
                    )
            delta_mfs = new_delta

    # ------------------------------------------------------------------ #
    # durability hooks and the journal
    # ------------------------------------------------------------------ #
    def attach_wal(self, wal) -> None:
        """Log every later ``apply`` batch to ``wal`` before the store
        mutates (recovery = snapshot + replay).  Attach only after any
        replay, or the replay would log itself again."""
        self.wal = wal

    def _journal_append(self, entry: dict) -> None:
        """Bounded append with a running byte count."""
        nbytes = len(json.dumps(entry))
        if self.journal.maxlen is not None and len(self.journal) == self.journal.maxlen:
            self._journal_nbytes -= self._journal_sizes[0]
        self.journal.append(entry)
        self._journal_sizes.append(nbytes)
        self._journal_nbytes += nbytes

    def truncate_journal(self) -> None:
        """Drop the in-memory journal."""
        self.journal.clear()
        self._journal_sizes.clear()
        self._journal_nbytes = 0

    def journal_bytes(self) -> int:
        """Resident bytes of the journal (JSON size of its scalar records,
        kept incrementally; the cap is ``journal_max``)."""
        return self._journal_nbytes

    def memory_report(self) -> dict[str, int]:
        """Byte reporter: the row index, the count columns, the explicit
        facts and the journal (the ColumnStore reports its nodes)."""
        idx = self.rows.memory_report()
        expl_owned, expl_backed = split_owned_backed(self.explicit.values())
        return {
            "index_bytes": idx["rows_bytes"],
            "index_snapshot_backed_bytes": idx["rows_snapshot_backed_bytes"],
            "counts_bytes": sum(tensor_nbytes(a) for a in self.counts.values()),
            "explicit_bytes": expl_owned,
            "explicit_snapshot_backed_bytes": expl_backed,
            "journal_bytes": self._journal_nbytes,
        }

    def mu_usage(self):
        """Dead-node accounting over the mu-store (deletion splits strand
        unreachable nodes; see :meth:`maybe_compact`)."""
        from ..storage.compact import mu_usage

        return mu_usage(self.facts)

    def compact(self):
        """Rebuild the reachable mu-DAG (hash-consing identical runs) and
        swap it in; answers and row indexes are unchanged."""
        from ..storage.compact import compact_store

        self._gc_usage = None
        self._drop_explain_tables()
        return compact_store(self)

    def maybe_compact(self, threshold: float = 0.5, min_nodes: int = 256,
                      growth: float = 1.1):
        """Run a compaction epoch when the dead-node fraction crosses
        ``threshold`` (and the store has at least ``min_nodes`` nodes).
        Returns the :class:`CompactionStats` or ``None``.  The
        reachability probe reruns only once the node count has grown by
        ``growth`` since the last below-threshold probe."""
        if threshold <= 0:
            return None
        n = self.store.n_nodes()
        if n < min_nodes:
            return None
        if self._gc_usage is not None and self._gc_usage[0] == n:
            usage = self._gc_usage[1]
        elif self._gc_usage is not None and n < growth * self._gc_usage[0]:
            return None  # barely grew since the last clean probe
        else:
            usage = self.mu_usage()
            self._gc_usage = (n, usage)
        if usage.dead_fraction < threshold:
            return None
        return self.compact()

    # ------------------------------------------------------------------ #
    # read side
    # ------------------------------------------------------------------ #
    def freeze(self, *, pin_meta: bool = False) -> FrozenFacts:
        """Epoch snapshot for query answering: the maintained row index
        seeds the sorted snapshots (shared, not copied: the index never
        writes into a tensor it handed out), so freezing costs no device
        work.  ``pin_meta=True`` also captures the meta-fact lists."""
        return FrozenFacts(self.facts, seed_rows=self.rows.views(), pin_meta=pin_meta)

    def to_dict(self) -> dict[str, torch.Tensor]:
        """Flat per-predicate materialisation (sorted unique rows)."""
        return self.rows.to_dict()

    def explain_fact(self, pred: str, terms, decode=None) -> dict | None:
        """Verified proof tree for a maintained fact
        (:mod:`repro_torch.obs.provenance`): works on a loaded, updated or
        restored store (rounds persist through snapshots; the journal is
        only a search accelerator).  The tables are kept until the next
        mutation."""
        from ..obs.provenance import Explainer, get_journal

        if self._prov_tables is None:
            self._prov_tables = Explainer.build_tables(self.facts)
        ex = Explainer(self.program, self._prov_tables, self.explicit,
                       journal=get_journal(), decode=decode)
        return ex.explain(pred, terms)

    def _drop_explain_tables(self) -> None:
        """Forget the Explainer's tables (this store's and its engine's)
        before a mutation."""
        self._prov_tables = None
        self.engine._prov_tables = None

    def check_integrity(self) -> None:
        """Test and debug invariants: the row index matches the unfolded
        store, and the maintained counts match a from-scratch recount."""
        unfolded = self.facts.to_dict()
        index = self.to_dict()
        preds = {p for p, r in unfolded.items() if r.shape[0]} | set(index)
        empty = torch.zeros((0, 1), dtype=_I64, device=self.device)
        for pred in preds:
            a = unfolded.get(pred, empty)
            b = index.get(pred, empty)
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"row index diverged for {pred!r}")
        if self.counting:
            for pred, want in self.recompute_counts().items():
                got = self.counts.get(pred, torch.zeros(0, dtype=_I64, device=self.device))
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"derivation counts diverged for {pred!r}: "
                        f"{got.tolist()} != {want.tolist()}"
                    )
