"""Distributed semi-naive materialisation and DRed maintenance, one shard.

Port of ``repro/core/distributed.py``'s ``DistributedEngine`` at one shard
on one device (``device=None``: the card).  The reference hash-partitions
every relation across the ``data`` axis of a JAX mesh and runs each round
as one jitted ``shard_map`` call; this slice keeps its dataflow exactly at
one shard, eagerly:

* each predicate's state is a ``(capacity, arity)`` int32 row buffer on
  the device (empty slots hold ``EMPTY = -1``) with a ``count`` and a
  delta watermark ``delta_lo``: rows in ``[delta_lo, count)`` are the last
  round's delta, rows below it are old;
* each round evaluates one compiled ``(rule, pivot)`` plan per delta pivot
  (:mod:`.compile`), joins through :func:`join_on_key` (its spans come from
  the ``join_bounds`` kernel), dedups the candidates against the target
  buffer through :func:`dedup_against` (membership by the
  ``sorted_member`` kernel) and appends the fresh rows in first-occurrence
  order, so the buffers match the reference's row for row;
* a join bigger than ``join_capacity`` doubles the padding and retries the
  round (``exchange_regrows``), as the reference's exchange does;
* :meth:`DistributedEngine.apply` runs the reference's DRed phases
  (overdelete, delete, rederive, insert) over the same rounds.

Counts and watermarks are read back to the host once per round, together
with the round's sums (one read), and kept there: the host slices each
partition out of its buffer instead of masking the whole capacity.  The
codes are the reference's int32 16-bit-halves pairs, so constants must lie
in ``[0, MAX_DIST_CONST)``.

With the derivation journal on (:mod:`repro_torch.obs.provenance`), each
round records its schedule (one ``schedule`` record per ``(rule, pivot)``)
and each predicate's growth (an ``apply`` record tagged with its shard),
read from the host counts the round already holds; the DRed phases record
their overdeleted and rederived rows, and :meth:`check_integrity` merges
the shard records.

Not ported: several shards (a later slice takes them through
``torch.distributed`` ``all_to_all_single``; ``ROADMAP.md`` queue 1 item
11) and ``abstract_round`` (an XLA lowering hook with no torch twin).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..incremental import (
    effective_updates,
    explicit_restores,
    normalise_batch,
    setdiff_rows,
)
from ..kernels import join_bounds, sorted_member
from ..obs import instant, publish_distributed, span
from .compile import SRC_DELTA, SRC_OLD, PlanCache, compile_body, stats_bucket
from .datalog import Program
from .engine import MaterialisationStats
from .program_graph import stratify, stratum_predicates
from .util import resolve_device, unique_rows

__all__ = [
    "MAX_DIST_CONST",
    "DistributedEngine",
    "DistributedStats",
    "dedup_against",
    "join_on_key",
    "pack_pairs",
    "unpack_pairs",
]

EMPTY = -1
#: packed fact keys live in int32: binary facts use 15/16-bit halves, so
#: the engine takes dictionaries of < 32768 constants
MAX_DIST_CONST = 1 << 15
BIG = torch.iinfo(torch.int32).max
#: join-padding doublings one round may take before it gives up
MAX_REGROWS = 8
_I32 = torch.int32


@dataclass
class DistributedStats(MaterialisationStats):
    """Materialisation/maintenance statistics with the exchange-layer
    counters the host engines have no analogue for."""

    #: matching pairs enumerated by the local joins (the paper's "work")
    rows_joined: int = 0
    #: all_to_all calls issued (pre-join re-keying + head routing)
    exchanges: int = 0
    #: all_to_all calls avoided because the planner's partition key
    #: matched the storage sharding
    exchanges_skipped: int = 0
    #: rounds retried with doubled exchange/join padding after overflow
    exchange_regrows: int = 0
    # incremental maintenance (apply) counters
    epoch: int = 0
    n_del_explicit: int = 0
    n_add_explicit: int = 0
    n_overdeleted: int = 0
    n_rederived: int = 0
    n_deleted: int = 0
    n_inserted: int = 0


def _hash_shard_np(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Multiplicative hash -> shard id (batch routing, dataset loads)."""
    h = (keys.astype(np.uint32) * np.uint32(2654435761)) >> np.uint32(16)
    return (h % np.uint32(n_shards)).astype(np.int32)


# --------------------------------------------------------------------- #
# tensor primitives (the reference's jnp ones; kernels where it had them)
# --------------------------------------------------------------------- #
def pack_pairs(rows: torch.Tensor) -> torch.Tensor:
    """Pack (n, 2) int32 rows into sortable int32 keys; (n, 1) passes
    through.  An EMPTY row packs to -1."""
    if rows.shape[1] == 1:
        return rows[:, 0]
    return (rows[:, 0] << 16) | (rows[:, 1] & 0xFFFF)


def unpack_pairs(keys: torch.Tensor, arity: int) -> torch.Tensor:
    if arity == 1:
        return keys[:, None]
    return torch.stack([keys >> 16, keys & 0xFFFF], dim=1)


def dedup_against(new_keys: torch.Tensor, new_valid: torch.Tensor,
                  old_keys_sorted: torch.Tensor) -> torch.Tensor:
    """Valid-mask of new facts that are not already present in old (the
    membership test is the ``sorted_member`` kernel) and are the first
    occurrence of their key among the valid new facts."""
    member = sorted_member(new_keys.contiguous(), old_keys_sorted.contiguous())
    masked = torch.where(new_valid, new_keys, BIG)
    # first occurrence: a stable sort keeps the lowest index first
    ks, order = torch.sort(masked, stable=True)
    first_sorted = torch.ones_like(ks, dtype=torch.bool)
    first_sorted[1:] = ks[1:] != ks[:-1]
    first = torch.empty_like(first_sorted)
    first[order] = first_sorted
    return new_valid & first & ~member


def join_on_key(l_keys, l_valid, l_payload, r_keys, r_valid, r_payload,
                out_capacity: int):
    """Equi-join with bounded output.

    Returns ``(left payload, right payload, valid, total)`` for up to
    ``out_capacity`` matching pairs, enumerated as (left row) x (matching
    right rows); ``total`` (an int32 device scalar) is the true join size
    so the caller can detect truncation and regrow.  The spans of the left
    keys come from the ``join_bounds`` kernel."""
    dev = l_keys.device
    n, m = l_keys.shape[0], r_keys.shape[0]
    if n == 0 or m == 0:
        return (
            torch.zeros((out_capacity, l_payload.shape[1]), dtype=_I32, device=dev),
            torch.zeros((out_capacity, r_payload.shape[1]), dtype=_I32, device=dev),
            torch.zeros(out_capacity, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=_I32, device=dev),
        )
    r_keys_s, order = torch.sort(torch.where(r_valid, r_keys, BIG), stable=True)
    r_payload_s = r_payload[order]
    probe = torch.where(l_valid, l_keys, BIG - 1)
    lo, hi = join_bounds(probe.contiguous(), r_keys_s)
    counts = torch.where(l_valid, hi - lo, 0)
    ends = torch.cumsum(counts, 0, dtype=_I32)
    total = ends[-1]
    out_idx = torch.arange(out_capacity, dtype=_I32, device=dev)
    # which left row does output slot i belong to?
    l_of = torch.searchsorted(ends, out_idx, right=True).clamp_(max=n - 1)
    within = out_idx - (ends - counts)[l_of]
    r_of = (lo[l_of] + within).clamp_(max=m - 1)
    return l_payload[l_of], r_payload_s[r_of.long()], out_idx < total, total


def _apply_atom_constraints(atom, rows, valid):
    """Constants / repeated variables as validity-mask filters."""
    vars_ = atom.variables()
    first = {v: atom.terms.index(v) for v in vars_}
    for pos, t in enumerate(atom.terms):
        if isinstance(t, int):
            valid = valid & (rows[:, pos] == t)
        elif pos != first[t]:
            valid = valid & (rows[:, pos] == rows[:, first[t]])
    cols = [rows[:, first[v]] for v in vars_]
    return torch.stack(cols, dim=1), valid


def _project_head(body_vars, rows, head):
    cols = []
    for t in head.terms:
        if isinstance(t, int):
            cols.append(torch.full((rows.shape[0],), t, dtype=rows.dtype,
                                   device=rows.device))
        elif t in body_vars:
            cols.append(rows[:, body_vars.index(t)])
        else:
            return None
    return torch.stack(cols, dim=1)


class _SchemaStats:
    """Planner statistics from host-tracked global row counts.

    Cardinalities are clamped ``>= 1`` (a delta/maintenance plan must
    never compile to the empty plan just because a partition is
    currently empty — real emptiness is a host-side scheduling decision);
    arities come from the program/dataset schema."""

    def __init__(self, counts: dict[str, int], arities: dict[str, int]):
        self.counts = counts
        self.arities = arities

    def n_rows(self, pred: str) -> int:
        return max(int(self.counts.get(pred, 0)), 1)

    def arity(self, pred: str) -> int:
        return self.arities.get(pred, 0)

    def selectivity(self, pred: str, pos: int, value: int) -> float:
        return 1.0 / max(float(np.sqrt(self.n_rows(pred))), 1.0)


def _row_set(rows, arity: int) -> set[tuple[int, ...]]:
    rows = torch.as_tensor(rows).cpu().reshape(-1, arity)
    return set(map(tuple, rows.tolist()))


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
class DistributedEngine:
    """Semi-naive materialisation for binary datalog over padded device
    buffers, one shard.

    Supports the rule shapes of the reference: single-atom rules and
    two-atom single-key joins ``A(x,y), B(y,z) -> H(x,z)`` (plus unary
    variants), arity <= 2.  ``seminaive=False`` reproduces the naive
    iteration.  ``n_shards`` other than 1 raises
    :class:`NotImplementedError`.
    """

    def __init__(
        self,
        program: Program,
        device: torch.device | str | None = None,
        capacity: int = 1 << 14,
        join_capacity: int | None = None,
        seminaive: bool = True,
        n_shards: int = 1,
    ):
        if n_shards != 1:
            raise NotImplementedError(
                "the port's distributed engine runs one shard per process; "
                "several shards through torch.distributed all_to_all_single "
                "are a later slice (ROADMAP.md queue 1 item 11)"
            )
        self.program = program
        self.device = resolve_device(device)
        self.capacity = capacity
        self.join_capacity = join_capacity or capacity
        self.n_shards = n_shards
        self.seminaive = seminaive
        self._plan_cache = PlanCache()
        #: per-predicate state: pred -> [rows, count, delta_lo]
        self._state: dict[str, list] | None = None
        self._preds: tuple[str, ...] = ()
        self._arities: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        #: host-side explicit fact set (int64 rows; the apply() contract)
        self.explicit: dict[str, torch.Tensor] = {}
        self.stats = DistributedStats()
        self.rounds = 0
        self.epoch = 0
        #: join padding multiplier, doubled on overflow retries
        self._factor = 1
        #: True while an apply() sweep is in flight: a mid-sweep failure
        #: leaves the state and the explicit set inconsistent, so further
        #: applies are refused until the next materialise()
        self._dirty = False
        self._rule_ids: dict = {}
        for k, rule in enumerate(program):
            self._rule_ids.setdefault(rule, k)
        self._pjournal = None  # bound per materialise/apply when enabled

    def _record_dist(
        self,
        kind: str,
        pred: str,
        *,
        stratum: int = -1,
        round_no: int = 0,
        rule_id: int = -1,
        pivot: int = -1,
        n_new: int = 0,
        shard: int = -1,
    ) -> None:
        """Journal one host-visible event (no-op when recording is off):
        per-shard growth records carry the shard tag and are merged at
        :meth:`check_integrity`; schedule records carry the rule lineage
        (the round's device work has no per-rule emit counts)."""
        j = self._pjournal
        if j is None:
            return
        from ..obs.provenance import DerivationRecord

        j.record(DerivationRecord(
            kind=kind,
            engine="dist",
            stratum=stratum,
            round=round_no,
            rule_id=rule_id,
            pivot=pivot,
            pred=pred,
            n_new=int(n_new),
            shard=int(shard),
            epoch=j.epoch,
        ))

    def _bind_journal(self, epoch: int | None = None) -> None:
        from ..obs.provenance import get_journal

        journal = get_journal()
        self._pjournal = journal if journal.enabled else None
        if self._pjournal is not None:
            if epoch is not None:
                self._pjournal.begin_epoch(epoch)
            self._pjournal.attach_program(self.program)

    # -------------------------------------------------------------- #
    # routing (one shard: every row stays, in order)
    # -------------------------------------------------------------- #
    def _route(self, rows_by_pred: dict[str, torch.Tensor]) -> dict:
        """Host rows into padded device buffers ``(capacity, arity)`` +
        counts."""
        cap = self.capacity
        out = {}
        for pred, rows in rows_by_pred.items():
            if rows.dim() == 1:
                rows = rows.reshape(-1, 1)
            self._check_const_range(pred, rows)
            n, arity = rows.shape
            if n > cap:
                raise ValueError(f"capacity {cap} too small for shard 0")
            buf = torch.full((cap, arity), EMPTY, dtype=_I32, device=self.device)
            buf[:n] = rows.to(device=self.device, dtype=_I32)
            out[pred] = (buf, n)
        return out

    @staticmethod
    def _check_const_range(pred: str, rows: torch.Tensor) -> None:
        """Load-bearing for pack_pairs/BIG-sentinel correctness:
        out-of-range ids would silently corrupt packed join/dedup keys."""
        if rows.numel():
            lo, hi = int(rows.min()), int(rows.max())
            if lo < 0 or hi >= MAX_DIST_CONST:
                raise ValueError(
                    f"distributed engine requires constants in "
                    f"[0, {MAX_DIST_CONST}) — {pred!r} has values in "
                    f"[{lo}, {hi}]"
                )

    def _delta_count(self, pred: str) -> int:
        _, cnt, lo = self._state[pred]
        return cnt - lo

    # -------------------------------------------------------------- #
    # planning
    # -------------------------------------------------------------- #
    def _plan(self, rule, pivot, frozen: bool = False):
        """Compile (rule, pivot) through the shared body compiler;
        ``frozen`` plans (the apply sweeps) are compiled once and never
        re-planned."""
        sv = _SchemaStats(self._counts, self._arities)
        if frozen:
            plan = self._plan_cache.get(
                (rule, pivot, "frozen"),
                (0,),
                lambda: compile_body(rule.body, sv, pivot=pivot),
            )
        else:
            plan = self._plan_cache.get(
                (rule, pivot),
                stats_bucket(sv, rule.body),
                lambda: compile_body(rule.body, sv, pivot=pivot),
            )
        self._check_supported(rule, plan)
        return plan

    @staticmethod
    def supports_rule(rule) -> bool:
        """True iff the rule is in the engine's fragment: <= 2-atom body,
        and a two-atom body joins on exactly one shared variable."""
        if len(rule.body) > 2:
            return False
        if len(rule.body) == 2:
            common = set(rule.body[0].variables()) & set(
                rule.body[1].variables()
            )
            if len(common) != 1:
                return False
        return True

    @classmethod
    def supported_program(cls, program: Program) -> Program:
        """The sub-program inside the engine's fragment."""
        return type(program)([r for r in program if cls.supports_rule(r)])

    @staticmethod
    def _check_supported(rule, plan) -> None:
        if len(rule.body) > 2:
            raise NotImplementedError(
                "distributed engine supports bodies of <= 2 atoms"
            )
        if plan.is_empty:
            raise AssertionError("schema stats must never compile empty plans")
        if plan.joins and (
            len(plan.joins[0].key_vars) != 1
            or plan.joins[0].partition_key is None
        ):
            raise NotImplementedError(
                "distributed engine supports single-key two-atom joins"
            )
        for atom in (rule.head, *rule.body):
            for t in atom.terms:
                # rule constants are emitted on the device and never pass
                # through _route's range guard — check here
                if isinstance(t, int) and not 0 <= t < MAX_DIST_CONST:
                    raise ValueError(
                        f"distributed engine requires constants in "
                        f"[0, {MAX_DIST_CONST}); rule {rule} uses {t}"
                    )

    def _resolve(self, rule_pivots, frozen: bool = False) -> tuple:
        return tuple(
            (rule, pivot, self._plan(rule, pivot, frozen=frozen))
            for rule, pivot in rule_pivots
        )

    def _static_exchange_counts(self, pairs) -> tuple[int, int]:
        """How many all_to_all calls one round issues, and how many the
        planner's partition keys elide: none at one shard."""
        return 0, 0

    # -------------------------------------------------------------- #
    # one (rule, pivot) plan over the partitions
    # -------------------------------------------------------------- #
    def _trace_pair(self, rule, plan, part, emit, factor):
        """Evaluate one compiled (rule, pivot) body; emits its candidate
        head rows and returns ``(dropped, rows_joined)`` device scalars for
        a join (None for a single-atom body or an empty join side, which
        contribute nothing)."""
        head = rule.head
        steps = [plan.first] + [j.scan for j in plan.joins]
        if len(steps) == 1:
            st = steps[0]
            rows = part(st.atom.predicate, st.source)
            valid = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
            rows, valid = _apply_atom_constraints(st.atom, rows, valid)
            out = _project_head(st.atom.variables(), rows, head)
            if out is not None:
                emit(head.predicate, out, valid)
            return None

        key = plan.joins[0].partition_key
        sides = []
        for step in steps:
            rows = part(step.atom.predicate, step.source)
            if rows.shape[0] == 0:
                return None  # joins to nothing: no candidates, no pairs
            valid = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
            rows, valid = _apply_atom_constraints(step.atom, rows, valid)
            sides.append((rows, valid, step.atom.variables()))
        (ra, va, va_vars), (rb, vb, vb_vars) = sides
        ka = ra[:, va_vars.index(key)]
        kb = rb[:, vb_vars.index(key)]
        jcap = self.join_capacity * factor
        lpay, rpay, valid, total = join_on_key(ka, va, ra, kb, vb, rb, jcap)
        dropped = (total - jcap).clamp(min=0)
        var_cols = {v: lpay[:, i] for i, v in enumerate(va_vars)}
        for i, v in enumerate(vb_vars):
            var_cols.setdefault(v, rpay[:, i])
        cols = [
            torch.full((jcap,), t, dtype=_I32, device=lpay.device)
            if isinstance(t, int) else var_cols[t]
            for t in head.terms
        ]
        emit(head.predicate, torch.stack(cols, dim=1), valid)
        return dropped, total

    # -------------------------------------------------------------- #
    # rounds
    # -------------------------------------------------------------- #
    def _merge_block(self, trows, tcnt: int, rows, valid, restrict=None):
        """Dedup candidate rows against a target buffer (and optionally
        restrict them to a membership set), then append — the shared tail
        of every round/seed.  Returns ``(rows', cnt', fresh, overflow)``
        with the last three as int32 device scalars."""
        cap = trows.shape[0]
        keys = pack_pairs(rows).contiguous()
        tsorted = torch.sort(pack_pairs(trows[:tcnt])).values
        fresh = dedup_against(keys, valid, tsorted)
        if restrict is not None:
            rrows, rcnt = restrict
            rsorted = torch.sort(pack_pairs(rrows[:rcnt])).values
            fresh = fresh & sorted_member(keys, rsorted)
        csum = torch.cumsum(fresh, 0, dtype=_I32)
        n_fresh = fresh.sum(dtype=_I32)
        overflow = (tcnt + n_fresh - cap).clamp(min=0)
        dest = tcnt + csum - 1
        ok = fresh & (dest < cap)
        # rows that are not appended are parked in an extra last slot,
        # which is cut off: a write to cap - 1 would collide with a fresh
        # row there whenever an append exactly fills the buffer
        dest = torch.where(ok, dest, cap)
        buf = torch.cat([trows, torch.full_like(trows[:1], EMPTY)])
        buf[dest.long()] = torch.where(ok[:, None], rows, EMPTY)
        ncnt = (tcnt + n_fresh).clamp(max=cap)
        return buf[:cap], ncnt, n_fresh, overflow

    def _build_round(self, pairs, factor, *, acc=None, union_acc=False,
                     restrict=None):
        """One fixpoint round: evaluate every scheduled (rule, pivot) plan,
        dedup, append into the delta partitions — without committing.

        With ``acc`` the round evaluates against the read-only current
        materialisation while accumulating into ``acc``'s per-predicate
        buffers (the overdelete/rederive phases of ``apply``; with
        ``union_acc`` the accumulator is unioned into old/all reads, and
        ``restrict`` keeps only candidates inside a membership set).

        Returns ``(new_state, sums, merged)``: the new per-predicate
        ``[rows, count, delta_lo]`` (counts of the ``merged`` predicates
        still device scalars) and one int32 device vector ``[total_new,
        dropped, overflow, rows_joined, *counts of merged]``."""
        base = self._state
        dev = self.device

        def part(pred, src):
            if acc is None:
                rows, cnt, lo = base[pred]
                if src == SRC_DELTA:
                    return rows[lo:cnt]
                if src == SRC_OLD:
                    return rows[:lo]
                return rows[:cnt]
            arows, acnt, alo = acc[pred]
            if src == SRC_DELTA:
                return arows[alo:acnt]
            brows, bcnt = base[pred][0], base[pred][1]
            if union_acc:
                return torch.cat([brows[:bcnt], arows[:acnt]])
            return brows[:bcnt]

        derived: dict[str, list] = {}

        def emit(pred, rows, valid):
            derived.setdefault(pred, []).append((rows, valid))

        zero = torch.zeros((), dtype=_I32, device=dev)
        dropped, joined = zero, zero
        for rule, _pivot, plan in pairs:
            res = self._trace_pair(rule, plan, part, emit, factor)
            if res is not None:
                dropped = dropped + res[0]
                joined = joined + res[1]

        new_state, total_new, overflow, merged, counts = self._merge_derived(
            base if acc is None else acc, derived, restrict
        )
        sums = torch.stack([total_new, dropped, overflow, joined, *counts])
        return new_state, sums, merged

    def _merge_derived(self, target, derived, restrict=None):
        """Merge each predicate's candidate blocks ``derived[pred]`` (a
        list of ``(rows, valid)``) into its ``target`` buffer, as the new
        delta.  Returns ``(new_state, total_new, overflow, merged,
        counts)``: the device scalars are read by the caller, ``counts``
        are those of the ``merged`` predicates."""
        zero = torch.zeros((), dtype=_I32, device=self.device)
        new_state: dict[str, list] = {}
        merged, counts = [], []
        total_new, overflow = zero, zero
        for pred in self._preds:
            trows, tcnt, _tlo = target[pred]
            blocks = derived.get(pred)
            if not blocks:
                # no candidates: the delta still gets consumed
                new_state[pred] = [trows, tcnt, tcnt]
                continue
            rows = torch.cat([b[0] for b in blocks])
            valid = torch.cat([b[1] for b in blocks])
            rows = torch.where(valid[:, None], rows, EMPTY)
            nrows, ncnt, n_fresh, of = self._merge_block(
                trows, tcnt, rows, valid,
                restrict=None if restrict is None else restrict[pred],
            )
            total_new = total_new + n_fresh
            overflow = overflow + of
            new_state[pred] = [nrows, ncnt, tcnt]
            merged.append(pred)
            counts.append(ncnt)
        return new_state, total_new, overflow, merged, counts

    def _commit(self, new_state: dict[str, list]) -> None:
        self._state = new_state
        for p in self._preds:
            self._counts[p] = new_state[p][1]

    def _run_round(self, pairs, build):
        """Run one round (``build(factor)``); on join overflow, double the
        padding factor and retry the *same* inputs (rounds commit nothing).
        Returns ``(new_state, total_new, joined)`` with host counts."""
        n_ex, n_sk = self._static_exchange_counts(pairs)
        for _ in range(MAX_REGROWS + 1):
            new_state, sums, merged = build(self._factor)
            total_new, dropped, overflow, joined, *counts = sums.tolist()
            if overflow > 0:
                raise RuntimeError(
                    f"relation buffer overflow: {overflow} rows past "
                    f"capacity {self.capacity} — increase capacity"
                )
            if dropped == 0:
                for pred, cnt in zip(merged, counts):
                    new_state[pred][1] = cnt
                self.stats.exchanges += n_ex
                self.stats.exchanges_skipped += n_sk
                self.stats.rows_joined += joined
                return new_state, total_new, joined
            self._factor *= 2
            self.stats.exchange_regrows += 1
            instant("dist.exchange_regrow", factor=self._factor)
        raise RuntimeError(
            "exchange overflow persists after "
            f"{MAX_REGROWS} regrows — increase capacity/join_capacity"
        )

    def _mat_round(self, pairs):
        """One materialise/insert round over the live partitions."""
        new_state, total_new, joined = self._run_round(
            pairs, lambda f: self._build_round(pairs, f)
        )
        self._commit(new_state)
        return total_new, joined

    def _acc_round(self, acc, pairs, *, union_acc, restrict):
        """One accumulator round (overdelete / rederive phases)."""
        new_acc, total_new, _joined = self._run_round(
            pairs,
            lambda f: self._build_round(
                pairs, f, acc=acc, union_acc=union_acc, restrict=restrict
            ),
        )
        acc.update(new_acc)
        return total_new

    # -------------------------------------------------------------- #
    # host-side scheduling (the semi-naive skip logic)
    # -------------------------------------------------------------- #
    def _schedule(self, stratum, entry: bool, stable: bool = False):
        """(rule, pivot) pairs to evaluate this round + pairs skipped
        without a probe (no delta on the pivot, or an empty body
        predicate).  ``stable=True`` (the apply sweeps) schedules every
        pair."""
        pairs = []
        skipped = 0
        if stable:
            pairs = [
                (rule, i)
                for rule in stratum
                for i in range(len(rule.body))
            ]
            return self._resolve(pairs, frozen=True), 0
        if entry:
            # first round of a stratum: nothing of it ever ran, evaluate
            # each rule once over everything derived so far (pivot=None)
            for rule in stratum:
                if not rule.body:
                    continue
                if any(
                    self._counts.get(a.predicate, 0) == 0 for a in rule.body
                ):
                    skipped += 1
                    continue
                pairs.append((rule, None))
            return self._resolve(pairs), skipped
        delta_preds = {
            p for p in self._preds if self._delta_count(p) > 0
        }
        for rule in stratum:
            for i, atom in enumerate(rule.body):
                if atom.predicate not in delta_preds:
                    skipped += 1
                    continue
                if any(
                    self._counts.get(a.predicate, 0) == 0 for a in rule.body
                ):
                    skipped += 1
                    continue
                pairs.append((rule, i))
        return self._resolve(pairs), skipped

    def _stratum_fixpoint(
        self, si, stratum, max_rounds, *, naive_entry, sweep_lo=None,
        stable=False,
    ) -> tuple[int, bool]:
        """Run one stratum to its fixpoint; returns ``(rounds used,
        converged)`` — ``converged=False`` means the round budget ran out
        with work still pending.

        ``sweep_lo`` (incremental insertion sweeps) re-marks everything
        appended since the sweep started as this stratum's incoming
        delta."""
        heads, body_preds = stratum_predicates(stratum)
        if sweep_lo is not None:
            for p in self._preds:
                self._state[p][2] = sweep_lo[p]
        entry = naive_entry
        rounds = 0
        r0 = len(self.stats.per_round)
        with span("dist.stratum", stratum=si, rules=len(stratum)):
            while rounds < max_rounds:
                if not entry and self.seminaive:
                    if not any(
                        self._delta_count(p) > 0
                        for p in body_preds
                        if p in self._state
                    ):
                        break
                pairs, skipped = self._schedule(stratum, entry, stable=stable)
                self.stats.rule_applications_skipped += skipped
                if not pairs:
                    break
                round_no = len(self.stats.per_round) + 1
                rule_ids = sorted({
                    self._rule_ids.get(rule, -1) for rule, _p, _pl in pairs
                })
                # counts are host ints: the growth records read no device
                counts_before = (
                    dict(self._counts) if self._pjournal is not None else None
                )
                with span(
                    "dist.round",
                    round=round_no,
                    stratum=si,
                    rule_applications=len(pairs),
                    rule_ids=rule_ids,
                ) as sp:
                    total_new, joined = self._mat_round(pairs)
                    sp.set(new_facts=total_new, rows_joined=joined)
                if counts_before is not None:
                    for rule, pivot, _plan in pairs:
                        self._record_dist(
                            "schedule", rule.head.predicate,
                            stratum=si, round_no=round_no,
                            rule_id=self._rule_ids.get(rule, -1),
                            pivot=-1 if pivot is None else pivot,
                        )
                    for p in self._preds:
                        grow = self._counts[p] - counts_before[p]
                        if grow:
                            self._record_dist(
                                "apply", p, stratum=si, round_no=round_no,
                                n_new=grow, shard=0,
                            )
                rounds += 1
                self.stats.n_rule_applications += len(pairs)
                self.stats.per_round.append(
                    {
                        "round": len(self.stats.per_round) + 1,
                        "stratum": si,
                        "new_facts": total_new,
                        "rows_joined": joined,
                        "rule_applications": len(pairs),
                        "rule_applications_skipped": skipped,
                    }
                )
                if self.seminaive:
                    entry = False
                if total_new == 0:
                    break
        self.stats.per_stratum.append(
            {
                "stratum": si,
                "rounds": rounds,
                "rules": len(stratum),
                "heads": sorted(heads),
                "rule_applications": sum(
                    r["rule_applications"]
                    for r in self.stats.per_round[r0:]
                ),
            }
        )
        # budget exhausted with work pending?  (the loop breaks on empty
        # schedules / empty rounds, so exiting via the while-condition
        # means the last round still derived facts, or it never ran)
        pending = False
        if rounds >= max_rounds:
            if entry:
                pairs, _ = self._schedule(stratum, True, stable=stable)
                pending = bool(pairs)
            else:
                pending = any(
                    self._delta_count(p) > 0
                    for p in body_preds
                    if p in self._state
                )
        return rounds, not pending

    # -------------------------------------------------------------- #
    # materialisation
    # -------------------------------------------------------------- #
    def _prepare(self, dataset) -> None:
        data = {p: torch.as_tensor(r) for p, r in dataset.items()}
        preds = tuple(sorted(set(data) | self.program.predicates()))
        arities: dict[str, int] = {}
        for p, r in data.items():
            arities[p] = 1 if r.dim() == 1 else r.shape[1]
        for rule in self.program:
            for atom in (rule.head, *rule.body):
                arities.setdefault(atom.predicate, atom.arity)
        for p, a in arities.items():
            if a > 2:
                raise NotImplementedError(
                    f"distributed engine supports arity <= 2 ({p!r} has {a})"
                )
        full = {}
        for p in preds:
            rows = data.get(p, torch.zeros((0, arities[p])))
            rows = rows.to("cpu", torch.int64).reshape(-1, arities[p])
            full[p] = unique_rows(rows) if rows.shape[0] else rows
        self._preds = preds
        self._arities = arities
        self._counts = {p: int(full[p].shape[0]) for p in preds}
        self.explicit = {
            p: rows for p, rows in full.items() if rows.shape[0]
        }
        self._factor = 1
        self._dirty = False
        routed = self._route(full)
        self._state = {p: [buf, cnt, 0] for p, (buf, cnt) in routed.items()}

    def materialise(self, dataset, max_rounds: int = 64) -> dict[str, torch.Tensor]:
        """Run rounds to fixpoint; returns per-predicate host rows
        (sorted unique int64 tensors, empty predicates included)."""
        self._prepare(dataset)
        self.stats = DistributedStats()
        self._bind_journal()
        strata = (
            stratify(self.program) if self.seminaive else [list(self.program)]
        )
        self.stats.n_strata = len(strata)
        rounds = 0
        with span(
            "dist.materialise", n_strata=len(strata), n_shards=self.n_shards
        ):
            for si, stratum in enumerate(strata):
                used, converged = self._stratum_fixpoint(
                    si, stratum, max_rounds - rounds, naive_entry=True
                )
                rounds += used
                if not converged:
                    raise RuntimeError(
                        f"materialisation did not reach a fixpoint within "
                        f"max_rounds={max_rounds} (stratum {si} still has "
                        f"pending deltas) — increase max_rounds"
                    )
        self.rounds = rounds
        self.stats.rounds = rounds
        self.stats.plan_cache = self._plan_cache.counters()
        publish_distributed(self.stats)
        if self._pjournal is not None:
            self._pjournal.publish()
        return {p: self._pull(*self._state[p][:2]) for p in self._preds}

    @staticmethod
    def _pull(rows, cnt: int) -> torch.Tensor:
        """Sorted unique int64 host rows of a buffer's first ``cnt``."""
        return unique_rows(rows[:cnt].to("cpu", torch.int64))

    # -------------------------------------------------------------- #
    # incremental maintenance
    # -------------------------------------------------------------- #
    def _empty_buffer(self, pred: str) -> torch.Tensor:
        return torch.full((self.capacity, self._arities[pred]), EMPTY,
                          dtype=_I32, device=self.device)

    def _new_acc(self, seeds: dict[str, torch.Tensor] | None = None) -> dict:
        routed = self._route_pairs(seeds or {})
        return {p: [buf, cnt, 0] for p, (buf, cnt) in routed.items()}

    def _pull_acc(self, acc: dict) -> dict[str, torch.Tensor]:
        return {
            p: self._pull(acc[p][0], acc[p][1])
            for p in self._preds
            if acc[p][1]
        }

    def _route_pairs(self, rows_by_pred: dict) -> dict:
        """``[rows, count]`` device buffers per predicate (empty when the
        predicate has no rows in the batch)."""
        routed = self._route(
            {p: r for p, r in rows_by_pred.items() if r.shape[0]}
        )
        return {
            p: list(routed[p]) if p in routed else [self._empty_buffer(p), 0]
            for p in self._preds
        }

    def _schedule_acc(self, rules, *, one_step: bool):
        """(rule, pivot) pairs for an accumulator round: the pivot reads
        the accumulator's delta (or ``None`` for the one-step
        rederivability check).  Deliberately stable: every pair is
        scheduled whatever holds deltas (an empty side joins to
        nothing)."""
        if one_step:
            pairs = [(rule, None) for rule in rules if rule.body]
        else:
            pairs = [
                (rule, i)
                for rule in rules
                for i in range(len(rule.body))
            ]
        return self._resolve(pairs, frozen=True)

    def apply(self, additions=None, deletions=None) -> DistributedStats:
        """Incrementally maintain the materialisation for
        ``E' = (E \\ deletions) ∪ additions``.

        Deletion batches run the DRed phases (overdelete / delete /
        rederive) set-at-a-time over the rounds, addition batches the
        stratified semi-naive insertion sweep.  Batches are clamped
        against the explicit set (idempotence), so the result is
        comparable through :meth:`check_integrity`."""
        if self._state is None:
            raise RuntimeError("materialise() must run before apply()")
        if self._dirty:
            raise RuntimeError(
                "a previous apply() failed mid-sweep; the state is "
                "inconsistent — materialise() again before applying"
            )
        t0 = time.perf_counter()
        st = DistributedStats()
        self.stats = st
        self._bind_journal(self.epoch + 1)
        adds = normalise_batch(additions)
        dels = normalise_batch(deletions)
        unknown = (set(adds) | set(dels)) - set(self._preds)
        if unknown:
            raise NotImplementedError(
                f"apply() over predicates absent at materialise time: "
                f"{sorted(unknown)}"
            )
        # validate the whole batch BEFORE any mutation: a rejection after
        # effective_updates has touched self.explicit would permanently
        # desynchronise the explicit set from the state
        for batch in (adds, dels):
            for pred, rows in batch.items():
                self._check_const_range(pred, rows)
        self._dirty = True
        with span(
            "dist.apply",
            n_additions=sum(int(r.shape[0]) for r in adds.values()),
            n_deletions=sum(int(r.shape[0]) for r in dels.values()),
        ):
            _, eff_dels = effective_updates(self.explicit, {}, dels)
            st.n_del_explicit += sum(
                int(r.shape[0]) for r in eff_dels.values()
            )
            if eff_dels:
                self._deletion_sweep(eff_dels, st)
            eff_adds, _ = effective_updates(self.explicit, adds, {})
            st.n_add_explicit += sum(
                int(r.shape[0]) for r in eff_adds.values()
            )
            if eff_adds:
                self._insertion_sweep(eff_adds, st)
        self._dirty = False
        self.epoch += 1
        st.epoch = self.epoch
        st.plan_cache = self._plan_cache.counters()
        st.time_total = time.perf_counter() - t0
        publish_distributed(st)
        if self._pjournal is not None:
            self._pjournal.publish()
        return st

    def _deletion_sweep(self, dels: dict[str, torch.Tensor], st) -> None:
        """DRed: overdelete (delta rounds over the pre-deletion view),
        physical delete, rederive (explicit restores + one-step check +
        forward propagation)."""
        rules = [r for r in self.program if r.body]
        # --- overdelete: propagate the deleted delta ------------------- #
        with span("dist.overdelete") as sp:
            over_acc = self._new_acc(dels)
            while True:
                pairs = self._schedule_acc(rules, one_step=False)
                if not pairs:
                    break
                st.n_rule_applications += len(pairs)
                total_new = self._acc_round(
                    over_acc, pairs, union_acc=False,
                    restrict={p: self._state[p][:2] for p in self._preds},
                )
                if total_new == 0:
                    break
            over = self._pull_acc(over_acc)
            n_over = sum(int(r.shape[0]) for r in over.values())
            st.n_overdeleted += n_over
            sp.set(n_overdeleted=n_over)
            for pred, rows in over.items():
                if rows.shape[0]:
                    self._record_dist("overdelete", pred, n_new=rows.shape[0])

        # --- delete: drop overdeleted rows ----------------------------- #
        with span("dist.delete"):
            self._delete(over)

        # --- rederive: explicit restores, one-step check, forward ------ #
        with span("dist.rederive") as sp:
            restored0 = explicit_restores(over, self.explicit)
            missing = {
                p: setdiff_rows(rows, restored0[p]) if p in restored0 else rows
                for p, rows in over.items()
            }
            missing = {p: r for p, r in missing.items() if r.shape[0]}
            red_acc = self._new_acc(restored0)
            if missing and rules:
                restrict = self._route_pairs(missing)
                pairs = self._schedule_acc(rules, one_step=True)
                if pairs:
                    st.n_rule_applications += len(pairs)
                    self._acc_round(
                        red_acc, pairs, union_acc=True, restrict=restrict
                    )
                while True:
                    pairs = self._schedule_acc(rules, one_step=False)
                    if not pairs:
                        break
                    st.n_rule_applications += len(pairs)
                    total_new = self._acc_round(
                        red_acc, pairs, union_acc=True, restrict=restrict
                    )
                    if total_new == 0:
                        break
            restored = self._pull_acc(red_acc)
            n_restored = sum(int(r.shape[0]) for r in restored.values())
            st.n_rederived += n_restored
            sp.set(n_rederived=n_restored)
            for pred, rows in restored.items():
                if rows.shape[0]:
                    self._record_dist("rederive", pred, n_new=rows.shape[0])

            # --- fold restorations back into the base partitions ------- #
            if n_restored:
                self._merge_host_rows(restored, st, count_inserted=False)
            st.n_deleted += (
                sum(int(r.shape[0]) for r in over.values()) - n_restored
            )

    def _delete(self, over: dict[str, torch.Tensor]) -> None:
        """Drop the given rows from every predicate's buffer and compact
        the survivors to the front, in order (delta emptied)."""
        routed = self._route_pairs(over)
        new_state, kept = {}, {}
        for p in self._preds:
            rows, cnt, _lo = self._state[p]
            drows, dcnt = routed[p]
            if dcnt == 0:
                new_state[p] = [rows, cnt, cnt]
                continue
            cap = rows.shape[0]
            dsorted = torch.sort(pack_pairs(drows[:dcnt])).values
            keep = ~sorted_member(pack_pairs(rows[:cnt]).contiguous(), dsorted)
            csum = torch.cumsum(keep, 0, dtype=_I32)
            buf = torch.full((cap + 1, rows.shape[1]), EMPTY, dtype=_I32,
                             device=rows.device)
            buf[torch.where(keep, csum - 1, cap).long()] = rows[:cnt]
            new_state[p] = [buf[:cap]]
            kept[p] = keep.sum(dtype=_I32)
        if kept:
            for p, n_keep in zip(kept, torch.stack(list(kept.values())).tolist()):
                new_state[p] += [n_keep, n_keep]
        self._commit(new_state)

    def _merge_host_rows(self, rows_by_pred, st, *, count_inserted) -> int:
        """Dedup-append host rows into their predicates' buffers as the
        new delta; returns the number of genuinely fresh facts."""
        derived = {
            p: [(rows[:cnt], torch.ones(cnt, dtype=torch.bool, device=self.device))]
            for p, (rows, cnt) in self._route_pairs(rows_by_pred).items()
            if cnt
        }
        new_state, fresh, overflow, merged, counts = self._merge_derived(
            self._state, derived
        )
        fresh, overflow, *counts = torch.stack([fresh, overflow, *counts]).tolist()
        if overflow > 0:
            raise RuntimeError(
                f"relation buffer overflow: {overflow} rows past capacity "
                f"{self.capacity} — increase capacity"
            )
        for p, c in zip(merged, counts):
            new_state[p][1] = c
        self._commit(new_state)
        if count_inserted:
            st.n_inserted += fresh
        return fresh

    def _insertion_sweep(self, adds: dict[str, torch.Tensor], st) -> None:
        """Stratified semi-naive insertion: the added facts are the
        incoming delta; every stratum re-marks the sweep's net additions
        as its delta (the ``sweep_lo`` watermark)."""
        with span("dist.insert") as sp:
            sweep_lo = {p: self._state[p][1] for p in self._preds}
            self._merge_host_rows(adds, st, count_inserted=True)
            strata = (
                stratify(self.program)
                if self.seminaive
                else [list(self.program)]
            )
            r0 = len(self.stats.per_round)
            for si, stratum in enumerate(strata):
                _, converged = self._stratum_fixpoint(
                    si, stratum, 512, naive_entry=False, sweep_lo=sweep_lo,
                    stable=True,
                )
                if not converged:
                    raise RuntimeError(
                        f"insertion sweep did not reach a fixpoint in "
                        f"stratum {si} within 512 rounds"
                    )
            st.n_inserted += sum(
                r["new_facts"] for r in self.stats.per_round[r0:]
            )
            st.rounds += len(self.stats.per_round) - r0
            sp.set(n_inserted=st.n_inserted)

    # -------------------------------------------------------------- #
    # read side / differential checking
    # -------------------------------------------------------------- #
    def to_dict(self) -> dict[str, torch.Tensor]:
        """Flat per-predicate materialisation (sorted unique int64 host
        rows, empty predicates omitted)."""
        return {
            p: self._pull(rows, cnt)
            for p, (rows, cnt, _lo) in self._state.items()
            if cnt
        }

    def check_integrity(self, host) -> None:
        """Differentially compare the materialisation against another
        engine maintained with the same batches (any object with
        ``to_dict()``, or a plain ``{pred: rows}`` dict); with the journal
        on, the shard records are merged first."""
        if self._pjournal is not None:
            self._pjournal.merge_shard_records()
        want = host.to_dict() if hasattr(host, "to_dict") else dict(host)
        got = self.to_dict()
        want = {p: r for p, r in want.items() if len(r)}
        errs = []
        for p in sorted(set(want) | set(got)):
            arity = self._arities.get(p, 1)
            a = _row_set(want[p], arity) if p in want else set()
            b = _row_set(got[p], arity) if p in got else set()
            if a != b:
                errs.append(
                    f"{p!r}: host-only={len(a - b)} shard-only={len(b - a)}"
                )
        if errs:
            raise AssertionError(
                "distributed materialisation diverged from host: "
                + "; ".join(errs)
            )
