"""Distributed semi-naive materialisation and DRed maintenance over shards.

Port of ``repro/core/distributed.py``'s ``DistributedEngine``.  The
reference hash-partitions every relation across the ``data`` axis of a JAX
mesh and runs each round as one jitted ``shard_map`` call; this port keeps
its dataflow, eagerly, with one process driving every shard:

* every relation is hash-partitioned on its first column over ``n_shards``
  shards, one device per shard (``devices``; by default every shard sits
  on ``device``, the card when ``None``);
* each shard keeps, per predicate, a ``(capacity, arity)`` int32 row buffer
  (empty slots hold ``EMPTY = -1``) with a ``count`` and a delta watermark
  ``delta_lo``: rows in ``[delta_lo, count)`` are the last round's delta,
  rows below it are old;
* each round evaluates one compiled ``(rule, pivot)`` plan per delta pivot
  (:mod:`.compile`) on every shard, joins through :func:`join_on_key` (its
  spans come from the ``join_bounds`` kernel), dedups the candidates
  against the target buffer through :func:`dedup_against` (membership by
  the ``sorted_member`` kernel) and appends the fresh rows in
  first-occurrence order, so every shard's buffers match the reference's
  row for row;
* a join side whose stored first column is not the planned join key is
  re-keyed through :meth:`DistributedEngine._exchange` before the join, and
  each head predicate's candidates are routed to their owner shards after
  it, unless the planner proves them aligned (``planner_exchange_keys``).
  The exchange is the reference's ``all_to_all``: each source shard sorts
  its rows by destination into buckets of one capacity, and each
  destination gathers its bucket from shards ``0 .. n-1`` in turn;
* rows past a bucket's capacity, or a join bigger than ``join_capacity``,
  double the padding and retry the round (``exchange_regrows``, at most
  ``MAX_REGROWS`` times);
* :meth:`DistributedEngine.apply` runs the reference's DRed phases
  (overdelete, delete, rederive, insert) over the same rounds.

Counts and watermarks are read back to the host once per round, together
with the round's sums (one read, not one per shard), and kept there: the
host slices each partition out of its buffer instead of masking the whole
capacity.  A bucket's capacity is still computed from the reference's
padded lengths (a partition read is ``capacity`` long, the union of a base
and an accumulator ``2 * capacity``, a join's output ``join_capacity *
factor``), since it decides which rounds regrow.  The codes are the
reference's int32 16-bit-halves pairs, so constants must lie in ``[0,
MAX_DIST_CONST)``.

With the derivation journal on (:mod:`repro_torch.obs.provenance`), each
round records its schedule (one ``schedule`` record per ``(rule, pivot)``)
and each shard's growth (an ``apply`` record tagged with its shard), read
from the host counts the round already holds; the DRed phases record
their overdeleted and rederived rows, and :meth:`check_integrity` merges
the shard records.

Not ported: ``abstract_round`` (an XLA lowering hook with no torch twin).
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
    "visible_devices",
]

EMPTY = -1
#: packed fact keys live in int32: binary facts use 15/16-bit halves, so
#: the engine takes dictionaries of < 32768 constants
MAX_DIST_CONST = 1 << 15
BIG = torch.iinfo(torch.int32).max
#: exchange/join-padding doublings one round may take before it gives up
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
    #: matched the storage sharding (or every head row was emitted on its
    #: owner shard)
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


def _hash_shard(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Multiplicative hash -> int32 shard id, stable across rounds: the
    reference's uint32 product, taken in int64 modulo 2**32."""
    h = ((keys.to(torch.int64) & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    return ((h >> 16) % n_shards).to(_I32)


def visible_devices(device: torch.device | str | None = None) -> list[torch.device]:
    """One shard's device per visible device of ``device``'s type, as the
    reference's mesh over ``jax.devices()``: every card (``None``: the
    card), or the one CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


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
    """Hash-partitioned semi-naive materialisation for binary datalog over
    padded device buffers.

    Supports the rule shapes of the reference: single-atom rules and
    two-atom single-key joins ``A(x,y), B(y,z) -> H(x,z)`` (plus unary
    variants), arity <= 2.  ``n_shards`` shards sit on ``devices`` (one
    each, the counterpart of the mesh's ``data`` axis) or, by default, all
    on ``device``.  ``seminaive=False`` reproduces the naive iteration;
    ``planner_exchange_keys=False`` disables the alignment-based exchange
    elision.
    """

    def __init__(
        self,
        program: Program,
        device: torch.device | str | None = None,
        capacity: int = 1 << 14,
        join_capacity: int | None = None,
        seminaive: bool = True,
        planner_exchange_keys: bool = True,
        n_shards: int | None = None,
        devices=None,
    ):
        if n_shards is None:
            n_shards = 1 if devices is None else len(devices)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if devices is None:
            devices = [resolve_device(device)] * n_shards
        else:
            devices = [resolve_device(d) for d in devices]
            if len(devices) != n_shards:
                raise ValueError(
                    f"{len(devices)} devices for {n_shards} shards"
                )
        self.program = program
        self.devices = tuple(devices)
        self.device = self.devices[0]
        self.capacity = capacity
        self.join_capacity = join_capacity or capacity
        self.n_shards = n_shards
        self.seminaive = seminaive
        self.planner_exchange_keys = planner_exchange_keys
        self._plan_cache = PlanCache()
        #: per-predicate sharded state: pred -> [rows, count, delta_lo],
        #: each a list with one entry per shard (tensors, host ints)
        self._state: dict[str, list] | None = None
        self._preds: tuple[str, ...] = ()
        self._arities: dict[str, int] = {}
        #: global row counts (summed over the shards), the planner's input
        self._counts: dict[str, int] = {}
        #: host-side explicit fact set (int64 rows; the apply() contract)
        self.explicit: dict[str, torch.Tensor] = {}
        self.stats = DistributedStats()
        self.rounds = 0
        self.epoch = 0
        #: exchange/join padding multiplier, doubled on overflow retries
        self._factor = 1
        #: True while an apply() sweep is in flight: a mid-sweep failure
        #: leaves the shards and the explicit set inconsistent, so further
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
    # sharding / routing
    # -------------------------------------------------------------- #
    def _route(self, rows_by_pred: dict[str, torch.Tensor]) -> dict:
        """Hash-partition host rows on their first column into per-shard
        padded buffers ``(capacity, arity)`` on each shard's device, and
        host counts; each shard keeps its rows in their host order."""
        n, cap = self.n_shards, self.capacity
        out = {}
        for pred, rows in rows_by_pred.items():
            if rows.dim() == 1:
                rows = rows.reshape(-1, 1)
            self._check_const_range(pred, rows)
            rows = rows.to("cpu", _I32)
            shard = _hash_shard(rows[:, 0], n) if n > 1 else None
            bufs, cnts = [], []
            for s, dev in enumerate(self.devices):
                mine = rows if shard is None else rows[shard == s]
                if mine.shape[0] > cap:
                    raise ValueError(f"capacity {cap} too small for shard {s}")
                buf = torch.full((cap, rows.shape[1]), EMPTY, dtype=_I32,
                                 device=dev)
                buf[: mine.shape[0]] = mine.to(dev)
                bufs.append(buf)
                cnts.append(int(mine.shape[0]))
            out[pred] = (bufs, cnts)
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
        return sum(c - l for c, l in zip(cnt, lo))

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

    # -------------------------------------------------------------- #
    # the exchange (the reference's all_to_all)
    # -------------------------------------------------------------- #
    def _exchange(self, side, length: int, factor: int, col: int = 0):
        """Route every shard's rows to the ``hash(rows[:, col])`` owner
        shard.

        ``side`` holds one ``(rows, valid)`` per source shard; ``length``
        is the reference's padded length of those rows, which fixes the
        bucket capacity ``per``.  Each source sorts its valid rows by
        destination (stably) into ``n_shards`` buckets of ``slots =
        min(per, its row count)`` slots; destination ``d`` receives the
        buckets of shards ``0 .. n-1`` in turn, each padded with ``EMPTY``
        to ``slots``.  The padding is sent too: a destination gets ``n *
        slots`` rows, of which about one in ``n`` is valid when the rows
        hash evenly, and fewer where the source rows are padded themselves
        (a join's output).  Sizing the buckets from the destinations'
        counts would take a host read an exchange.  Returns the
        per-destination ``(rows, valid)`` and the number of rows dropped
        past ``per`` (an int32 scalar on the first shard's device), which
        makes the round regrow instead of silently under-deriving."""
        n = self.n_shards
        # bucket capacity grows with the regrow factor but never past the
        # input length — once one bucket can hold every row nothing drops,
        # so the regrow loop ends
        per = min(max(length * factor // n, 1), length)
        dropped = torch.zeros((), dtype=_I32, device=self.device)
        sent = []
        for rows, valid in side:
            # a bucket never needs more slots than its source has rows
            slots = min(per, rows.shape[0])
            dest = torch.where(valid, _hash_shard(rows[:, col], n), n)
            dest_s, order = torch.sort(dest, stable=True)
            # position within its bucket: offset from the bucket's start
            start = torch.searchsorted(dest_s, dest_s)
            pos = torch.arange(dest_s.shape[0], device=rows.device) - start
            live = dest_s < n
            ok = live & (pos < per)
            dropped = dropped + (live & ~ok).sum(dtype=_I32).to(self.device)
            # rows that are not sent are parked in one extra slot, cut off
            slot = torch.where(ok, dest_s * slots + pos, n * slots)
            buckets = torch.full((n * slots + 1, rows.shape[1]), EMPTY,
                                 dtype=_I32, device=rows.device)
            buckets[slot] = torch.where(ok[:, None], rows[order], EMPTY)
            sent.append(buckets[: n * slots].view(n, slots, rows.shape[1]))
        return self._deliver(sent), dropped

    def _deliver(self, sent: list[torch.Tensor]) -> list[tuple]:
        """The all-to-all: destination ``d`` receives bucket ``d`` of every
        source ``sent[s]`` (``(n_shards, slots, arity)``), in source order;
        its ``(rows, valid)``."""
        out = []
        for d, dev in enumerate(self.devices):
            rows = torch.cat([b[d].to(dev) for b in sent])
            out.append((rows, rows[:, 0] != EMPTY))
        return out

    @staticmethod
    def _side_aligned(atom, key) -> bool:
        """True when a join side's stored partitioning (hash of the first
        term) already equals the planner's partition key — no exchange."""
        return bool(atom.terms) and atom.terms[0] == key

    def _exchanges_side(self, atom, key) -> bool:
        return self.n_shards > 1 and not (
            self.planner_exchange_keys and self._side_aligned(atom, key)
        )

    def _static_exchange_counts(self, pairs) -> tuple[int, int]:
        """How many all_to_all calls one round issues, and how many the
        planner's partition keys elide (none of either at one shard)."""
        if self.n_shards == 1:
            return 0, 0
        n_ex = n_sk = 0
        head_aligned: dict[str, bool] = {}
        for rule, _pivot, plan in pairs:
            steps = [plan.first] + [j.scan for j in plan.joins]
            if len(steps) == 2:
                key = plan.joins[0].partition_key
                for st in steps:
                    if self._exchanges_side(st.atom, key):
                        n_ex += 1
                    else:
                        n_sk += 1
                al = rule.head.terms[0] == key
            else:
                al = rule.head.terms[0] == steps[0].atom.terms[0]
            p = rule.head.predicate
            head_aligned[p] = head_aligned.get(p, True) and al
        for al in head_aligned.values():
            if self.planner_exchange_keys and al:
                n_sk += 1
            else:
                n_ex += 1
        return n_ex, n_sk

    # -------------------------------------------------------------- #
    # one (rule, pivot) plan over the partitions
    # -------------------------------------------------------------- #
    def _trace_pair(self, rule, plan, part, emit, factor):
        """Evaluate one compiled (rule, pivot) body on every shard: emits
        its candidate head rows and returns ``(dropped, rows_joined)``
        int32 scalars on the first shard's device (None for a single-atom
        body, which drops and joins nothing)."""
        head = rule.head
        steps = [plan.first] + [j.scan for j in plan.joins]
        if len(steps) == 1:
            st = steps[0]
            parts, length = part(st.atom.predicate, st.source)
            blocks = []
            for rows in parts:
                valid = torch.ones(rows.shape[0], dtype=torch.bool,
                                   device=rows.device)
                rows, valid = _apply_atom_constraints(st.atom, rows, valid)
                out = _project_head(st.atom.variables(), rows, head)
                if out is None:
                    return None
                blocks.append((out, valid))
            emit(head.predicate, blocks,
                 head.terms[0] == st.atom.terms[0], length)
            return None

        key = plan.joins[0].partition_key
        dropped = torch.zeros((), dtype=_I32, device=self.device)
        joined = dropped
        sides = []
        for step in steps:
            parts, length = part(step.atom.predicate, step.source)
            vars_ = step.atom.variables()
            side = [
                _apply_atom_constraints(
                    step.atom, rows,
                    torch.ones(rows.shape[0], dtype=torch.bool,
                               device=rows.device),
                )
                for rows in parts
            ]
            # re-partition on the planned join key — unless this side's
            # storage sharding already is the key
            if self._exchanges_side(step.atom, key):
                side, d = self._exchange(side, length, factor,
                                         col=vars_.index(key))
                dropped = dropped + d
            sides.append((side, vars_))
        (a_side, va_vars), (b_side, vb_vars) = sides
        ia, ib = va_vars.index(key), vb_vars.index(key)
        jcap = self.join_capacity * factor
        blocks = []
        for (ra, va), (rb, vb) in zip(a_side, b_side):
            if ra.shape[0] == 0 or rb.shape[0] == 0:
                blocks.append(None)  # joins to nothing on this shard
                continue
            lpay, rpay, valid, total = join_on_key(
                ra[:, ia], va, ra, rb[:, ib], vb, rb, jcap
            )
            dropped = dropped + (total - jcap).clamp(min=0).to(self.device)
            joined = joined + total.to(self.device)
            var_cols = {v: lpay[:, i] for i, v in enumerate(va_vars)}
            for i, v in enumerate(vb_vars):
                var_cols.setdefault(v, rpay[:, i])
            cols = [
                torch.full((jcap,), t, dtype=_I32, device=lpay.device)
                if isinstance(t, int) else var_cols[t]
                for t in head.terms
            ]
            blocks.append((torch.stack(cols, dim=1), valid))
        emit(head.predicate, blocks, head.terms[0] == key, jcap)
        return dropped, joined

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
        """One fixpoint round: evaluate every scheduled (rule, pivot) plan
        on every shard, route the derivations to their owner shards, dedup,
        append into the delta partitions — without committing.

        With ``acc`` the round evaluates against the read-only current
        materialisation while accumulating into ``acc``'s per-predicate
        buffers (the overdelete/rederive phases of ``apply``; with
        ``union_acc`` the accumulator is unioned into old/all reads, and
        ``restrict`` keeps only candidates inside a membership set).

        Returns ``(new_state, sums, merged)``: the new per-predicate
        ``[rows, count, delta_lo]`` (the counts of the ``merged`` (pred,
        shard) pairs still device scalars) and one int32 vector
        ``[total_new, dropped, overflow, rows_joined, *counts of
        merged]`` on the first shard's device."""
        base = self._state
        cap = self.capacity

        def part(pred, src):
            """The partition's rows on every shard, and the reference's
            padded length of them."""
            if acc is None:
                rows, cnt, lo = base[pred]
                if src == SRC_DELTA:
                    return [r[l:c] for r, c, l in zip(rows, cnt, lo)], cap
                if src == SRC_OLD:
                    return [r[:l] for r, l in zip(rows, lo)], cap
                return [r[:c] for r, c in zip(rows, cnt)], cap
            arows, acnt, alo = acc[pred]
            if src == SRC_DELTA:
                return [r[l:c] for r, c, l in zip(arows, acnt, alo)], cap
            brows, bcnt = base[pred][0], base[pred][1]
            if union_acc:
                return [
                    torch.cat([b[:bc], a[:ac]])
                    for b, bc, a, ac in zip(brows, bcnt, arows, acnt)
                ], 2 * cap
            return [b[:bc] for b, bc in zip(brows, bcnt)], cap

        derived: dict[str, list] = {}

        def emit(pred, blocks, aligned, length):
            derived.setdefault(pred, []).append((blocks, aligned, length))

        dropped = torch.zeros((), dtype=_I32, device=self.device)
        joined = dropped
        for rule, _pivot, plan in pairs:
            res = self._trace_pair(rule, plan, part, emit, factor)
            if res is not None:
                dropped = dropped + res[0]
                joined = joined + res[1]

        new_state, total_new, d, overflow, merged, counts = (
            self._merge_derived(
                base if acc is None else acc, derived, factor, restrict
            )
        )
        sums = torch.stack([
            total_new, dropped + d, overflow, joined,
            *(c.to(self.device) for c in counts),
        ])
        return new_state, sums, merged

    def _merge_derived(self, target, derived, factor=None, restrict=None):
        """Merge each predicate's candidate blocks ``derived[pred]`` (a
        list of ``(per-shard (rows, valid) or None, aligned, padded
        length)``) into its ``target`` buffers, as the new delta.  With a
        ``factor`` the candidates are first routed to their owner shards
        (unless every block is aligned); without, they already sit there.

        Returns ``(new_state, total_new, dropped, overflow, merged,
        counts)``: int32 scalars on the first shard's device, read by the
        caller, and the device counts of the ``merged`` (pred, shard)
        pairs."""
        zero = torch.zeros((), dtype=_I32, device=self.device)
        new_state: dict[str, list] = {}
        merged, counts = [], []
        total_new, dropped, overflow = zero, zero, zero
        for pred in self._preds:
            trows, tcnt, _tlo = target[pred]
            new_state[pred] = [list(trows), list(tcnt), list(tcnt)]
            blocks = derived.get(pred, [])
            if all(b is None for shards, _a, _l in blocks for b in shards):
                continue  # no candidates: the delta still gets consumed
            cand = []
            for s, dev in enumerate(self.devices):
                mine = [shards[s] for shards, _a, _l in blocks
                        if shards[s] is not None]
                if not mine:
                    cand.append(None)
                    continue
                rows = torch.cat([b[0] for b in mine])
                valid = torch.cat([b[1] for b in mine])
                cand.append((torch.where(valid[:, None], rows, EMPTY), valid))
            # route each derivation to the shard owning its head key
            if factor is not None and self.n_shards > 1 and not (
                self.planner_exchange_keys and all(a for _s, a, _l in blocks)
            ):
                arity = self._arities[pred]
                cand, d = self._exchange(
                    [
                        c if c is not None else (
                            torch.empty((0, arity), dtype=_I32, device=dev),
                            torch.empty(0, dtype=torch.bool, device=dev),
                        )
                        for c, dev in zip(cand, self.devices)
                    ],
                    sum(length for _s, _a, length in blocks),
                    factor,
                )
                dropped = dropped + d
            for s, c in enumerate(cand):
                if c is None:
                    continue
                nrows, ncnt, n_fresh, of = self._merge_block(
                    trows[s], tcnt[s], c[0], c[1],
                    restrict=None if restrict is None else (
                        restrict[pred][0][s], restrict[pred][1][s]
                    ),
                )
                total_new = total_new + n_fresh.to(self.device)
                overflow = overflow + of.to(self.device)
                new_state[pred][0][s] = nrows
                merged.append((pred, s))
                counts.append(ncnt)
        return new_state, total_new, dropped, overflow, merged, counts

    def _commit(self, new_state: dict[str, list]) -> None:
        self._state = new_state
        for p in self._preds:
            self._counts[p] = sum(new_state[p][1])

    def _run_round(self, pairs, build):
        """Run one round (``build(factor)``); on exchange or join overflow,
        double the padding factor and retry the *same* inputs (rounds
        commit nothing).  Returns ``(new_state, total_new, joined)`` with
        host counts."""
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
                for (pred, s), cnt in zip(merged, counts):
                    new_state[pred][1][s] = cnt
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
                self._state[p][2] = list(sweep_lo[p])
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
                    {p: list(self._state[p][1]) for p in self._preds}
                    if self._pjournal is not None else None
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
                        for s, (now, before) in enumerate(
                            zip(self._state[p][1], counts_before[p])
                        ):
                            if now != before:
                                self._record_dist(
                                    "apply", p, stratum=si,
                                    round_no=round_no, n_new=now - before,
                                    shard=s,
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
        self._state = {
            p: [bufs, cnts, [0] * self.n_shards]
            for p, (bufs, cnts) in routed.items()
        }

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
    def _pull(rows, cnt) -> torch.Tensor:
        """Sorted unique int64 host rows of every shard's first ``cnt``."""
        return unique_rows(torch.cat(
            [r[:c].to("cpu", torch.int64) for r, c in zip(rows, cnt)]
        ))

    # -------------------------------------------------------------- #
    # incremental maintenance: deltas through the exchange
    # -------------------------------------------------------------- #
    def _new_acc(self, seeds: dict[str, torch.Tensor] | None = None) -> dict:
        routed = self._route_pairs(seeds or {})
        return {
            p: [bufs, cnts, [0] * self.n_shards]
            for p, (bufs, cnts) in routed.items()
        }

    def _pull_acc(self, acc: dict) -> dict[str, torch.Tensor]:
        return {
            p: self._pull(acc[p][0], acc[p][1])
            for p in self._preds
            if sum(acc[p][1])
        }

    def _route_pairs(self, rows_by_pred: dict) -> dict:
        """``[rows, count]`` per-shard buffers per predicate (empty when
        the predicate has no rows in the batch)."""
        routed = self._route(
            {p: r for p, r in rows_by_pred.items() if r.shape[0]}
        )
        return {
            p: list(routed[p]) if p in routed else [
                [
                    torch.full((self.capacity, self._arities[p]), EMPTY,
                               dtype=_I32, device=dev)
                    for dev in self.devices
                ],
                [0] * self.n_shards,
            ]
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
        """Incrementally maintain the sharded materialisation for
        ``E' = (E \\ deletions) ∪ additions``.

        Deletion batches run the DRed phases (overdelete / delete /
        rederive) set-at-a-time over the shards, their deltas through the
        same exchange as materialisation rounds; addition batches run the
        stratified semi-naive insertion sweep.  Batches are clamped
        against the explicit set (idempotence), so the result is
        comparable through :meth:`check_integrity`."""
        if self._state is None:
            raise RuntimeError("materialise() must run before apply()")
        if self._dirty:
            raise RuntimeError(
                "a previous apply() failed mid-sweep; the sharded state is "
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
        # desynchronise the explicit set from the shards
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
        """DRed over the shards: overdelete (delta rounds over the
        pre-deletion view), physical delete, rederive (explicit restores +
        one-step check + forward propagation)."""
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

        # --- delete: drop overdeleted rows from every shard ------------ #
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
        """Drop the given rows, each routed to its owner shard, from every
        predicate's buffers and compact the survivors to the front, in
        order (delta emptied)."""
        routed = self._route_pairs(over)
        new_state, kept = {}, []
        for p in self._preds:
            rows, cnt, _lo = self._state[p]
            drows, dcnt = routed[p]
            new_state[p] = [list(rows), list(cnt), list(cnt)]
            for s in range(self.n_shards):
                if dcnt[s] == 0:
                    continue
                r = rows[s]
                cap = r.shape[0]
                dsorted = torch.sort(pack_pairs(drows[s][: dcnt[s]])).values
                keep = ~sorted_member(
                    pack_pairs(r[: cnt[s]]).contiguous(), dsorted
                )
                csum = torch.cumsum(keep, 0, dtype=_I32)
                buf = torch.full((cap + 1, r.shape[1]), EMPTY, dtype=_I32,
                                 device=r.device)
                buf[torch.where(keep, csum - 1, cap).long()] = r[: cnt[s]]
                new_state[p][0][s] = buf[:cap]
                kept.append((p, s, keep.sum(dtype=_I32)))
        if kept:
            n_keep = torch.stack([k.to(self.device) for _p, _s, k in kept])
            for (p, s, _k), n in zip(kept, n_keep.tolist()):
                new_state[p][1][s] = new_state[p][2][s] = n
        self._commit(new_state)

    def _merge_host_rows(self, rows_by_pred, st, *, count_inserted) -> int:
        """Route host rows to their owner shards and dedup-append them as
        the new delta; returns the number of genuinely fresh facts."""
        derived = {}
        for p, (bufs, cnts) in self._route_pairs(rows_by_pred).items():
            if sum(cnts):
                derived[p] = [([
                    (r[:c], torch.ones(c, dtype=torch.bool, device=r.device))
                    if c else None
                    for r, c in zip(bufs, cnts)
                ], True, self.capacity)]
        new_state, fresh, _dropped, overflow, merged, counts = (
            self._merge_derived(self._state, derived)
        )
        fresh, overflow, *counts = torch.stack(
            [fresh, overflow, *(c.to(self.device) for c in counts)]
        ).tolist()
        if overflow > 0:
            raise RuntimeError(
                f"relation buffer overflow: {overflow} rows past capacity "
                f"{self.capacity} — increase capacity"
            )
        for (p, s), c in zip(merged, counts):
            new_state[p][1][s] = c
        self._commit(new_state)
        if count_inserted:
            st.n_inserted += fresh
        return fresh

    def _insertion_sweep(self, adds: dict[str, torch.Tensor], st) -> None:
        """Stratified semi-naive insertion: the added facts are the
        incoming delta; every stratum re-marks the sweep's net additions
        as its delta (the ``sweep_lo`` watermark)."""
        with span("dist.insert") as sp:
            sweep_lo = {p: list(self._state[p][1]) for p in self._preds}
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
            if sum(cnt)
        }

    def check_integrity(self, host) -> None:
        """Differentially compare the sharded materialisation against
        another engine maintained with the same batches (any object with
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
