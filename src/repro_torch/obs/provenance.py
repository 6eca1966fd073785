"""Derivation provenance: lineage journal, verified proof trees, rule costs.

The port's twin of the JAX package's provenance module.  One derivation
step of the compressed engines justifies many facts at once, so the
journal records at the meta-fact level: one :class:`DerivationRecord`
per rule application ``(stratum, round, rule_id, pivot, input mf ids /
row ranges) -> output mf ids``, never one per fact.

* :class:`DerivationJournal` — a bounded, epoch-aware append log shared
  by the four engines (CMat / Flat / Distributed / Incremental).  It is
  off by default and free when off (every hook short-circuits on one
  attribute); the buffer is a ``deque(maxlen=...)``, and evictions are
  counted.  It reports its bytes to the port's accountant under
  ``provenance`` and survives checkpoint/restore through
  :meth:`DerivationJournal.to_payload` / :meth:`load_payload` (the JSON
  payload of the JAX package, so each package loads the other's).
* :class:`Explainer` — ``explain(pred, terms)`` rebuilds a minimal proof
  tree by re-running rule bodies restricted to the queried fact (lower
  strata unrestricted, the same stratum restricted to strictly smaller
  rounds) over per-predicate ``(rows, rounds)`` tensors on the store's
  device, and re-checks every step by re-deriving it from exactly its
  chosen body facts.  The journal only orders the candidate rules.
  Proof trees are plain dicts of Python ints and strings.
* per-rule costs — :meth:`DerivationJournal.publish` sets the
  ``rule.<id>.{derived,redundant,time_ns,rounds_active}`` gauges.

``time_ns`` is host time (``perf_counter_ns``) around an application's
host code: on a card it includes device time only where the application
waits for the device.

Core modules are imported inside functions: ``repro_torch.core`` imports
``repro_torch.obs`` at module load.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from .memory import register_reporter
from .metrics import get_registry

__all__ = [
    "DerivationRecord",
    "DerivationJournal",
    "Explainer",
    "get_journal",
    "now_ns",
    "proof_to_json",
    "proof_to_dot",
]

#: cap on input/output meta-fact ids kept per record
MAX_IDS_PER_RECORD = 16

#: default bounded-buffer size (records, not facts)
DEFAULT_MAX_RECORDS = 100_000

_I64 = torch.int64
_NO_ROUND = torch.iinfo(torch.int64).max


@dataclass(slots=True)
class DerivationRecord:
    """One rule application (or maintenance phase step), meta-fact granular.

    ``kind`` is ``"apply"`` for fixpoint rounds and one of the
    maintenance phases (``"insert"``, ``"overdelete"``, ``"rederive"``,
    ``"survive_explicit"``, ``"survive_backward"``, ...) otherwise."""

    kind: str
    engine: str  # cmat | flat | dist | inc
    stratum: int
    round: int
    rule_id: int  # index into the attached program; -1 = no rule
    pivot: int  # delta-anchored body position; -1 = naive / whole body
    pred: str  # head predicate the record derived into
    n_emitted: int = 0  # rows emitted by the rule body
    n_new: int = 0  # rows surviving dedup (fresh facts)
    in_mf_ids: tuple = ()  # input meta-fact ids (capped)
    out_mf_ids: tuple = ()  # output meta-fact ids (capped)
    row_span: tuple = ()  # flat engine: (watermark_before, watermark_after)
    shard: int = -1  # distributed: shard tag; -1 = host
    epoch: int = 0  # incremental epoch the record belongs to
    time_ns: int = 0

    def key(self) -> tuple:
        """Identity ignoring shard and counters (shard merging)."""
        return (
            self.kind,
            self.engine,
            self.stratum,
            self.round,
            self.rule_id,
            self.pivot,
            self.pred,
            self.epoch,
        )

    def to_list(self) -> list:
        return [
            self.kind,
            self.engine,
            self.stratum,
            self.round,
            self.rule_id,
            self.pivot,
            self.pred,
            self.n_emitted,
            self.n_new,
            list(self.in_mf_ids),
            list(self.out_mf_ids),
            list(self.row_span),
            self.shard,
            self.epoch,
            self.time_ns,
        ]

    @classmethod
    def from_list(cls, row: list) -> DerivationRecord:
        return cls(
            kind=row[0],
            engine=row[1],
            stratum=int(row[2]),
            round=int(row[3]),
            rule_id=int(row[4]),
            pivot=int(row[5]),
            pred=row[6],
            n_emitted=int(row[7]),
            n_new=int(row[8]),
            in_mf_ids=tuple(row[9]),
            out_mf_ids=tuple(row[10]),
            row_span=tuple(row[11]),
            shard=int(row[12]),
            epoch=int(row[13]),
            time_ns=int(row[14]),
        )


@dataclass
class _RuleCost:
    derived: int = 0
    redundant: int = 0
    time_ns: int = 0
    rounds: set = field(default_factory=set)


class DerivationJournal:
    """Bounded, epoch-aware derivation log (off by default).

    Engines bind the journal per run only when ``enabled`` is true, so a
    disabled journal costs one attribute read per application.  ``dropped``
    counts evictions; the Explainer treats a journal miss as "try every
    candidate rule", so eviction makes an explanation slower, never
    wrong."""

    def __init__(self, max_records: int = DEFAULT_MAX_RECORDS):
        self.enabled = False
        self.max_records = int(max_records)
        self.records: deque[DerivationRecord] = deque(maxlen=self.max_records)
        self.n_recorded = 0  # total ever recorded (>= len(records))
        self.epoch = 0
        self.rule_strs: dict[int, str] = {}
        self.costs: dict[int, _RuleCost] = {}

    # ------------------------------------------------------------------ #
    def configure(self, max_records: int) -> None:
        """Resize the bounded buffer, keeping the newest records."""
        max_records = int(max_records)
        if max_records == self.max_records:
            return
        self.max_records = max_records
        self.records = deque(self.records, maxlen=max_records)

    def attach_program(self, program) -> None:
        """Remember rule strings; ``rule_id`` is the rule's position in
        ``program.rules``, the order every engine shares."""
        for i, rule in enumerate(program):
            self.rule_strs[i] = str(rule)

    def begin_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def clear(self) -> None:
        self.records.clear()
        self.n_recorded = 0
        self.costs.clear()

    @property
    def dropped(self) -> int:
        return self.n_recorded - len(self.records)

    # ------------------------------------------------------------------ #
    def record(self, rec: DerivationRecord) -> None:
        if not self.enabled:
            return
        self.records.append(rec)
        self.n_recorded += 1
        if rec.rule_id >= 0:
            c = self.costs.setdefault(rec.rule_id, _RuleCost())
            c.derived += rec.n_new
            c.redundant += max(0, rec.n_emitted - rec.n_new)
            c.time_ns += rec.time_ns
            c.rounds.add((rec.stratum, rec.round))

    # ------------------------------------------------------------------ #
    def lookup(self, pred: str, round_no: int | None = None) -> list[DerivationRecord]:
        """Records that derived into ``pred`` (optionally at one round)."""
        return [
            rec
            for rec in self.records
            if rec.pred == pred and (round_no is None or rec.round == round_no)
        ]

    def rule_ids_for(self, pred: str, round_no: int | None = None) -> list[int]:
        """Distinct rule ids recorded for (pred, round), in record order."""
        seen: list[int] = []
        for rec in self.lookup(pred, round_no):
            if rec.rule_id >= 0 and rec.rule_id not in seen:
                seen.append(rec.rule_id)
        return seen

    # ------------------------------------------------------------------ #
    def merge_shard_records(self) -> int:
        """Coalesce records equal up to shard and counters into host rows
        (``shard=-1``, counters summed); returns the rows removed."""
        merged: dict[tuple, DerivationRecord] = {}
        order: list[tuple] = []
        for rec in self.records:
            k = rec.key()
            if k in merged:
                m = merged[k]
                m.n_emitted += rec.n_emitted
                m.n_new += rec.n_new
                m.time_ns += rec.time_ns
                m.in_mf_ids = (m.in_mf_ids + rec.in_mf_ids)[:MAX_IDS_PER_RECORD]
                m.out_mf_ids = (m.out_mf_ids + rec.out_mf_ids)[:MAX_IDS_PER_RECORD]
                m.shard = -1
            else:
                merged[k] = DerivationRecord(
                    **{s: getattr(rec, s) for s in DerivationRecord.__slots__}
                )
                order.append(k)
        removed = len(self.records) - len(order)
        self.records = deque((merged[k] for k in order), maxlen=self.max_records)
        return removed

    # ------------------------------------------------------------------ #
    def publish(self, registry=None) -> None:
        """Set the ``rule.<id>.*`` and ``rule.journal.*`` gauges."""
        reg = registry if registry is not None else get_registry()
        for rid, c in self.costs.items():
            reg.gauge(f"rule.{rid}.derived").set(c.derived)
            reg.gauge(f"rule.{rid}.redundant").set(c.redundant)
            reg.gauge(f"rule.{rid}.time_ns").set(c.time_ns)
            reg.gauge(f"rule.{rid}.rounds_active").set(len(c.rounds))
        reg.gauge("rule.journal.records").set(len(self.records))
        reg.gauge("rule.journal.dropped").set(self.dropped)

    def hot_rules(self, n: int = 10) -> list[dict]:
        """Top-n rules by recorded host time, with derived/redundant."""
        ranked = sorted(self.costs.items(), key=lambda kv: kv[1].time_ns, reverse=True)
        return [
            {
                "rule_id": rid,
                "rule": self.rule_strs.get(rid, f"<rule {rid}>"),
                "derived": c.derived,
                "redundant": c.redundant,
                "time_ns": c.time_ns,
                "rounds_active": len(c.rounds),
            }
            for rid, c in ranked[:n]
        ]

    # ------------------------------------------------------------------ #
    def to_payload(self) -> dict:
        return {
            "version": 1,
            "epoch": self.epoch,
            "max_records": self.max_records,
            "n_recorded": self.n_recorded,
            "rule_strs": {str(k): v for k, v in self.rule_strs.items()},
            "records": [r.to_list() for r in self.records],
            "costs": {
                str(rid): {
                    "derived": c.derived,
                    "redundant": c.redundant,
                    "time_ns": c.time_ns,
                    "rounds": sorted([list(t) for t in c.rounds]),
                }
                for rid, c in self.costs.items()
            },
        }

    def load_payload(self, payload: dict) -> None:
        """Replace the journal's state with a checkpoint sidecar's."""
        self.epoch = int(payload.get("epoch", 0))
        self.configure(int(payload.get("max_records", self.max_records)))
        self.records = deque(
            (DerivationRecord.from_list(r) for r in payload.get("records", [])),
            maxlen=self.max_records,
        )
        self.n_recorded = int(payload.get("n_recorded", len(self.records)))
        self.rule_strs = {int(k): v for k, v in payload.get("rule_strs", {}).items()}
        self.costs = {
            int(rid): _RuleCost(
                derived=int(c["derived"]),
                redundant=int(c["redundant"]),
                time_ns=int(c["time_ns"]),
                rounds={tuple(t) for t in c.get("rounds", [])},
            )
            for rid, c in payload.get("costs", {}).items()
        }

    def memory_report(self) -> dict[str, int]:
        """Accountant reporter: the record buffer's estimated bytes
        (160 B a slotted record plus 8 B a kept id, the JAX package's
        estimate)."""
        id_bytes = sum(8 * (len(r.in_mf_ids) + len(r.out_mf_ids)) for r in self.records)
        return {
            "journal_bytes": 160 * len(self.records) + id_bytes,
            "n_records": len(self.records),
            "n_dropped": self.dropped,
        }


#: process-wide journal (the strong reference that keeps the weakly
#: registered reporter alive)
_JOURNAL: DerivationJournal | None = None


def get_journal() -> DerivationJournal:
    global _JOURNAL
    if _JOURNAL is None:
        _JOURNAL = DerivationJournal()
        register_reporter("provenance", _JOURNAL)
    return _JOURNAL


# --------------------------------------------------------------------- #
# verified explanation
# --------------------------------------------------------------------- #
Tables = dict[str, tuple[torch.Tensor, torch.Tensor]]


class Explainer:
    """Reconstruct and verify proof trees for materialised facts.

    Works over per-predicate tables ``{pred: (rows, rounds)}`` of tensors
    on one device, where ``rounds[i]`` is the round that first derived
    ``rows[i]`` (0 for input facts) and rows are lexicographically sorted
    and unique.  Build one with :meth:`from_fact_store` (compressed
    engines, incremental store) or :meth:`from_flat` (flat engine).

    Every engine derives a fact only from body facts in strictly lower
    strata or in the same stratum at strictly smaller rounds, and
    ``_derive`` restricts same-stratum sources to rounds ``< r``, so the
    recursion ends in explicit facts."""

    def __init__(
        self,
        program,
        tables: Tables,
        explicit: dict[str, torch.Tensor] | None = None,
        journal: DerivationJournal | None = None,
        max_depth: int = 64,
        decode=None,
    ):
        from ..core.program_graph import stratify

        self.program = program
        self.rules = list(program)
        self.tables = tables
        self.explicit = explicit if explicit is not None else {}
        self.journal = journal
        self.max_depth = max_depth
        self.decode = decode
        self.stratum_of: dict[str, int] = {}
        for si, stratum in enumerate(stratify(program)):
            for rule in stratum:
                self.stratum_of[rule.head.predicate] = si
        self._memo: dict[tuple, dict] = {}
        # the device the step checks run on: the tables' (or the explicit
        # rows') own
        held = [rows for rows, _ in tables.values()] + list(self.explicit.values())
        self.device = held[0].device if held else torch.device("cpu")

    # ------------------------------------------------------------------ #
    # building the tables
    # ------------------------------------------------------------------ #
    @staticmethod
    def build_tables(store) -> Tables:
        """Unfold a ``FactStore`` into ``{pred: (rows, rounds)}`` with
        duplicates collapsed to their minimum round (a fact's first
        derivation).  A predicate's rounds are one ``rle_expand`` of its
        meta-facts' rounds by their lengths."""
        from ..kernels import rle_expand

        tables: Tables = {}
        for pred in store.predicates():
            mfs = store.all(pred)
            if not mfs:
                continue
            rows = store.unfold_pred(pred)
            dev = rows.device
            lengths = torch.tensor([mf.length for mf in mfs], dtype=_I64).to(dev)
            per_mf = torch.tensor([mf.round for mf in mfs], dtype=_I64).to(dev)
            rounds = rle_expand(per_mf, lengths, int(rows.shape[0]))
            tables[pred] = _dedup_min_round(rows, rounds)
        return tables

    @classmethod
    def from_fact_store(cls, program, store, explicit=None, **kw) -> Explainer:
        return cls(program, cls.build_tables(store), explicit, **kw)

    @classmethod
    def from_flat(
        cls,
        program,
        facts: dict[str, torch.Tensor],
        fresh_log: dict[str, list[tuple[int, torch.Tensor]]] | None = None,
        explicit: dict[str, torch.Tensor] | None = None,
        **kw,
    ) -> Explainer:
        """Build from a ``FlatEngine``: ``facts`` are its final sorted
        tables; ``fresh_log`` (its per-round fresh rows) gives rounds,
        else every fact is at round 0."""
        tables: Tables = {}
        for pred, rows in facts.items():
            if fresh_log and pred in fresh_log:
                blocks = fresh_log[pred]
                all_rows = torch.cat([b for _, b in blocks])
                rounds = torch.cat([
                    torch.full((b.shape[0],), rno, dtype=_I64, device=b.device)
                    for rno, b in blocks
                ])
                tables[pred] = _dedup_min_round(all_rows, rounds)
            else:
                tables[pred] = (
                    rows, torch.zeros(rows.shape[0], dtype=_I64, device=rows.device)
                )
        return cls(program, tables, explicit, **kw)

    # ------------------------------------------------------------------ #
    def explain(self, pred: str, terms) -> dict | None:
        """Verified proof tree for ``pred(terms)``, or ``None`` if the
        fact is not in the materialisation."""
        terms = tuple(int(t) for t in terms)
        self._memo.clear()
        return self._explain(pred, terms, stack=set(), depth=0)

    # ------------------------------------------------------------------ #
    def _fact_str(self, pred: str, terms: tuple) -> str:
        if self.decode is not None:
            shown = ", ".join(str(self.decode(t)) for t in terms)
        else:
            shown = ", ".join(str(t) for t in terms)
        return f"{pred}({shown})"

    @staticmethod
    def _hits(rows: torch.Tensor, terms: tuple) -> torch.Tensor:
        want = torch.tensor(terms, dtype=_I64).to(rows.device)
        return (rows == want).all(dim=1)

    def _is_explicit(self, pred: str, terms: tuple) -> bool:
        rows = self.explicit.get(pred)
        if rows is None or rows.shape[0] == 0:
            return False
        if rows.dim() == 1:
            rows = rows.reshape(-1, 1)
        if rows.shape[1] != len(terms):
            return False
        return bool(self._hits(rows, terms).any())

    def _round_of(self, pred: str, terms: tuple) -> int | None:
        tab = self.tables.get(pred)
        if tab is None:
            return None
        rows, rounds = tab
        if rows.shape[0] == 0 or rows.shape[1] != len(terms):
            return None
        # one host read: the least round among the hits, or the sentinel
        r = int(torch.where(self._hits(rows, terms), rounds, _NO_ROUND).min())
        return None if r == _NO_ROUND else r

    def _source_rows(self, pred: str, head_stratum: int, max_round: int):
        """Rows of ``pred`` usable as body facts under the proof of a
        head in ``head_stratum`` first derived at ``max_round``."""
        tab = self.tables.get(pred)
        if tab is None:
            rows = self.explicit.get(pred)
            if rows is None:
                return None
            rows = rows.to(_I64)
            return rows.reshape(-1, 1) if rows.dim() == 1 else rows
        rows, rounds = tab
        if self.stratum_of.get(pred, -1) == head_stratum:
            rows = rows[rounds < max_round]
        return rows

    def _explain(self, pred: str, terms: tuple, stack: set, depth: int) -> dict | None:
        key = (pred, terms)
        if key in self._memo:
            return self._memo[key]
        if self._is_explicit(pred, terms):
            node = {
                "fact": self._fact_str(pred, terms),
                "pred": pred,
                "terms": list(terms),
                "kind": "explicit",
                "verified": True,
                "children": [],
            }
            self._memo[key] = node
            return node
        r = self._round_of(pred, terms)
        if r is None:
            return None  # not in the materialisation
        if depth >= self.max_depth or key in stack:
            return None
        stack = stack | {key}
        strat = self.stratum_of.get(pred, -1)
        for rid in self._candidate_rules(pred, r):
            rule = self.rules[rid]
            step = self._derive(rule, terms, strat, r)
            if step is None:
                continue
            body_facts, verified = step
            children = []
            ok = verified
            for b_pred, b_terms in body_facts:
                child = self._explain(b_pred, b_terms, stack, depth + 1)
                if child is None:
                    ok = False
                    break
                children.append(child)
            if not ok:
                continue
            node = {
                "fact": self._fact_str(pred, terms),
                "pred": pred,
                "terms": list(terms),
                "kind": "derived",
                "rule_id": rid,
                "rule": str(rule),
                "round": r,
                "verified": verified and all(c["verified"] for c in children),
                "children": children,
            }
            self._memo[key] = node
            return node
        return None

    def _candidate_rules(self, pred: str, r: int) -> list[int]:
        """Journal hits for (pred, round) first, then (pred, any round),
        then every rule with a matching head."""
        ordered: list[int] = []
        if self.journal is not None and self.journal.records:
            for rid in self.journal.rule_ids_for(pred, r):
                if rid < len(self.rules) and rid not in ordered:
                    ordered.append(rid)
            for rid in self.journal.rule_ids_for(pred):
                if rid < len(self.rules) and rid not in ordered:
                    ordered.append(rid)
        for rid, rule in enumerate(self.rules):
            if rule.head.predicate == pred and rid not in ordered:
                ordered.append(rid)
        return ordered

    def _derive(self, rule, terms: tuple, strat: int, r: int):
        """Re-derive ``head(terms)`` with ``rule`` under the round
        restriction: bind the head, join the restricted sources, and let
        the first solution row fix one fact per body atom; then verify
        that step alone.  Returns ``(body_facts, True)`` or None."""
        from ..core.datalog import Atom
        from ..core.flat import _join, _match_flat

        head = rule.head
        if len(head.terms) != len(terms):
            return None
        binding: dict[str, int] = {}
        for t, v in zip(head.terms, terms):
            if isinstance(t, int):
                if t != v:
                    return None
            elif binding.setdefault(t, v) != v:
                return None

        def bound(atom):
            return Atom(
                atom.predicate,
                tuple(binding.get(t, t) if isinstance(t, str) else t for t in atom.terms),
            )

        L = None
        for atom in rule.body:
            src = self._source_rows(atom.predicate, strat, r)
            if src is None or src.shape[0] == 0:
                return None
            R = _match_flat(bound(atom), src)
            if R is None:
                return None
            L = R if L is None else _join(L, R)
            if L.rows.shape[0] == 0:
                return None
        theta = dict(binding)
        if L is not None and L.vars:
            for v, val in zip(L.vars, L.rows[0].tolist()):
                theta[v] = int(val)
        body_facts = [
            (atom.predicate,
             tuple(theta[t] if isinstance(t, str) else int(t) for t in atom.terms))
            for atom in rule.body
        ]
        verified = self._check_step(rule, terms, body_facts)
        return (body_facts, verified) if verified else None

    def _check_step(self, rule, terms: tuple, body_facts: list) -> bool:
        """Apply the rule to exactly the chosen body facts (one row per
        atom, on the tables' device) and check the head equals the
        queried fact: rule semantics only, no journal, no tables."""
        from ..core.flat import _join, _match_flat

        L = None
        for atom, (_, fact) in zip(rule.body, body_facts):
            rows = torch.tensor([fact], dtype=_I64).to(self.device)
            R = _match_flat(atom, rows)
            if R is None:
                return False
            L = R if L is None else _join(L, R)
            if L.rows.shape[0] == 0:
                return False
        if L is not None and L.vars:
            sols = [dict(zip(L.vars, row)) for row in L.rows.tolist()]
        else:
            sols = [{}]
        for theta in sols:
            out = tuple(
                int(theta[t]) if isinstance(t, str) else int(t) for t in rule.head.terms
            )
            if out == terms:
                return True
        return False


def _dedup_min_round(rows: torch.Tensor, rounds: torch.Tensor):
    """Collapse duplicate rows to their minimum round; the unique rows
    come in lexicographic order (packed codes for pairs of dictionary
    ids, a row-wise unique otherwise)."""
    if rows.shape[0] == 0:
        return rows, rounds
    from ..core.util import unique_rows

    uniq, inv = unique_rows(rows, return_inverse=True)
    min_rounds = torch.full((uniq.shape[0],), _NO_ROUND, dtype=_I64, device=rows.device)
    min_rounds.scatter_reduce_(0, inv.reshape(-1), rounds.to(_I64), reduce="amin")
    return uniq.to(_I64), min_rounds


# --------------------------------------------------------------------- #
# exporters
# --------------------------------------------------------------------- #
def proof_to_json(node: dict, indent: int | None = 2) -> str:
    return json.dumps(node, indent=indent)


def proof_to_dot(node: dict, title: str = "proof") -> str:
    """Graphviz DOT rendering: facts are boxes, rule applications small
    circles labelled with the rule id."""
    lines = [
        f'digraph "{title}" {{',
        "  rankdir=BT;",
        '  node [fontname="monospace", fontsize=10];',
    ]
    counter = [0]

    def emit(n: dict) -> str:
        nid = f"f{counter[0]}"
        counter[0] += 1
        shape = "box" if n["kind"] == "derived" else "box, style=filled, fillcolor=lightgrey"
        check = "✓" if n.get("verified") else "?"
        lines.append(f'  {nid} [label="{n["fact"]} {check}", shape={shape}];')
        if n.get("children"):
            rnode = f"r{counter[0]}"
            counter[0] += 1
            rid = n.get("rule_id", -1)
            lines.append(f'  {rnode} [label="R{rid}", shape=circle, width=0.3];')
            lines.append(f"  {rnode} -> {nid};")
            for child in n["children"]:
                cid = emit(child)
                lines.append(f"  {cid} -> {rnode};")
        return nid

    emit(node)
    lines.append("}")
    return "\n".join(lines)


def now_ns() -> int:
    """Monotonic host clock for record timing."""
    return time.perf_counter_ns()
