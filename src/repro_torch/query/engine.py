"""QueryEngine: the request path over a materialised compressed KB.

Materialise once (``CMatEngine``), freeze, then answer a stream of
conjunctive queries on the store's device::

    qe = QueryEngine(eng, dictionary)
    res = qe.answer("?s, ?c <- memberOf(?s, \"dept3\"), takesCourse(?s, ?c)")
    res.answers            # (n, 2) int64 tensor, sorted unique
    print(res.plan)        # inspectable plan
    res.stats.unfold_fractions()

Serving behaviour:

* **plan cache** (LRU): a query shape is planned once,
* **result cache** (LRU): repeated queries are answered by lookup; a
  caller gets a clone of the cached answers, so mutating it in place
  cannot poison later responses,
* scratch reclamation: every miss evaluates in a released scratch region
  of the column store, so memory stays flat across a query stream,
* **epoch stamping**: plan and result entries are stamped with the KB
  epoch they were computed at; :meth:`QueryEngine.bump_epoch` makes
  stale entries miss and evict lazily, so a mutated store can never serve
  pre-update answers — and a pre-update *plan* is re-planned too.

The kernels run wherever the store's tensors lie (the card, or their
plain versions on the CPU), so there is no kernel switch.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch

from ..core.engine import CMatEngine
from ..core.frozen import FrozenFacts
from ..core.metafacts import FactStore
from ..core.terms import Dictionary
from ..obs import span
from .ast import Query, parse_query
from .exec import ExecStats, execute
from .plan import Plan, plan_query

__all__ = ["QueryEngine", "QueryResult"]

#: sentinel for constants absent from the dictionary: no stored fact can
#: contain it (term ids are dense and non-negative), so any atom naming
#: it provably matches nothing
_UNKNOWN_CONSTANT = -1


class _LookupOnlyDict:
    """Read-only dictionary view for query parsing: unseen constants map
    to :data:`_UNKNOWN_CONSTANT` instead of being interned, so a stream
    of queries over unknown terms cannot grow the shared dictionary.
    (Two distinct unknown constants collide on the sentinel, but every
    query naming one has a provably empty answer set.)"""

    def __init__(self, base: Dictionary):
        self._base = base

    def intern(self, term: str) -> int:
        if term in self._base:
            return self._base.id_of(term)
        return _UNKNOWN_CONSTANT


@dataclass
class QueryResult:
    query: Query
    answers: torch.Tensor  # (n, len(projection)) int64, sorted unique
    plan: Plan
    stats: ExecStats
    from_cache: bool = False

    @property
    def n_answers(self) -> int:
        return int(self.answers.shape[0])

    @property
    def ask(self) -> bool:
        """Truth value for ASK queries (any query: 'has answers')."""
        return self.answers.shape[0] > 0


class QueryEngine:
    """Answers BGP queries directly over the frozen ``<M, mu>`` store, on
    that store's device."""

    def __init__(
        self,
        source: CMatEngine | FactStore | FrozenFacts,
        dictionary: Dictionary | None = None,
        *,
        plan_cache_size: int = 256,
        result_cache_size: int = 1024,
    ):
        self.frozen = self._resolve_frozen(source)
        self.dictionary = dictionary
        # 'is not None': an empty Dictionary is falsy but still a dictionary
        self._parse_dict = (
            _LookupOnlyDict(dictionary) if dictionary is not None else None
        )
        self._plan_cache: OrderedDict[Query, tuple[int, Plan]] = OrderedDict()
        self._result_cache: OrderedDict[Query, tuple[int, QueryResult]] = OrderedDict()
        self._text_cache: OrderedDict[str, Query] = OrderedDict()
        self._plan_cache_size = plan_cache_size
        self._result_cache_size = result_cache_size
        self.plan_hits = self.plan_misses = 0
        self.result_hits = self.result_misses = 0
        #: KB version: entries cached at an older epoch are stale
        self.epoch = 0
        self.stale_evictions = 0

    # ------------------------------------------------------------------ #
    @staticmethod
    def _resolve_frozen(source) -> FrozenFacts:
        if isinstance(source, FrozenFacts):
            return source
        if isinstance(source, CMatEngine):
            return source.facts.freeze()
        if isinstance(source, FactStore):
            return source.freeze()
        if hasattr(source, "freeze"):
            return source.freeze()
        raise TypeError(f"cannot build QueryEngine from {type(source)!r}")

    def bump_epoch(self, source) -> None:
        """Switch to a new KB snapshot after an applied update batch.

        Every plan/result entry cached before this call is stamped with
        the previous epoch and will miss (and be evicted) on its next
        lookup."""
        self.frozen = self._resolve_frozen(source)
        self.epoch += 1

    # ------------------------------------------------------------------ #
    @staticmethod
    def _lru_get(cache: OrderedDict, key):
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
        return hit

    @staticmethod
    def _lru_put(cache: OrderedDict, key, value, capacity: int) -> None:
        cache[key] = value
        if len(cache) > capacity:
            cache.popitem(last=False)

    def _stamped_get(self, cache: OrderedDict, key):
        """Epoch-checked LRU lookup: entries stamped with an older epoch
        are evicted and reported as misses."""
        hit = cache.get(key)
        if hit is None:
            return None
        entry_epoch, value = hit
        if entry_epoch != self.epoch:
            del cache[key]
            self.stale_evictions += 1
            return None
        cache.move_to_end(key)
        return value

    def _stamped_put(self, cache: OrderedDict, key, value, capacity: int) -> None:
        cache[key] = (self.epoch, value)
        if len(cache) > capacity:
            cache.popitem(last=False)

    def parse(self, text: str) -> Query:
        """Parse query text (LRU-cached, so repeated requests skip the
        regex work; never interns new terms into the dictionary)."""
        query = self._lru_get(self._text_cache, text)
        if query is None:
            query = parse_query(text, self._parse_dict)
            # must not be smaller than the result cache it gates, or hot
            # result hits beyond its capacity re-parse on every request
            self._lru_put(
                self._text_cache,
                text,
                query,
                max(self._plan_cache_size, self._result_cache_size, 1),
            )
        return query

    def plan(self, query: Query | str) -> Plan:
        if isinstance(query, str):
            query = self.parse(query)
        plan = self._stamped_get(self._plan_cache, query)
        if plan is not None:
            self.plan_hits += 1
            return plan
        self.plan_misses += 1
        plan = plan_query(query, self.frozen)
        self._stamped_put(self._plan_cache, query, plan, self._plan_cache_size)
        return plan

    def explain(self, query: Query | str) -> str:
        return self.plan(query).explain()

    @staticmethod
    def _handed_out(result: QueryResult, query: Query | None = None,
                    from_cache: bool = True) -> QueryResult:
        """A caller's copy of a cached result: its own answers tensor."""
        return QueryResult(
            result.query if query is None else query,
            result.answers.clone(), result.plan, result.stats,
            from_cache=from_cache,
        )

    def answer(self, query: Query | str) -> QueryResult:
        with span("query.answer") as sp:
            if isinstance(query, str):
                query = self.parse(query)
            if self._result_cache_size > 0:
                hit = self._stamped_get(self._result_cache, query)
                if hit is not None:
                    self.result_hits += 1
                    sp.set(cached=True, n_answers=hit.n_answers)
                    return self._handed_out(hit, query)
            self.result_misses += 1
            plan = self.plan(query)
            answers, stats = execute(plan, self.frozen)
            result = QueryResult(query, answers, plan, stats)
            sp.set(cached=False, n_answers=result.n_answers)
            if self._result_cache_size > 0:
                self._stamped_put(
                    self._result_cache, query, result, self._result_cache_size,
                )
                return self._handed_out(result, from_cache=False)
            return result

    # ------------------------------------------------------------------ #
    # micro-batch admission (see query.batch)
    # ------------------------------------------------------------------ #
    def cached(self, query: Query | str) -> QueryResult | None:
        """Result-cache peek (epoch-checked, counts as a hit when it
        lands; no evaluation on miss — the batch executor uses this to
        skip already-answered members of a signature group)."""
        if isinstance(query, str):
            query = self.parse(query)
        if self._result_cache_size <= 0:
            return None
        hit = self._stamped_get(self._result_cache, query)
        if hit is None:
            return None
        self.result_hits += 1
        return self._handed_out(hit, query)

    def seed_result(self, result: QueryResult) -> None:
        """Install an externally computed result (e.g. a split of a
        generalised batched answer) into the result cache, stamped with
        the current epoch."""
        if self._result_cache_size > 0:
            self._stamped_put(
                self._result_cache, result.query, result,
                self._result_cache_size,
            )

    def answer_batch(self, queries, *, min_group: int = 2):
        """Answer a micro-batch with shared-plan grouping: queries with
        the same constant-abstracted signature and one constant slot run
        as a single generalised scan/join.  Returns ``(results,
        BatchStats)`` with ``results`` aligned to the input order."""
        from .batch import answer_group

        parsed = [
            self.parse(q) if isinstance(q, str) else q for q in queries
        ]
        by_query, stats = answer_group(self, parsed, min_group=min_group)
        return [by_query[q] for q in parsed], stats

    # ------------------------------------------------------------------ #
    def decode(self, answers: torch.Tensor) -> list[tuple[str, ...]]:
        """Render answer rows back to term strings via the dictionary
        (one read of the answers to the host)."""
        if self.dictionary is None:
            raise ValueError("no dictionary attached")
        return [
            tuple(self.dictionary.term_of(v) for v in row)
            for row in answers.cpu().tolist()
        ]

    def cache_stats(self) -> dict:
        return {
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "result_hits": self.result_hits,
            "result_misses": self.result_misses,
            "stale_evictions": self.stale_evictions,
        }
