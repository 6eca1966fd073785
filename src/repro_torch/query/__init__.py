"""Compressed query answering: BGP queries served directly over meta-facts,
on the store's device.

The request path of the paper's pipeline: materialisation is a
preprocessing step; this package answers conjunctive (BGP-style) queries
*on the compressed ``<M, mu>`` representation* without unfolding the
store:

* :mod:`ast` — query AST + text parser (rule-atom syntax),
* :mod:`plan` — selectivity-ordered plans over frozen-store statistics,
* :mod:`exec` — plan execution with the engine's ``match``/``sjoin``/
  ``xjoin`` primitives plus indexed constant lookups (the
  ``join_bounds`` and ``sorted_member`` kernels),
* :mod:`batch` — shared-plan micro-batches,
* :mod:`engine` — :class:`QueryEngine`, the cached serving facade,
* :mod:`ref` — the flat-join correctness oracle.
"""

from .ast import Query, parse_query
from .batch import BatchStats, answer_group, plan_signature
from .engine import QueryEngine, QueryResult
from .exec import ExecStats, execute
from .plan import JoinStep, Plan, ScanStep, plan_query
from .ref import answer_flat

__all__ = [
    "BatchStats",
    "ExecStats",
    "JoinStep",
    "Plan",
    "Query",
    "QueryEngine",
    "QueryResult",
    "ScanStep",
    "answer_flat",
    "answer_group",
    "execute",
    "parse_query",
    "plan_query",
    "plan_signature",
]
