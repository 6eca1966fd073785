"""Query planner: the shared body compiler applied to BGP queries.

A query body is a conjunction of atoms — the same planning problem as a
rule body under semi-naive evaluation, so since the one-body-compiler
refactor all of the actual logic (cardinality estimation, greedy
connected-selectivity ordering, join-kind/direction selection, the
``Plan``/``ScanStep``/``JoinStep`` types) lives in
:mod:`repro_torch.core.compile` and is shared with all three materialisation
engines.  This module is the request-path entry point: it feeds the
compiler :class:`~repro_torch.core.frozen.FrozenFacts` statistics (exact
constant frequencies once a snapshot exists, RLE-run estimates
otherwise) and attaches the query so plans ``explain()`` with their
projection.

Plans carry only estimates; the executor (``exec.py``) records actuals.
"""

from __future__ import annotations

from ..core.compile import (
    SCAN_INDEX,
    SCAN_SHARE,
    JoinStep,
    Plan,
    ScanStep,
    compile_body,
    estimate_rows,
)
from ..core.frozen import FrozenFacts
from .ast import Query

__all__ = [
    "ScanStep",
    "JoinStep",
    "Plan",
    "plan_query",
    "estimate_rows",
    "SCAN_SHARE",
    "SCAN_INDEX",
]


def plan_query(query: Query, frozen: FrozenFacts) -> Plan:
    """Greedy selectivity-ordered plan (constants bound first)."""
    return compile_body(
        query.body, frozen, projection=query.projection, query=query
    )
