"""Term dictionary: external RDF terms (strings) <-> dense int64 ids.

The paper requires an arbitrary but fixed total order ``<`` over constants
(Section 3, "Representation and Framework").  Like most RDF stores we
dictionary-encode terms as integers and use integer order as ``<``.
"""

from __future__ import annotations

import numpy as np

RDF_TYPE = "rdf:type"


class Dictionary:
    """Bidirectional mapping between term strings and int64 ids.

    Ids are assigned densely in first-seen order.  The total order over
    constants used by the engine is plain integer order on these ids.
    """

    __slots__ = ("_to_id", "_to_term")

    def __init__(self) -> None:
        self._to_id: dict[str, int] = {}
        self._to_term: list[str] = []

    def __len__(self) -> int:
        return len(self._to_term)

    def intern(self, term: str) -> int:
        tid = self._to_id.get(term)
        if tid is None:
            tid = len(self._to_term)
            self._to_id[term] = tid
            self._to_term.append(term)
        return tid

    def intern_many(self, terms) -> np.ndarray:
        return np.asarray([self.intern(t) for t in terms], dtype=np.int64)

    def id_of(self, term: str) -> int:
        return self._to_id[term]

    def term_of(self, tid: int) -> str:
        return self._to_term[tid]

    def __contains__(self, term: str) -> bool:
        return term in self._to_id
