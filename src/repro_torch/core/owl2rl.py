"""OWL 2 RL-style datalog rule templates (Grosof et al. lower-bound style),
on the port's own :mod:`.datalog` (no kernel: rules are host objects).

The paper obtains its test programs by applying the sound-but-incomplete
transformation of Grosof et al. [7] to OWL ontologies (without
axiomatising owl:sameAs).  This module provides the same template rules so
users can build `lower bound` programs from schema triples:

    subClassOf(C, D):        C(x) -> D(x)
    subPropertyOf(P, Q):     P(x, y) -> Q(x, y)
    domain(P, C):            P(x, y) -> C(x)
    range(P, C):             P(x, y) -> C(y)
    transitive(P):           P(x, y), P(y, z) -> P(x, z)
    symmetric(P):            P(x, y) -> P(y, x)
    inverseOf(P, Q):         P(x, y) -> Q(y, x)
    someValuesFrom(P, C, D): P(x, y), C(y) -> D(x)   (Grosof clause)
    intersectionOf(C, D, E): C(x), D(x) -> E(x)
"""

from __future__ import annotations

from .datalog import Atom, Program, Rule

__all__ = ["OntologyBuilder"]


class OntologyBuilder:
    """Accumulates schema axioms and emits the lower-bound program."""

    def __init__(self) -> None:
        self.rules: list[Rule] = []

    # class axioms ---------------------------------------------------- #
    def sub_class_of(self, c: str, d: str) -> "OntologyBuilder":
        self.rules.append(Rule((Atom(c, ("x",)),), Atom(d, ("x",))))
        return self

    def intersection_of(self, c: str, d: str, e: str) -> "OntologyBuilder":
        self.rules.append(
            Rule((Atom(c, ("x",)), Atom(d, ("x",))), Atom(e, ("x",)))
        )
        return self

    def some_values_from(self, p: str, c: str, d: str) -> "OntologyBuilder":
        self.rules.append(
            Rule((Atom(p, ("x", "y")), Atom(c, ("y",))), Atom(d, ("x",)))
        )
        return self

    # property axioms -------------------------------------------------- #
    def sub_property_of(self, p: str, q: str) -> "OntologyBuilder":
        self.rules.append(Rule((Atom(p, ("x", "y")),), Atom(q, ("x", "y"))))
        return self

    def domain(self, p: str, c: str) -> "OntologyBuilder":
        self.rules.append(Rule((Atom(p, ("x", "y")),), Atom(c, ("x",))))
        return self

    def range(self, p: str, c: str) -> "OntologyBuilder":
        self.rules.append(Rule((Atom(p, ("x", "y")),), Atom(c, ("y",))))
        return self

    def transitive(self, p: str) -> "OntologyBuilder":
        self.rules.append(
            Rule(
                (Atom(p, ("x", "y")), Atom(p, ("y", "z"))),
                Atom(p, ("x", "z")),
            )
        )
        return self

    def symmetric(self, p: str) -> "OntologyBuilder":
        self.rules.append(Rule((Atom(p, ("x", "y")),), Atom(p, ("y", "x"))))
        return self

    def inverse_of(self, p: str, q: str) -> "OntologyBuilder":
        self.rules.append(Rule((Atom(p, ("x", "y")),), Atom(q, ("y", "x"))))
        self.rules.append(Rule((Atom(q, ("x", "y")),), Atom(p, ("y", "x"))))
        return self

    def property_chain(self, p: str, q: str, r: str) -> "OntologyBuilder":
        """p o q -> r (OWL 2 RL property chain)."""
        self.rules.append(
            Rule(
                (Atom(p, ("x", "y")), Atom(q, ("y", "z"))),
                Atom(r, ("x", "z")),
            )
        )
        return self

    def build(self) -> Program:
        return Program(list(self.rules))
