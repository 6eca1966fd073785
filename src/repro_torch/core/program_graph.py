"""Predicate-dependency graph and fixpoint stratification.

The head→body dependency graph of a datalog program tells the fixpoint
which rules can possibly fire when: a rule whose body predicates all
belong to already-completed strata can never derive anything new once
its stratum's fixpoint is reached.  Running the semi-naive loop
stratum-by-stratum (strongly connected components of the dependency
graph, in topological order) therefore skips whole rule groups in every
round — the paper's "fewer rule applications" goal lifted from the
per-round delta check to the program structure.

For positive datalog (this repo's fragment) stratification is purely an
evaluation-order optimisation: the materialisation is identical, which
the differential tests in ``tests/test_compile.py`` pin down.
"""

from __future__ import annotations

from .datalog import Program, Rule

__all__ = [
    "dependency_graph",
    "condensation",
    "stratify",
    "explain_strata",
    "is_recursive",
    "stratum_predicates",
]


def dependency_graph(program: Program) -> dict[str, set[str]]:
    """``edges[b] = {h, ...}``: body predicate ``b`` feeds head ``h``.

    Every predicate mentioned anywhere in the program appears as a node
    (possibly with no outgoing edges)."""
    edges: dict[str, set[str]] = {}
    for rule in program:
        edges.setdefault(rule.head.predicate, set())
        for atom in rule.body:
            edges.setdefault(atom.predicate, set()).add(rule.head.predicate)
    return edges


def _tarjan_sccs(edges: dict[str, set[str]]) -> list[list[str]]:
    """Iterative Tarjan.  SCCs are emitted in reverse topological order
    of the condensation (every SCC after all SCCs it has edges into)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = 0

    for root in sorted(edges):  # deterministic traversal
        if root in index:
            continue
        work = [(root, iter(sorted(edges[root])))]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter
                    counter += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(edges[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
    return sccs


def condensation(program: Program) -> list[list[str]]:
    """SCCs of the dependency graph in topological order: every
    component's body-side dependencies come before it."""
    edges = dependency_graph(program)
    # Tarjan emits successors (heads) first; heads must run *after*
    # their body predicates, so reverse into bodies-first order.
    return list(reversed(_tarjan_sccs(edges)))


def stratify(program: Program) -> list[list[Rule]]:
    """Partition the rules into strata to run in order.

    A rule belongs to the stratum of its head predicate's SCC; since a
    body predicate ``b`` has an edge into the head, ``b``'s component is
    never later than the head's, so by the time a stratum runs, every
    body predicate from earlier strata is fully materialised and only
    the stratum's own (mutually recursive) predicates still iterate.
    Components that head no rule (EDB-only predicates) yield no stratum.
    Rule order inside a stratum follows the program text (determinism).
    """
    comps = condensation(program)
    stratum_of = {
        pred: k for k, comp in enumerate(comps) for pred in comp
    }
    buckets: dict[int, list[Rule]] = {}
    for rule in program:
        buckets.setdefault(stratum_of[rule.head.predicate], []).append(rule)
    return [buckets[k] for k in sorted(buckets)]


def explain_strata(program: Program) -> str:
    """Human-readable stratification report."""
    strata = stratify(program)
    lines = [f"{len(strata)} strata over {len(program)} rules"]
    for k, rules in enumerate(strata):
        heads = sorted({r.head.predicate for r in rules})
        tag = " (recursive)" if is_recursive(rules) else ""
        lines.append(
            f"  stratum {k}: {len(rules)} rule(s), heads [{', '.join(heads)}]{tag}"
        )
    return "\n".join(lines)


def stratum_predicates(rules: list[Rule]) -> tuple[set[str], set[str]]:
    """``(heads, body_preds)`` of one stratum's rules — the predicates a
    fixpoint driver must watch for deltas (bodies) and the predicates the
    stratum can change (heads).  Shared by the incremental sweeps and the
    distributed stratum scheduler."""
    heads = {r.head.predicate for r in rules}
    bodies = {a.predicate for r in rules for a in r.body}
    return heads, bodies


def is_recursive(rules: list[Rule]) -> bool:
    """True iff a stratum's rules feed their own heads (mutual recursion).

    Non-recursive strata reach fixpoint in one round, and — used by the
    incremental subsystem — admit *exact* derivation-count maintenance;
    recursive strata fall back to Delete/Rederive."""
    heads = {r.head.predicate for r in rules}
    return any(a.predicate in heads for r in rules for a in r.body)
