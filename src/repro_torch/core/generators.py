"""Synthetic RDF knowledge-base generators.

The paper's evaluation datasets (LUBM-1K, Reactome, Claros) are not
redistributable here, so we generate structurally-analogous KBs:

* :func:`paper_example` — the exact running example of Section 3.
* :func:`lubm_like` — a university-domain KB with the regularity LUBM has
  (departments, students, courses, advisors) and a recursive L-style
  program; highly regular -> high compressibility (paper's LUBM row).
* :func:`chain` — transitive closure over a path: quadratic derivation
  count from linear input (paper's Claros_LE 'difficult rules' regime).
* :func:`star` / :func:`bipartite` — join-heavy shapes exercising xjoin.
* :func:`random_kb` — randomised KBs for property-based testing.
"""

from __future__ import annotations

import numpy as np

from .datalog import Program, parse_program
from .terms import Dictionary

__all__ = [
    "paper_example",
    "lubm_like",
    "chain",
    "star",
    "bipartite",
    "random_kb",
]


def paper_example(n: int = 4, m: int = 3):
    """The running example of Section 3 (facts (1)-(4), rules (5)-(6)).

    Constants are laid out exactly in the paper's order:
    ``a_1 < ... < a_2n < b_1 < ... < b_m < c_1 < ... < c_m < d < e_*``.
    """
    d = Dictionary()
    a = [d.intern(f"a{i}") for i in range(1, 2 * n + 1)]
    b = [d.intern(f"b{i}") for i in range(1, m + 1)]
    c = [d.intern(f"c{i}") for i in range(1, m + 1)]
    dd = d.intern("d")
    e = [d.intern(f"e{i}") for i in range(1, m + 1)]

    P = np.asarray(
        [[ai, dd] for ai in a] + [[bi, ci] for bi, ci in zip(b, c)], dtype=np.int64
    )
    R = np.asarray([[a[2 * i - 1]] for i in range(1, n + 1)], dtype=np.int64)
    T = np.asarray([[dd, ei] for ei in e], dtype=np.int64)

    program = parse_program(
        """
        P(x, y), R(x) -> S(x, y)
        S(x, y), T(y, z) -> P(x, z)
        """
    )
    return program, {"P": P, "R": R, "T": T}, d


def lubm_like(n_dept: int = 20, n_students: int = 200, n_courses: int = 25, seed: int = 0):
    """University-domain KB with LUBM-style regularity.

    Schema (vertically partitioned predicates):
      memberOf(student, dept), subOrganizationOf(dept, univ),
      takesCourse(student, course), teacherOf(prof, course),
      advisor(student, prof), GraduateStudent(s), Professor(p)

    Recursive program (lower-bound style): the bulk of LUBM_L's rules are
    taxonomic (subclass / subproperty / domain / range) — these produce
    the paper's headline compression because every derived level shares
    the source columns wholesale — plus joins and a recursive clique.
    """
    rng = np.random.default_rng(seed)
    d = Dictionary()
    univ = d.intern("univ0")
    depts = d.intern_many([f"dept{i}" for i in range(n_dept)])
    students = d.intern_many([f"student{i}" for i in range(n_students)])
    profs = d.intern_many([f"prof{i}" for i in range(max(2, n_dept * 2))])
    courses = d.intern_many([f"course{i}" for i in range(n_courses)])

    member_of = np.stack(
        [students, depts[rng.integers(0, n_dept, n_students)]], axis=1
    )
    sub_org = np.stack([depts, np.full(n_dept, univ)], axis=1)
    takes = np.stack(
        [
            np.repeat(students, 3),
            courses[rng.integers(0, n_courses, 3 * n_students)],
        ],
        axis=1,
    )
    teacher_of = np.stack([profs[rng.integers(0, len(profs), n_courses)], courses], axis=1)
    advisor = np.stack(
        [students, profs[rng.integers(0, len(profs), n_students)]], axis=1
    )
    grad = students[rng.random(n_students) < 0.4].reshape(-1, 1)

    program = parse_program(
        """
        memberOf(x, dv), subOrganizationOf(dv, u) -> memberOfOrg(x, u)
        takesCourse(s, cv), teacherOf(p, cv) -> taughtBy(s, p)
        taughtBy(s, p) -> knows(s, p)
        advisor(s, p) -> knows(s, p)
        # taxonomic chains (the LUBM_L profile: most rules are unary)
        GraduateStudent(s) -> Student(s)
        Student(s) -> Person(s)
        Person(s) -> Agent(s)
        Agent(s) -> Thing(s)
        # domain/range derivations
        advisor(s, p) -> Student(s)
        advisor(s, p) -> Professor(p)
        Professor(p) -> Faculty(p)
        Faculty(p) -> Employee(p)
        Employee(p) -> Person(p)
        teacherOf(p, cv) -> Professor(p)
        teacherOf(p, cv) -> Course(cv)
        takesCourse(s, cv) -> Course(cv)
        memberOf(x, dv) -> Organization(dv)
        subOrganizationOf(dv, u) -> Organization(dv)
        subOrganizationOf(dv, u) -> Organization(u)
        # subproperty
        advisor(s, p) -> worksWith(s, p)
        taughtBy(s, p) -> worksWith(s, p)
        Student(s), memberOfOrg(s, u) -> OrgMember(s)
        knows(x, y), knows(y, z) -> connected(x, z)
        connected(x, y) -> knows(x, y)
        """
    )
    dataset = {
        "memberOf": member_of,
        "subOrganizationOf": sub_org,
        "takesCourse": np.unique(takes, axis=0),
        "teacherOf": teacher_of,
        "advisor": advisor,
        "GraduateStudent": grad,
    }
    return program, dataset, d


def chain(n: int = 200):
    """Transitive closure over a path graph — O(n^2) derived facts from
    O(n) input (the paper's Claros_LE 'difficult rules' regime)."""
    d = Dictionary()
    nodes = d.intern_many([f"v{i:06d}" for i in range(n + 1)])
    edge = np.stack([nodes[:-1], nodes[1:]], axis=1)
    program = parse_program(
        """
        edge(x, y) -> path(x, y)
        path(x, y), edge(y, z) -> path(x, z)
        """
    )
    return program, {"edge": edge}, d


def star(n_spokes: int = 1000, n_hubs: int = 3):
    """Hub-and-spoke KB: semi-join heavy (the paper's rule (5) pattern)."""
    d = Dictionary()
    hubs = d.intern_many([f"hub{i}" for i in range(n_hubs)])
    spokes = d.intern_many([f"s{i:06d}" for i in range(n_spokes)])
    P = np.stack(
        [np.tile(spokes, n_hubs), np.repeat(hubs, n_spokes)], axis=1
    )
    R = spokes[::2].reshape(-1, 1)
    T = np.stack(
        [np.repeat(hubs, 4), d.intern_many([f"t{i}" for i in range(4 * n_hubs)])],
        axis=1,
    )
    program = parse_program(
        """
        P(x, y), R(x) -> S(x, y)
        S(x, y), T(y, z) -> Q(x, z)
        """
    )
    return program, {"P": P, "R": R, "T": T}, d


def bipartite(n_left: int = 300, n_right: int = 300, seed: int = 1):
    """Dense bipartite cross-join workload (worst case for flat storage)."""
    rng = np.random.default_rng(seed)
    d = Dictionary()
    left = d.intern_many([f"l{i:05d}" for i in range(n_left)])
    right = d.intern_many([f"r{i:05d}" for i in range(n_right)])
    mid = d.intern("mid")
    A = np.stack([left, np.full(n_left, mid)], axis=1)
    B = np.stack([np.full(n_right, mid), right], axis=1)
    program = parse_program("A(x, y), B(y, z) -> C(x, z)")
    _ = rng
    return program, {"A": A, "B": B}, d


def random_kb(
    rng: np.random.Generator,
    n_constants: int = 12,
    n_facts: int = 40,
    n_rules: int = 4,
    predicates=("P", "Q", "R", "S"),
):
    """Random small KB + recursive program for property-based testing."""
    from .datalog import Atom, Rule

    arity = {p: int(rng.integers(1, 3)) for p in predicates}
    dataset = {}
    for p in predicates:
        k = arity[p]
        rows = rng.integers(0, n_constants, size=(n_facts, k)).astype(np.int64)
        dataset[p] = np.unique(rows, axis=0)

    variables = ["x", "y", "z", "w"]
    rules = []
    attempts = 0
    while len(rules) < n_rules and attempts < 200:
        attempts += 1
        n_body = int(rng.integers(1, 4))
        body = []
        for _ in range(n_body):
            p = predicates[int(rng.integers(0, len(predicates)))]
            terms = tuple(
                variables[int(rng.integers(0, len(variables)))]
                for _ in range(arity[p])
            )
            body.append(Atom(p, terms))
        body_vars = [v for a in body for v in a.variables()]
        if not body_vars:
            continue
        hp = predicates[int(rng.integers(0, len(predicates)))]
        head_terms = tuple(
            body_vars[int(rng.integers(0, len(body_vars)))] for _ in range(arity[hp])
        )
        try:
            rules.append(Rule(tuple(body), Atom(hp, head_terms)))
        except ValueError:
            continue
    return Program(rules), dataset
