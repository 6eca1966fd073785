"""LUBM's university data, drawn from the generation profile of its
generator (UBA, the Univ-Bench Artificial data generator; Guo, Pan and
Heflin, J. Web Semantics 3(2-3), 2005), in numpy.

The configuration's ``kb`` group holds the profile as it is run: every
range is inclusive, drawn uniformly, as UBA draws it.  Per university,
15-25 departments, each ``subOrganizationOf`` it.  Per department:

* faculty of four ranks (7-10 full, 10-14 associate, 8-11 assistant
  professors, 5-7 lecturers), each ``worksFor`` the department; one full
  professor is ``headOf`` it;
* each faculty member ``teacherOf`` 1-2 courses and 1-2 graduate courses
  of the department, no course taught twice; has an undergraduate,
  master's and doctoral degree from universities drawn over the degree
  pool, a research interest, and publications by rank (15-20, 10-18, 5-10,
  0-5), of which they are the ``publicationAuthor``;
* undergraduates, 8-14 per faculty member, and graduate students, 3-4 per
  faculty member, each ``memberOf`` the department; an undergraduate
  ``takesCourse`` 2-4 of its courses, and one in five has an ``advisor``
  among its professors; a graduate student takes 1-3 of its graduate
  courses, has an advisor among its professors and an undergraduate degree
  from the pool, and co-authors 0-5 of the advisor's publications;
* one in 4-5 graduate students is a ``TeachingAssistant`` of a course of
  the department, no course twice, and one in 3-4 of the others a
  ``ResearchAssistant``;
* 10-20 research groups, each ``subOrganizationOf`` the department.

Every entity has its UBA class (``rdf:type``) and every person a name, an
e-mail address and a telephone; courses and publications have names.

Ids are dense, in the order a dictionary would intern UBA's output read
university by university and department by department: first the
universities of the degree pool, then each department's block (the
department, its research groups, faculty by rank, courses, graduate
courses, undergraduates, graduate students, publications), then the
literals (names, the telephone, research interests, e-mail addresses).

It imports nothing of the program under test: it returns the explicit
facts as numpy id arrays, with the datalog rules' text, which the harness
hands to both the system under test and the reference.
"""

from __future__ import annotations

import numpy as np

from . import KB

__all__ = ["KB", "TINY", "WIDE", "generate"]

RANKS = ("FullProfessor", "AssociateProfessor", "AssistantProfessor", "Lecturer")
_PUBS = ("full", "associate", "assistant", "lecturer")

#: one university, about 160,000 triples
TINY = {"n_universities": 1}
#: five universities, whose ids pass 2**16
WIDE = {"n_universities": 5}


def _draw(rng, lohi, n: int) -> np.ndarray:
    lo, hi = lohi
    return rng.integers(lo, hi + 1, n)


def _seg_arange(counts: np.ndarray) -> np.ndarray:
    """``0..c-1`` for each segment of ``counts``, concatenated."""
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(int(counts.sum()), dtype=np.int64) - starts


def _distinct(rng, n: np.ndarray, k: np.ndarray, kmax: int):
    """For row ``i``, ``k[i]`` distinct draws from ``0..n[i]-1``: an
    ``(rows, kmax)`` array and the mask of the drawn columns.  Rows with a
    repeat are drawn again (``k <= n`` everywhere)."""
    rows = len(n)
    cols = np.arange(kmax)
    mask = cols[None, :] < k[:, None]
    out = np.floor(rng.random((rows, kmax)) * n[:, None]).astype(np.int64)
    redo = np.arange(rows)
    while redo.size:
        s = np.sort(np.where(mask[redo], out[redo], -1 - cols[None, :]), axis=1)
        redo = redo[(s[:, 1:] == s[:, :-1]).any(axis=1)]
        out[redo] = np.floor(rng.random((redo.size, kmax)) * n[redo, None]).astype(np.int64)
    return out, mask


def _rank_within(rng, group: np.ndarray) -> np.ndarray:
    """A random order within each group: the rank of every row among the
    rows of its group (``group`` sorted)."""
    order = np.lexsort((rng.random(len(group)), group))
    rank = np.empty(len(group), dtype=np.int64)
    rank[order] = _seg_arange(np.bincount(group, minlength=group.max(initial=-1) + 1))
    return rank


def generate(kb: dict, seed: int, program: str) -> KB:
    """The KB of the configuration's ``kb`` group, with the datalog
    ``program`` (its text) to materialise it under.

    Every count (departments, people, courses, publications, the courses
    each student takes, who is advised and who assists) is drawn from the
    configuration's ``size_seed``, so every run holds the same amount of
    work; every choice (which courses, advisor, publications, degree
    universities, head, assistants) from ``seed``."""
    size = np.random.default_rng(int(kb["size_seed"]))
    rng = np.random.default_rng(seed)
    p = kb["profile"]
    n_univ = int(kb["n_universities"])
    pool = int(kb["degree_universities"])
    n_research = int(kb["research_interests"])
    if pool < n_univ:
        raise ValueError("the degree pool holds the generated universities")

    # --- per department -------------------------------------------------
    n_dept_u = _draw(size, p["departments_per_university"], n_univ)
    dept_univ = np.repeat(np.arange(n_univ, dtype=np.int64), n_dept_u)
    dept_local = _seg_arange(n_dept_u)
    n_dept = len(dept_univ)
    by_rank = np.stack([_draw(size, p[r], n_dept) for r in
                        ("full_professors", "associate_professors",
                         "assistant_professors", "lecturers")], axis=1)
    n_fac = by_rank.sum(axis=1)
    n_prof = by_rank[:, :3].sum(axis=1)
    n_ug = n_fac * _draw(size, p["undergraduates_per_faculty"], n_dept)
    n_gs = n_fac * _draw(size, p["graduates_per_faculty"], n_dept)
    n_rg = _draw(size, p["research_groups"], n_dept)

    # --- per faculty member (department by department, rank by rank) -----
    fac_dept = np.repeat(np.arange(n_dept, dtype=np.int64), n_fac)
    fac_rank = np.repeat(np.tile(np.arange(4), n_dept), by_rank.reshape(-1))
    fac_local = _seg_arange(n_fac)
    rank_local = _seg_arange(by_rank.reshape(-1))
    nf = len(fac_dept)
    n_uc_f = _draw(size, p["courses_per_faculty"], nf)
    n_gc_f = _draw(size, p["graduate_courses_per_faculty"], nf)
    n_pub_f = np.zeros(nf, dtype=np.int64)
    for r, key in enumerate(_PUBS):
        at = fac_rank == r
        n_pub_f[at] = _draw(size, p["publications"][key], int(at.sum()))
    n_uc = np.bincount(fac_dept, weights=n_uc_f, minlength=n_dept).astype(np.int64)
    n_gc = np.bincount(fac_dept, weights=n_gc_f, minlength=n_dept).astype(np.int64)
    n_pub = np.bincount(fac_dept, weights=n_pub_f, minlength=n_dept).astype(np.int64)

    # --- ids: the degree pool, then one block a department ----------------
    block = 1 + n_rg + n_fac + n_uc + n_gc + n_ug + n_gs + n_pub
    dept_id = pool + np.cumsum(block) - block
    rg_at = dept_id + 1
    fac_at = rg_at + n_rg
    uc_at = fac_at + n_fac
    gc_at = uc_at + n_uc
    ug_at = gc_at + n_gc
    gs_at = ug_at + n_ug
    pub_at = gs_at + n_gs
    n_entities = pool + int(block.sum())

    fac = fac_at[fac_dept] + fac_local
    uc_dept = np.repeat(np.arange(n_dept, dtype=np.int64), n_uc)
    gc_dept = np.repeat(np.arange(n_dept, dtype=np.int64), n_gc)
    uc = uc_at[uc_dept] + _seg_arange(n_uc)
    gc = gc_at[gc_dept] + _seg_arange(n_gc)
    ug_dept = np.repeat(np.arange(n_dept, dtype=np.int64), n_ug)
    gs_dept = np.repeat(np.arange(n_dept, dtype=np.int64), n_gs)
    ug = ug_at[ug_dept] + _seg_arange(n_ug)
    gs = gs_at[gs_dept] + _seg_arange(n_gs)
    rg_dept = np.repeat(np.arange(n_dept, dtype=np.int64), n_rg)
    rg = rg_at[rg_dept] + _seg_arange(n_rg)
    pub_fac = np.repeat(np.arange(nf, dtype=np.int64), n_pub_f)
    pub_local = _seg_arange(n_pub_f)  # the index within its author's
    pub_first_f = pub_at[fac_dept] + (
        np.cumsum(n_pub_f) - n_pub_f - np.repeat(np.cumsum(n_pub) - n_pub, n_fac))
    pub = pub_first_f[pub_fac] + pub_local
    univ = np.arange(n_univ, dtype=np.int64)

    # --- relations ---------------------------------------------------------
    def pairs(a, b):
        return np.stack([np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)], axis=1)

    ds: dict[str, list[np.ndarray]] = {}

    def add(pred, rows):
        rows = np.asarray(rows, dtype=np.int64)
        ds.setdefault(pred, []).append(rows.reshape(len(rows), -1))

    add("University", univ)
    add("Department", dept_id)
    add("subOrganizationOf", pairs(dept_id, dept_univ))
    add("ResearchGroup", rg)
    add("subOrganizationOf", pairs(rg, dept_id[rg_dept]))
    for r, cls in enumerate(RANKS):
        add(cls, fac[fac_rank == r])
    add("worksFor", pairs(fac, dept_id[fac_dept]))
    head = fac_at + np.floor(rng.random(n_dept) * by_rank[:, 0]).astype(np.int64)
    add("headOf", pairs(head, dept_id))
    add("Course", uc)
    add("GraduateCourse", gc)
    add("teacherOf", pairs(np.repeat(fac, n_uc_f), uc))
    add("teacherOf", pairs(np.repeat(fac, n_gc_f), gc))
    for prop in ("undergraduateDegreeFrom", "mastersDegreeFrom", "doctoralDegreeFrom"):
        add(prop, pairs(fac, rng.integers(0, pool, nf)))
    add("Publication", pub)
    add("publicationAuthor", pairs(pub, fac[pub_fac]))

    add("UndergraduateStudent", ug)
    add("memberOf", pairs(ug, dept_id[ug_dept]))
    k = _draw(size, p["courses_per_undergraduate"], len(ug))
    pick, mask = _distinct(rng, n_uc[ug_dept], np.minimum(k, n_uc[ug_dept]), int(p["courses_per_undergraduate"][1]))
    add("takesCourse", pairs(np.broadcast_to(ug[:, None], pick.shape)[mask],
                             (uc_at[ug_dept][:, None] + pick)[mask]))
    advised = size.random(len(ug)) < 1.0 / float(p["undergraduates_per_advisee"])
    adv = fac_at[ug_dept] + np.floor(rng.random(len(ug)) * n_prof[ug_dept]).astype(np.int64)
    add("advisor", pairs(ug[advised], adv[advised]))

    add("GraduateStudent", gs)
    add("memberOf", pairs(gs, dept_id[gs_dept]))
    k = _draw(size, p["courses_per_graduate"], len(gs))
    pick, mask = _distinct(rng, n_gc[gs_dept], np.minimum(k, n_gc[gs_dept]), int(p["courses_per_graduate"][1]))
    add("takesCourse", pairs(np.broadcast_to(gs[:, None], pick.shape)[mask],
                             (gc_at[gs_dept][:, None] + pick)[mask]))
    adv_local = np.floor(rng.random(len(gs)) * n_prof[gs_dept]).astype(np.int64)
    adv_f = np.repeat(np.cumsum(n_fac) - n_fac, n_gs) + adv_local  # faculty row
    add("advisor", pairs(gs, fac[adv_f]))
    add("undergraduateDegreeFrom", pairs(gs, rng.integers(0, pool, len(gs))))
    k = _draw(size, p["publications"]["graduate"], len(gs))
    n_adv_pub = n_pub_f[adv_f]
    pick, mask = _distinct(rng, n_adv_pub, np.minimum(k, n_adv_pub), int(p["publications"]["graduate"][1]))
    add("publicationAuthor", pairs((pub_first_f[adv_f][:, None] + pick)[mask],
                                   np.broadcast_to(gs[:, None], pick.shape)[mask]))

    # teaching and research assistants: a random order of each
    # department's graduate students, and of its courses
    n_ta = n_gs // _draw(size, p["graduates_per_teaching_assistant"], n_dept)
    n_ra = n_gs // _draw(size, p["graduates_per_research_assistant"], n_dept)
    n_ta = np.minimum(n_ta, n_uc)
    gs_rank = _rank_within(rng, gs_dept)
    uc_rank = _rank_within(rng, uc_dept)
    uc_by_rank = np.empty_like(uc)
    uc_by_rank[(np.cumsum(n_uc) - n_uc)[uc_dept] + uc_rank] = uc
    ta = gs_rank < n_ta[gs_dept]
    ra = (~ta) & (gs_rank < (n_ta + n_ra)[gs_dept])
    add("TeachingAssistant", gs[ta])
    add("teachingAssistantOf", pairs(
        gs[ta], uc_by_rank[(np.cumsum(n_uc) - n_uc)[gs_dept[ta]] + gs_rank[ta]]))
    add("ResearchAssistant", gs[ra])

    # --- literals ------------------------------------------------------------
    # names: one literal per kind and index ("GraduateStudent12"), shared
    # by the departments; then the telephone, the research interests and
    # one e-mail address a person
    named = [
        ("University", univ, univ),
        ("Department", dept_id, dept_local),
        ("Faculty", fac, rank_local),
        ("Course", uc, _seg_arange(n_uc)),
        ("GraduateCourse", gc, _seg_arange(n_gc)),
        ("UndergraduateStudent", ug, _seg_arange(n_ug)),
        ("GraduateStudent", gs, _seg_arange(n_gs)),
        ("Publication", pub, pub_local),
    ]
    lit = n_entities
    for kind, ids, idx in named:
        if kind == "Faculty":  # a name pool per rank
            for r in range(4):
                at = fac_rank == r
                add("name", pairs(ids[at], lit + idx[at]))
                lit += int(by_rank[:, r].max(initial=0))
            continue
        add("name", pairs(ids, lit + idx))
        lit += int(idx.max(initial=-1)) + 1
    persons = np.sort(np.concatenate([fac, ug, gs]))
    add("telephone", pairs(persons, np.full(len(persons), lit)))
    lit += 1
    add("researchInterest", pairs(fac, lit + rng.integers(0, n_research, nf)))
    lit += n_research
    add("emailAddress", pairs(persons, lit + np.arange(len(persons))))
    lit += len(persons)

    dataset = {pred: np.unique(np.concatenate(parts), axis=0) for pred, parts in ds.items()}
    counts = {"university": n_univ, "department": n_dept, "faculty": nf,
              "undergraduate": len(ug), "graduate": len(gs), "course": len(uc) + len(gc),
              "publication": len(pub), "research_group": len(rg)}
    return KB(program, dataset, lit, counts)
