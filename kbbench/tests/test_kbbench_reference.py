"""The benchmark's generator keeps to UBA's profile, its reference agrees
with the program at small sizes, and its comparison sees every
difference."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kbbench.compare import fact_mismatches
from kbbench.data import uba
from kbbench.reference import flat

from .conftest import ROOT, cells, config_of

SEEDS = [0, 2147483661, 2**31 + 7]


def _config() -> dict:
    return config_of(cells()[0])


def _kb(seed: int, n_universities: int = 1) -> tuple[uba.KB, dict]:
    cfg = _config()
    cfg["kb"]["n_universities"] = n_universities
    rules = (ROOT / cfg["program"]).read_text()
    return uba.generate(cfg["kb"], seed, rules), cfg["kb"]["profile"]


class _Depts:
    """Each entity's department, from the id layout: a department's block
    of ids starts at the department."""

    def __init__(self, kb: uba.KB):
        self.ids = np.sort(kb.dataset["Department"][:, 0])

    def of(self, ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.ids, ids, side="right") - 1


def _within(values, lohi) -> bool:
    lo, hi = lohi
    return bool(values.size) and lo <= values.min() and values.max() <= hi


def _per(keys: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(keys, minlength=n)


def check_departments(kb, p):
    univ = kb.dataset["subOrganizationOf"]
    depts = kb.dataset["Department"][:, 0]
    to_univ = univ[np.isin(univ[:, 0], depts)]
    assert len(to_univ) == len(depts)
    assert _within(np.bincount(to_univ[:, 1])[np.unique(to_univ[:, 1])],
                   p["departments_per_university"])


def check_faculty(kb, p):
    d = _Depts(kb)
    n = len(d.ids)
    for cls, key in zip(uba.RANKS, ("full_professors", "associate_professors",
                                     "assistant_professors", "lecturers")):
        assert _within(_per(d.of(kb.dataset[cls][:, 0]), n), p[key])
    works = kb.dataset["worksFor"]
    assert (d.of(works[:, 0]) == d.of(works[:, 1])).all()
    head = kb.dataset["headOf"]
    assert (_per(d.of(head[:, 1]), n) == 1).all()
    assert np.isin(head[:, 0], kb.dataset["FullProfessor"][:, 0]).all()
    assert (d.of(head[:, 0]) == d.of(head[:, 1])).all()


def check_students(kb, p):
    d = _Depts(kb)
    n = len(d.ids)
    fac = _per(d.of(kb.dataset["worksFor"][:, 0]), n)
    ug = _per(d.of(kb.dataset["UndergraduateStudent"][:, 0]), n)
    gs = _per(d.of(kb.dataset["GraduateStudent"][:, 0]), n)
    assert (ug % fac == 0).all() and _within(ug // fac, p["undergraduates_per_faculty"])
    assert (gs % fac == 0).all() and _within(gs // fac, p["graduates_per_faculty"])
    member = kb.dataset["memberOf"]
    assert len(member) == ug.sum() + gs.sum()
    assert (d.of(member[:, 0]) == d.of(member[:, 1])).all()


def check_courses(kb, p):
    d = _Depts(kb)
    teach = kb.dataset["teacherOf"]
    assert (d.of(teach[:, 0]) == d.of(teach[:, 1])).all()
    courses = np.concatenate([kb.dataset["Course"][:, 0], kb.dataset["GraduateCourse"][:, 0]])
    assert np.array_equal(np.sort(teach[:, 1]), np.sort(courses))  # each taught once
    is_grad = np.isin(teach[:, 1], kb.dataset["GraduateCourse"][:, 0])
    fac = kb.dataset["worksFor"][:, 0]
    for grad, key in ((False, "courses_per_faculty"), (True, "graduate_courses_per_faculty")):
        per = np.unique(teach[is_grad == grad, 0], return_counts=True)
        assert np.array_equal(per[0], np.sort(fac)) and _within(per[1], p[key])


def check_takes(kb, p):
    d = _Depts(kb)
    takes = kb.dataset["takesCourse"]
    assert (d.of(takes[:, 0]) == d.of(takes[:, 1])).all()
    for cls, course, key in (("UndergraduateStudent", "Course", "courses_per_undergraduate"),
                             ("GraduateStudent", "GraduateCourse", "courses_per_graduate")):
        rows = takes[np.isin(takes[:, 0], kb.dataset[cls][:, 0])]
        assert np.isin(rows[:, 1], kb.dataset[course][:, 0]).all()
        who, per = np.unique(rows[:, 0], return_counts=True)
        assert len(who) == len(kb.dataset[cls]) and _within(per, p[key])


def check_advisors(kb, p):
    d = _Depts(kb)
    adv = kb.dataset["advisor"]
    profs = np.concatenate([kb.dataset[c][:, 0] for c in uba.RANKS[:3]])
    assert np.isin(adv[:, 1], profs).all() and (d.of(adv[:, 0]) == d.of(adv[:, 1])).all()
    assert len(np.unique(adv[:, 0])) == len(adv)
    gs, ug = kb.dataset["GraduateStudent"][:, 0], kb.dataset["UndergraduateStudent"][:, 0]
    assert np.isin(gs, adv[:, 0]).all()
    share = np.isin(ug, adv[:, 0]).mean()
    assert abs(share - 1 / p["undergraduates_per_advisee"]) < 0.02


def check_publications(kb, p):
    d = _Depts(kb)
    auth = kb.dataset["publicationAuthor"]
    assert (d.of(auth[:, 0]) == d.of(auth[:, 1])).all()
    for cls, key in zip(uba.RANKS, ("full", "associate", "assistant", "lecturer")):
        fac = kb.dataset[cls][:, 0]
        per = _per(np.searchsorted(np.sort(fac), auth[np.isin(auth[:, 1], fac), 1]), len(fac))
        assert _within(per, p["publications"][key])
    gs = kb.dataset["GraduateStudent"][:, 0]
    co = auth[np.isin(auth[:, 1], gs)]
    per = _per(np.searchsorted(np.sort(gs), co[:, 1]), len(gs))
    assert _within(per, p["publications"]["graduate"])
    # a graduate student co-authors their advisor's publications
    first = {tuple(r) for r in auth[~np.isin(auth[:, 1], gs)]}
    adv = dict(map(tuple, kb.dataset["advisor"]))
    assert all((pub, adv[s]) in first for pub, s in co)


def check_assistants(kb, p):
    d = _Depts(kb)
    n = len(d.ids)
    ta = kb.dataset["teachingAssistantOf"]
    gs = _per(d.of(kb.dataset["GraduateStudent"][:, 0]), n)
    n_ta = _per(d.of(ta[:, 0]), n)
    lo, hi = p["graduates_per_teaching_assistant"]
    assert ((gs // hi <= n_ta) & (n_ta <= gs // lo)).all()
    assert len(np.unique(ta[:, 1])) == len(ta) and len(np.unique(ta[:, 0])) == len(ta)
    assert np.isin(ta[:, 1], kb.dataset["Course"][:, 0]).all()
    assert (d.of(ta[:, 0]) == d.of(ta[:, 1])).all()
    ra = kb.dataset["ResearchAssistant"][:, 0]
    assert not np.isin(ra, ta[:, 0]).any() and np.isin(ra, kb.dataset["GraduateStudent"]).all()
    n_ra = _per(d.of(ra), n)
    lo, hi = p["graduates_per_research_assistant"]
    assert ((gs // hi <= n_ra) & (n_ra <= gs // lo)).all()


def check_groups(kb, p):
    d = _Depts(kb)
    rg = kb.dataset["ResearchGroup"][:, 0]
    assert _within(_per(d.of(rg), len(d.ids)), p["research_groups"])
    sub = kb.dataset["subOrganizationOf"]
    sub = sub[np.isin(sub[:, 0], rg)]
    assert len(sub) == len(rg) and np.isin(sub[:, 1], d.ids).all()
    assert (d.of(sub[:, 0]) == d.of(sub[:, 1])).all()


def check_literals(kb, p):
    persons = np.concatenate([kb.dataset[c][:, 0] for c in
                              (*uba.RANKS, "UndergraduateStudent", "GraduateStudent")])
    mail, tel = kb.dataset["emailAddress"], kb.dataset["telephone"]
    assert np.array_equal(np.sort(mail[:, 0]), np.sort(persons))
    assert len(np.unique(mail[:, 1])) == len(mail)
    assert np.array_equal(np.sort(tel[:, 0]), np.sort(persons)) and len(np.unique(tel[:, 1])) == 1
    assert np.isin(persons, kb.dataset["name"][:, 0]).all()
    lits = np.concatenate([mail[:, 1], tel[:, 1], kb.dataset["name"][:, 1]])
    assert lits.min() > kb.dataset["publicationAuthor"][:, 0].max() and lits.max() < kb.n_terms


CHECKS = {f.__name__[6:]: f for f in (
    check_departments, check_faculty, check_students, check_courses, check_takes,
    check_advisors, check_publications, check_assistants, check_groups, check_literals)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("check", sorted(CHECKS))
def test_generator_keeps_to_the_profile(check, seed):
    kb, profile = _kb(seed, n_universities=2)
    CHECKS[check](kb, profile)


def test_generator_is_a_function_of_the_seed():
    a, _ = _kb(5)
    b, _ = _kb(5)
    c, _ = _kb(6)
    assert set(a.dataset) == set(b.dataset) == set(c.dataset)
    assert all(np.array_equal(a.dataset[k], b.dataset[k]) for k in a.dataset)
    assert any(not np.array_equal(a.dataset[k], c.dataset[k]) for k in a.dataset)
    # another seed makes other choices over the same counts
    assert {k: r.shape for k, r in a.dataset.items()} == {k: r.shape for k, r in c.dataset.items()}
    assert a.n_terms == c.n_terms and a.counts == c.counts
    assert all(np.array_equal(r, np.unique(r, axis=0)) for r in a.dataset.values())


def test_rules_read_alike():
    from repro_torch.core import parse_program

    text = (ROOT / _config()["program"]).read_text()
    ours = flat.parse_rules(text)
    theirs = list(parse_program(text))
    assert len(ours) == len(theirs) > 80
    for r, s in zip(ours, theirs):
        assert r.head.pred == s.head.predicate and r.head.terms == s.head.terms
        assert [(a.pred, a.terms) for a in r.body] == [(a.predicate, a.terms) for a in s.body]


@pytest.mark.parametrize("n_universities, seed", [(1, 0), (2, 2147483661)])
def test_reference_closure_is_the_programs(n_universities, seed):
    from repro_torch.core import CMatEngine, parse_program

    kb, _ = _kb(seed, n_universities)
    eng = CMatEngine(parse_program(kb.program), fused=True, device="cpu")
    eng.load(kb.dataset)
    stats = eng.materialise()
    want = flat.closure(kb.program, kb.dataset, "cpu")
    assert fact_mismatches(eng.materialisation(), want) == 0
    assert stats.n_facts == sum(int(r.shape[0]) for r in want.values())


def test_config_names_its_program():
    cfg = json.loads((ROOT / "BENCHMARK.json").read_text())["configs"][0]
    assert (ROOT / json.loads((ROOT / cfg["file"]).read_text())["program"]).is_file()


def test_comparisons_see_every_difference():
    a = torch.tensor([[1, 2], [3, 4]])
    assert fact_mismatches({"p": a}, {"p": a}) == 0
    assert fact_mismatches({"p": a[:1]}, {"p": a}) == 1
    assert fact_mismatches({"p": torch.cat([a, a[:1]])}, {"p": a}) == 1  # a duplicate
    assert fact_mismatches({"p": a, "q": a}, {"p": a}) == 2
    assert fact_mismatches({"p": torch.tensor([[1, 2], [3, 5]])}, {"p": a}) == 2
