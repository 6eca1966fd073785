"""The port's core modules against the JAX package's, on the CPU.

Compressed state is built by the reference, read out of its objects as
numpy arrays and carried into the port with ``repro_torch.convert``; both
packages then run the same operation and the results are compared
exactly, as unfolded rows.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import columns as jcolumns
from repro.core import compress as jcompress
from repro.core import dedup as jdedup
from repro.core import joins as jjoins
from repro.core import util as jutil
from repro.core.datalog import Atom
from repro.core.generators import lubm_like, star
from repro.core.metafacts import FactStore as JFactStore
from repro.core.metafacts import MetaFact as JMetaFact
from repro.core.metafacts import flat_repr_size as j_flat_repr_size
from repro_torch import convert
from repro_torch.core import compress as tcompress
from repro_torch.core import dedup as tdedup
from repro_torch.core import joins as tjoins
from repro_torch.core import util as tutil
from repro_torch.core.metafacts import flat_repr_size as t_flat_repr_size
from repro_torch.kernels.buffers import FactBuffers
from repro_torch.obs import get_registry
from repro.kernels.buffers import FactBuffers as JFactBuffers


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows_set(a) -> np.ndarray:
    a = np.asarray(a)
    return np.unique(a, axis=0) if a.size else a.reshape(0, a.shape[-1] if a.ndim > 1 else 1)


def _export_store(store):
    """The reference store's nodes as numpy payloads (``convert``'s input)."""
    nodes = {}
    for cid in store.live_ids():
        if store.is_leaf(cid):
            rv, rc = store.leaf_payload(cid)
            nodes[cid] = ("leaf", np.asarray(rv), np.asarray(rc))
        else:
            nodes[cid] = ("concat", store.children(cid))
    return nodes


def _carry(jfacts):
    """Carry a reference FactStore (and its ColumnStore) into the port."""
    jstore = jfacts.store
    store = convert.store_from_numpy(
        _export_store(jstore), jstore._next_id, device="cpu"
    )
    mfs = [
        (mf.predicate, mf.columns, mf.length, mf.round)
        for p in jfacts.predicates()
        for mf in jfacts.all(p)
    ]
    return store, convert.facts_from_numpy(store, mfs)


def _lubm_state(inplace=True):
    """A reference store with RLE leaves and Concat nodes: compressed
    lubm facts, some of them split in place."""
    _, dataset, _ = lubm_like(n_dept=4, n_students=60, n_courses=10)
    jstore = jcolumns.ColumnStore()
    jfacts = JFactStore(jstore)
    for pred, rows in dataset.items():
        rows = jutil.unique_rows(np.asarray(rows, dtype=np.int64).reshape(len(rows), -1))
        for cols, length in jcompress.compress_rows(rows, jstore):
            jfacts.add(JMetaFact(pred, cols, length, round=0))
    rng = np.random.default_rng(0)
    for mf in list(jfacts.all("takesCourse"))[:4]:
        keep = rng.random(mf.length) < 0.5
        if keep.any():
            for c in mf.columns:
                jstore.split(c, keep, inplace=inplace)
    return jfacts


# --------------------------------------------------------------------- #
# util
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 2, 3])
def test_unique_rows_and_factorize(k):
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 40, size=(300, k)).astype(np.int64)
    other = rng.integers(0, 40, size=(120, k)).astype(np.int64)
    u, inv = tutil.unique_rows(_t(rows), return_inverse=True)
    ju, jinv = jutil.unique_rows(rows, return_inverse=True)
    assert_array_equal(u.numpy(), ju)
    assert_array_equal(inv.numpy(), jinv)
    got = [c.numpy() for c in tutil.factorize_rows(_t(rows), _t(other))]
    want = jutil.factorize_rows(rows, other)
    for g, w in zip(got, want):
        assert_array_equal(g, w)
    assert_array_equal(
        tutil.multicol_member(_t(rows), _t(other)).numpy(),
        jutil.multicol_member(rows, other),
    )


def test_util_wide_values_and_masks():
    rows = np.array([[2**40, 1], [0, 2], [2**40, 1], [-1, 3]], dtype=np.int64)
    assert_array_equal(tutil.unique_rows(_t(rows)).numpy(), jutil.unique_rows(rows))
    codes = np.random.default_rng(2).integers(0, 30, size=200).astype(np.int64)
    assert_array_equal(
        tutil.first_occurrence_mask(_t(codes)).numpy(),
        jutil.first_occurrence_mask(codes),
    )
    b = np.unique(codes[:50])
    assert_array_equal(
        tutil.sorted_member(_t(codes), _t(b)).numpy(), jutil.sorted_member(codes, b)
    )


def test_merges_match_reference():
    rng = np.random.default_rng(0)
    old = np.unique(rng.integers(0, 1000, size=80))
    fresh = np.setdiff1d(np.unique(rng.integers(0, 1000, size=40)), old)
    assert_array_equal(
        tutil.merge_sorted_unique(_t(old), _t(fresh)).numpy(),
        jutil.merge_sorted_unique_np(old, fresh),
    )
    old_r = jutil.unique_rows(rng.integers(0, 60, size=(50, 2)).astype(np.int64))
    cand = jutil.unique_rows(rng.integers(0, 60, size=(30, 2)).astype(np.int64))
    co_c, co_o = jutil.factorize_rows(cand, old_r)
    keep = ~np.isin(co_c, co_o)
    want = jutil.merge_sorted_rows_np(old_r, cand[keep], co_o, co_c[keep])
    got = tutil.merge_sorted_rows(
        _t(old_r), _t(cand[keep]), _t(co_o), _t(co_c[keep])
    )
    assert_array_equal(got.numpy(), want)


def test_segment_counts():
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1], dtype=torch.bool)
    assert tutil.segment_counts(mask, [2, 0, 3, 2]) == [1, 0, 2, 1]
    assert tutil.segment_counts(mask, [7]) == [4]


# --------------------------------------------------------------------- #
# ColumnStore and compress
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "copy"])
def test_column_store_unfold_and_sizes(inplace):
    jfacts = _lubm_state(inplace)
    jstore = jfacts.store
    store, facts = _carry(jfacts)
    assert store.n_nodes() == jstore.n_nodes()
    n_concat = 0
    for cid in jstore.live_ids():
        assert_array_equal(store.unfold(cid).numpy(), jstore.unfold(cid))
        assert store.length(cid) == jstore.length(cid)
        assert store.repr_size(cid) == jstore.repr_size(cid)
        assert store.repr_size(cid, adaptive=False) == jstore.repr_size(cid, adaptive=False)
        assert store.depth(cid) == jstore.depth(cid)
        n_concat += not jstore.is_leaf(cid)
    assert n_concat > 0 if inplace else n_concat == 0
    assert facts.total_repr_size() == jfacts.total_repr_size()
    assert facts.mu_stats() == jfacts.mu_stats()
    jflat = jfacts.to_dict()
    tflat = facts.to_dict()
    assert t_flat_repr_size(tflat) == j_flat_repr_size(jflat)
    for p in jflat:
        assert_array_equal(tflat[p].numpy(), jflat[p])


def test_column_store_split_and_head_values():
    jfacts = _lubm_state(False)
    jstore = jfacts.store
    store, _ = _carry(jfacts)
    rng = np.random.default_rng(4)
    cids = [mf.columns[0] for mf in jfacts.all("memberOf")][:5]
    for cid in cids:
        keep = rng.random(jstore.length(cid)) < 0.6
        keep[0] = True
        for inplace in (False, True):
            got = store.split(cid, _t(keep), inplace=inplace)
            want = jstore.split(cid, keep, inplace=inplace)
            assert_array_equal(store.unfold(got).numpy(), jstore.unfold(want))
            assert_array_equal(store.unfold(cid).numpy(), jstore.unfold(cid))
    assert_array_equal(
        store.head_values(cids + cids[:2]).numpy(),
        jstore.head_values(np.asarray(cids + cids[:2])),
    )


@pytest.mark.parametrize("k,hi", [(1, 50), (2, 30), (2, 5), (3, 8)])
def test_compress_rows_segmentation(k, hi):
    rng = np.random.default_rng(k * 100 + hi)
    rows = jutil.unique_rows(rng.integers(0, hi, size=(400, k)).astype(np.int64))
    jstore = jcolumns.ColumnStore()
    want = jcompress.compress_rows(rows, jstore)
    store = convert.store_from_numpy({}, 0, device="cpu")
    got = tcompress.compress_rows(_t(rows), store)
    assert len(got) == len(want)
    for (gc, gl), (wc, wl) in zip(got, want):
        assert gc == tuple(int(w) for w in wc)
        assert gl == wl
        for g, w in zip(gc, wc):
            assert_array_equal(store.unfold(g).numpy(), jstore.unfold(w))
            assert store.n_runs(g) == jstore.n_runs(w)


# --------------------------------------------------------------------- #
# block-backed leaves: batch constructors and readers against the
# one-at-a-time ones
# --------------------------------------------------------------------- #
_FLAT = np.array([3, 3, 3, 5, 5, 7, 1, 1, 2, 2, 2, 9, 4, 4, 4, 4, 6, 0, 0, 8,
                  8, 8, 1, 5, 5, 5, 5, 2], dtype=np.int64)

#: (starts, lengths) of one new_leaves batch over _FLAT
_BATCHES = {
    "gaps": ([0, 7, 12, 20], [5, 3, 4, 6]),
    "empty": ([0, 3, 3, 9, 27], [3, 0, 4, 0, 1]),
    "unordered": ([20, 4, 11, 0], [8, 6, 5, 4]),
    "one": ([6], [13]),
}


def _payload(store, cid):
    rv, rc = store.leaf_payload(cid)
    return rv.numpy().tobytes(), rc.numpy().tobytes()


def _same_stores(got, want, ids):
    assert got.n_nodes() == want.n_nodes() and got.mark() == want.mark()
    assert got.memory_report() == want.memory_report()
    for cid in ids:
        assert got.length(cid) == want.length(cid)
        assert got.is_leaf(cid) == want.is_leaf(cid)
        assert got.is_cached(cid) == want.is_cached(cid)
        if got.is_leaf(cid):
            assert _payload(got, cid) == _payload(want, cid)
        assert_array_equal(got.unfold(cid).numpy(), want.unfold(cid).numpy())
    assert got.memory_report() == want.memory_report()


def _two_batch_store(batched):
    """Two leaf batches over _FLAT and its reverse, singly made leaves
    (cached and not), a constant batch and a composite between them.
    ``batched=False`` makes every leaf one at a time, in the same order
    (the same ids)."""
    store = convert.store_from_numpy({}, 0, device="cpu")
    flats = [_t(_FLAT), _t(_FLAT[::-1].copy())]
    starts, lengths = [0, 5, 9, 14, 20], [5, 4, 5, 6, 8]
    for flat in flats:
        if batched:
            store.new_leaves(flat, starts, lengths)
        else:
            for s, n in zip(starts, lengths):
                store.new_leaf(flat[s: s + n])
        store.new_leaf(_t(np.array([7, 7, 8])))
        store.new_leaf_rle(_t(np.array([2, 6])), _t(np.array([3, 1])), 4)
    if batched:
        store.new_constants([4, 9], [3, 2])
    else:
        store.new_constant(4, 3)
        store.new_constant(9, 2)
    store.new_concat([2, 7, 15])
    return store


#: interleaved ids of _two_batch_store: batch 0 is ids 0-4, batch 1 ids
#: 7-11, singles 5-6 and 12-13, constants 14-15, the composite 16
_CIDS = [0, 1, 2, 7, 8, 12, 3, 4, 9, 10, 11, 16, 5, 13, 14, 2, 15, 6, 0, 1]


#: copy_splits' items over _two_batch_store: one leaf at three offsets
#: (once beside another column), and leaves of both batches, a constant,
#: a singly made leaf and the composite
_SPLIT_ITEMS = {
    "copy_splits_one_leaf": [(9,), (9, 2), (9,)],
    "copy_splits_leaves": [(0, 7), (1, 8), (2, 9), (14,), (16,), (3, 10), (5, 12)],
}


def _meter_one_by_one(store, cids):
    cached = fresh = 0
    for c in cids:
        if store.is_cached(c):
            cached += store.length(c)
        else:
            fresh += store.length(c)
        store.unfold(c)
    return cached, fresh


@pytest.mark.parametrize("case", [*_BATCHES, "unfold_cat", "copy_splits_one_leaf",
                                  "copy_splits_leaves"])
def test_block_leaves_equal_one_at_a_time(case):
    if case in _BATCHES:
        starts, lengths = _BATCHES[case]
        got = convert.store_from_numpy({}, 0, device="cpu")
        want = convert.store_from_numpy({}, 0, device="cpu")
        ids = got.new_leaves(_t(_FLAT), starts, lengths)
        assert ids == [want.new_leaf(_t(_FLAT[s: s + n])) for s, n in zip(starts, lengths)]
        _same_stores(got, want, ids)
        return
    got, want = _two_batch_store(True), _two_batch_store(False)
    _same_stores(got, want, [])
    if case == "unfold_cat":
        metered = []
        out = got.unfold_cat(_CIDS, meter=lambda *a: metered.append(a))
        assert metered == [_meter_one_by_one(want, _CIDS)]
        assert_array_equal(out.numpy(), torch.cat([want.unfold(c) for c in _CIDS]).numpy())
        _same_stores(got, want, range(got.mark()))
        return
    # items of equal-length columns, as split_survivors hands them over:
    # an item's distinct columns are requests at one offset of ``keep``
    items = _SPLIT_ITEMS[case]
    lengths = [got.length(cols[0]) for cols in items]
    offs = np.cumsum([0] + lengths)[:-1].tolist()
    keep = np.random.default_rng(len(items)).random(sum(lengths)) < 0.5
    for off, n in zip(offs, lengths):
        keep[off], keep[off + n - 1] = True, False  # partly kept
    requests = [(c, off, int(keep[off: off + n].sum()))
                for cols, off, n in zip(items, offs, lengths) for c in cols]
    ids = got.copy_splits(requests, _t(keep))
    assert ids == [
        want.split(c, _t(keep[off: off + want.length(c)]), inplace=False)
        for c, off, _ in requests
    ]
    assert [got.length(c) for c in ids] == [k for _, _, k in requests]
    assert got.n_splits == want.n_splits == len(requests)
    _same_stores(got, want, range(got.mark()))


def test_new_leaves_makes_no_tensor_per_leaf():
    """A batch of leaves adds a constant number of live tensors, whatever
    the number of parts: the leaves keep host offsets into the blocks."""
    import gc

    def n_tensors():
        gc.collect()
        return sum(isinstance(o, torch.Tensor) for o in gc.get_objects())

    store = convert.store_from_numpy({}, 0, device="cpu")
    flat = torch.arange(20_000, dtype=torch.int64) // 3
    before = n_tensors()
    ids = store.new_leaves(flat, list(range(0, 20_000, 2)), [2] * 10_000)
    store.unfold_cat(ids)
    after = n_tensors()
    assert len(ids) == 10_000 and store.n_nodes() == 10_000
    assert after - before < 32


# --------------------------------------------------------------------- #
# match / sjoin / xjoin / elim_dup
# --------------------------------------------------------------------- #
def _subst_rows(store, subst):
    if subst.is_empty():
        return np.zeros((0, len(subst.vars)), dtype=np.int64)
    idx = list(range(len(subst.vars)))
    if isinstance(store, jcolumns.ColumnStore):
        return jjoins._unfold_cols(store, subst.items, idx)
    return tjoins._unfold_cols(store, subst.items, idx).numpy()


def _same(store_t, st, store_j, sj):
    assert st.vars == sj.vars
    assert st.n_substitutions() == sj.n_substitutions()
    gt, gj = _subst_rows(store_t, st), _subst_rows(store_j, sj)
    assert_array_equal(_rows_set(gt), _rows_set(gj))


ATOMS = [
    Atom("takesCourse", ("s", "c")),
    Atom("memberOf", ("x", "d")),
    Atom("advisor", ("s", "s")),  # repeated variable: matches nothing
]


@pytest.mark.parametrize("atom", ATOMS, ids=lambda a: a.predicate)
def test_match(atom):
    jfacts = _lubm_state(False)
    store, facts = _carry(jfacts)
    sj = jjoins.match(atom, jfacts.all(atom.predicate), jfacts.store)
    st = tjoins.match(atom, facts.all(atom.predicate), store)
    _same(store, st, jfacts.store, sj)


def test_match_constant():
    jfacts = _lubm_state(False)
    store, facts = _carry(jfacts)
    const = int(jfacts.unfold_pred("memberOf")[0, 1])
    atom = Atom("memberOf", ("x", const))
    sj = jjoins.match(atom, jfacts.all("memberOf"), jfacts.store)
    st = tjoins.match(atom, facts.all("memberOf"), store)
    _same(store, st, jfacts.store, sj)
    assert 0 < st.n_substitutions() < sum(mf.length for mf in facts.all("memberOf"))


@pytest.mark.parametrize("direction", ["filter_members", "filter_courses"])
def test_sjoin(direction):
    jfacts = _lubm_state(False)
    store, facts = _carry(jfacts)
    a1, a2 = Atom("GraduateStudent", ("s",)), Atom("takesCourse", ("s", "c"))
    if direction == "filter_courses":
        a1, a2 = Atom("takesCourse", ("s", "c")), Atom("advisor", ("s", "p"))
    jf = jjoins.match(a1, jfacts.all(a1.predicate), jfacts.store)
    jd = jjoins.match(a2, jfacts.all(a2.predicate), jfacts.store)
    tf = tjoins.match(a1, facts.all(a1.predicate), store)
    td = tjoins.match(a2, facts.all(a2.predicate), store)
    sj = jjoins.sjoin(jf, jd, ("s",), jfacts.store)
    st = tjoins.sjoin(tf, td, ("s",), store)
    _same(store, st, jfacts.store, sj)


@pytest.mark.parametrize("which", ["teach", "member", "star"])
def test_xjoin(which):
    if which == "star":
        _, dataset, _ = star(n_spokes=40, n_hubs=3)
        jstore = jcolumns.ColumnStore()
        jfacts = JFactStore(jstore)
        for pred, rows in dataset.items():
            rows = jutil.unique_rows(np.asarray(rows, dtype=np.int64).reshape(len(rows), -1))
            for cols, length in jcompress.compress_rows(rows, jstore):
                jfacts.add(JMetaFact(pred, cols, length))
        left, right, key = Atom("P", ("x", "y")), Atom("T", ("y", "z")), ("y",)
    else:
        jfacts = _lubm_state(False)
        if which == "teach":
            left, right, key = Atom("takesCourse", ("s", "c")), Atom("teacherOf", ("p", "c")), ("c",)
        else:
            left, right, key = Atom("memberOf", ("x", "d")), Atom("subOrganizationOf", ("d", "u")), ("d",)
    store, facts = _carry(jfacts)
    jl = jjoins.match(left, jfacts.all(left.predicate), jfacts.store)
    jr = jjoins.match(right, jfacts.all(right.predicate), jfacts.store)
    tl = tjoins.match(left, facts.all(left.predicate), store)
    tr = tjoins.match(right, facts.all(right.predicate), store)
    sj = jjoins.xjoin(jl, jr, key, jfacts.store)
    st = tjoins.xjoin(tl, tr, key, store)
    assert len(st.items) == len(sj.items)
    _same(store, st, jfacts.store, sj)


@pytest.mark.parametrize("index", [None, "dedup_index", "buffers"])
def test_elim_dup_survivors(index):
    jfacts = _lubm_state(False)
    store, facts = _carry(jfacts)
    # candidates: every takesCourse meta-fact again (all duplicates) plus
    # a relabelled copy under a new predicate (half new)
    cand_j = {"takesCourse": [(mf.columns, mf.length) for mf in jfacts.all("takesCourse")]}
    cand_j["advisor"] = [(mf.columns, mf.length) for mf in jfacts.all("takesCourse")]
    cand_t = {p: list(v) for p, v in cand_j.items()}
    if index == "dedup_index":
        j_idx, t_idx = jdedup.DedupIndex(), tdedup.DedupIndex()
    elif index == "buffers":
        j_idx, t_idx = JFactBuffers(), FactBuffers("cpu")
    else:
        j_idx = t_idx = None
    if j_idx is not None:
        for p in ("takesCourse", "advisor"):
            rows = jfacts.unfold_pred(p)
            j_idx.seed(p, rows)
            t_idx.seed(p, _t(rows))
    dj = jdedup.elim_dup(cand_j, jfacts, jfacts.store, 1, index=j_idx)
    dt = tdedup.elim_dup(cand_t, facts, store, 1, index=t_idx)
    assert [(m.predicate, m.length, m.round) for m in dt] == [
        (m.predicate, m.length, m.round) for m in dj
    ]
    for mt, mj in zip(dt, dj):
        for ct, cj in zip(mt.columns, mj.columns):
            assert_array_equal(store.unfold(ct).numpy(), jfacts.store.unfold(cj))
    assert sum(m.length for m in dt) > 0


def test_dedup_index_rounds_match_reference():
    """Several rounds of ``fresh_mask`` (survivors merged by position)
    keep the same masks and the same sorted index as the reference."""
    rng = np.random.default_rng(7)
    j_idx, t_idx = jdedup.DedupIndex(), tdedup.DedupIndex()
    seed_rows = rng.integers(0, 50, size=(40, 2))
    j_idx.seed("p", seed_rows)
    t_idx.seed("p", _t(seed_rows))
    for arity in (2, 2, 2, 1, 1):
        rows = rng.integers(0, 60, size=(200, arity))
        pred = "p" if arity == 2 else "q"
        want = j_idx.fresh_mask(pred, rows)
        got = t_idx.fresh_mask(pred, _t(rows))
        assert_array_equal(got.numpy(), want)
    for pred in ("p", "q"):
        assert_array_equal(t_idx._packed[pred].numpy(), j_idx._packed[pred])


# --------------------------------------------------------------------- #
# FactBuffers: grow before merge, DedupIndex-compatible fresh_mask
# --------------------------------------------------------------------- #
def test_fact_buffers_fresh_mask_matches_reference():
    rng = np.random.default_rng(9)
    j_buf, t_buf = JFactBuffers(), FactBuffers("cpu", initial_capacity=128)
    for _ in range(6):
        rows = rng.integers(0, 400, size=(rng.integers(1, 300), 2)).astype(np.int64)
        kj = j_buf.fresh_mask("P", rows)
        kt = t_buf.fresh_mask("P", _t(rows))
        assert_array_equal(kt.numpy(), kj)
        assert_array_equal(t_buf.codes("P").numpy(), j_buf.codes("P"))
    assert t_buf.regrows > 0
    cap = t_buf.capacity("P")
    assert cap >= t_buf.count("P") and cap & (cap - 1) == 0
    front = t_buf._front["P"]
    assert (front[t_buf.count("P"):] == torch.iinfo(torch.int64).max).all()
    assert t_buf.fresh_mask("W", _t(np.zeros((3, 3), np.int64))) is None


def test_fact_buffers_steady_state_allocates_nothing():
    buf = FactBuffers("cpu", initial_capacity=1024)
    buf.merge("P", torch.arange(0, 100, dtype=torch.int64))
    ptrs = {buf._front["P"].data_ptr(), buf._back["P"].data_ptr()}
    for k in range(1, 5):
        added = buf.merge("P", torch.arange(100 * k, 100 * k + 100, dtype=torch.int64))
        assert added == 100
        assert {buf._front["P"].data_ptr(), buf._back["P"].data_ptr()} == ptrs
    assert buf.count("P") == 500 and buf.regrows == 0
    # a merge that outgrows the capacity regrows first and keeps every code
    assert buf.merge("P", torch.arange(500, 2000, dtype=torch.int64)) == 1500
    assert buf.regrows == 1 and buf.capacity("P") == 2048
    assert_array_equal(buf.codes("P").numpy(), np.arange(2000))


# --------------------------------------------------------------------- #
# FactBuffers, int32 mode: the reference's FactBuffers(device=True)
# --------------------------------------------------------------------- #
def _fresh32(rng, n):
    return np.unique(rng.integers(0, 2**20, size=n).astype(np.int32))


def test_fact_buffers_int32_steady_state_matches_reference():
    """After the first allocation, merges that fit allocate nothing (the
    buffer pair is swapped, standing in for the reference's donation),
    and every merge gives the reference's ``n_new`` and codes."""
    reg = get_registry()
    reg.reset("kernels.")
    j_buf = JFactBuffers(device=True, donate=False, initial_capacity=1024)
    t_buf = FactBuffers("cpu", initial_capacity=1024, dtype=torch.int32)
    j_buf.ensure("P", 1024)
    t_buf.ensure("P", 1024)
    ptrs = {t_buf._front["P"].data_ptr(), t_buf._back["P"].data_ptr()}
    rng = np.random.default_rng(1)
    for _ in range(6):
        fresh = _fresh32(rng, 50)
        assert t_buf.merge("P", _t(fresh)) == j_buf.merge("P", fresh)
        assert_array_equal(t_buf.codes("P").numpy(), j_buf.codes("P"))
    snap = reg.snapshot("kernels.")
    assert snap["kernels.buffers.allocations"] == 1
    assert snap["kernels.buffers.merges"] == 6
    assert {t_buf._front["P"].data_ptr(), t_buf._back["P"].data_ptr()} == ptrs
    front, n = t_buf._front["P"], t_buf.count("P")
    assert front.dtype == torch.int32 and t_buf.capacity("P") == j_buf.capacity("P")
    assert (front[n:] == np.iinfo(np.int32).max).all()
    assert t_buf.occupied_bytes() == j_buf.occupied_bytes()


def test_fact_buffers_int32_regrow_before_merge_matches_reference():
    j_buf = JFactBuffers(device=True, donate=False, initial_capacity=128)
    t_buf = FactBuffers("cpu", initial_capacity=128, dtype=torch.int32)
    rng = np.random.default_rng(2)
    for _ in range(5):
        fresh = _fresh32(rng, 100)
        assert t_buf.merge("P", _t(fresh)) == j_buf.merge("P", fresh)
    assert_array_equal(t_buf.codes("P").numpy(), j_buf.codes("P"))
    assert t_buf.capacity("P") == j_buf.capacity("P") >= t_buf.count("P")
    assert t_buf.regrows == j_buf.regrows >= 1
    with pytest.raises(RuntimeError, match="int32"):
        t_buf.seed("Q", _t(np.zeros((2, 2), np.int64)))


def test_fact_buffers_int32_folds_fused_join_dedup_output():
    """A ``fused_join_dedup`` output (sentinel-padded) merges as the
    reference merges its Pallas kernel's output."""
    from repro.kernels.fused import fused_join_dedup as j_fused_join_dedup
    from repro_torch.kernels import fused_join_dedup

    rng = np.random.default_rng(4)
    l_keys = rng.integers(0, 40, size=60).astype(np.int32)
    r_keys = np.sort(rng.integers(0, 40, size=50).astype(np.int32))
    l_pay = rng.integers(0, 2**15, size=60).astype(np.int32)
    r_pay = rng.integers(0, 2**15, size=50).astype(np.int32)
    j_out, _, _ = j_fused_join_dedup(l_keys, l_pay, r_keys, r_pay, capacity=256, interpret=True)
    t_out, t_cnt, _ = fused_join_dedup(*map(_t, (l_keys, l_pay, r_keys, r_pay)), 256)
    j_buf = JFactBuffers(device=True, donate=False, initial_capacity=128)
    t_buf = FactBuffers("cpu", initial_capacity=128, dtype=torch.int32)
    seed = _fresh32(rng, 30)
    j_buf.merge("H", seed)
    t_buf.merge("H", _t(seed))
    assert t_buf.merge("H", t_out) == j_buf.merge("H", j_out) == int(t_cnt[0])
    assert_array_equal(t_buf.codes("H").numpy(), j_buf.codes("H"))
    assert t_buf.merge("H", t_out) == 0  # folding it again adds nothing
