"""The port's kernels against the JAX package's, on the CPU.

Seeded numpy inputs go through three paths: the port's wrapper on CPU
tensors (its plain PyTorch version), the JAX Pallas kernel in interpret
mode, and the JAX package's oracle in ``repro.kernels.ref``.  int32 inputs
carry the TPU contract (int32-max padding, merge truncation, uncapped
counts); int64 inputs are held against ``repro.core.util``.  Every
comparison is exact: these are integer set operations.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds
them against the same plain versions there.  Here the tests check that a
wrapper handed a tensor it cannot serve without a CUDA build raises
instead of computing.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import util as jutil
from repro.kernels import ref as jref
from repro.kernels.fused import fused_join_dedup as j_fused_join_dedup
from repro.kernels.fused import merge_sorted_unique as j_merge
from repro.kernels.join_bounds import join_bounds as j_join_bounds
from repro.kernels.rle_expand import rle_expand as j_rle_expand
from repro.kernels.sorted_member import sorted_member as j_sorted_member
from repro_torch.kernels import (
    build,
    fused_join_dedup,
    join_bounds,
    merge_sorted_unique,
    ops,
    rle_expand,
    sorted_member,
)
from repro_torch.kernels.fused import scratch_words
from repro_torch.kernels.join_bounds import (
    PATHS,
    THREAD_KEYS,
    WARP_KEYS,
    join_bounds_by,
    route,
)

BIG32 = np.iinfo(np.int32).max
BIG64 = np.iinfo(np.int64).max

SHAPES = [(0, 5), (1, 1), (7, 3), (100, 1000), (513, 2049), (300, 0)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sorted32(rng, m, hi=10_000):
    return np.sort(rng.integers(0, hi, size=m).astype(np.int32))


def _pad32(x, n):
    return np.concatenate([x, np.full(n, BIG32, np.int32)])


#: the cases the card's redesign is sensitive to: ``m = 1`` (one bucket),
#: duplicates in ``b`` (keys drawn from 3,000 values) with ``n`` not a
#: multiple of four, and ``b`` far longer than ``a`` (few, wide buckets)
MEMBER_EDGES = [
    pytest.param(300, 1, id="m-1"),
    pytest.param(2003, 4000, id="n-ragged-duplicates"),
    pytest.param(50, 20_000, id="few-probes-duplicates"),
]


@pytest.mark.parametrize("n,m", SHAPES + MEMBER_EDGES)
def test_sorted_member_int32_vs_pallas(n, m):
    rng = np.random.default_rng(n * 31 + m)
    a = rng.integers(0, 3_000, size=n).astype(np.int32)
    b = _sorted32(rng, m, hi=3_000)
    got = sorted_member(_t(a), _t(b)).numpy()
    assert_array_equal(got, np.asarray(j_sorted_member(a, b, interpret=True)))
    assert_array_equal(got, np.asarray(jref.sorted_member_ref(a, b)))


def test_sorted_member_int32_sentinel_padding():
    """All-sentinel padding on both sides: a padded slot of ``a`` meets
    the padding of ``b``, as in the TPU kernel."""
    rng = np.random.default_rng(5)
    a = _pad32(rng.integers(0, 50, size=40).astype(np.int32), 24)
    b = _pad32(_sorted32(rng, 30, hi=50), 34)
    got = sorted_member(_t(a), _t(b)).numpy()
    assert_array_equal(got, np.asarray(j_sorted_member(a, b, interpret=True)))
    only_pad = np.full(16, BIG32, np.int32)
    assert sorted_member(_t(only_pad), _t(b)).numpy().all()


@pytest.mark.parametrize("n,m", [(0, 4), (50, 0), (200, 700), (1000, 30)])
def test_sorted_member_int64_vs_util(n, m):
    rng = np.random.default_rng(n + 7 * m)
    a = (rng.integers(0, 1 << 20, size=n) << 32) | rng.integers(0, 64, size=n)
    b = np.unique(
        (rng.integers(0, 1 << 20, size=m) << 32) | rng.integers(0, 64, size=m)
    ).astype(np.int64)
    got = sorted_member(_t(a.astype(np.int64)), _t(b)).numpy()
    assert_array_equal(got, jutil.sorted_member(a.astype(np.int64), b))


@pytest.mark.parametrize("n,m", SHAPES)
def test_join_bounds_int32_vs_pallas(n, m):
    rng = np.random.default_rng(n * 7 + m)
    l = rng.integers(0, 300, size=n).astype(np.int32)
    r = _sorted32(rng, m, hi=300)
    lo, hi = join_bounds(_t(l), _t(r))
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    jlo, jhi = j_join_bounds(l, r, interpret=True)
    rlo, rhi = jref.join_bounds_ref(l, r)
    assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert_array_equal(lo.numpy(), np.asarray(rlo))
    assert_array_equal(hi.numpy(), np.asarray(rhi))


def _join_edge(case, rng):
    """``(l, r)`` int32 of one ``join_bounds`` edge case."""
    if case == "gap-clustered":
        # two far clusters of r: buckets in the gap hold no key, yet a key
        # there needs its exact position
        r = np.sort(np.concatenate([rng.integers(0, 300, 400),
                                    rng.integers(2**30, 2**30 + 300, 400)]))
        l = np.concatenate([rng.integers(300, 2**30, 300), r[::7], [299, 300, 2**30 - 1]])
    elif case == "out-of-span":
        r = np.sort(rng.integers(10**6, 2 * 10**6, 900))
        l = np.concatenate([rng.integers(0, 10**6, 200), rng.integers(2 * 10**6, 2**31 - 2, 200),
                            r[[0, -1]], r[[0, -1]] + [-1, 1], r[::50]])
    elif case == "all-equal":
        r = np.full(1500, 77)
        l = rng.integers(70, 85, 333)
    else:  # duplicate runs in r longer than any bucket, duplicates in l
        r = np.sort(np.repeat(rng.integers(0, 5000, 40), 60))
        l = np.repeat(np.concatenate([r[::97], rng.integers(0, 5000, 20)]), 3)
    return rng.permutation(l).astype(np.int32), r.astype(np.int32)


@pytest.mark.parametrize("case", ["gap-clustered", "out-of-span", "all-equal", "duplicate-runs"])
def test_join_bounds_edges_vs_pallas(case):
    """The cases the card's bucket table and its search path are sensitive
    to, against the Pallas kernel in interpret mode and searchsorted."""
    l, r = _join_edge(case, np.random.default_rng(41))
    lo, hi = join_bounds(_t(l), _t(r))
    jlo, jhi = j_join_bounds(l, r, interpret=True)
    assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert_array_equal(lo.numpy(), np.searchsorted(r, l, side="left"))
    assert_array_equal(hi.numpy(), np.searchsorted(r, l, side="right"))
    if case == "out-of-span":
        below, above = l < r[0], l > r[-1]
        assert below.any() and above.any()
        assert (lo.numpy()[below] == 0).all() and (hi.numpy()[above] == r.size).all()


@pytest.mark.parametrize("n,m,path", [
    (500, 1_000_000, "warp"), (WARP_KEYS, 4_000_000, "warp"), (5_000, 0, "warp"),
    (0, 0, "warp"), (WARP_KEYS + 1, 4_000_000, "thread"), (10_000, 2_999_718, "warp"),
    (THREAD_KEYS, THREAD_KEYS, "thread"), (30_000, 1_000, "thread"),
    (THREAD_KEYS + 1, 1_000, "table"), (4_000_000, 4_000_000, "table"),
])
def test_join_bounds_route(n, m, path):
    assert route(n, m) == path


def test_join_bounds_by_runs_on_the_card_only():
    a = torch.arange(10, dtype=torch.int64)
    for path in PATHS:
        with pytest.raises(ValueError, match="card only"):
            join_bounds_by(a, a, path)
    with pytest.raises(ValueError, match="no path"):
        join_bounds_by(a, a, "bisect")


def test_join_bounds_int64_vs_searchsorted():
    rng = np.random.default_rng(11)
    l = rng.integers(-(1 << 40), 1 << 40, size=500).astype(np.int64)
    r = np.sort(np.concatenate([l[:100], rng.integers(-(1 << 40), 1 << 40, 300)]))
    lo, hi = join_bounds(_t(l), _t(r.astype(np.int64)))
    assert_array_equal(lo.numpy(), np.searchsorted(r, l, side="left"))
    assert_array_equal(hi.numpy(), np.searchsorted(r, l, side="right"))


@pytest.mark.parametrize(
    "runs",
    [
        [(5, 1)],
        [(3, 4), (7, 2), (9, 10)],
        [(1, 1000)],
        [(i, (i % 7) + 1) for i in range(300)],
        # zero-length stretches at the start, in the middle and at the end
        [(i, 0) for i in range(700)] + [(i, i % 40 + 1) for i in range(60)]
        + [(i, 0) for i in range(900)] + [(7, 5000)] + [(i, 0) for i in range(999)],
        # one run over many 16 KB output tiles, between two short ones
        [(4, 2), (5, 20_001), (6, 1)],
        # an odd total: the last tile ends inside a 16-byte vector
        [(i, 163 + (i == 49)) for i in range(50)],
        # one run holds 90 % of the total
        [(i, 3) for i in range(40)] + [(99, 1080)] + [(i, 0) for i in range(9)],
    ],
)
def test_rle_expand_int32_vs_pallas(runs):
    vals = np.asarray([v for v, _ in runs], dtype=np.int32)
    cnts = np.asarray([c for _, c in runs], dtype=np.int32)
    total = int(cnts.sum())
    got = rle_expand(_t(vals), _t(cnts), total).numpy()
    assert_array_equal(
        got, np.asarray(j_rle_expand(vals, cnts, total=total, interpret=True))
    )
    assert_array_equal(got, np.asarray(jref.rle_expand_ref(vals, cnts, total)))


def test_rle_expand_int64_with_empty_runs():
    """Zero-length runs are skipped; int64 values survive whole."""
    rng = np.random.default_rng(3)
    vals = rng.integers(-(1 << 50), 1 << 50, size=200).astype(np.int64)
    cnts = rng.integers(0, 4, size=200).astype(np.int64)
    total = int(cnts.sum())
    got = rle_expand(_t(vals), _t(cnts), total).numpy()
    assert_array_equal(got, np.repeat(vals, cnts))
    empty = rle_expand(_t(vals[:0]), _t(cnts[:0]), 0)
    assert empty.shape == (0,)


def _merge_case(rng, nb, nf, cap, overlap):
    old = np.unique(rng.integers(0, 2**30, size=nb).astype(np.int32))
    buf = np.full(cap, BIG32, np.int32)
    buf[: old.size] = old
    extra = rng.integers(0, 2**30, size=nf).astype(np.int32)
    fresh = np.unique(np.concatenate([extra, old[:overlap]]))
    return buf, fresh


@pytest.mark.parametrize(
    "nb,nf,cap,overlap",
    [
        (0, 0, 128, 0),       # empty buf and empty fresh
        (0, 40, 128, 0),      # all-sentinel buf
        (60, 0, 128, 0),      # nothing to merge
        (60, 50, 128, 30),    # duplicates across buf and fresh
        (64, 64, 128, 0),     # fills buf exactly
        (100, 90, 128, 10),   # truncates at cap: count stays uncapped
        (500, 300, 1024, 200),
    ],
)
def test_merge_sorted_unique_int32_vs_pallas(nb, nf, cap, overlap):
    rng = np.random.default_rng(nb * 13 + nf)
    buf, fresh = _merge_case(rng, nb, nf, cap, overlap)
    merged, cnt, n_new = merge_sorted_unique(_t(buf), _t(fresh))
    j_merged, j_cnt, j_new = j_merge(buf, fresh, interpret=True)
    r_merged, r_cnt, r_new = jref.merge_sorted_unique_ref(buf, fresh)
    assert_array_equal(merged.numpy(), np.asarray(j_merged))
    assert_array_equal(merged.numpy(), r_merged)
    assert int(cnt[0]) == int(j_cnt[0]) == r_cnt
    assert int(n_new[0]) == int(j_new[0]) == r_new


@pytest.mark.parametrize("run", [7, 1100, 9000])
def test_merge_sorted_unique_duplicate_runs_vs_pallas(run):
    """Runs of equal fresh values longer than a card tile (7,936 int32
    positions) and shorter: one copy of each is kept, none of a value
    already buffered."""
    rng = np.random.default_rng(run)
    old = np.unique(rng.integers(0, 2**20, 300).astype(np.int32))
    buf = _pad32(old, 1024 - old.size)
    values = np.concatenate([old[::40], rng.integers(2**20, 2**21, 12).astype(np.int32)])
    fresh = np.sort(np.repeat(values, run))
    merged, cnt, n_new = merge_sorted_unique(_t(buf), _t(fresh))
    j_merged, j_cnt, j_new = j_merge(buf, fresh, interpret=True)
    assert_array_equal(merged.numpy(), np.asarray(j_merged))
    assert (int(cnt[0]), int(n_new[0])) == (int(j_cnt[0]), int(j_new[0]))
    assert int(n_new[0]) == np.setdiff1d(values, old).size


def test_merge_sorted_unique_fresh_inside_buf_vs_pallas():
    """Every fresh value already buffered: nothing new, and the slots the
    dropped values would have taken hold the sentinel."""
    rng = np.random.default_rng(19)
    old = np.unique(rng.integers(0, 2**30, 3000).astype(np.int32))
    buf = _pad32(old, 8192 - old.size)
    fresh = _pad32(old[1::2], 40)
    merged, cnt, n_new = merge_sorted_unique(_t(buf), _t(fresh))
    j_merged, j_cnt, j_new = j_merge(buf, fresh, interpret=True)
    assert_array_equal(merged.numpy(), np.asarray(j_merged))
    assert (int(cnt[0]), int(n_new[0])) == (int(j_cnt[0]), int(j_new[0])) == (old.size, 0)
    assert_array_equal(merged.numpy(), buf)


def test_merge_sorted_unique_rejects_bad_count_and_aliased_out():
    buf = torch.full((128,), BIG64)
    buf[:10] = torch.arange(10)
    fresh = torch.arange(5, 20, dtype=torch.int64)
    for bad in (-1, 129):
        with pytest.raises(ValueError, match="outside"):
            merge_sorted_unique(buf, fresh, count=bad)
    with pytest.raises(ValueError, match="does not hold"):
        merge_sorted_unique(buf, fresh, count=9)
    with pytest.raises(ValueError, match="alias"):
        merge_sorted_unique(buf, fresh, out=buf)
    merged, cnt, n_new = merge_sorted_unique(buf, fresh, count=10)
    assert (int(cnt[0]), int(n_new[0])) == (20, 10)
    assert_array_equal(merged.numpy()[:20], np.arange(20))


def test_fact_buffers_raise_on_merge_overflow(monkeypatch):
    """A merge whose total outgrows the buffer (here: the grow-before-merge
    step skipped) raises instead of dropping codes."""
    from repro_torch.kernels.buffers import FactBuffers

    buffers = FactBuffers("cpu", initial_capacity=128)
    buffers.merge("P", torch.arange(100, dtype=torch.int64))
    monkeypatch.setattr(FactBuffers, "ensure", lambda self, pred, need=None: self._front[pred])
    with pytest.raises(RuntimeError, match="overflow"):
        buffers.merge("P", torch.arange(100, 200, dtype=torch.int64))


def test_merge_sorted_unique_fills_exactly_and_pads_fresh():
    buf = np.full(128, BIG32, np.int32)
    buf[:100] = np.arange(0, 200, 2)
    fresh = _pad32(np.arange(1, 57, 2).astype(np.int32), 12)  # 28 new
    merged, cnt, n_new = merge_sorted_unique(_t(buf), _t(fresh))
    assert int(cnt[0]) == 128 and int(n_new[0]) == 28
    assert (merged.numpy() != BIG32).all()
    assert_array_equal(merged.numpy(), np.asarray(j_merge(buf, fresh, interpret=True)[0]))


def test_merge_sorted_unique_int64_into_out_vs_util():
    """The int64 form folds survivors as ``merge_sorted_unique_np`` does,
    writing into a second buffer and leaving ``buf`` as it was."""
    rng = np.random.default_rng(21)
    old = np.unique((rng.integers(0, 1 << 20, 300) << 32) | rng.integers(0, 9, 300))
    fresh = np.setdiff1d(
        np.unique((rng.integers(0, 1 << 20, 200) << 32) | rng.integers(0, 9, 200)),
        old,
    )
    buf = np.full(1024, BIG64, np.int64)
    buf[: old.size] = old
    tbuf = _t(buf.copy())
    out = torch.empty_like(tbuf)
    merged, cnt, n_new = merge_sorted_unique(tbuf, _t(fresh), out=out)
    want = jutil.merge_sorted_unique_np(old, fresh)
    assert merged is out
    assert int(cnt[0]) == want.size and int(n_new[0]) == fresh.size
    assert_array_equal(merged.numpy()[: want.size], want)
    assert (merged.numpy()[want.size:] == BIG64).all()
    assert_array_equal(tbuf.numpy(), buf)
    with pytest.raises(ValueError, match="alias"):
        merge_sorted_unique(tbuf, _t(fresh), out=tbuf)


def _fjd_case(rng, capacity, big_left=False):
    """The seeded join of ``tests/test_fused_kernels.py``: small key range,
    15-bit left and 16-bit right payloads; optionally some left keys set
    to the int32 sentinel (the TPU kernel masks them out)."""
    n, m = int(rng.integers(0, 80)), int(rng.integers(0, 80))
    l_keys = rng.integers(0, 50, size=n).astype(np.int32)
    if big_left and n:
        l_keys[rng.random(n) < 0.3] = BIG32
    r_keys = np.sort(rng.integers(0, 50, size=m).astype(np.int32))
    l_pay = rng.integers(0, 2**15, size=n).astype(np.int32)
    r_pay = rng.integers(0, 2**16, size=m).astype(np.int32)
    return l_keys, l_pay, r_keys, r_pay


def _fjd_port(args, capacity):
    out, cnt, tot = fused_join_dedup(*map(_t, args), capacity)
    assert out.dtype == cnt.dtype == torch.int32 and out.shape == (capacity,)
    return out.numpy(), int(cnt[0]), tot


@pytest.mark.parametrize("capacity", [1, 7, 64, 256, 1000])
def test_fused_join_dedup_vs_pallas(capacity):
    """Seeded trials with and without sentinel left keys: each against the
    reference's oracle where it applies, the first six also against the
    Pallas kernel in interpret mode (about 0.4 s a call there)."""
    rng = np.random.default_rng(capacity)
    for trial in range(20):
        args = _fjd_case(rng, capacity, big_left=trial % 2 == 1)
        out, cnt, tot = _fjd_port(args, capacity)
        if trial % 2 == 0:  # the numpy oracle does not mask sentinel keys
            r_out, r_cnt, r_tot = jref.fused_join_dedup_ref(*args, capacity=capacity)
            assert (cnt, tot) == (r_cnt, r_tot)
            assert_array_equal(out, r_out)
        if trial < 6:
            j_out, j_cnt, j_tot = j_fused_join_dedup(*args, capacity=capacity, interpret=True)
            assert (cnt, tot) == (int(j_cnt[0]), int(j_tot[0]))
            assert_array_equal(out, np.asarray(j_out))


@pytest.mark.parametrize(
    "case",
    ["empty-left", "empty-right", "zero-capacity", "all-duplicates",
     "cut-then-regrow", "sentinel-left-keys", "wide-payloads"],
)
def test_fused_join_dedup_edges_vs_pallas(case):
    rng = np.random.default_rng(17)
    some = np.asarray([1, 2, 3], np.int32)
    empty = np.zeros(0, np.int32)
    capacity = 64
    if case == "empty-left":
        args = (empty, empty, some, some)
    elif case == "empty-right":
        args = (some, some, empty, empty)
    elif case == "zero-capacity":
        args, capacity = (some, some, some, some), 0
    elif case == "all-duplicates":  # every match packs to one code
        args = (np.full(37, 5, np.int32), np.full(37, 9, np.int32),
                np.full(11, 5, np.int32), np.full(11, 3, np.int32))
        capacity = 512
    elif case == "cut-then-regrow":  # 20 x 20 pairs cut at 64
        args = (np.zeros(20, np.int32), rng.integers(0, 2**15, 20).astype(np.int32),
                np.zeros(20, np.int32), rng.integers(0, 2**16, 20).astype(np.int32))
    elif case == "sentinel-left-keys":
        l = np.asarray([BIG32, 4, BIG32, 4], np.int32)
        r = np.asarray([4, BIG32, BIG32], np.int32)
        args = (l, np.arange(4, dtype=np.int32), r, np.arange(3, dtype=np.int32))
    else:  # payloads past 15 bits wrap as int32 arithmetic does
        args = (np.zeros(30, np.int32), rng.integers(2**15, 2**16, 30).astype(np.int32),
                np.zeros(3, np.int32), rng.integers(0, 2**20, 3).astype(np.int32))
    out, cnt, tot = _fjd_port(args, capacity)
    j_out, j_cnt, j_tot = j_fused_join_dedup(*args, capacity=capacity, interpret=True)
    assert (cnt, tot) == (int(j_cnt[0]), int(j_tot[0]))
    assert_array_equal(out, np.asarray(j_out))
    if case == "all-duplicates":
        assert (cnt, tot, int(out[0])) == (1, 37 * 11, (9 << 16) | 3)
    if case == "cut-then-regrow":
        assert tot == 400 > capacity
        out, cnt, tot = _fjd_port(args, 512)
        want = np.unique((args[1].astype(np.int64)[:, None] << 16) | args[3][None, :])
        assert (cnt, tot) == (want.size, 400)
        assert_array_equal(out[: want.size], want)
    if case in ("empty-left", "empty-right", "zero-capacity"):
        assert (cnt, tot) == (0, 0) and (out == BIG32).all()


@pytest.mark.parametrize("capacity", [1, 30, 64, 200])
def test_fused_join_dedup_wide_payloads_cut_vs_pallas(capacity):
    """Codes that wrap to negative int32 (left payloads past 15 bits),
    enumerated left-major and cut at ``capacity`` before the dedup: the
    card's radix sort must keep them below the positive ones."""
    rng = np.random.default_rng(capacity)
    l = rng.integers(0, 6, size=40).astype(np.int32)
    r = np.sort(rng.integers(0, 6, size=12).astype(np.int32))
    args = (l, rng.integers(0, 2**16, 40).astype(np.int32), r,
            rng.integers(0, 2**20, 12).astype(np.int32))
    out, cnt, tot = _fjd_port(args, capacity)
    j_out, j_cnt, j_tot = j_fused_join_dedup(*args, capacity=capacity, interpret=True)
    assert (cnt, tot) == (int(j_cnt[0]), int(j_tot[0]))
    assert_array_equal(out, np.asarray(j_out))
    if tot <= capacity:  # every pair kept: both signs present
        assert (out[:cnt] < 0).any() and (out[:cnt] >= 0).any()
    else:
        assert cnt <= capacity < tot


def test_launch_shapes_count_each_distinct_launch():
    """The launch meter keeps every distinct set of operand lengths with
    its count, in the order first seen, as the closure's launches are
    read from it; a reset clears them."""
    ops.reset_launch_counts()
    for shape in ({"n": 3, "m": 2}, {"n": 5, "m": 2}, {"n": 3, "m": 2}):
        ops.note_launch("fused_join_dedup", **shape)
    assert ops.launch_shapes("fused_join_dedup") == [({"n": 3, "m": 2}, 2), ({"n": 5, "m": 2}, 1)]
    assert ops.launch_counts()["fused_join_dedup"] == 3
    assert ops.largest_launches()["fused_join_dedup"] == {"n": 5, "m": 2}
    ops.reset_launch_counts()
    assert ops.launch_shapes("fused_join_dedup") == []


def _c_layout_bytes(n: int, capacity: int) -> int:
    """``layout(n, capacity).bytes`` of ``csrc/fused_join_dedup.cu``,
    evaluated from the source itself: its ``constexpr`` integers and the
    body of ``layout``, read as Python (``/`` on integers is ``//``)."""
    import re

    src = (Path(ops.__file__).parent / "csrc" / "fused_join_dedup.cu").read_text()

    def py(expr):
        return re.sub(r"int64_t\{(\w+)\}", r"\1", expr).replace("/", "//")

    consts = {}
    for decl in re.findall(r"constexpr (?:int|int64_t) ([^;]+);", src):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            consts[name] = py(expr.strip())
    env = {"align16": lambda x: (x + 15) & ~15, "n": n, "cap": capacity}
    for name in ("kHeaderWords", "kThreads", "kRowItems", "kRowTile", "kUnitShift", "kUnit",
                 "kBits", "kBins", "kPasses"):
        env[name] = eval(consts[name], {}, env)
    body = re.search(r"Layout layout\(int64_t n, int64_t cap\) \{(.*?)return s;", src, re.S)
    for field, expr in re.findall(r"s\.(\w+) = ([^;]+);", body.group(1)):
        env["s_" + field] = eval(py(expr).replace("s.", "s_"), {}, env)
    return env["s_bytes"]


@pytest.mark.parametrize("n,capacity", [(1, 1), (0, 4096), (89_912, 131_072),
                                        (119_755, 4096), (3000, 1 << 20), (7, 4097)])
def test_fused_join_dedup_scratch_is_sized_from_n_and_capacity(n, capacity):
    """The kernel's scratch, as the wrapper allocates it from ``n`` and
    ``capacity`` alone, holds the kernel's own layout (its ``layout``
    evaluated from the CUDA source) and is no larger by a word."""
    assert 0 <= scratch_words(n, capacity) * 8 - _c_layout_bytes(n, capacity) < 8
    # a row tile more adds its status word, and at most a word of padding
    assert scratch_words(n + 2048, capacity) - scratch_words(n, capacity) in (0, 1, 2)


def test_fused_join_dedup_rejects_int64():
    x = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        fused_join_dedup(x, x, x, x, 8)


@pytest.mark.parametrize(
    "call",
    [
        lambda x: sorted_member(x, x),
        lambda x: join_bounds(x, x),
        lambda x: rle_expand(x, x, 4),
        lambda x: merge_sorted_unique(x, x),
        lambda x: fused_join_dedup(*[x.to(torch.int32)] * 4, 16),
    ],
    ids=["sorted_member", "join_bounds", "rle_expand", "merge_sorted_unique",
         "fused_join_dedup"],
)
def test_wrapper_without_cuda_build_raises(call):
    """Off the CPU a wrapper launches its kernel or raises: here there is
    no CUDA build, so it raises and computes nothing — and counts
    nothing."""
    ops.reset_launch_counts()
    x = torch.ones(4, dtype=torch.int64, device="meta")
    with pytest.raises(build.KernelBuildError):
        call(x)
    assert sum(ops.launch_counts().values()) == 0


def test_build_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the build would run")
    with pytest.raises(build.KernelBuildError):
        build.build()


def test_cpu_calls_do_not_count():
    ops.reset_launch_counts()
    a = torch.arange(10, dtype=torch.int64)
    sorted_member(a, a)
    join_bounds(a, a)
    rle_expand(a, torch.ones(10, dtype=torch.int64), 10)
    merge_sorted_unique(torch.full((128,), BIG64), a)
    a32 = a.to(torch.int32)
    fused_join_dedup(a32, a32, a32, a32, 16)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize(
    "args,exc",
    [
        ((torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int64)), TypeError),
        ((torch.zeros(3), torch.zeros(3)), TypeError),
        ((torch.zeros(3, 2, dtype=torch.int64), torch.zeros(3, dtype=torch.int64)), ValueError),
        ((torch.zeros(6, dtype=torch.int64)[::2], torch.zeros(3, dtype=torch.int64)), ValueError),
    ],
    ids=["mixed-types", "float", "2-d", "strided"],
)
def test_wrappers_reject_bad_operands(args, exc):
    with pytest.raises(exc):
        sorted_member(*args)
    with pytest.raises(exc):
        join_bounds(*args)
