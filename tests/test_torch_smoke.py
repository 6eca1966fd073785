"""The kernel-check inputs of ``chip_smoke.py``, built on the CPU.

The script times each kernel at the operand lengths the launch meter
recorded on the full-size run; these tests hold its input builder and its
bytes bound to those lengths at a small size, and run every case it holds
``sorted_member``, ``join_bounds``, ``rle_expand`` and
``merge_sorted_unique`` to, and the CMat run's own ``join_bounds``
launches, through the port's plain version and the JAX package's Pallas
kernel (interpret mode).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.kernels.fused import merge_sorted_unique as j_merge
from repro.kernels.join_bounds import join_bounds as j_join_bounds
from repro.kernels.rle_expand import rle_expand as j_rle_expand
from repro.kernels.sorted_member import sorted_member as j_sorted_member
from repro_torch.kernels import join_bounds, merge_sorted_unique, ref, rle_expand, sorted_member

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,hi", [(0, 10), (1000, 1000), (5000, 2**31 - 2)])
def test_distinct_is_exact(smoke, n, hi):
    x = smoke._distinct(np.random.default_rng(3), n, hi)
    assert x.shape == (n,)
    assert np.unique(x).shape == (n,)
    assert n == 0 or (x.min() >= 0 and x.max() < hi)


SHAPES = {
    "sorted_member": {"n": 700, "m": 900},
    "join_bounds": {"n": 1100, "m": 600},
    "rle_expand": {"runs": 50, "total": 3000},
    "merge_sorted_unique": {"cap": 4096, "count": 300, "fresh": 2000},
}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_timed_case_has_the_metered_lengths(smoke, name, dtype):
    cases = smoke._cases(name, SHAPES[name], dtype, torch.device("cpu"),
                         np.random.default_rng(5))
    (args,) = [a for label, a, timed in cases if timed and label == "full"]
    sh = SHAPES[name]
    size = dtype.itemsize
    if name in ("sorted_member", "join_bounds"):
        a, b = args
        assert (a.shape[0], b.shape[0]) == (sh["n"], sh["m"])
        assert torch.equal(b, torch.unique(b))
        # of b, the 32-byte sectors holding the keys on either side of
        # each bound
        sides = ("left",) if name == "sorted_member" else ("left", "right")
        bounds = [np.searchsorted(b.numpy(), a.numpy(), side) for side in sides]
        at = np.concatenate([x + d for x in bounds for d in (-1, 0)])
        at = at[(at >= 0) & (at < sh["m"])]
        sectors = np.unique((b.data_ptr() % 32 + at * size) // 32).shape[0]
        deciding = min(sh["m"] * size, 32 * sectors)
        want = sh["n"] * size + deciding + (1 if name == "sorted_member" else 8) * sh["n"]
    elif name == "rle_expand":
        vals, counts, total = args
        assert (vals.shape[0], total, int(counts.sum())) == (sh["runs"], sh["total"], sh["total"])
        want = sh["runs"] * (size + counts.element_size()) + sh["total"] * size
    else:
        buf, fresh = args
        occupied = buf[buf != ref.sentinel(dtype)]
        assert (buf.shape[0], occupied.shape[0], fresh.shape[0]) == (
            sh["cap"], sh["count"], sh["fresh"]
        )
        assert torch.equal(fresh, torch.unique(fresh))
        assert torch.equal(occupied, torch.unique(occupied))
        assert not bool(torch.isin(fresh, occupied).any())
        want = (sh["count"] + sh["fresh"] + sh["cap"]) * size + 16
    assert smoke._bytes(name, args, size) == want
    assert smoke.LIBRARY_CALLS[name].startswith("torch.")
    smoke._library_call(name, args)()  # the yardstick runs on these inputs


@pytest.mark.parametrize("name", ["sorted_member", "join_bounds"])
def test_search_bound_reads_only_the_deciding_keys(smoke, name):
    """A search's bytes bound counts of its sorted side only the sectors
    that decide the answers: one sector for keys all above (or all below)
    its span, all of it for keys spread over every gap."""
    r = torch.arange(0, 80_000, 8, dtype=torch.int64)  # 10,000 keys, 2,500 sectors
    out = 1 if name == "sorted_member" else 8
    for l, sectors in [(r[-1] + 1 + torch.arange(300), 1), (r[0] - 1 - torch.arange(300), 1),
                       (r + 3, 2_500)]:
        n = l.shape[0]
        assert smoke._bytes(name, (l, r), 8) == n * 8 + 32 * sectors + out * n


@pytest.mark.parametrize("m", [40, 40_000])
def test_join_cases_have_the_metered_lengths(smoke, m):
    """``fused_join_dedup``'s timed case has the closure's largest launch
    lengths (its right side may hold more rows than 15-bit ids); every
    case runs through the wrapper (its plain version here) and the
    yardstick's packed pairs are the pairs the join enumerates."""
    from repro_torch.kernels import fused_join_dedup

    shape = {"n": 900, "m": m, "capacity": 1024, "pairs": 900}
    cases = smoke._cases("fused_join_dedup", shape, torch.int32, torch.device("cpu"),
                         np.random.default_rng(5))
    (args,) = [a for _, a, timed in cases if timed]
    l_keys, l_pay, r_keys, r_pay, cap = args
    assert (l_keys.shape[0], r_keys.shape[0], cap) == (900, m, 1024)
    assert torch.equal(r_keys, torch.unique(r_keys))  # each right key once
    # every left key and payload (all 900 pairs are kept), the right keys
    # on either side of each span and the payloads of the matched right
    # rows, in the 32-byte sectors that hold them; 1,024 codes and the count
    lo = np.searchsorted(r_keys.numpy(), l_keys.numpy(), "left")
    hi = np.searchsorted(r_keys.numpy(), l_keys.numpy(), "right")
    assert (hi - lo == 1).all()

    def sectors(x, at):
        at = at[(at >= 0) & (at < x.shape[0])]
        return min(4 * x.shape[0], 32 * np.unique((x.data_ptr() % 32 + 4 * at) // 32).shape[0])

    want = (900 * 4 + sectors(r_keys, np.concatenate([lo - 1, lo, hi - 1, hi]))
            + 900 * 4 + sectors(r_pay, lo) + 1024 * 4 + 4)
    assert smoke._bytes("fused_join_dedup", args, 4) == want
    for label, case, _ in cases:
        out, count, total = fused_join_dedup(*case)
        assert out.shape == (case[4],) and int(count[0]) <= min(total, case[4]), label
    out, count, total = fused_join_dedup(*args)
    assert total == 900  # every left key matches one right row
    codes, n_pairs = ref.join_pairs16(*args)
    assert n_pairs == total and codes.shape == (900,)
    assert torch.equal(smoke._library_call("fused_join_dedup", args)(), out[: int(count[0])])
    assert "sort-and-dedup half only" in smoke.LIBRARY_CALLS["fused_join_dedup"]


@pytest.mark.parametrize("pairs", [0, 450, 900, 2_700])
def test_join_cases_have_the_metered_pairs(smoke, pairs):
    """The timed ``fused_join_dedup`` case enumerates the pair count of
    the metered launch, which its cost grows with, not only its lengths."""
    from repro_torch.kernels import fused_join_dedup

    shape = {"n": 900, "m": 40, "capacity": 4096, "pairs": pairs}
    cases = smoke._cases("fused_join_dedup", shape, torch.int32, torch.device("cpu"),
                         np.random.default_rng(6))
    (args,) = [a for _, a, timed in cases if timed]
    assert (args[0].shape[0], args[2].shape[0]) == (900, 40)
    assert fused_join_dedup(*args)[2] == pairs
    # a launch cut at a smaller capacity emitted fewer pairs than these
    with pytest.raises(AssertionError, match="pairs"):
        smoke._cases("fused_join_dedup", dict(shape, pairs=pairs + 1, capacity=pairs),
                     torch.int32, torch.device("cpu"), np.random.default_rng(6))


@pytest.mark.parametrize("n_students,n_courses", [(500, 700), (3000, 3000)])
def test_closure_nopairs_case_matches_nothing(smoke, n_students, n_courses):
    """The closure's join that matches nothing (``knows`` with itself:
    professors on the left, students on the right), rebuilt for timing
    from the flat oracle of a small KB as for the full one: the recorded
    lengths and capacity, sorted right keys, every left key above them, no
    pair, an all-sentinel output; its bound reads one sector of the right
    keys and no payload."""
    from repro_torch.kernels import fused_join_dedup

    kb = {"n_dept": 20, "n_students": n_students, "n_courses": n_courses}
    program, facts = smoke._kb_facts(tuple(sorted(kb.items())))
    heads = {rule.head.predicate: args
             for rule, args in smoke.closure_joins(program, facts, torch.device("cpu"))}
    assert set(heads) == {"memberOfOrg", "taughtBy", "connected"}
    n, m = heads["connected"][0].shape[0], heads["connected"][2].shape[0]
    assert n == m == facts["knows"].shape[0]
    shape = {"kb": kb, "head": "connected", "n": n, "m": m, "capacity": 4096, "pairs": 0}
    args = smoke._timed_args("fused_join_dedup", "closure-connected-4096", shape, torch.int32,
                             torch.device("cpu"), np.random.default_rng(9))
    l_keys, l_pay, r_keys, r_pay, cap = args
    assert (l_keys.shape[0], r_keys.shape[0], cap) == (n, m, 4096)
    assert torch.equal(r_keys, torch.sort(r_keys).values)
    assert int(l_keys.min()) > int(r_keys.max())
    out, count, total = fused_join_dedup(*args)
    assert (total, int(count[0])) == (0, 0)
    assert bool((out == ref.sentinel(torch.int32)).all())
    assert smoke._bytes("fused_join_dedup", args, 4) == n * 4 + 32 + 4096 * 4 + 4
    with pytest.raises(AssertionError, match="oracle"):
        smoke._closure_case(dict(shape, n=n + 1), torch.device("cpu"))


def test_join_bound_counts_only_the_pairs_kept(smoke):
    """``fused_join_dedup``'s bytes bound reads every left key, of the
    right keys only what decides the spans, and the payloads only of the
    rows whose pairs are kept: none when every left key lies above the
    right side or is the sentinel, the first ``capacity`` rows when each
    left row matches once and the cut falls at ``capacity``."""
    big = ref.sentinel(torch.int32)
    r = torch.arange(0, 4000, 4, dtype=torch.int32)  # 1,000 keys, 125 sectors
    l_keys, l_pay, r_pay = r.clone(), torch.arange(1000, dtype=torch.int32), r.clone()
    assert all(x.data_ptr() % 32 == 0 for x in (r, l_keys, l_pay, r_pay))
    above = 5000 + l_keys[:300]
    assert smoke._bytes("fused_join_dedup", (above, l_pay[:300], r, r_pay, 64), 4) == (
        300 * 4 + 32 + 64 * 4 + 4)
    padded = torch.cat([r, torch.full((8,), big, dtype=torch.int32)])
    sentinel = torch.full((300,), big, dtype=torch.int32)
    assert smoke._bytes("fused_join_dedup", (sentinel, l_pay[:300], padded, padded, 64), 4) == (
        300 * 4 + 64 * 4 + 4)
    # 128 of 1,000 single matches kept: 16 sectors of each payload
    assert smoke._bytes("fused_join_dedup", (l_keys, l_pay, r, r_pay, 128), 4) == (
        1000 * 4 + 1000 * 4 + 128 * 4 + 128 * 4 + 128 * 4 + 4)


#: every case ``chip_smoke.py`` holds the four redesigned kernels to on
#: the card, mirrored here in int32 against the Pallas kernels
MIRRORED = {
    "join_bounds": [
        "full", "empty-a", "empty-b", "sentinel-padding", "all-sentinel", "sentinel-padded-r",
        "gap-probes",
        "out-of-span", "all-r-equal", "m-1", "duplicates-in-l", "n-ragged",
        "unaligned-views", "long-runs-in-r", "out-of-span-few-keys", "many-long-gaps",
    ],
    "merge_sorted_unique": [
        "full", "empty-buf-empty-fresh", "all-sentinel-buf", "duplicates", "fills-exactly",
        "truncates", "padded-fresh", "runs-across-tiles", "fresh-inside-buf",
        "cut-mid-tile", "cap-far-above-inputs",
    ],
    "sorted_member": [
        "full", "empty-a", "empty-b", "sentinel-padding", "all-sentinel", "m-1",
        "duplicates-in-b", "sentinel-padding-long-b", "n-ragged",
        "unaligned-views", "few-probes", "few-probes-sentinel", "clustered-keys",
    ],
    "rle_expand": [
        "full", "skewed", "zero-runs", "one-run", "empty", "zero-stretches",
        "one-run-many-tiles", "ragged-tail",
    ],
}


def _int32_cases(smoke, name):
    return smoke._cases(name, SHAPES[name], torch.int32, torch.device("cpu"),
                        np.random.default_rng(7))


@pytest.mark.parametrize(
    "name,label", [(n, lab) for n, labels in MIRRORED.items() for lab in labels]
)
def test_kernel_cases_match_pallas(smoke, name, label):
    """Each card case of the redesigned kernels through the port's wrapper
    (its plain version here) and the JAX package's Pallas kernel in
    interpret mode, int32, exactly."""
    (args,) = [a for lab, a, _ in _int32_cases(smoke, name) if lab == label]
    if name == "join_bounds":
        l, r = args
        got = np.stack([x.numpy() for x in join_bounds(l, r)])
        want = np.stack([np.asarray(x) for x in j_join_bounds(l.numpy(), r.numpy(),
                                                             interpret=True)])
        assert_array_equal(got, np.stack([np.searchsorted(r.numpy(), l.numpy(), side)
                                          for side in ("left", "right")]))
        # the Pallas kernel pads r to its block with the sentinel, which a
        # sentinel key (itself padding) then counts as equal: compare the
        # other keys
        real = l.numpy() != ref.sentinel(torch.int32)
        got, want = got[:, real], want[:, real]
    elif name == "merge_sorted_unique":
        buf, fresh = args
        merged, count, n_new = merge_sorted_unique(buf, fresh)
        j_merged, j_count, j_new = j_merge(buf.numpy(), fresh.numpy(), interpret=True)
        assert (int(count[0]), int(n_new[0])) == (int(j_count[0]), int(j_new[0]))
        got, want = merged.numpy(), np.asarray(j_merged)
        if label == "fresh-inside-buf":
            assert int(n_new[0]) == 0 and int(count[0]) < buf.shape[0] // 2
        if label == "cut-mid-tile":
            assert int(count[0]) > buf.shape[0]
    elif name == "sorted_member":
        a, b = args
        got = sorted_member(a, b).numpy()
        want = np.asarray(j_sorted_member(a.numpy(), b.numpy(), interpret=True))
        assert_array_equal(got, np.isin(a.numpy(), b.numpy()))
    else:
        vals, counts, total = args
        got = rle_expand(vals, counts, total).numpy()
        want = np.asarray(j_rle_expand(vals.numpy(), counts.numpy().astype(np.int32),
                                       total=total, interpret=True))
        assert_array_equal(got, np.repeat(vals.numpy(), counts.numpy()))
    assert_array_equal(got, want)
    if label == "skewed":
        assert int(counts.max()) >= 0.9 * total
    if label == "ragged-tail":
        assert total % 4 and total % 2


@pytest.mark.parametrize("label,shape", [
    ("cmat-disjoint", {"n": 3001, "m": 2000, "l_values": 10, "r_values": 1000}),
    ("cmat-xjoin", {"n": 100, "m": 3001}),
])
def test_main_path_cases_match_pallas(smoke, label, shape):
    """The CMat run's own ``join_bounds`` launches, at a small size: every
    left key above every right key (no pairs), or distinct left keys that
    the right keys repeat (each left key matched)."""
    l, r = smoke._timed_args("join_bounds", label, shape, torch.int32, torch.device("cpu"),
                             np.random.default_rng(8))
    assert (l.shape[0], r.shape[0]) == (shape["n"], shape["m"])
    assert torch.equal(r, torch.sort(r).values)
    lo, hi = join_bounds(l, r)
    jlo, jhi = j_join_bounds(l.numpy(), r.numpy(), interpret=True)
    assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert_array_equal(hi.numpy(), np.asarray(jhi))
    if label == "cmat-disjoint":
        assert (lo == shape["m"]).all() and (hi == shape["m"]).all()
        assert torch.unique(l).shape[0] == shape["l_values"]
        assert torch.unique(r).shape[0] == shape["r_values"]
    else:
        assert torch.unique(l).shape[0] == shape["n"] and bool((hi > lo).all())
        assert int((hi - lo).sum()) == shape["m"]


@pytest.mark.parametrize("label,shape", [
    ("query-one-key", {"n": 1, "m": 5000}),
    ("query-one-constant", {"n": 3001, "m": 1}),
])
def test_query_cases_match_pallas(smoke, label, shape):
    """The query path's one-sided launches, at a small size: one key that
    a sorted column holds in runs (``SortedRows`` spans), and one constant
    against a candidate slice about half of which holds it (``in_set``)."""
    a, b = smoke._timed_args("sorted_member" if shape["m"] == 1 else "join_bounds", label,
                             shape, torch.int32, torch.device("cpu"), np.random.default_rng(9))
    assert (a.shape[0], b.shape[0]) == (shape["n"], shape["m"])
    assert torch.equal(b, torch.sort(b).values)
    if label == "query-one-key":
        lo, hi = join_bounds(a, b)
        jlo, jhi = j_join_bounds(a.numpy(), b.numpy(), interpret=True)
        assert_array_equal(lo.numpy(), np.asarray(jlo))
        assert_array_equal(hi.numpy(), np.asarray(jhi))
        assert 0 < int(hi[0] - lo[0]) < shape["m"]
        assert torch.unique(b).shape[0] == shape["m"] // smoke.QUERY_KEY_RUN
    else:
        got = sorted_member(a, b).numpy()
        assert_array_equal(got, np.asarray(j_sorted_member(a.numpy(), b.numpy(),
                                                           interpret=True)))
        assert_array_equal(got, a.numpy() == int(b[0]))
        assert 0.4 < got.mean() < 0.6


def test_mirrored_cases_are_every_card_case(smoke):
    for name, labels in MIRRORED.items():
        assert [lab for lab, _, _ in _int32_cases(smoke, name)] == labels


def test_larger_launches_keeps_only_launches_above_every_base(smoke):
    base = {
        "serve": {"largest_launch": {"sorted_member": {"n": 10, "m": 30},
                                     "rle_expand": {"runs": 8, "total": 30}}},
        "live": {"largest_launch": {"sorted_member": {"n": 12, "m": 30},
                                    "rle_expand": {}}},
    }
    runs = {"mvcc": {"largest_launch": {"sorted_member": {"n": 12, "m": 30},
                                        "rle_expand": {"runs": 30, "total": 30},
                                        "join_bounds": {}}}}
    got = smoke.larger_launches(base, runs)
    assert got == {"mvcc": {"largest_launch": {"rle_expand": {"runs": 30, "total": 30}}}}


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-1.2b", "seamless-m4t-large-v2"])
def test_model_phase_forces_every_layer_and_router(smoke, arch):
    """Phase 1a's card run, rehearsed on the CPU: the forced run consumes
    every layer and router call the recorded run made (MLA, MoE and the
    MTP head; the hybrid's shared attention; the encoder) and, on the same
    device, reproduces it exactly."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "cpu")
    net = model.init(torch.Generator().manual_seed(0))
    inputs = smoke._model_inputs(cfg)
    with smoke._recording() as (layers, routes):
        want = smoke._model_run(model, net, inputs, "cpu")
    n_decode = smoke.MODEL_STEPS * cfg.n_layers
    assert len(layers) == 2 * (cfg.n_layers + cfg.n_encoder_layers) + cfg.mtp_depth + n_decode
    n_moe = cfg.n_layers - cfg.moe.first_k_dense if cfg.moe else 0
    assert len(routes) == n_moe * (2 + smoke.MODEL_STEPS)
    with smoke._forcing(layers, routes, smoke.MODEL_TOL["bf16"]) as forced:
        got = smoke._model_run(model, net, inputs, torch.device("cpu"))
    b, s = smoke.MODEL_B, smoke.MODEL_S
    assert forced == {"layer_max_abs_err": 0.0, "near_ties": 0, "tie_gap": 0.0,
                      "routed_rows": n_moe * (2 * b * s + smoke.MODEL_STEPS * b)}
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen2-moe-a2.7b"])
def test_model_phase_forces_the_decode_from_a_forward(smoke, arch):
    """Phase 1a (c)'s MoE run, rehearsed on the CPU: a forward's records,
    cut by ``_by_step``, feed every decode step's layers and routers in
    the decode's order, and the forced decode ends on the forward's
    logits."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "cpu")
    net = model.init(torch.Generator().manual_seed(0))
    n = smoke.WIDE_MOE_S
    tokens = torch.from_numpy(smoke._model_inputs(cfg)["tokens"][:, :n])
    with torch.no_grad():
        with smoke._recording() as (layers, routes):
            full, _ = model.logits(net, {"tokens": tokens})
        cache = model.init_cache(smoke.MODEL_B, n)
        with smoke._forcing(*smoke._by_step(layers, routes, n), smoke.MODEL_TOL["bf16"],
                            rowwise=True, hold_routes=False) as forced:
            decode = torch.cat([model.decode_step(net, tokens[:, t:t + 1], cache, t)[0]
                                for t in range(n)], dim=1)
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    assert forced["routed_rows"] == n_moe * smoke.MODEL_B * n
    torch.testing.assert_close(decode.float(), full.float(), rtol=2e-2, atol=2e-2)


def test_route_ties_counts_near_ties_and_raises_past_them(smoke):
    """Two routers' top-2 of 4 experts: a row that differs at a
    log-probability gap below ``ROUTE_TIE`` is counted, one past it
    raises unless not held."""
    tie = smoke.ROUTE_TIE
    probs = torch.log_softmax(torch.tensor([[3.0, 2.0, 2.0 - tie / 2, 0.0],
                                            [3.0, 2.0, 1.0, 0.0]]), dim=-1).exp()
    ids = torch.tensor([[0, 1], [0, 1]])
    assert smoke.route_ties(probs, ids, probs, ids, 2) == (0, 0.0)
    ties, gap = smoke.route_ties(probs, torch.tensor([[0, 2], [1, 0]]), probs, ids, 2)
    assert ties == 1 and 0 < gap < tie
    with pytest.raises(AssertionError, match="log-probability gap"):
        smoke.route_ties(probs, torch.tensor([[0, 1], [0, 2]]), probs, ids, 2)
    ties, gap = smoke.route_ties(probs, torch.tensor([[0, 1], [0, 2]]), probs, ids, 2,
                                 hold=False)
    assert ties == 1 and gap == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("ties,rows,ok", [(0, 0, True), (1, 100, True), (2, 256, True),
                                          (1, 99, False), (3, 256, False)])
def test_check_tie_share(smoke, ties, rows, ok):
    if ok:
        smoke.check_tie_share("x", ties, rows)
    else:
        with pytest.raises(AssertionError, match=f"{ties} of {rows} routed rows"):
            smoke.check_tie_share("x", ties, rows)
