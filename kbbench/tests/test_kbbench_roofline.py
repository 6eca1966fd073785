"""The hand kernels' bytes models on hand-counted shapes, the CUDA symbol
map, the roofline share and the trace reductions on made-up records."""

from __future__ import annotations

import json

import pytest

from kbbench.harness import Record
from kbbench.roofline import share
from kbbench.roofline.bytes_model import launch_bytes
from kbbench.trace import Span, breakdown, busy_ns

from .conftest import ROOT


@pytest.mark.parametrize("kernel, shape, key, want", [
    # probes read, one key of b per probe (at most all of b), a mask byte each
    ("sorted_member", {"n": 1000, "m": 10}, 8, (8 * 1010, 1000)),
    ("sorted_member", {"n": 10, "m": 1000}, 8, (8 * 20, 10)),
    ("sorted_member", {}, 8, (0, 0)),
    # l read, a right key per left key, two int32 spans written
    ("join_bounds", {"n": 10_000, "m": 2_999_718}, 8, (8 * 20_000, 8 * 10_000)),
    ("join_bounds", {"n": 5, "m": 3}, 4, (4 * 8, 40)),
    # run values and int64 ends read, every expanded key written
    ("rle_expand", {"runs": 7, "total": 100}, 8, (16 * 7, 800)),
    ("rle_expand", {"runs": 7, "total": 100}, 4, (12 * 7, 400)),
    # the codes below the watermark and the fresh read, the buffer written
    ("merge_sorted_unique", {"cap": 4_194_304, "fresh": 3_993_727, "count": 100},
     8, (8 * 3_993_827, 8 * 4_194_304)),
    ("merge_sorted_unique", {"cap": 128, "fresh": 3}, 8, (24, 1024)),
    # left keys and payloads, a right pair per emitted pair (at most m)
    ("fused_join_dedup", {"n": 100, "m": 50, "capacity": 4096, "pairs": 80}, 4, (8 * 150, 0)),
    ("fused_join_dedup", {"n": 100, "m": 500, "capacity": 4096, "pairs": 80}, 4, (8 * 180, 0)),
])
def test_bytes_model_hand_counted(kernel, shape, key, want):
    assert launch_bytes(kernel, shape, key) == want


def test_symbol_map_names_every_kernel_and_matches_profiler_names():
    from repro_torch.kernels import ops

    sym = json.loads((ROOT / "kbbench/roofline/symbols.json").read_text())["kernels"]
    assert set(sym) == set(ops.KERNELS)
    m = share._match
    assert m("void (anonymous namespace)::bucket_probe_kernel<long>(long const*, long)",
             sym["sorted_member"]["symbols"]) == "long"
    assert m("join_bounds_warp_kernel<int>(int const*)", sym["join_bounds"]["symbols"]) == "int"
    assert m("void fjd_kernel<true>(Params)", sym["fused_join_dedup"]["symbols"]) == "true"
    assert m("void xbucket_probe_kernel<long>(long)", sym["sorted_member"]["symbols"]) is None
    assert m("void at::native::vectorized_gather_kernel<16, long>(char*)",
             sym["rle_expand"]["symbols"]) is None


def _record(events, shapes, t1=10_000_000):
    return Record(t0_ns=0, t1_ns=t1, spans=[],
                  launches={k: sum(n for _, n in v) for k, v in shapes.items()},
                  launch_shapes=shapes, tuning={}, device_events=events)


def test_share_is_bound_over_device_time():
    bw = share.peaks()["hbm_bytes_per_s"]
    shape = {"runs": 1000, "total": 1_000_000}
    need = sum(launch_bytes("rle_expand", shape, 8)) * 2
    t_bound = need / bw
    events = [("void rle_expand_kernel<long>(long const*)", 0, int(2 * t_bound * 1e9)),
              ("void at::native::other_kernel<long>(long)", 10, 999_999)]
    got = share.kernels_share(_record(events, {"rle_expand": [(shape, 2)]}))
    assert got == pytest.approx(50.0, rel=1e-3)
    # launches but no device time, or device time but no launches: left out
    assert share.kernels_share(_record(events[1:], {"rle_expand": [(shape, 2)]})) is None
    assert share.kernels_share(_record(events, {})) is None
    # two key widths under one kernel: the meter cannot say which launch is which
    mixed = events + [("void rle_expand_kernel<int>(int const*)", 5, 100)]
    assert share.kernels_share(_record(mixed, {"rle_expand": [(shape, 2)]})) is None


def test_busy_and_breakdown():
    events = [("k1", 0, 100), ("k2", 50, 100), ("k1", 400, 100), ("k3", 900, 200)]
    assert busy_ns(events, 0, 1000) == 150 + 100 + 100
    spans = [Span("job.load", 0, 1000, 0, 1), Span("cmat.dedup", 500, 300, 1, 1)]
    b = breakdown(events, spans, 0, 1000)
    assert b["device_ops"][0] == ["k1", 200 / 1e9]
    idle = dict((n, v) for n, v in b["idle_gaps"])
    # gaps 150-400 and 500-900: the first under job.load, the second under dedup
    assert idle == {"job.load": 250 / 1e9, "cmat.dedup": 400 / 1e9}
