"""The port's MVCC serving tier, on the CPU.

The behaviours of ``tests/test_serving.py`` on the port (the epoch
registry, pinned reads isolated from the writer, no retirement while
pinned, compaction deferred while pinned, malformed queries failing
alone, pins holding checkpoint pruning and WAL truncation back), one
seeded interleaving of reads, pins, batches and compactions through the
synchronous tier of both packages (answers, versions, epochs and
``stats()`` equal), and a threaded closed-loop stress: zero stale reads,
each version's answers equal to ``answer_flat`` over ``flat_seminaive`` of
that version's explicit set.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core.generators import chain
from repro.incremental import IncrementalStore as JInc
from repro.serving import ServingTier as JServingTier
from repro_torch.core import flat_seminaive
from repro_torch.incremental import IncrementalStore
from repro_torch.query import QueryEngine, answer_flat, parse_query
from repro_torch.serving import EpochRegistry, ServingTier
from repro_torch.storage import CheckpointManager


def rows_set(arr):
    return frozenset(map(tuple, np.asarray(arr).tolist()))


def make_chain_store(n=8):
    program, dataset, dictionary = chain(n=n)
    inc = IncrementalStore(program, device="cpu")
    inc.load(dataset)
    return program, dataset, dictionary, inc


def path_oracle(program, inc):
    mat = flat_seminaive(program, inc.explicit, device="cpu")
    return rows_set(mat.get("path", torch.zeros((0, 2), dtype=torch.int64)))


# --------------------------------------------------------------------- #
# epoch registry
# --------------------------------------------------------------------- #
def test_registry_pin_publish_retire():
    retired = []
    reg = EpochRegistry(on_retire=lambda e: retired.append(e.version))
    with pytest.raises(RuntimeError):
        reg.pin()
    reg.publish(0, frozen="f0", engine="e0")
    assert reg.version == 0 and reg.n_live() == 1
    reg.publish(1, frozen="f1", engine="e1")  # unpinned previous retires
    assert retired == [0] and reg.n_live() == 1
    lease = reg.pin()
    assert lease.version == 1 and lease.engine == "e1"
    reg.publish(2, frozen="f2", engine="e2")
    assert reg.n_live() == 2 and retired == [0]  # v1 pinned: live
    assert reg.pinned_epochs() == {1}
    lease.release()
    assert retired == [0, 1] and reg.n_live() == 1
    lease.release()  # idempotent
    assert reg.stats() == {
        "published": 3, "retired": 2, "live": 1, "pinned": 0,
        "version": 2, "epoch": 2,
    }
    assert reg.max_pinned == 1


def test_registry_refcounts_and_current_pin():
    reg = EpochRegistry()
    reg.publish(0, frozen=None, engine=None)
    l1, l2 = reg.pin(), reg.pin()
    assert reg.n_pinned() == 2 == reg.max_pinned
    l1.release()
    l2.release()  # the current entry survives its last release
    assert reg.n_live() == 1 and reg.version == 0
    reg.publish(1, frozen=None, engine=None)
    assert reg.n_live() == 1 and reg.retired == 1


# --------------------------------------------------------------------- #
# tier read path
# --------------------------------------------------------------------- #
def test_tier_answers_match_query_engine():
    program, dataset, dictionary, inc = make_chain_store()
    tier = ServingTier(inc, dictionary)
    try:
        engine = QueryEngine(inc.freeze(), dictionary)
        for text in ("?x, ?y <- path(?x, ?y)", '?y <- path("v000000", ?y)',
                     '<- edge("v000000", "v000001")'):
            resp = tier.answer(text)
            assert isinstance(resp.answers, torch.Tensor)
            assert torch.equal(resp.answers, engine.answer(text).answers), text
            assert not resp.stale
    finally:
        tier.close()


def test_pinned_epoch_isolated_from_writer():
    program, dataset, dictionary, inc = make_chain_store()
    tier = ServingTier(inc, dictionary)
    query = "?x, ?y <- path(?x, ?y)"
    try:
        want_v0 = path_oracle(program, inc)
        lease = tier.pin()
        # the lease's snapshot rows are the row index's own tensors
        pinned_rows = lease.engine.frozen.snapshot("path")
        kept = pinned_rows.clone()
        dels = {"edge": np.asarray(dataset["edge"])[3:4]}
        tier.apply_sync(deletions=dels)
        want_v1 = path_oracle(program, inc)
        assert want_v1 != want_v0, "the update must change the closure"
        assert rows_set(lease.answer(query).answers) == want_v0
        assert rows_set(tier.answer(query).answers) == want_v1
        tier.apply_sync(additions=dels)
        assert rows_set(lease.answer(query).answers) == want_v0
        # the index replaced its tensors, it never wrote into them
        assert torch.equal(pinned_rows, kept)
        assert lease.engine.frozen.snapshot("path") is pinned_rows
        lease.release()
    finally:
        tier.close()


def test_no_retire_while_pinned():
    program, dataset, dictionary, inc = make_chain_store()
    tier = ServingTier(inc, dictionary)
    try:
        lease = tier.pin()
        entry = lease._lease._entry
        dels = {"edge": np.asarray(dataset["edge"])[:1]}
        tier.apply_sync(deletions=dels)
        tier.apply_sync(additions=dels)
        assert not entry.retired, "entry retired while pinned"
        assert tier.registry.n_live() == 2
        lease.release()
        assert entry.retired, "entry must retire on last unpin"
        assert tier.registry.n_live() == 1
    finally:
        tier.close()


def test_compaction_deferred_while_pinned():
    program, dataset, dictionary, inc = make_chain_store(n=20)
    tier = ServingTier(inc, dictionary, compact_threshold=0.01)
    query = "?x, ?y <- path(?x, ?y)"
    try:
        lease = tier.pin()
        v0 = path_oracle(program, inc)
        dels = {"edge": np.asarray(dataset["edge"])[4:6]}
        tier.apply_sync(deletions=dels)
        assert tier.compactions == 0 and tier.compactions_deferred >= 1
        assert rows_set(lease.answer(query).answers) == v0
        lease.release()
        tier.apply_sync(additions=dels)
        assert tier.compactions >= 1, "compaction must run once unpinned"
        assert rows_set(tier.answer(query).answers) == path_oracle(program, inc)
    finally:
        tier.close()


def test_malformed_query_fails_alone():
    program, dataset, dictionary, inc = make_chain_store()
    tier = ServingTier(inc, dictionary)
    try:
        tier.start()
        good = tier.submit("?x, ?y <- path(?x, ?y)")
        bad = tier.submit("this is not a query")
        good2 = tier.submit('?y <- path("v000000", ?y)')
        with pytest.raises(ValueError):
            bad.wait(timeout=30.0)
        assert good.wait(timeout=30.0).n_answers > 0
        assert good2.wait(timeout=30.0).n_answers > 0
    finally:
        tier.close()


def test_writer_failure_reaches_the_caller():
    """An error in the writer thread is raised by ``apply_sync``; the tier
    keeps serving."""
    program, dataset, dictionary, inc = make_chain_store()
    tier = ServingTier(inc, dictionary)

    def broken(store, stats):
        raise RuntimeError("publish hook failed")

    try:
        tier.start()
        inc.subscribe_publish(broken)
        with pytest.raises(RuntimeError, match="publish hook failed"):
            tier.apply_sync(deletions={"edge": np.asarray(dataset["edge"])[:1]})
        inc.unsubscribe_publish(broken)
        assert tier.answer("?x, ?y <- edge(?x, ?y)", timeout=30.0).n_answers > 0
    finally:
        tier.close()


# --------------------------------------------------------------------- #
# one interleaving through both packages' synchronous tiers
# --------------------------------------------------------------------- #
def _interleaving(seed: int, n_ops: int = 24):
    rng = np.random.default_rng(seed)
    kinds = ["apply", "pin", "unpin", "query_current", "query_pinned", "query_other"]
    ops = []
    for _ in range(n_ops):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        if kind == "apply":
            ops.append(("apply", int(rng.integers(0, 10)), bool(rng.integers(0, 2))))
        elif kind in ("unpin", "query_pinned"):
            ops.append((kind, int(rng.integers(0, 5))))
        else:
            ops.append((kind,))
    return ops


def _drive(tier, ops, edges, as_numpy):
    """Run ``ops`` on a synchronous tier; returns what each op observed."""
    queries = ["?x, ?y <- path(?x, ?y)", '?y <- path("v000002", ?y)']
    pinned, seen = [], []
    for op in ops:
        if op[0] == "apply":
            _, i, delete = op
            batch = {"edge": edges[i % len(edges): i % len(edges) + 1]}
            st = tier.apply_sync(**({"deletions": batch} if delete else {"additions": batch}))
            seen.append(("apply", st.epoch, st.n_deleted, st.n_inserted))
        elif op[0] == "pin":
            lease = tier.pin()
            pinned.append(lease)
            seen.append(("pin", lease.version, lease.epoch))
        elif op[0] == "unpin" and pinned:
            pinned.pop(op[1] % len(pinned)).release()
        elif op[0] == "query_pinned" and pinned:
            lease = pinned[op[1] % len(pinned)]
            seen.append(("pinned", lease.version, as_numpy(lease.answer(queries[0]).answers)))
        elif op[0] in ("query_current", "query_other"):
            resp = tier.answer(queries[op[0] == "query_other"])
            seen.append(("answer", resp.version, resp.epoch, resp.from_cache, resp.stale,
                         as_numpy(resp.answers)))
        seen.append(("stats", tier.stats()))
    for lease in pinned:
        lease.release()
    seen.append(("final", tier.stats(), tier.registry.n_live(), tier.registry.n_pinned()))
    return seen


@pytest.mark.parametrize("seed", [1, 4, 5])
def test_sync_interleaving_matches_reference(seed):
    """Seeds whose interleaving compacts once unpinned and defers while
    pinned (chain(20) is above ``maybe_compact``'s node floor)."""
    program, dataset, dictionary = chain(n=20)
    edges = np.asarray(dataset["edge"])
    ops = _interleaving(seed)
    inc = IncrementalStore(program, device="cpu")
    inc.load(dataset)
    jinc = JInc(program)
    jinc.load(dataset)
    tier = ServingTier(inc, dictionary, compact_threshold=0.05)
    jtier = JServingTier(jinc, dictionary, compact_threshold=0.05)
    try:
        got = _drive(tier, ops, edges, lambda t: t.numpy())
        want = _drive(jtier, ops, edges, np.asarray)
    finally:
        tier.close()
        jtier.close()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, np.ndarray):
                assert_array_equal(a, b)
            else:
                assert a == b, (g[0], a, b)
    final = got[-1][1]
    assert final["compactions"] >= 1 and final["compactions_deferred"] >= 1


# --------------------------------------------------------------------- #
# threaded stress: readers + writer, per-version oracle
# --------------------------------------------------------------------- #
def test_threaded_closed_loop_stress():
    program, dataset, dictionary, inc = make_chain_store(n=12)
    tier = ServingTier(inc, dictionary, max_batch=8)
    # every published version's explicit set (this subscriber runs after
    # the tier's own publish hook, so registry.version is fresh)
    explicit_by_version = {
        tier.registry.version: {p: r.clone() for p, r in inc.explicit.items()}
    }

    def record(store, stats):
        explicit_by_version[tier.registry.version] = {
            p: r.clone() for p, r in store.explicit.items()
        }

    inc.subscribe_publish(record)
    texts = ["?x, ?y <- path(?x, ?y)", '?y <- path("v000000", ?y)',
             '?y <- path("v000005", ?y)', "?x, ?y <- edge(?x, ?y)"]
    n_clients, per_client = 8, 25
    out_lock = threading.Lock()
    observations, errors = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(per_client):
                text = texts[int(rng.integers(0, len(texts)))]
                resp = tier.answer(text, timeout=60.0)
                with out_lock:
                    observations.append((text, resp))
        except Exception as e:  # noqa: BLE001 — asserted after the join
            with out_lock:
                errors.append(e)

    edges = np.asarray(dataset["edge"])
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tier.start()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n_clients)]
        for th in threads:
            th.start()
        for i in range(5):  # writer churn beside the clients
            dels = {"edge": edges[i % len(edges): i % len(edges) + 1]}
            tier.apply_sync(deletions=dels)
            tier.apply_sync(additions=dels)
        for th in threads:
            th.join(timeout=120.0)
            assert not th.is_alive(), "client thread hung"
    finally:
        sys.setswitchinterval(switch)
        tier.close()
        inc.unsubscribe_publish(record)

    assert not errors, errors
    assert len(observations) == n_clients * per_client
    assert tier.stats()["stale_reads"] == 0
    oracles: dict[int, dict] = {}
    for text, resp in observations:
        assert not resp.stale
        assert resp.version in explicit_by_version, resp.version
        if resp.version not in oracles:
            oracles[resp.version] = flat_seminaive(
                program, explicit_by_version[resp.version], device="cpu")
        want = answer_flat(parse_query(text, dictionary), oracles[resp.version])
        assert torch.equal(resp.answers, want), f"{text} at version {resp.version}"


# --------------------------------------------------------------------- #
# storage integration: pins hold pruning and truncation back
# --------------------------------------------------------------------- #
def test_checkpoint_prune_respects_pins(tmp_path):
    program, dataset, dictionary, inc = make_chain_store()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=1, label="t")
    inc.attach_wal(mgr.wal)
    edges = np.asarray(dataset["edge"])
    inc.apply(deletions={"edge": edges[:1]})   # epoch 1
    mgr.checkpoint(inc)
    pinned_epoch = inc.epoch
    mgr.pin_epoch(pinned_epoch)
    inc.apply(additions={"edge": edges[:1]})   # epoch 2
    inc.apply(deletions={"edge": edges[1:2]})  # epoch 3
    mgr.checkpoint(inc)
    assert mgr.snapshots() == [f"snap-{pinned_epoch:08d}", f"snap-{inc.epoch:08d}"]
    assert len([r for r in mgr.wal.records() if r["epoch"] > pinned_epoch]) == 2
    mgr.unpin_epoch(pinned_epoch)
    inc.apply(additions={"edge": edges[1:2]})  # epoch 4
    mgr.checkpoint(inc)
    assert mgr.snapshots() == [f"snap-{inc.epoch:08d}"]
    assert mgr.wal.records() == []


def test_tier_epoch_source_feeds_checkpoint(tmp_path):
    program, dataset, dictionary, inc = make_chain_store()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=1, label="t")
    inc.attach_wal(mgr.wal)
    tier = ServingTier(inc, dictionary, checkpoint=mgr, checkpoint_every=1)
    edges = np.asarray(dataset["edge"])
    try:
        lease = tier.pin()
        pinned_epoch = lease.epoch
        tier.apply_sync(deletions={"edge": edges[:1]})
        tier.apply_sync(additions={"edge": edges[:1]})
        assert {pinned_epoch} == tier.registry.pinned_epochs()
        assert all(r["epoch"] > pinned_epoch for r in mgr.wal.records())
        assert len(mgr.wal.records()) == 2 - pinned_epoch
        lease.release()
        tier.apply_sync(deletions={"edge": edges[1:2]})
        assert mgr.wal.records() == [], "unpinned WAL prefix kept"
        assert tier.stats()["checkpoints"] == 3
    finally:
        tier.close()
