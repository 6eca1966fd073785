"""The port's durable storage against the JAX package's, on the CPU.

Each behaviour of ``tests/test_storage.py`` runs through both packages on
the same seeded KB and batches, and the results are compared: snapshots
and WAL files are equal byte for byte (the manifest but for
``created_unix``), each package restores the other's and continues with
equal state, and a restored store equals the one that wrote it (rows row
for row, derivation counts, explicit set, epoch, meta-facts, node ids).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core.generators import chain, lubm_like, paper_example, random_kb
from repro.incremental import IncrementalStore as JInc
from repro.storage import CheckpointManager as JCheckpointManager
from repro.storage import restore_incremental as j_restore_incremental
from repro.storage import write_snapshot as j_write_snapshot
from repro_torch.core import CMatEngine, flat_seminaive
from repro_torch.incremental import IncrementalStore as TInc
from repro_torch.query import QueryEngine
from repro_torch.storage import (
    CheckpointManager,
    SnapshotError,
    WriteAheadLog,
    load_frozen,
    load_into,
    mu_usage,
    restore_incremental,
    write_snapshot,
)


def small_lubm():
    return lubm_like(n_dept=3, n_students=30, n_courses=6, seed=0)


def pick_batch(dataset, k, seed=0):
    rng = np.random.default_rng(seed)
    pool = [
        (p, tuple(int(v) for v in row))
        for p, rows in dataset.items()
        for row in np.asarray(rows).reshape(len(rows), -1)
    ]
    rng.shuffle(pool)
    out: dict[str, list] = {}
    for p, row in pool[:k]:
        out.setdefault(p, []).append(row)
    return {p: np.asarray(r, dtype=np.int64) for p, r in out.items()}


def both(program, dataset=None):
    """A loaded store in each package: ``(port, reference)``."""
    t, j = TInc(program, device="cpu"), JInc(program)
    if dataset is not None:
        t.load(dataset)
        j.load(dataset)
    return t, j


def _rows_set(rows):
    return frozenset(map(tuple, np.asarray(rows).tolist()))


def assert_same_store(t: TInc, j: JInc, *, nodes: bool = True) -> None:
    """The port's store equals the reference's: rows row for row, counts,
    explicit facts, epoch, meta-facts, and (``nodes``) node count and id
    counter."""
    dt, dj = t.to_dict(), j.to_dict()
    assert set(dt) == set(dj)
    for p in dj:
        assert_array_equal(dt[p].numpy(), dj[p], err_msg=p)
    assert set(t.counts) == set(j.counts)
    for p in j.counts:
        assert_array_equal(t.counts[p].numpy(), j.counts[p], err_msg=f"counts {p}")
    assert {p: _rows_set(r) for p, r in t.explicit.items() if len(r)} == {
        p: _rows_set(r) for p, r in j.explicit.items() if len(r)
    }
    assert t.epoch == j.epoch
    assert t.facts.n_meta_facts() == j.facts.n_meta_facts()
    assert t.facts.n_facts() == j.facts.n_facts()
    if nodes:
        assert t.store.n_nodes() == j.store.n_nodes()
        assert t.store._next_id == j.store._next_id


def assert_same_port(a: TInc, b: TInc) -> None:
    da, db = a.to_dict(), b.to_dict()
    assert set(da) == set(db)
    for p in da:
        assert torch.equal(da[p], db[p]), p
    assert set(a.counts) == set(b.counts)
    for p in a.counts:
        assert torch.equal(a.counts[p], b.counts[p]), f"counts {p}"
    assert a.epoch == b.epoch


def _snapshot_kwargs(inc):
    return dict(epoch=inc.epoch, round_tag=inc._round, rows=inc.rows.to_dict(),
                counts=inc.counts, explicit=inc.explicit, arities=inc.arities)


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _manifest(path) -> dict:
    with open(os.path.join(path, "manifest.json")) as fh:
        m = json.load(fh)
    m.pop("created_unix")
    return m


def assert_same_snapshot(a: str, b: str) -> None:
    """Equal ``data.bin`` bytes; equal manifests but for ``created_unix``."""
    assert _sha(os.path.join(a, "data.bin")) == _sha(os.path.join(b, "data.bin"))
    assert _manifest(a) == _manifest(b)


def _write_both(tmp_path, t, j, **kw):
    tp, jp = str(tmp_path / "port"), str(tmp_path / "ref")
    tm = write_snapshot(tp, t.facts, **_snapshot_kwargs(t), **kw)
    jm = j_write_snapshot(jp, j.facts, **_snapshot_kwargs(j), **kw)
    return tp, jp, tm, jm


# --------------------------------------------------------------------- #
# snapshot round trip, byte parity, cross-restore
# --------------------------------------------------------------------- #
def test_snapshot_round_trip_is_byte_equal(tmp_path):
    program, dataset, _ = small_lubm()
    t, j = both(program, dataset)
    tp, jp, tm, jm = _write_both(tmp_path, t, j)
    assert tm["store"]["n_nodes"] > 0
    tm.pop("created_unix"), jm.pop("created_unix")
    assert tm == jm
    assert_same_snapshot(tp, jp)
    t2, meta = restore_incremental(program, tp, verify=True, device="cpu")
    j2, _ = j_restore_incremental(program, jp, verify=True)
    assert meta.kind == "incremental"
    assert_same_store(t2, j2)
    assert_same_port(t, t2)


def test_snapshot_preserves_sharing(tmp_path):
    """Splits create shared/concat structure; a round trip keeps the
    paper's representation size (payload dedup may shrink it) and gives
    the reference's nodes."""
    program, dataset, _ = paper_example(n=6, m=4)
    t, j = both(program, dataset)
    batch = pick_batch(dataset, 3)
    for inc in (t, j):
        inc.apply(deletions=batch)  # copy-splits: concats and sharing
        inc.apply(additions=batch)
    size_before = t.facts.total_repr_size()
    assert size_before == j.facts.total_repr_size()
    tp, jp, _, _ = _write_both(tmp_path, t, j)
    assert_same_snapshot(tp, jp)
    t2, _ = restore_incremental(program, tp, device="cpu")
    j2, _ = j_restore_incremental(program, jp)
    assert t2.facts.total_repr_size() == j2.facts.total_repr_size() <= size_before
    assert t2.facts.n_meta_facts() == t.facts.n_meta_facts()
    assert_same_store(t2, j2)
    assert mu_usage(t2.facts).total_bytes == sum(
        t2.store.node_nbytes(c) for c in t2.store._nodes)


def test_load_numbers_nodes_as_the_reference(tmp_path):
    """Loading one snapshot in both packages gives the same node ids:
    leaves and concats interleaved in disk order, a repeated payload
    pointing at its first node, every meta-fact's columns equal."""
    program, dataset, _ = paper_example(n=6, m=4)
    j = JInc(program)
    j.load(dataset)
    for seed in range(3):
        batch = pick_batch(dataset, 3, seed=seed)
        j.apply(deletions=batch)
        j.apply(additions=batch)
    path = str(tmp_path / "snap")
    manifest = j_write_snapshot(path, j.facts, **_snapshot_kwargs(j))
    assert manifest["store"]["n_payloads"] < manifest["store"]["n_leaves"]  # dedup hit
    t2, _ = restore_incremental(program, path, device="cpu")
    j2, _ = j_restore_incremental(program, path)
    assert_same_store(t2, j2)
    for p in j2.facts.predicates():
        assert [mf.columns for mf in t2.facts.all(p)] == [mf.columns for mf in j2.facts.all(p)]
    for cid in j2.store._nodes:
        assert t2.store.is_leaf(cid) == j2.store.is_leaf(cid)
        assert t2.store.length(cid) == j2.store.length(cid)
        assert t2.store.children(cid) == j2.store.children(cid)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_restore_then_apply(tmp_path, writer):
    """A snapshot plus WAL written by one package restores in the other;
    one more batch in each then gives equal state."""
    program, dataset, _ = small_lubm()
    inc = JInc(program) if writer == "ref" else TInc(program, device="cpu")
    inc.load(dataset)
    mgr = (JCheckpointManager if writer == "ref" else CheckpointManager)(str(tmp_path / "ck"))
    inc.attach_wal(mgr.wal)
    inc.apply(deletions=pick_batch(dataset, 4, seed=1))
    mgr.checkpoint(inc)
    inc.apply(additions=pick_batch(dataset, 4, seed=1), deletions=pick_batch(dataset, 3, seed=2))
    t, trec = CheckpointManager(str(tmp_path / "ck")).restore(program, verify=True, device="cpu")
    j, jrec = JCheckpointManager(str(tmp_path / "ck")).restore(program, verify=True)
    assert (trec.snapshot_epoch, trec.final_epoch, trec.wal_batches) == (1, 2, 1)
    assert (jrec.snapshot_epoch, jrec.final_epoch, jrec.wal_batches) == (1, 2, 1)
    assert_same_store(t, j)
    batch = pick_batch(dataset, 5, seed=3)
    t.apply(deletions=batch)
    j.apply(deletions=batch)
    assert_same_store(t, j)
    t.check_integrity()


def test_same_batches_give_equal_checkpoints_and_wal(tmp_path):
    """The same KB and batches through both packages' managers: every
    snapshot's ``data.bin`` and the WAL byte for byte, the manifests but
    for ``created_unix``."""
    program, dataset, _ = small_lubm()
    t, j = both(program, dataset)
    tm, jm = CheckpointManager(str(tmp_path / "t")), JCheckpointManager(str(tmp_path / "j"))
    for inc, mgr in ((t, tm), (j, jm)):
        inc.attach_wal(mgr.wal)
        mgr.checkpoint(inc)
        for seed in range(3):
            inc.apply(deletions=pick_batch(dataset, 4, seed=seed))
            inc.apply(additions=pick_batch(dataset, 2, seed=seed))
            if seed == 1:
                mgr.checkpoint(inc)
    assert tm.snapshots() == jm.snapshots() == ["snap-00000000", "snap-00000004"]
    for name in tm.snapshots():
        assert_same_snapshot(os.path.join(tm.root, name), os.path.join(jm.root, name))
    with open(tm.wal.path, "rb") as a, open(jm.wal.path, "rb") as b:
        assert a.read() == b.read()
    assert tm.wal.nbytes() > 0
    assert [r["epoch"] for r in tm.wal.records()] == [5, 6]


def test_counts_are_copies_and_rows_land_on_the_device(tmp_path):
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    path = str(tmp_path / "snap")
    write_snapshot(path, t.facts, **_snapshot_kwargs(t))
    t2, meta = restore_incremental(program, path, device="cpu")
    assert meta.counts and meta.rows and meta.explicit
    for tables in (meta.rows, meta.counts, meta.explicit):
        assert all(x.device.type == "cpu" and x.dtype == torch.int64 for x in tables.values())
    for p, c in t2.counts.items():  # owned: index_add_ writes into it
        assert c.untyped_storage().nbytes() == c.numel() * 8, p
    # the row index adopts the rows; a later apply replaces, never writes
    before = {p: r.clone() for p, r in meta.rows.items()}
    t2.apply(deletions=pick_batch(dataset, 5))
    assert all(torch.equal(meta.rows[p], r) for p, r in before.items())


def test_snapshot_rejects_corruption(tmp_path):
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    snap = str(tmp_path / "snap")
    write_snapshot(snap, t.facts, rows=t.rows.to_dict(), counts=t.counts, explicit=t.explicit)
    blob = os.path.join(snap, "data.bin")
    with open(blob, "r+b") as fh:
        fh.seek(10)
        byte = fh.read(1)
        fh.seek(10)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(SnapshotError):
        restore_incremental(program, snap, device="cpu")
    with pytest.raises(SnapshotError):
        restore_incremental(program, str(tmp_path / "nowhere"), device="cpu")


def test_frozen_snapshot_serves_queries(tmp_path):
    """Static warm start: a frozen-kind snapshot answers queries as the
    engine it was written from, without re-unfolding, and its bytes are
    the reference's."""
    from repro.core import CMatEngine as JCMatEngine

    program, dataset, dictionary = small_lubm()
    eng = CMatEngine(program, device="cpu")
    eng.load(dataset)
    eng.materialise()
    frozen = eng.facts.freeze()
    rows = {p: frozen.snapshot(p) for p in frozen.predicates()}
    write_snapshot(str(tmp_path / "frozen"), eng.facts, kind="frozen", rows=rows)
    jeng = JCMatEngine(program)
    jeng.load(dataset)
    jeng.materialise()
    jfrozen = jeng.facts.freeze()
    j_write_snapshot(str(tmp_path / "jfrozen"), jeng.facts, kind="frozen",
                     rows={p: jfrozen.snapshot(p) for p in jfrozen.predicates()})
    assert_same_snapshot(str(tmp_path / "frozen"), str(tmp_path / "jfrozen"))
    restored = load_frozen(str(tmp_path / "frozen"), device="cpu")
    for p in frozen.predicates():
        assert restored.has_snapshot(p)  # seeded, not re-unfolded
    q1, q2 = QueryEngine(frozen, dictionary), QueryEngine(restored, dictionary)
    for text in ('?s, ?c <- memberOf(?s, "dept1"), takesCourse(?s, ?c)',
                 "?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)",
                 "?x <- Student(?x)"):
        assert torch.equal(q1.answer(text).answers, q2.answer(text).answers)
    assert restored.snapshot_cells == 0


def test_incremental_restore_requires_incremental_kind(tmp_path):
    program, dataset, _ = small_lubm()
    eng = CMatEngine(program, device="cpu")
    eng.load(dataset)
    eng.materialise()
    write_snapshot(str(tmp_path / "frozen"), eng.facts, kind="frozen")
    with pytest.raises(SnapshotError):
        restore_incremental(program, str(tmp_path / "frozen"), device="cpu")


def test_load_into_fills_an_empty_store(tmp_path):
    from repro_torch.core import ColumnStore
    from repro_torch.core.metafacts import FactStore

    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    path = str(tmp_path / "snap")
    write_snapshot(path, t.facts, **_snapshot_kwargs(t))
    store = ColumnStore("cpu")
    facts = FactStore(store)
    meta = load_into(path, store, facts)
    assert meta.epoch == t.epoch and meta.round == t._round
    got = facts.to_dict()
    for p, rows in t.to_dict().items():
        assert torch.equal(got[p], rows), p


# --------------------------------------------------------------------- #
# WAL and crash recovery
# --------------------------------------------------------------------- #
def test_wal_crash_recovery_parity(tmp_path):
    """Snapshot + WAL replay == the store that crashed == a fresh fixpoint
    over the final explicit set, in both packages, from equal files."""
    program, dataset, _ = small_lubm()
    t, j = both(program, dataset)
    tm, jm = CheckpointManager(str(tmp_path / "t")), JCheckpointManager(str(tmp_path / "j"))
    for inc, mgr in ((t, tm), (j, jm)):
        mgr.checkpoint(inc)
        inc.attach_wal(mgr.wal)
        for i in range(3):
            inc.apply(deletions=pick_batch(dataset, 4, seed=i))
            inc.apply(additions=pick_batch(dataset, 2, seed=i))
    with open(tm.wal.path, "rb") as a, open(jm.wal.path, "rb") as b:
        assert a.read() == b.read()
    t2, rec = tm.restore(program, verify=True, device="cpu")
    j2, jrec = jm.restore(program, verify=True)
    assert rec.wal_batches == jrec.wal_batches == 6
    assert rec.snapshot_epoch == 0 and rec.final_epoch == t.epoch
    assert_same_port(t, t2)
    assert_same_store(t2, j2)
    want = flat_seminaive(program, t.explicit, device="cpu")
    got = t2.to_dict()
    assert {p for p, r in want.items() if r.shape[0]} == set(got)
    assert all(torch.equal(want[p], got[p]) for p in got)


def test_wal_torn_tail_is_dropped(tmp_path):
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.checkpoint(t)
    t.attach_wal(ckpt.wal)
    t.apply(deletions=pick_batch(dataset, 3))
    state = t.to_dict()
    with open(ckpt.wal.path, "a") as fh:  # a crash mid-append
        fh.write('{"rec": {"epoch": 99, "adds": {}, "de')
    t2, rec = ckpt.restore(program, device="cpu")
    j2, jrec = JCheckpointManager(str(tmp_path / "ckpt")).restore(program)
    assert rec.wal_batches == jrec.wal_batches == 1
    assert rec.wal_dropped == jrec.wal_dropped == 1
    assert t2.epoch == t.epoch
    got = t2.to_dict()
    assert set(got) == set(state) and all(torch.equal(got[p], state[p]) for p in got)
    assert_same_store(t2, j2)


def test_wal_checksum_guards_bitrot(tmp_path):
    from repro.storage import WriteAheadLog as JWriteAheadLog

    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    wal.append(1, {"P": torch.tensor([[1, 2]])}, None)
    wal.append(2, None, {"P": np.asarray([[1, 2]])})
    jwal = JWriteAheadLog(str(tmp_path / "jwal.jsonl"))
    jwal.append(1, {"P": np.asarray([[1, 2]])}, None)
    jwal.append(2, None, {"P": np.asarray([[1, 2]])})
    with open(wal.path) as a, open(jwal.path) as b:
        lines = a.read().splitlines()
        assert lines == b.read().splitlines()
    flipped = lines[0].replace('"epoch": 1', '"epoch": 7')
    with open(wal.path, "w") as fh:
        fh.write(flipped + "\n" + lines[1] + "\n")
    # record 0 fails its checksum: it and everything after are dropped
    assert wal.records() == []
    assert wal.n_dropped == 2


def test_wal_truncate_keeps_newer_records(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    for e in (1, 2, 3):
        wal.append(e, {"P": np.asarray([[e, e]])}, None)
    wal.truncate(keep_after_epoch=2)
    assert [r["epoch"] for r in wal.records()] == [3]
    wal.truncate()
    assert wal.records() == [] and wal.nbytes() == 0


def test_wal_replay_hands_tensors_on_the_store_device(tmp_path):
    """A record becomes tensors on the store's device only in replay."""
    seen = []

    class Probe:
        device = torch.device("cpu")

        def apply(self, additions, deletions):
            seen.append((additions, deletions))

    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    wal.append(1, {"P": np.asarray([[3, 4], [1, 2]])}, {"Q": torch.tensor([[5]])})
    wal.append(2, None, None)
    assert wal.replay(Probe(), after_epoch=0) == 2
    adds, dels = seen[0]
    assert isinstance(adds["P"], torch.Tensor) and adds["P"].tolist() == [[3, 4], [1, 2]]
    assert dels["Q"].dtype == torch.int64 and seen[1] == ({}, {})
    assert wal.replay(Probe(), after_epoch=1) == 1


# --------------------------------------------------------------------- #
# checkpoint orchestration
# --------------------------------------------------------------------- #
def test_checkpoint_truncates_wal_and_journal(tmp_path):
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    t.attach_wal(ckpt.wal)
    st = t.apply(deletions=pick_batch(dataset, 3))
    assert st.journal_bytes > 0
    assert len(ckpt.wal.records()) == 1
    ckpt.checkpoint(t)
    assert ckpt.wal.records() == []
    assert len(t.journal) == 0 and t.journal_bytes() == 0


def test_checkpoint_prunes_and_tracks_latest(tmp_path):
    program, dataset, _ = small_lubm()
    t, j = both(program, dataset)
    tm = CheckpointManager(str(tmp_path / "t"), keep=2)
    jm = JCheckpointManager(str(tmp_path / "j"), keep=2)
    batch = pick_batch(dataset, 2)
    for inc, mgr in ((t, tm), (j, jm)):
        inc.attach_wal(mgr.wal)  # batches after the last snapshot replay
        for _ in range(3):
            mgr.checkpoint(inc)
            inc.apply(deletions=batch)
            inc.apply(additions=batch)
    assert tm.snapshots() == jm.snapshots() and len(tm.snapshots()) == 2
    assert tm.latest().endswith(f"snap-{t.epoch - 2:08d}")
    t2, _ = tm.restore(program, verify=True, device="cpu")
    j2, _ = jm.restore(program, verify=True)
    assert_same_store(t2, j2)
    assert_same_port(t, t2)
    assert tm.latest_manifest()["epoch"] == t.epoch - 2
    assert tm.disk_nbytes() > 0
    report = tm.memory_report()
    assert report["n_snapshots"] == 2 and report["wal_disk_bytes"] == tm.wal.nbytes()


def test_restore_then_apply_continues(tmp_path):
    """A restored store is a live store: the same further batch on the
    original and the restored copy stays identical."""
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.checkpoint(t)
    t2, _ = ckpt.restore(program, device="cpu")
    batch = pick_batch(dataset, 5, seed=3)
    t.apply(deletions=batch)
    t2.apply(deletions=batch)
    t.check_integrity()
    t2.check_integrity()
    assert_same_port(t, t2)


def test_label_mismatch_refused(tmp_path):
    """A labelled manager refuses a snapshot written for another KB; an
    unlabelled side leaves the check unbound."""
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), label="lubm:scale1")
    manifest = ckpt.checkpoint(t)
    assert manifest["label"] == "lubm:scale1"
    ok, _ = ckpt.restore(program, device="cpu")
    assert_same_port(t, ok)
    with pytest.raises(SnapshotError):
        CheckpointManager(str(tmp_path / "ckpt"), label="chain:scale2").restore(
            program, device="cpu")
    unlabelled, _ = CheckpointManager(str(tmp_path / "ckpt")).restore(program, device="cpu")
    assert_same_port(t, unlabelled)
    with pytest.raises(SnapshotError):
        load_frozen(ckpt.latest(), expected_label="chain:scale2", device="cpu")


def test_reset_wipes_stale_history(tmp_path):
    """A cold run over a reused directory does not stitch its fresh
    epochs onto a previous run's snapshots and WAL records."""
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.checkpoint(t)
    t.attach_wal(ckpt.wal)
    t.apply(deletions=pick_batch(dataset, 3))  # stale WAL record
    ckpt2 = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt2.reset()
    assert not ckpt2.has_snapshot()
    assert ckpt2.wal.records() == []
    t2, _ = both(program)
    t2.load(dataset)
    t2.attach_wal(ckpt2.wal)
    t2.apply(deletions=pick_batch(dataset, 2, seed=9))
    ckpt2.checkpoint(t2)
    t3, rec = ckpt2.restore(program, verify=True, device="cpu")
    assert rec.snapshot_epoch == t2.epoch
    assert_same_port(t2, t3)


def test_snapshot_after_compaction_round_trips(tmp_path):
    program, dataset, _ = small_lubm()
    t, j = both(program, dataset)
    for inc in (t, j):
        for i in range(6):
            batch = pick_batch(dataset, 4, seed=i)
            inc.apply(deletions=batch)
            inc.apply(additions=batch)
        inc.compact()
    assert_same_store(t, j)
    tm, jm = CheckpointManager(str(tmp_path / "t")), JCheckpointManager(str(tmp_path / "j"))
    tm.checkpoint(t)
    jm.checkpoint(j)
    assert_same_snapshot(tm.latest(), jm.latest())
    t2, _ = tm.restore(program, verify=True, device="cpu")
    assert_same_port(t, t2)
    assert mu_usage(t2.facts).n_dead == 0


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_random_kbs_snapshot_round_trip(tmp_path, seed):
    rng = np.random.default_rng(seed)
    trials = 0
    for trial in range(6):
        program, dataset = random_kb(
            rng,
            n_constants=int(rng.integers(2, 8)),
            n_facts=int(rng.integers(1, 20)),
            n_rules=int(rng.integers(1, 4)),
        )
        if not len(program.rules):
            continue
        trials += 1
        t, j = both(program, dataset)
        tp = str(tmp_path / f"t{trial}")
        jp = str(tmp_path / f"j{trial}")
        write_snapshot(tp, t.facts, **_snapshot_kwargs(t))
        j_write_snapshot(jp, j.facts, **_snapshot_kwargs(j))
        assert_same_snapshot(tp, jp)
        t2, _ = restore_incremental(program, jp, verify=True, device="cpu")
        j2, _ = j_restore_incremental(program, tp, verify=True)
        assert_same_store(t2, j2)
        dels = {p: np.asarray(r)[: max(1, len(r) // 2)] for p, r in dataset.items()}
        t2.apply(deletions=dels)
        j2.apply(deletions=dels)
        assert_same_store(t2, j2)
    assert trials


def test_chain_churn_restores_with_equal_node_table(tmp_path):
    """Delete/re-add churn on a recursive KB (DRed splits), checkpointed
    by the port: the reference restores the same nodes."""
    program, dataset, _ = chain(20)
    t, _ = both(program)
    t.load(dataset)
    for i in range(3):
        batch = pick_batch(dataset, 2, seed=i)
        t.apply(deletions=batch)
        t.apply(additions=batch)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.checkpoint(t)
    t2, _ = ckpt.restore(program, verify=True, device="cpu")
    j2, _ = JCheckpointManager(str(tmp_path / "ck")).restore(program, verify=True)
    assert_same_store(t2, j2)
    assert_same_port(t, t2)


def test_loads_default_to_cuda_and_raise_without(tmp_path, monkeypatch):
    """A restore or a frozen load lands on the card unless the caller asks
    for the CPU; without a card it raises, it never falls back."""
    program, dataset, _ = small_lubm()
    t, _ = both(program)
    t.load(dataset)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.checkpoint(t)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(program)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_frozen(ckpt.latest())
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_incremental(program, ckpt.latest())
