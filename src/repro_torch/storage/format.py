"""Snapshot format: the compressed store serialised with its sharing.

A snapshot is a directory holding a JSON manifest and one columnar blob::

    snap-00000012/
      manifest.json   format version, epoch, predicate table, TOC, checksum
      data.bin        zlib-compressed concatenation of all columns

The format is the JAX package's, byte for byte: for the same store state
``data.bin`` is equal and so is the manifest but for ``created_unix``, so
a snapshot written by either package restores in the other.

* The ``_Leaf``/``_Concat`` DAG is written as a node table in topological
  order (children before parents, :meth:`ColumnStore.topo_order`), so
  shared subtrees are written once.
* Leaf payloads (RLE run arrays) are deduplicated by content hash: two
  leaves with identical runs share one payload record.
* All bulk data lives in flat int64 columns packed into one blob; the
  manifest's TOC maps names to (dtype, shape, offset).

The blob's SHA-256 is recorded in the manifest and verified on load; the
manifest is written last, so a torn snapshot directory is detected rather
than half-loaded.

On the card, writing gathers every reachable leaf's payload into one
device block and reads it to the host in one transfer (as compaction
does); hashing and deduplication then run on the host in the reference's
order.  Loading moves the payload block and each side table to the store's
device in one transfer each and makes every leaf a slice of its block.
Node ids come out as the reference's node-by-node loop gives them: leaves
and concats interleaved in disk order, a deduplicated payload pointing at
its first node.

Besides the mu-DAG and meta-facts, a snapshot carries the incremental
maintenance state: the :class:`RowIndex` rows, derivation-count columns
(aligned with the rows) and the explicit fact set, so a restored store
resumes ``apply``/``freeze`` where the saved one stopped.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.columns import ColumnStore
from ..core.frozen import FrozenFacts
from ..core.metafacts import FactStore, MetaFact
from .compact import leaf_payloads

__all__ = [
    "FORMAT_VERSION",
    "SnapshotError",
    "SnapshotMeta",
    "check_label",
    "load_frozen",
    "load_into",
    "read_manifest",
    "restore_incremental",
    "snapshot_nbytes",
    "write_snapshot",
]

FORMAT_VERSION = 1

_MANIFEST = "manifest.json"
_DATA = "data.bin"
_SIDE_TABLES = ("rows", "counts", "explicit")

_EMPTY_I64 = np.zeros(0, dtype=np.int64)


class SnapshotError(RuntimeError):
    """Unreadable, corrupt, or version-incompatible snapshot."""


@dataclass
class SnapshotMeta:
    """What :func:`load_into` hands back besides the populated store: the
    side tables as int64 tensors on the store's device."""

    epoch: int
    round: int
    kind: str
    rows: dict[str, torch.Tensor] = field(default_factory=dict)
    counts: dict[str, torch.Tensor] = field(default_factory=dict)
    explicit: dict[str, torch.Tensor] = field(default_factory=dict)
    arities: dict[str, int] = field(default_factory=dict)
    manifest: dict = field(default_factory=dict)


# --------------------------------------------------------------------- #
# the blob container
# --------------------------------------------------------------------- #
def _write_blob(path: str, arrays: dict[str, np.ndarray]) -> dict:
    """Concatenate arrays into one zlib stream; returns the TOC."""
    entries: dict[str, dict] = {}
    parts: list[bytes] = []
    off = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        buf = arr.tobytes()
        entries[name] = {
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "offset": off,
        }
        parts.append(buf)
        off += len(buf)
    comp = zlib.compress(b"".join(parts), 1)
    with open(path, "wb") as fh:
        fh.write(comp)
        fh.flush()
        os.fsync(fh.fileno())
    return {
        "codec": "zlib",
        "raw_bytes": off,
        "sha256": hashlib.sha256(comp).hexdigest(),
        "entries": entries,
    }


def _read_blob(path: str, spec: dict, verify: bool) -> dict[str, np.ndarray]:
    """One read + one decompress + zero-copy slices (read-only arrays)."""
    with open(path, "rb") as fh:
        comp = fh.read()
    if verify:
        got = hashlib.sha256(comp).hexdigest()
        if got != spec["sha256"]:
            raise SnapshotError(f"checksum mismatch for {path!r}")
    raw = zlib.decompress(comp)
    if len(raw) != spec["raw_bytes"]:
        raise SnapshotError(f"size mismatch for {path!r}")
    out: dict[str, np.ndarray] = {}
    for name, e in spec["entries"].items():
        dtype = np.dtype(e["dtype"])
        count = int(np.prod(e["shape"], dtype=np.int64)) if e["shape"] else 1
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=int(e["offset"]))
        out[name] = arr.reshape(e["shape"])
    return out


# --------------------------------------------------------------------- #
# writing
# --------------------------------------------------------------------- #
def _export_mu(store: ColumnStore, roots: list[int]):
    """Node table + deduplicated payloads for the DAG under ``roots``.

    Returns ``(arrays, old_to_disk, stats)`` where ``old_to_disk`` maps
    live node ids to dense on-disk ids (topological order).  The leaves'
    payloads come to the host in one transfer."""
    order = store.topo_order(roots)
    old_to_disk = {cid: i for i, cid in enumerate(order)}
    leaves = [cid for cid in order if store.is_leaf(cid)]
    _, flat, offsets, keys = leaf_payloads(store, leaves)
    where = dict(zip(leaves, zip(offsets, keys)))

    payload_index: dict[bytes, int] = {}
    pv_parts: list[np.ndarray] = []
    pc_parts: list[np.ndarray] = []
    payload_lens: list[int] = []
    kinds = np.zeros(len(order), dtype=np.uint8)  # 0 = leaf, 1 = concat
    payload_of = np.full(len(order), -1, dtype=np.int64)
    children_flat: list[int] = []
    children_len = np.zeros(len(order), dtype=np.int64)
    dup_bytes = 0

    for i, cid in enumerate(order):
        if cid in where:
            off, key = where[cid]
            n = store.n_runs(cid)
            idx = payload_index.get(key)
            if idx is None:
                idx = len(payload_lens)
                payload_index[key] = idx
                pv_parts.append(flat[off:off + n])
                pc_parts.append(flat[off + n:off + 2 * n])
                payload_lens.append(n)
            else:
                dup_bytes += 16 * n
            payload_of[i] = idx
        else:
            kinds[i] = 1
            kids = store.children(cid)
            children_flat.extend(old_to_disk[c] for c in kids)
            children_len[i] = len(kids)

    payload_off = np.zeros(len(payload_lens) + 1, dtype=np.int64)
    if payload_lens:
        payload_off[1:] = np.cumsum(payload_lens)
    children_off = np.zeros(len(order) + 1, dtype=np.int64)
    if len(order):
        children_off[1:] = np.cumsum(children_len)

    arrays = {
        "mu/kinds": kinds,
        "mu/payload_of": payload_of,
        "mu/children_flat": np.asarray(children_flat, dtype=np.int64),
        "mu/children_off": children_off,
        "mu/pv_flat": np.concatenate(pv_parts).astype(np.int64) if pv_parts else _EMPTY_I64,
        "mu/pc_flat": np.concatenate(pc_parts).astype(np.int64) if pc_parts else _EMPTY_I64,
        "mu/payload_off": payload_off,
    }
    stats = {
        "n_nodes": len(order),
        "n_leaves": int((kinds == 0).sum()),
        "n_payloads": len(payload_lens),
        "payload_bytes": int(arrays["mu/pv_flat"].nbytes + arrays["mu/pc_flat"].nbytes),
        "dedup_saved_bytes": dup_bytes,
    }
    return arrays, old_to_disk, stats


def _host_table(table) -> dict[str, np.ndarray]:
    """A side table (tensors on one device, or arrays) as int64 numpy
    arrays, with one transfer for all of its tensors."""
    table = table or {}
    tensors = {p: torch.as_tensor(t) for p, t in table.items()}
    if not tensors:
        return {}
    dev = next(iter(tensors.values())).device
    flat = torch.cat([t.to(dev, torch.int64).reshape(-1) for t in tensors.values()])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for p, t in tensors.items():
        n = t.numel()
        out[p] = host[off:off + n].reshape(tuple(t.shape))
        off += n
    return out


def write_snapshot(
    path: str,
    facts: FactStore,
    *,
    kind: str = "incremental",
    label: str = "",
    epoch: int = 0,
    round_tag: int = 0,
    rows=None,
    counts=None,
    explicit=None,
    arities: dict[str, int] | None = None,
) -> dict:
    """Serialise a fact store (and optional maintenance state: per
    predicate rows, counts and explicit facts, as tensors or arrays) to
    ``path``; returns the manifest dict.  The manifest is written last —
    a directory without one is not a snapshot."""
    os.makedirs(path, exist_ok=True)
    preds = sorted(p for p in facts.predicates() if facts.all(p))
    pred_idx = {p: i for i, p in enumerate(preds)}
    roots = [c for p in preds for mf in facts.all(p) for c in mf.columns]
    arrays, old_to_disk, mu_stats = _export_mu(facts.store, roots)

    mf_pred: list[int] = []
    mf_length: list[int] = []
    mf_round: list[int] = []
    cols_flat: list[int] = []
    cols_len: list[int] = []
    for p in preds:
        for mf in facts.all(p):
            mf_pred.append(pred_idx[p])
            mf_length.append(mf.length)
            mf_round.append(mf.round)
            cols_flat.extend(old_to_disk[c] for c in mf.columns)
            cols_len.append(mf.arity)
    cols_off = np.zeros(len(mf_pred) + 1, dtype=np.int64)
    if mf_pred:
        cols_off[1:] = np.cumsum(cols_len)
    arrays.update(
        {
            "facts/mf_pred": np.asarray(mf_pred, dtype=np.int64),
            "facts/mf_length": np.asarray(mf_length, dtype=np.int64),
            "facts/mf_round": np.asarray(mf_round, dtype=np.int64),
            "facts/cols_flat": np.asarray(cols_flat, dtype=np.int64),
            "facts/cols_off": cols_off,
        }
    )

    # maintenance state: three flat columns per table (pred index, shape,
    # concatenated data), so the TOC stays a handful of entries
    rows, counts, explicit = _host_table(rows), _host_table(counts), _host_table(explicit)
    side_preds = sorted(set(rows) | set(counts) | set(explicit))
    side_idx = {p: i for i, p in enumerate(side_preds)}
    for table_name, table in (("rows", rows), ("counts", counts), ("explicit", explicit)):
        idxs: list[int] = []
        n0: list[int] = []
        n1: list[int] = []
        flats: list[np.ndarray] = []
        for p in sorted(table, key=side_idx.__getitem__):
            arr = table[p]
            if not arr.size:
                continue
            idxs.append(side_idx[p])
            n0.append(arr.shape[0])
            n1.append(arr.shape[1] if arr.ndim == 2 else 0)  # 0 = 1-D
            flats.append(arr.ravel())
        arrays[f"side/{table_name}_pred"] = np.asarray(idxs, dtype=np.int64)
        arrays[f"side/{table_name}_n0"] = np.asarray(n0, dtype=np.int64)
        arrays[f"side/{table_name}_n1"] = np.asarray(n1, dtype=np.int64)
        arrays[f"side/{table_name}_flat"] = np.concatenate(flats) if flats else _EMPTY_I64

    toc = _write_blob(os.path.join(path, _DATA), arrays)

    manifest = {
        "format": "compmat-snapshot",
        "version": FORMAT_VERSION,
        "kind": kind,
        # free-form provenance tag (e.g. "lubm:scale2"); loaders with an
        # expectation refuse a mismatch instead of serving the wrong KB
        "label": label,
        "created_unix": time.time(),
        "epoch": int(epoch),
        "round": int(round_tag),
        "predicates": [
            {
                "name": p,
                "arity": facts.all(p)[0].arity,
                "n_meta_facts": len(facts.all(p)),
                "n_facts": sum(mf.length for mf in facts.all(p)),
            }
            for p in preds
        ],
        "side_predicates": side_preds,
        "arities": dict(arities or {}),
        "store": mu_stats,
        "data": toc,
    }
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(path, _MANIFEST))
    fsync_dir(path)
    return manifest


def fsync_dir(path: str) -> None:
    """Make a rename within ``path`` durable (best effort: not every
    filesystem supports directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def snapshot_nbytes(path: str) -> int:
    """Total on-disk bytes of a snapshot directory."""
    return sum(
        os.path.getsize(os.path.join(path, f))
        for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f))
    )


# --------------------------------------------------------------------- #
# loading
# --------------------------------------------------------------------- #
def read_manifest(path: str) -> dict:
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise SnapshotError(f"no manifest in {path!r} (torn snapshot?)")
    with open(mpath) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != "compmat-snapshot":
        raise SnapshotError(f"{path!r} is not a compmat snapshot")
    if manifest.get("version", 0) > FORMAT_VERSION:
        raise SnapshotError(
            f"snapshot version {manifest.get('version')} is newer than "
            f"this reader ({FORMAT_VERSION})"
        )
    return manifest


def _to_device(arrays: list[np.ndarray], device: torch.device) -> list[torch.Tensor]:
    """int64 arrays as tensors on ``device``, moved in one transfer (the
    blob's slices are read-only, so the host block is a copy)."""
    block = torch.from_numpy(np.concatenate([np.ravel(a) for a in arrays]).astype(np.int64))
    return list(torch.split(block.to(device), [a.size for a in arrays]))


def _rebuild_mu(z: dict[str, np.ndarray], store: ColumnStore) -> list[int]:
    """Instantiate the on-disk DAG in ``store``; returns the new id of
    every disk node.  Ids are numbered as creating the nodes one by one in
    disk order numbers them (a repeated payload creates nothing, a
    one-child concat is its child); the payloads reach the device in one
    transfer and each leaf is a slice of that block."""
    kinds = z["mu/kinds"].tolist()
    payload_of = z["mu/payload_of"].tolist()
    children_flat = z["mu/children_flat"].tolist()
    children_off = z["mu/children_off"].tolist()
    payload_off = z["mu/payload_off"]
    pc_flat = z["mu/pc_flat"]
    # unfolded length of each payload: its run counts summed
    csum = np.concatenate([[0], np.cumsum(pc_flat)])
    payload_len = (csum[payload_off[1:]] - csum[payload_off[:-1]]).tolist()

    next_id = store.mark()
    disk_to_new = [0] * len(kinds)
    first_node: dict[int, int] = {}  # payload idx -> its first node's id
    leaves: list[tuple[int, int]] = []  # (new id, payload idx)
    concats: list[tuple[int, list[int]]] = []
    for i, kind in enumerate(kinds):
        if kind == 0:
            pidx = payload_of[i]
            hit = first_node.get(pidx)
            if hit is None:
                hit = first_node[pidx] = next_id
                leaves.append((next_id, pidx))
                next_id += 1
            disk_to_new[i] = hit
        else:
            kids = [disk_to_new[c] for c in children_flat[children_off[i]:children_off[i + 1]]]
            if len(kids) == 1:
                disk_to_new[i] = kids[0]
                continue
            disk_to_new[i] = next_id
            concats.append((next_id, kids))
            next_id += 1

    sizes = np.diff(payload_off).tolist()
    pv, pc = _to_device([z["mu/pv_flat"], pc_flat], store.device)
    rvs, rcs = torch.split(pv, sizes), torch.split(pc, sizes)
    store.add_nodes(
        [(cid, rvs[p], rcs[p], payload_len[p]) for cid, p in leaves], concats, next_id
    )
    return disk_to_new


def _side_tables(z, side_preds, device, meta: SnapshotMeta) -> None:
    """Fill ``meta``'s rows / counts / explicit, each table moved to the
    device in one transfer; counts are copies (they are updated in place
    by ``index_add_``)."""
    for label in _SIDE_TABLES:
        idxs = z[f"side/{label}_pred"].tolist()
        n0 = z[f"side/{label}_n0"].tolist()
        n1 = z[f"side/{label}_n1"].tolist()
        if not idxs:
            continue
        sizes = [r * max(c, 1) for r, c in zip(n0, n1)]
        (flat,) = _to_device([z[f"side/{label}_flat"][: sum(sizes)]], device)
        table = getattr(meta, label)
        for k, part in enumerate(torch.split(flat, sizes)):
            if n1[k]:
                part = part.reshape(n0[k], n1[k])
            table[side_preds[idxs[k]]] = part.clone() if label == "counts" else part


def load_into(
    path: str,
    store: ColumnStore,
    facts: FactStore,
    *,
    verify_checksums: bool = True,
) -> SnapshotMeta:
    """Rebuild a snapshot into the given (empty) store + fact store, on
    the store's device.

    The DAG is re-instantiated bottom-up, so sharing recorded on disk
    becomes sharing in memory; meta-fact columns are remapped to the
    fresh node ids."""
    manifest = read_manifest(path)
    z = _read_blob(os.path.join(path, _DATA), manifest["data"], verify_checksums)
    disk_to_new = _rebuild_mu(z, store)

    preds = [p["name"] for p in manifest["predicates"]]
    mf_pred = z["facts/mf_pred"].tolist()
    mf_length = z["facts/mf_length"].tolist()
    mf_round = z["facts/mf_round"].tolist()
    cols_flat = z["facts/cols_flat"].tolist()
    cols_off = z["facts/cols_off"].tolist()
    for k in range(len(mf_pred)):
        cols = tuple(disk_to_new[c] for c in cols_flat[cols_off[k]:cols_off[k + 1]])
        facts.add(MetaFact(preds[mf_pred[k]], cols, mf_length[k], mf_round[k]))
    facts.current_round = int(manifest["round"])

    meta = SnapshotMeta(
        epoch=int(manifest["epoch"]),
        round=int(manifest["round"]),
        kind=manifest["kind"],
        arities={k: int(v) for k, v in manifest.get("arities", {}).items()},
        manifest=manifest,
    )
    _side_tables(z, manifest.get("side_predicates", []), store.device, meta)
    return meta


def check_label(manifest: dict, expected: str | None, path: str) -> None:
    """Refuse a snapshot written for a different KB than the caller
    expects (both sides must carry a label for the check to bind)."""
    got = manifest.get("label", "")
    if expected and got and got != expected:
        raise SnapshotError(
            f"snapshot at {path!r} is labelled {got!r}, expected "
            f"{expected!r} — refusing to serve the wrong KB"
        )


def load_frozen(
    path: str,
    *,
    verify_checksums: bool = True,
    expected_label: str | None = None,
    device: torch.device | str | None = None,
) -> FrozenFacts:
    """Warm-start the read path: a :class:`FrozenFacts` on ``device``
    (``None``: the card) whose sorted snapshots are seeded from the
    on-disk rows (no re-unfold)."""
    check_label(read_manifest(path), expected_label, path)
    store = ColumnStore(device)
    facts = FactStore(store)
    meta = load_into(path, store, facts, verify_checksums=verify_checksums)
    return FrozenFacts(facts, seed_rows=meta.rows or None)


def restore_incremental(
    program,
    path: str,
    *,
    verify: bool = False,
    verify_checksums: bool = True,
    expected_label: str | None = None,
    **store_kwargs,
):
    """Rebuild an :class:`~repro_torch.incremental.IncrementalStore` from a
    snapshot directory (``store_kwargs`` go to the store, ``device``
    among them): the warm-start path that replaces ``load()``.

    With ``verify=True`` :meth:`check_integrity` runs after the rebuild
    (row index against the unfolded store, maintained derivation counts
    against a recount)."""
    from ..incremental import IncrementalStore

    manifest = read_manifest(path)
    if manifest["kind"] != "incremental":
        raise SnapshotError(
            f"snapshot at {path!r} is kind {manifest['kind']!r}, not 'incremental'"
        )
    check_label(manifest, expected_label, path)
    inc = IncrementalStore(program, **store_kwargs)
    meta = load_into(path, inc.store, inc.facts, verify_checksums=verify_checksums)
    for pred, rows in meta.rows.items():
        # written from RowIndex.to_dict(), so already sorted-unique
        inc.rows.seed_sorted(pred, rows)
    inc.explicit = dict(meta.explicit)
    inc.arities.update(meta.arities)
    inc.epoch = meta.epoch
    inc._round = meta.round + 1
    if inc.counting:
        missing = [
            p for p in inc._counting_preds if inc.rows.n_rows(p) and p not in meta.counts
        ]
        if missing:
            # written without count columns (e.g. by a counting=False
            # store): rebuild them from scratch
            inc.counts = inc.recompute_counts()
        else:
            inc.counts.update(meta.counts)
    if verify:
        inc.check_integrity()
    return inc, meta
