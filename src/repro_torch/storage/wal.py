"""Write-ahead log for incremental update batches.

One JSON line per :meth:`IncrementalStore.apply` call, written *before*
the store mutates::

    {"rec": {"epoch": 8, "adds": {...}, "dels": {...}}, "sha": "..."}

``sha`` is the SHA-256 of the canonical (sorted-keys) encoding of
``rec``, so torn or bit-rotted records are detected.  Records are the JAX
package's byte for byte: batches cross the file boundary as int64 numpy
arrays (a tensor is read to the host once), and become tensors on the
store's device only in :meth:`WriteAheadLog.replay`.  Recovery = load the
latest snapshot, then replay every record with ``epoch > snapshot.epoch``
through ``apply``: the maintenance code is the redo log's interpreter.

A crash mid-write leaves a partial last line; :meth:`records` stops at
the first undecodable or checksum-failing record and reports how many
lines it dropped (apply logs before mutating, so a torn record's batch
was never applied).  After a checkpoint at epoch ``e`` every record with
``epoch <= e`` is redundant; :meth:`truncate` rewrites the log keeping
only newer records.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..obs import get_registry, span

__all__ = ["WriteAheadLog"]


def _canonical(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _host_rows(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows, dtype=np.int64)


def _encode_batch(batch) -> dict:
    out = {}
    for pred, rows in (batch or {}).items():
        rows = _host_rows(rows)
        if rows.size:
            out[pred] = rows.tolist()
    return out


def _decode_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    return {
        pred: torch.as_tensor(np.asarray(rows, dtype=np.int64)).to(device)
        for pred, rows in batch.items()
    }


def _line(rec: dict) -> str:
    sha = hashlib.sha256(_canonical(rec).encode()).hexdigest()
    return json.dumps({"rec": rec, "sha": sha}, sort_keys=True) + "\n"


class WriteAheadLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        #: torn/corrupt trailing lines dropped by the last :meth:`records`
        self.n_dropped = 0

    # ------------------------------------------------------------------ #
    def append(self, epoch: int, additions, deletions) -> None:
        """Log one batch (per predicate rows: tensors or arrays) durably."""
        with span("storage.wal.append", epoch=int(epoch)) as sp:
            line = _line({
                "epoch": int(epoch),
                "adds": _encode_batch(additions),
                "dels": _encode_batch(deletions),
            })
            with open(self.path, "a") as fh:
                fh.write(line)
                fh.flush()
                os.fsync(fh.fileno())
            sp.set(bytes=len(line))
        reg = get_registry()
        reg.counter("storage.wal.appends").inc()
        reg.counter("storage.wal.bytes").inc(len(line))

    # ------------------------------------------------------------------ #
    def records(self) -> list[dict]:
        """Verified records in log order; stops at the first torn or
        checksum-failing line (later records depend on the dropped batch
        having been applied)."""
        if not os.path.exists(self.path):
            self.n_dropped = 0
            return []
        out: list[dict] = []
        dropped = 0
        with open(self.path) as fh:
            lines = fh.readlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
                rec = entry["rec"]
                want = entry["sha"]
            except (json.JSONDecodeError, KeyError, TypeError):
                dropped = len(lines) - i
                break
            got = hashlib.sha256(_canonical(rec).encode()).hexdigest()
            if got != want:
                dropped = len(lines) - i
                break
            out.append(rec)
        self.n_dropped = dropped
        return out

    def replay(self, inc, after_epoch: int) -> int:
        """Re-apply every verified record newer than ``after_epoch``
        through ``inc.apply`` (its batches as tensors on the store's
        device); returns the number of batches replayed.

        The store must not have this WAL attached yet, or the replay
        would re-log itself: attach after recovery."""
        n = 0
        for rec in self.records():
            if rec["epoch"] <= after_epoch:
                continue
            inc.apply(
                additions=_decode_batch(rec["adds"], inc.device),
                deletions=_decode_batch(rec["dels"], inc.device),
            )
            n += 1
        return n

    # ------------------------------------------------------------------ #
    def truncate(self, keep_after_epoch: int | None = None) -> None:
        """Drop records with ``epoch <= keep_after_epoch`` (all of them
        when ``None``); called after a checkpoint makes them redundant."""
        keep = (
            [rec for rec in self.records() if rec["epoch"] > keep_after_epoch]
            if keep_after_epoch is not None
            else []
        )
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            for rec in keep:
                fh.write(_line(rec))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def nbytes(self) -> int:
        return os.path.getsize(self.path) if os.path.exists(self.path) else 0
