"""GC/compaction epochs for the mu-store.

Incremental deletion never rewrites shared structure in place: a
partially hit meta-fact is replaced by a copy-mode split, leaving the
original columns in the store with nothing pointing at them.  Under
sustained churn the dead fraction climbs without bound; this module is
the reclaim path.

:func:`mu_usage` measures it: nodes and bytes, total against reachable
from the live meta-facts.  :func:`compact_store` rebuilds the reachable
DAG into a fresh node table, children before parents, and hash-conses
while doing so: leaves with identical RLE payloads collapse to one node,
and identical Concat child vectors collapse the same way.  A leaf's key
is the SHA-256 of its int64 run values and counts as little-endian bytes;
all the reachable leaves' payloads are gathered into one device block,
which comes to the host in one transfer, and the new leaves' payloads are
slices of it.  The
rebuild happens off to the side, then the live store is redirected to it
in a short reference-assignment section, between requests.  It is not
safe against a concurrent reader: a ``MetaFact`` captured before the swap
holds node ids of the old table.  The fact set is identical before and
after: row indexes, count columns and answers are untouched.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import torch

from ..core.columns import ColumnStore
from ..core.metafacts import FactStore, MetaFact
from ..obs import get_registry, span
from ..obs.memory import publish_predicate_effectiveness

__all__ = ["CompactionStats", "MuUsage", "compact_store", "mu_usage"]


@dataclass
class MuUsage:
    n_nodes: int
    n_reachable: int
    total_bytes: int
    reachable_bytes: int

    @property
    def n_dead(self) -> int:
        return self.n_nodes - self.n_reachable

    @property
    def dead_fraction(self) -> float:
        return self.n_dead / self.n_nodes if self.n_nodes else 0.0

    @property
    def dead_bytes(self) -> int:
        return self.total_bytes - self.reachable_bytes


@dataclass
class CompactionStats:
    nodes_before: int
    nodes_after: int
    bytes_before: int
    bytes_after: int
    dead_fraction_before: float
    reshared_leaves: int  # distinct source leaves merged by hash-consing
    time_s: float


def _roots(facts: FactStore) -> list[int]:
    return [c for p in facts.predicates() for mf in facts.all(p) for c in mf.columns]


def mu_usage(facts: FactStore) -> MuUsage:
    """Dead-node accounting over the store backing ``facts`` (host
    only)."""
    store = facts.store
    reach = store.reachable(_roots(facts))
    return MuUsage(
        n_nodes=store.n_nodes(),
        n_reachable=len(reach),
        total_bytes=store.total_nbytes(),
        reachable_bytes=sum(store.node_nbytes(c) for c in reach),
    )


def leaf_payloads(store: ColumnStore, leaves: list[int]):
    """The leaves' payloads in one device block (each leaf's run values
    then its counts), its host copy and, per leaf, its offset in the
    block and its key: the SHA-256 of its ``run_values`` bytes, a zero
    byte and its ``run_counts`` bytes (int64, little-endian).  The block
    comes to the host in one transfer."""
    if not leaves:
        return None, None, [], []
    payloads = [store.leaf_payload(c) for c in leaves]
    block = torch.cat([t for rv, rc in payloads for t in (rv, rc)])
    flat = block.cpu().numpy().astype("<i8", copy=False)
    offsets, keys = [], []
    off = 0
    for rv, _ in payloads:
        n = int(rv.shape[0])
        values = flat[off:off + n].tobytes()
        counts = flat[off + n:off + 2 * n].tobytes()
        offsets.append(off)
        keys.append(hashlib.sha256(values + b"\x00" + counts).digest())
        off += 2 * n
    return block, flat, offsets, keys


def compact_store(inc) -> CompactionStats:
    """Rebuild the reachable mu-DAG of an incremental store and swap it
    in (between requests; see the module docstring).  The swapped-in
    state represents the identical fact set."""
    with span("storage.compact") as sp:
        stats = _compact_store(inc)
        sp.set(nodes_before=stats.nodes_before, nodes_after=stats.nodes_after)
    reg = get_registry()
    reg.counter("gc.compactions").inc()
    reg.counter("gc.nodes_reclaimed").inc(stats.nodes_before - stats.nodes_after)
    reg.counter("gc.bytes_reclaimed").inc(stats.bytes_before - stats.bytes_after)
    reg.counter("gc.reshared_leaves").inc(stats.reshared_leaves)
    reg.counter("gc.time_s").inc(stats.time_s)
    reg.gauge("gc.nodes").set(stats.nodes_after)
    reg.gauge("gc.bytes").set(stats.bytes_after)
    # compaction re-shares structure: re-sample the compression gauges
    publish_predicate_effectiveness(inc.facts, reg)
    return stats


def _compact_store(inc) -> CompactionStats:
    t0 = time.perf_counter()
    store: ColumnStore = inc.store
    facts: FactStore = inc.facts
    before = mu_usage(facts)

    fresh = ColumnStore(store.device)
    old_to_new: dict[int, int] = {}
    leaf_cons: dict[bytes, int] = {}
    concat_cons: dict[tuple[int, ...], int] = {}
    reshared = 0

    preds = list(facts.predicates())
    order = store.topo_order(_roots(facts))
    leaves = [cid for cid in order if store.is_leaf(cid)]
    block, _, offsets, keys = leaf_payloads(store, leaves)
    where = {cid: (off, key) for cid, off, key in zip(leaves, offsets, keys)}
    for cid in order:
        if store.is_leaf(cid):
            off, key = where[cid]
            hit = leaf_cons.get(key)
            if hit is None:
                # the new leaf's payload is its slice of the block
                n = store.n_runs(cid)
                hit = fresh.new_leaf_rle(block[off:off + n], block[off + n:off + 2 * n],
                                         store.length(cid))
                leaf_cons[key] = hit
            else:
                reshared += 1
            old_to_new[cid] = hit
        else:
            kids = tuple(old_to_new[c] for c in store.children(cid))
            hit = concat_cons.get(kids)
            if hit is None:
                hit = fresh.new_concat(list(kids))
                concat_cons[kids] = hit
            old_to_new[cid] = hit

    new_facts: dict[str, list[MetaFact]] = {}
    for pred in preds:
        new_facts[pred] = [
            MetaFact(pred, tuple(old_to_new[c] for c in mf.columns), mf.length, mf.round)
            for mf in facts.all(pred)
        ]

    # -- the swap (between requests; not concurrent-reader safe) ------- #
    store._nodes = fresh._nodes
    store._parents = fresh._parents
    store._unfold_cache = fresh._unfold_cache
    store._next_id = fresh._next_id
    store.recount_bytes()  # the running byte counters track the new table
    facts._facts = new_facts
    inc.pre_mfs = {}
    inc.stats_view.refresh()

    after = mu_usage(facts)
    return CompactionStats(
        nodes_before=before.n_nodes,
        nodes_after=after.n_nodes,
        bytes_before=before.total_bytes,
        bytes_after=after.total_bytes,
        dead_fraction_before=before.dead_fraction,
        reshared_leaves=reshared,
        time_s=time.perf_counter() - t0,
    )
