"""Column store: the paper's meta-constant mapping ``mu``, on tensors.

A *meta-constant* names a vector of constants.  Following Appendix A, the
mapping ``mu`` sends a meta-constant to either

* a **leaf**: a non-decreasing vector of constants, stored run-length
  encoded (``run_values`` / ``run_counts``, int64 tensors on the store's
  device), or
* a **composite**: a vector of child meta-constants (``Concat``).

Node lengths live on the host, so the DAG's shape (lengths, run counts,
children) never needs a device read.  A leaf unfolds through the
``rle_expand`` kernel; unfoldings are cached per node.

Leaves made in a batch (:meth:`ColumnStore.new_leaves`,
:meth:`ColumnStore.new_constants`) are *block-backed*: a leaf holds no
tensor of its own, only its batch's run block with host ints for its
first run and its run count, and, as its cached unfolding, the batch's
value block with its offset in it.  ``run_values`` / ``run_counts`` are
views made when asked.  Leaves made one at a time own their tensors.  The
batch readers (:meth:`ColumnStore.unfold_cat`,
:meth:`ColumnStore.copy_splits`) gather by ranges, and merge consecutive
parts that lie end to end in one block into one slice.  So a batch of
leaves costs the host one Python object a leaf, and no tensor a leaf:
fewer objects to make, and fewer for the collector to walk.

The paper's ``shuffle`` (Algorithm 4) splits a leaf ``a`` into ``b_in`` /
``b_out`` and *redefines* ``mu(a) := b_in . b_out`` (:meth:`split` with
``inplace=True``); the copy mode, the engines' default, copies the
survivors into a fresh leaf instead.

Representation-size accounting follows Section 4 of the paper: a mapping
entry with ``m`` RLE runs costs ``1 + 2*m`` symbols.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rle_expand
from ..obs.memory import register_reporter, split_owned_backed, tensor_nbytes
from .util import resolve_device

__all__ = ["ColumnStore", "rle_encode"]

_I64 = torch.int64


def rle_encode(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run-length encode a 1-D tensor (returns run_values, run_counts)."""
    n = values.shape[0]
    if n == 0:
        return values[:0], torch.zeros(0, dtype=_I64, device=values.device)
    change = torch.ones(n, dtype=torch.bool, device=values.device)
    torch.ne(values[1:], values[:-1], out=change[1:])
    starts = torch.nonzero(change).flatten()
    ends = torch.empty_like(starts)
    ends[:-1] = starts[1:]
    ends[-1] = n
    return values[starts], ends - starts


def _n_runs_host(ids: list[int]) -> int:
    return sum(1 for i, c in enumerate(ids) if i == 0 or c != ids[i - 1])


class _Leaf:
    """A leaf's RLE payload and its cached unfolding.

    The leaf's runs are ``[r0, r0 + n_runs)`` of the run block ``rv`` /
    ``rc``: all of a block of its own for a leaf made alone, a range of
    its batch's block for a batch-made one.  Its cached unfolding, when
    there is one, is ``vals[v0: v0 + length]``."""

    __slots__ = ("rv", "rc", "r0", "n_runs", "length", "owned", "vals", "v0")

    def __init__(self, rv: torch.Tensor, rc: torch.Tensor, length: int,
                 owned: bool = False, r0: int = 0, n_runs: int | None = None,
                 vals: torch.Tensor | None = None, v0: int = 0):
        self.rv = rv
        self.rc = rc
        self.r0 = r0
        self.n_runs = rv.shape[0] if n_runs is None else n_runs
        self.length = length
        #: the payload is a disjoint slice of a block made for a batch of
        #: leaves: its bytes are the leaf's own, though the tensors view
        #: a larger storage
        self.owned = owned
        self.vals = vals
        self.v0 = v0

    @property
    def run_values(self) -> torch.Tensor:
        return _view(self.rv, self.r0, self.r0 + self.n_runs)

    @property
    def run_counts(self) -> torch.Tensor:
        return _view(self.rc, self.r0, self.r0 + self.n_runs)


def _view(t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """``t[start:stop]``, or ``t`` itself when that is all of it."""
    return t if start == 0 and stop == t.shape[0] else t[start:stop]


class _Concat:
    __slots__ = ("children", "length")

    def __init__(self, children: list[int], length: int):
        self.children = children
        self.length = length


class ColumnStore:
    """The mapping ``mu``: meta-constant id -> Leaf | Concat node, on one
    device (``device=None``: the card)."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)
        self._nodes: dict[int, object] = {}
        self._parents: dict[int, set[int]] = {}
        self._unfold_cache: dict[int, torch.Tensor] = {}
        self._next_id = 0
        self.n_splits = 0
        self.n_inplace_redefs = 0
        #: leaf parts :meth:`unfold_cat` has gathered, and the slices they
        #: merged into (``slices / leaves``: how far the gather coalesces)
        self.n_gathered_leaves = 0
        self.n_gathered_slices = 0
        # running byte accounting (O(1) memory_report)
        self._nbytes_owned = 0
        self._nbytes_backed = 0
        self._backed_by_id: dict[int, int] = {}
        self._cache_nbytes = 0
        register_reporter("columns", self)

    # ------------------------------------------------------------------ #
    # byte accounting (obs.memory reporter protocol)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _node_nbytes_of(node) -> int:
        if isinstance(node, _Leaf):  # int64 values and counts, one per run
            return 16 * node.n_runs
        return 8 * len(node.children)

    def _account_add(self, cid: int, node) -> None:
        if isinstance(node, _Leaf) and node.owned:
            owned, backed = self._node_nbytes_of(node), 0
        elif isinstance(node, _Leaf):
            owned, backed = split_owned_backed(
                (node.run_values, node.run_counts)
            )
        else:
            owned, backed = 8 * len(node.children), 0
        self._nbytes_owned += owned
        self._nbytes_backed += backed
        if backed:
            self._backed_by_id[cid] = backed

    def _account_remove(self, cid: int, node) -> None:
        backed = self._backed_by_id.pop(cid, 0)
        self._nbytes_backed -= backed
        self._nbytes_owned -= self._node_nbytes_of(node) - backed

    def _cache_set(self, cid: int, values: torch.Tensor) -> None:
        """Cache a composite's unfolding (a leaf keeps its own)."""
        prev = self._unfold_cache.get(cid)
        if prev is not None:
            self._cache_nbytes -= tensor_nbytes(prev)
        self._unfold_cache[cid] = values
        self._cache_nbytes += tensor_nbytes(values)

    def _cache_drop(self, cid: int) -> None:
        node = self._nodes.get(cid)
        if isinstance(node, _Leaf):
            if node.vals is not None:
                self._cache_nbytes -= 8 * node.length
                node.vals = None
            return
        prev = self._unfold_cache.pop(cid, None)
        if prev is not None:
            self._cache_nbytes -= tensor_nbytes(prev)

    def is_cached(self, cid: int) -> bool:
        """Whether ``cid``'s unfolding is cached (:meth:`unfold` would
        launch nothing for it)."""
        node = self._nodes[cid]
        if isinstance(node, _Leaf):
            return node.vals is not None
        return cid in self._unfold_cache

    def recount_bytes(self) -> None:
        """Rebuild the running counters from the node table (after
        compaction swaps the table wholesale)."""
        self._nbytes_owned = 0
        self._nbytes_backed = 0
        self._backed_by_id = {}
        self._cache_nbytes = sum(tensor_nbytes(a) for a in self._unfold_cache.values())
        for cid, node in self._nodes.items():
            self._account_add(cid, node)
            if isinstance(node, _Leaf) and node.vals is not None:
                self._cache_nbytes += 8 * node.length

    def memory_report(self) -> dict[str, int]:
        """Owned node payload bytes, backed node bytes (slices of a larger
        block), unfold-cache bytes, and the node count."""
        return {
            "nodes_bytes": self._nbytes_owned,
            "nodes_backed_bytes": self._nbytes_backed,
            "unfold_cache_bytes": self._cache_nbytes,
            "n_nodes": len(self._nodes),
        }

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    def _fresh(self) -> int:
        cid = self._next_id
        self._next_id += 1
        return cid

    def _add_leaf(self, run_values, run_counts, length: int, owned: bool = False) -> int:
        cid = self._fresh()
        node = _Leaf(run_values, run_counts, length, owned)
        self._nodes[cid] = node
        self._account_add(cid, node)
        return cid

    def new_leaves(self, flat: torch.Tensor, starts, lengths) -> list[int]:
        """One leaf per part ``flat[starts[i]: starts[i] + lengths[i]]``,
        created in the order given (ascending ids), as :meth:`new_leaf`
        would create them one by one; each part's values stay cached as
        its unfolding.  Parts must not overlap and may leave gaps;
        ``starts`` and ``lengths`` are host sequences or arrays.

        One run-length pass covers every part: runs start at every part's
        start and end and wherever the value changes; the run counts per
        part and the index of each part's first run come to the host in
        one read (two synchronisations in all, however many leaves).  The
        leaves are block-backed: each holds the batch's run block with
        its first run and run count, and ``flat`` with its start as its
        cached unfolding.  No tensor is made per leaf."""
        starts = np.asarray(starts, dtype=np.int64)
        lengths = np.asarray(lengths, dtype=np.int64)
        n_parts = starts.shape[0]
        if n_parts == 0:
            return []
        dev = self.device
        flat = flat.to(device=dev, dtype=_I64)
        n = flat.shape[0]
        # by start, an empty part before a part that starts where it does
        order = np.lexsort((lengths, starts))
        s_sorted = starts[order]
        bounds = torch.from_numpy(np.concatenate([s_sorted, s_sorted + lengths[order]]))
        bounds = bounds.to(dev)
        part_starts, part_ends = bounds[:n_parts], bounds[n_parts:]
        change = torch.ones(n + 1, dtype=torch.bool, device=dev)
        if n > 1:
            torch.ne(flat[1:], flat[:-1], out=change[1:n])
        change[bounds] = True
        run_pos = torch.nonzero(change[:n]).flatten()
        run_end = torch.empty_like(run_pos)
        run_end[:-1] = run_pos[1:]
        run_end[-1:] = n
        run_values, run_counts = flat[run_pos], run_end - run_pos
        # each run lies in at most one part (runs break at every bound)
        part = torch.searchsorted(part_starts, run_pos, right=True) - 1
        inside = (part >= 0) & (run_pos < part_ends[part.clamp(min=0)])
        per_part = torch.zeros(n_parts, dtype=_I64, device=dev).scatter_add_(
            0, part.clamp(min=0), inside.to(_I64))
        first = torch.searchsorted(run_pos, part_starts)
        counts_sorted, firsts_sorted = torch.stack([per_part, first]).cpu().numpy()
        counts, firsts = np.empty_like(counts_sorted), np.empty_like(firsts_sorted)
        counts[order], firsts[order] = counts_sorted, firsts_sorted
        base = self._next_id
        nodes = self._nodes
        for cid, r0, n_runs, v0, length in zip(
                range(base, base + n_parts), firsts.tolist(), counts.tolist(),
                starts.tolist(), lengths.tolist()):
            nodes[cid] = _Leaf(run_values, run_counts, length, True, r0, n_runs, flat, v0)
        self._next_id = base + n_parts
        self._nbytes_owned += 16 * int(counts.sum())
        self._cache_nbytes += 8 * int(lengths.sum())
        return list(range(base, base + n_parts))

    def new_constants(self, values: list[int], counts: list[int]) -> list[int]:
        """RLE leaves ``values[i] * counts[i]``, created in order, their
        payloads sent to the device in one copy (no launch per leaf), as
        one run block the leaves are backed by."""
        n_leaves = len(values)
        if not n_leaves:
            return []
        block = torch.tensor([values, counts], dtype=_I64).to(self.device)
        rv, rc = block[0], block[1]
        base = self._next_id
        nodes = self._nodes
        for i, c in enumerate(counts):
            nodes[base + i] = _Leaf(rv, rc, c, True, i, 1)
        self._next_id = base + n_leaves
        self._nbytes_owned += 16 * n_leaves
        return list(range(base, base + n_leaves))

    def new_leaf(self, values: torch.Tensor) -> int:
        """Create a leaf meta-constant from a constant vector (stored RLE;
        the vector itself is kept as the leaf's cached unfolding)."""
        values = values.to(device=self.device, dtype=_I64)
        rv, rc = rle_encode(values)
        cid = self._add_leaf(rv, rc, int(values.shape[0]))
        self._nodes[cid].vals = values
        self._cache_nbytes += tensor_nbytes(values)
        return cid

    def new_leaf_rle(self, run_values: torch.Tensor, run_counts: torch.Tensor,
                     length: int | None = None) -> int:
        """Leaf from an RLE payload (moved to the store's device), handed
        over to the leaf: its bytes count as the leaf's own, though it may
        slice a larger block of disjoint payloads.  ``length`` is the
        payload's unfolded length when the caller knows it; otherwise it
        is read from the counts (one host read)."""
        rv = run_values.to(device=self.device, dtype=_I64)
        rc = run_counts.to(device=self.device, dtype=_I64)
        if length is None:
            length = int(rc.sum())
        return self._add_leaf(rv, rc, int(length), owned=True)

    def new_constant(self, value: int, count: int) -> int:
        """RLE leaf ``value * count`` (the paper's ``d * n`` notation)."""
        return self._add_leaf(
            torch.full((1,), value, dtype=_I64, device=self.device),
            torch.full((1,), count, dtype=_I64, device=self.device),
            int(count),
        )

    def add_nodes(self, leaves, concats, next_id: int) -> None:
        """Insert nodes at ids reserved by the caller (a snapshot load):
        ``leaves`` holds ``(cid, run_values, run_counts, length)``, each
        payload a disjoint slice of one device block (owned, as in
        :meth:`new_leaf_rle`), ``concats`` holds ``(cid, children)`` in
        ascending ids, each child inserted before its parents.  The id
        counter moves to ``next_id``."""
        nodes = self._nodes
        runs = 0
        for cid, rv, rc, length in leaves:
            nodes[cid] = _Leaf(rv, rc, length, True)
            runs += rv.shape[0]
        self._nbytes_owned += 16 * runs
        for cid, children in concats:
            node = _Concat(list(children), sum(nodes[c].length for c in children))
            nodes[cid] = node
            self._nbytes_owned += 8 * len(children)
            for c in children:
                self._parents.setdefault(c, set()).add(cid)
        self._next_id = next_id

    def new_concat(self, children: list[int]) -> int:
        if len(children) == 1:
            return children[0]
        length = sum(self.length(c) for c in children)
        cid = self._fresh()
        node = _Concat(list(children), length)
        self._nodes[cid] = node
        self._account_add(cid, node)
        for c in children:
            self._parents.setdefault(c, set()).add(cid)
        return cid

    # ------------------------------------------------------------------ #
    # accessors
    # ------------------------------------------------------------------ #
    def is_leaf(self, cid: int) -> bool:
        return isinstance(self._nodes[cid], _Leaf)

    def length(self, cid: int) -> int:
        return self._nodes[cid].length

    def _first_leaf(self, cid: int) -> _Leaf:
        node = self._nodes[cid]
        while isinstance(node, _Concat):
            node = self._nodes[node.children[0]]
        return node

    def head_values(self, cids) -> torch.Tensor:
        """First constant of each meta-constant's unfolding, as a tensor on
        the store's device: each distinct id is resolved once, with no
        device read (the singleton-recompression fast path — length-one
        columns unfold to exactly their head value)."""
        cids = [int(c) for c in cids]
        if not cids:
            return torch.zeros(0, dtype=_I64, device=self.device)
        uniq = sorted(set(cids))
        pos = {c: k for k, c in enumerate(uniq)}
        vals = torch.cat([self._first_leaf(c).run_values[:1] for c in uniq])
        inv = torch.tensor([pos[c] for c in cids], dtype=_I64).to(self.device)
        return vals[inv]

    def depth(self, cid: int) -> int:
        """Meta-constant depth per Appendix B (leaf = 1)."""
        node = self._nodes[cid]
        if isinstance(node, _Leaf):
            return 1
        return 1 + max(self.depth(c) for c in node.children)

    def n_runs(self, cid: int) -> int:
        """Number of RLE runs in ``mu(cid)`` (leaf: constant runs;
        composite: runs over the child-id sequence) — host only."""
        node = self._nodes[cid]
        if isinstance(node, _Leaf):
            return node.n_runs
        return _n_runs_host(node.children)

    def repr_size(self, cid: int, adaptive: bool = True) -> int:
        """Paper metric: ``1 + 2*m`` for ``m`` RLE-encoded entries;
        ``adaptive=True`` charges incompressible leaves as plain vectors
        ``1 + n`` when that is cheaper."""
        rle = 1 + 2 * self.n_runs(cid)
        if not adaptive:
            return rle
        node = self._nodes[cid]
        plain = 1 + (
            node.length if isinstance(node, _Leaf) else len(node.children)
        )
        return min(rle, plain)

    def reachable(self, roots) -> set[int]:
        seen: set[int] = set()
        stack = list(roots)
        while stack:
            cid = stack.pop()
            if cid in seen:
                continue
            seen.add(cid)
            node = self._nodes[cid]
            if isinstance(node, _Concat):
                stack.extend(node.children)
        return seen

    def topo_order(self, roots) -> list[int]:
        """Reachable node ids, children before parents (the order
        compaction rebuilds the DAG in)."""
        order: list[int] = []
        seen: set[int] = set()
        stack: list[tuple[int, bool]] = [(cid, False) for cid in roots]
        while stack:
            cid, expanded = stack.pop()
            if expanded:
                order.append(cid)
                continue
            if cid in seen:
                continue
            seen.add(cid)
            stack.append((cid, True))
            node = self._nodes[cid]
            if isinstance(node, _Concat):
                stack.extend((c, False) for c in node.children if c not in seen)
        return order

    def leaf_payload(self, cid: int) -> tuple[torch.Tensor, torch.Tensor]:
        """RLE payload ``(run_values, run_counts)`` of a leaf."""
        node = self._nodes[cid]
        assert isinstance(node, _Leaf)
        return node.run_values, node.run_counts

    def children(self, cid: int) -> list[int]:
        node = self._nodes[cid]
        return list(node.children) if isinstance(node, _Concat) else []

    def node_nbytes(self, cid: int) -> int:
        """Bytes of one node's payload (RLE tensors for leaves, 8 per
        child id for composites)."""
        return self._node_nbytes_of(self._nodes[cid])

    def total_nbytes(self) -> int:
        """Bytes across all live nodes, reachable or not (the running
        counters: owned and backed bytes together)."""
        return self._nbytes_owned + self._nbytes_backed

    def leaf_rle_stats(self, ids) -> tuple[int, int]:
        """``(cells, runs)`` over the leaves among ``ids``."""
        cells = runs = 0
        for cid in ids:
            node = self._nodes[cid]
            if isinstance(node, _Leaf):
                cells += node.length
                runs += node.n_runs
        return cells, runs

    def expanded_nbytes(self, roots) -> int:
        """Tree-expanded bytes: each node counted once per path from the
        roots (storage with no DAG sharing)."""
        memo: dict[int, int] = {}
        total = 0
        for root in roots:
            stack: list[tuple[int, bool]] = [(root, False)]
            while stack:
                cid, expanded = stack.pop()
                if not expanded and cid in memo:
                    continue
                node = self._nodes[cid]
                if isinstance(node, _Leaf):
                    memo[cid] = self._node_nbytes_of(node)
                elif expanded:
                    memo[cid] = 8 * len(node.children) + sum(memo[c] for c in node.children)
                else:
                    stack.append((cid, True))
                    stack.extend((c, False) for c in node.children if c not in memo)
            total += memo[root]
        return total

    # ------------------------------------------------------------------ #
    # unfolding
    # ------------------------------------------------------------------ #
    def unfold(self, cid: int) -> torch.Tensor:
        """Recursively unfold a meta-constant into its constant vector."""
        node = self._nodes[cid]
        if isinstance(node, _Leaf):
            if node.vals is None:
                self._expand([node])
            return _view(node.vals, node.v0, node.v0 + node.length)
        cached = self._unfold_cache.get(cid)
        if cached is not None:
            return cached
        parts = [self.unfold(c) for c in node.children]
        out = (
            torch.cat(parts)
            if parts
            else torch.zeros(0, dtype=_I64, device=self.device)
        )
        self._cache_set(cid, out)
        return out

    def _expand(self, leaves: list[_Leaf]) -> None:
        """Unfold uncached leaves in one ``rle_expand`` over their runs
        (gathered by ranges, as :meth:`unfold_cat` gathers values); its
        output becomes their value block, each leaf at its offset."""
        rv_parts, rc_parts = [], []
        vb = cb = None
        lo = hi = total = 0
        for nd in leaves:
            total += nd.length
            if nd.rv is vb and nd.rc is cb and nd.r0 == hi:
                hi += nd.n_runs
                continue
            if vb is not None:
                rv_parts.append(_view(vb, lo, hi))
                rc_parts.append(_view(cb, lo, hi))
            vb, cb, lo, hi = nd.rv, nd.rc, nd.r0, nd.r0 + nd.n_runs
        rv_parts.append(_view(vb, lo, hi))
        rc_parts.append(_view(cb, lo, hi))
        if len(rv_parts) == 1:
            out = rle_expand(rv_parts[0], rc_parts[0], total)
        else:
            out = rle_expand(torch.cat(rv_parts), torch.cat(rc_parts), total)
        off = 0
        for nd in leaves:
            nd.vals, nd.v0 = out, off
            off += nd.length
        self._cache_nbytes += 8 * total

    def unfold_cat(self, cids, meter=None) -> torch.Tensor:
        """``torch.cat`` of the unfoldings of ``cids``, in order.  The
        leaves among them not yet cached unfold together, in one
        ``rle_expand`` over their runs, and take its output as their
        value block, each at its offset, as :meth:`unfold` one by one
        would cache them.

        The gather walks ``cids`` once and merges consecutive parts that
        lie end to end in one block into one slice before the one
        ``torch.cat``: the leaves of one batch in id order, one column at
        a time (a load's or a ``compress_rows``' column), are one slice.
        :attr:`n_gathered_leaves` and :attr:`n_gathered_slices` count the
        leaf parts gathered and the slices they merged into.

        ``meter(cached_cells, fresh_cells)``, when given, receives what
        :meth:`unfold` one by one would have found cached and unfolded
        afresh."""
        cids = list(cids)
        if not cids:
            if meter is not None:
                meter(0, 0)
            return torch.zeros(0, dtype=_I64, device=self.device)
        nodes, cache = self._nodes, self._unfold_cache
        fresh: dict[int, object] = {}  # uncached ids, by first occurrence
        for c in cids:
            node = nodes[c]
            if node.vals is None if isinstance(node, _Leaf) else c not in cache:
                fresh[c] = node
        if fresh:
            leaves = [nd for nd in fresh.values() if isinstance(nd, _Leaf)]
            if leaves:
                self._expand(leaves)
            if len(leaves) < len(fresh):
                if meter is not None:
                    # a composite caches its children as it unfolds: meter
                    # the calls one by one
                    seen: set[int] = set()
                    cached = unfolded = 0
                    for c in cids:
                        n = nodes[c].length
                        if c not in fresh or c in seen:
                            cached += n
                        else:
                            unfolded += n
                            seen.update(self.reachable([c]))
                    meter(cached, unfolded)
                    meter = None
                for c, nd in fresh.items():
                    if not isinstance(nd, _Leaf):
                        self.unfold(c)
        if meter is not None:
            fresh_cells = sum(nd.length for nd in fresh.values())
            meter(sum(nodes[c].length for c in cids) - fresh_cells, fresh_cells)
        slices = []
        base = None
        lo = hi = n_leaves = n_leaf_slices = 0
        for c in cids:
            node = nodes[c]
            if isinstance(node, _Leaf):
                block, off = node.vals, node.v0
                n_leaves += 1
            else:
                block, off = cache[c], 0
            if block is base and off == hi:
                hi += node.length
                continue
            if base is not None:
                slices.append(_view(base, lo, hi))
            base, lo, hi = block, off, off + node.length
            n_leaf_slices += isinstance(node, _Leaf)
        slices.append(_view(base, lo, hi))
        self.n_gathered_leaves += n_leaves
        self.n_gathered_slices += n_leaf_slices
        return slices[0] if len(slices) == 1 else torch.cat(slices)

    def _invalidate_up(self, cid: int) -> None:
        stack = [cid]
        while stack:
            c = stack.pop()
            self._cache_drop(c)
            stack.extend(self._parents.get(c, ()))

    # ------------------------------------------------------------------ #
    # the paper's shuffle split (Algorithm 4, lines 47-52)
    # ------------------------------------------------------------------ #
    def copy_splits(self, requests: list[tuple[int, int, int]],
                    keep: torch.Tensor) -> list[int]:
        """Batched copy-mode :meth:`split`: for each ``(cid, offset,
        kept)`` a fresh leaf holding the survivors of ``cid`` under
        ``keep[offset: offset + length(cid)]`` (``kept`` of them, known on
        the host), created in order.  Same nodes as one ``split(...,
        inplace=False)`` per request, with a constant number of
        synchronisations.

        The requests are gathered slot by slot: the first request at each
        offset in order, then the second, and so on (an item's distinct
        columns share its offset).  So the same column of consecutive
        items, and their ranges of ``keep``, lie end to end: the values
        come from :meth:`unfold_cat`'s coalesced gather, and the survivor
        mask from ``keep`` by the same merged ranges, not one slice a
        request.  The survivors are one block-backed batch
        (:meth:`new_leaves`), their ids in request order."""
        if not requests:
            return []
        self.n_splits += len(requests)
        req = np.asarray(requests, dtype=np.int64).reshape(-1, 3)
        offs, kept = req[:, 1], req[:, 2]
        idx = np.arange(req.shape[0])
        run_start = np.maximum.accumulate(
            np.where(np.r_[True, offs[1:] != offs[:-1]], idx, 0))
        order = np.argsort(idx - run_start, kind="stable")
        cids = req[order, 0].tolist()
        values = self.unfold_cat(cids)
        nodes = self._nodes
        lo = offs[order]
        hi = lo + np.fromiter((nodes[c].length for c in cids), dtype=np.int64,
                              count=len(cids))
        # a slice of ``keep`` starts where a range does not continue the last
        first = np.flatnonzero(np.r_[True, lo[1:] != hi[:-1]])
        last = np.r_[first[1:] - 1, len(cids) - 1]
        pieces = [keep[a:b] for a, b in zip(lo[first].tolist(), hi[last].tolist())]
        mask = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        kept_sorted = kept[order]
        starts = np.empty_like(kept)
        starts[order] = np.cumsum(kept_sorted) - kept_sorted
        return self.new_leaves(values[mask], starts, kept)

    def split(self, cid: int, keep: torch.Tensor, inplace: bool = True) -> int:
        """Split a column by a boolean mask over its unfolding; returns the
        meta-constant holding the surviving positions.

        With ``inplace=True`` every touched leaf ``a`` is split into fresh
        leaves ``b_in`` / ``b_out`` and ``mu(a)`` is redefined as
        ``b_in . b_out``.  With ``inplace=False`` (or when the same node
        occurs twice under ``cid``) a fresh copy of the survivors is
        returned instead — always sound, slightly larger."""
        if keep.shape[0] != self.length(cid):
            raise ValueError("split mask length differs from the column's")
        self.n_splits += 1
        if not inplace or self._has_shared_occurrence(cid):
            return self.new_leaf(self.unfold(cid)[keep])
        visited: dict[int, int] = {}
        return self._split_rec(cid, keep, 0, visited)

    def _has_shared_occurrence(self, cid: int) -> bool:
        """True iff some node occurs more than once in the tree under cid."""
        seen: set[int] = set()
        stack = [cid]
        while stack:
            c = stack.pop()
            node = self._nodes[c]
            if isinstance(node, _Concat):
                for ch in node.children:
                    if ch in seen:
                        return True
                    seen.add(ch)
                    stack.append(ch)
        return False

    def _split_rec(
        self, cid: int, keep: torch.Tensor, offset: int, visited: dict[int, int]
    ) -> int:
        node = self._nodes[cid]
        n = node.length
        sub = keep[offset: offset + n]
        kept = int(sub.sum())
        if kept == 0:
            return -1  # nothing survives under this node
        if kept == n:
            return cid  # full sharing, no split needed
        if isinstance(node, _Leaf):
            vals = rle_expand(node.run_values, node.run_counts, n)
            if cid in visited:
                # the same leaf twice under one split root: the first
                # occurrence was already redefined; copy this one
                return self.new_leaf(vals[sub])
            b_in = self.new_leaf(vals[sub])
            b_out = self.new_leaf(vals[~sub])
            visited[cid] = b_in
            # redefine mu(cid) := b_in . b_out  (paper, Alg. 4 line 51)
            self._cache_drop(cid)
            self._account_remove(cid, node)
            redefined = _Concat([b_in, b_out], n)
            self._nodes[cid] = redefined
            self._account_add(cid, redefined)
            self._parents.setdefault(b_in, set()).add(cid)
            self._parents.setdefault(b_out, set()).add(cid)
            self._invalidate_up(cid)
            self.n_inplace_redefs += 1
            return b_in
        parts: list[int] = []
        off = offset
        for child in node.children:
            cl = self.length(child)
            part = self._split_rec(child, keep, off, visited)
            if part >= 0:
                parts.append(part)
            off += cl
        if len(parts) == 1:
            return parts[0]
        return self.new_concat(parts)

    # ------------------------------------------------------------------ #
    # scratch regions (query-time allocations)
    # ------------------------------------------------------------------ #
    def mark(self) -> int:
        """Checkpoint the id counter; nodes created from here on form a
        scratch region that :meth:`release` can reclaim wholesale."""
        return self._next_id

    def release(self, mark: int) -> None:
        """Drop every node with id >= ``mark``, with its unfold-cache
        entry, its bytes and its parent links.

        Sound only under the frozen-store contract: no node below ``mark``
        has been redefined in place since the checkpoint (query evaluation
        splits with ``inplace=False``), and no surviving meta-fact
        references a dropped id."""
        for cid in range(mark, self._next_id):
            node = self._nodes.get(cid)
            if node is None:
                continue
            self._cache_drop(cid)
            del self._nodes[cid]
            self._account_remove(cid, node)
            self._parents.pop(cid, None)
            if isinstance(node, _Concat):
                for child in node.children:
                    parents = self._parents.get(child)
                    if parents is not None:
                        parents.discard(cid)
        self._next_id = mark

    # ------------------------------------------------------------------ #
    # stats
    # ------------------------------------------------------------------ #
    def n_nodes(self) -> int:
        return len(self._nodes)
