"""Vectorised meta-substitution joins: match / sjoin / xjoin (Alg. 3-5).

A :class:`SubstSet` is the engine's working set ``L`` from Algorithm 1: a
variable order plus a list of meta-substitutions, each a tuple of column
ids (one per variable, equal unfolding length).

As in the reference, only the join-key columns are materialised; semi-joins
are sorted-membership tests (the ``sorted_member`` kernel); cross-joins
group the right side on the key, compress each group once, and locate each
group's left span with the ``join_bounds`` kernel.  Per-item keep counts
come to the host in one read per operation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import join_bounds
from .columns import ColumnStore
from .compress import compress_grouped, fewest_distinct_first, lexsort
from .metafacts import MetaFact
from .util import factorize_rows, multicol_member, segment_counts

__all__ = ["SubstSet", "match", "sjoin", "split_survivors", "xjoin"]

_I64 = torch.int64


@dataclass
class SubstSet:
    """A set of meta-substitutions over a fixed variable order."""

    vars: tuple[str, ...]
    items: list[tuple[tuple[int, ...], int]] = field(default_factory=list)
    # items: (column ids aligned with ``vars``, unfolding length)

    def is_empty(self) -> bool:
        return not self.items

    def n_substitutions(self) -> int:
        return sum(length for _, length in self.items)


def _unfold_cols(store: ColumnStore, items, var_idx: list[int]) -> torch.Tensor:
    """Unfold selected columns of every item into one ``(n, k)`` tensor."""
    if not items:
        return torch.zeros((0, len(var_idx)), dtype=_I64, device=store.device)
    if not var_idx:
        n = sum(length for _, length in items)
        return torch.zeros((n, 0), dtype=_I64, device=store.device)
    cols = [
        store.unfold_cat([cols_ids[j] for cols_ids, _ in items])
        for j in var_idx
    ]
    return torch.stack(cols, dim=1)


def split_survivors(
    store: ColumnStore,
    items,
    keep: torch.Tensor,
    kept: list[int],
    inplace_splits: bool = False,
) -> list:
    """The paper's shuffle (Algorithm 4) over consecutive ``(column ids,
    length)`` items: ``keep`` masks their concatenation and ``kept`` holds
    each item's survivor count (host).  Per item: the item itself when
    every position survives, ``None`` when none does, else each distinct
    column split to the survivors.  Copy-mode splits run as one batch
    (:meth:`ColumnStore.copy_splits`), creating the nodes one split per
    column would, in the same order."""
    lengths = np.fromiter((length for _, length in items), dtype=np.int64,
                          count=len(items))
    kept_np = np.asarray(kept, dtype=np.int64)
    offsets = np.cumsum(lengths) - lengths
    # untouched items are shared; only the partly kept ones are visited
    out: list = [item if k == length else None
                 for item, k, length in zip(items, kept, lengths.tolist())]
    requests: list[tuple[int, int, int]] = []
    pending = []
    for i in np.flatnonzero((kept_np > 0) & (kept_np < lengths)).tolist():
        cols_ids, length = items[i]
        k, off = kept[i], int(offsets[i])
        distinct = list(dict.fromkeys(cols_ids))
        if inplace_splits:
            sub = keep[off: off + length]
            split_of = {c: store.split(c, sub, inplace=True) for c in distinct}
            out[i] = (tuple(split_of[c] for c in cols_ids), k)
        else:
            pending.append((i, cols_ids, distinct, len(requests)))
            requests.extend((c, off, k) for c in distinct)
    ids = store.copy_splits(requests, keep)
    for i, cols_ids, distinct, first in pending:
        split_of = dict(zip(distinct, ids[first: first + len(distinct)]))
        out[i] = (tuple(split_of[c] for c in cols_ids), kept[i])
    return out


def _filter_items(
    store: ColumnStore,
    subst: SubstSet,
    mask: torch.Tensor,
    inplace_splits: bool = False,
) -> SubstSet:
    """Keep only the positions of ``mask`` in each item, via the paper's
    shuffle: untouched items are shared as-is; touched items have every
    column split (Algorithm 4)."""
    kept = segment_counts(mask, [length for _, length in subst.items])
    items = split_survivors(store, subst.items, mask, kept, inplace_splits)
    return SubstSet(subst.vars, [item for item in items if item is not None])


# --------------------------------------------------------------------- #
# match (Appendix A.1, last paragraph)
# --------------------------------------------------------------------- #
def match(
    atom,
    facts: list[MetaFact],
    store: ColumnStore,
    inplace_splits: bool = False,
) -> SubstSet:
    """All meta-substitutions matching ``atom`` against a meta-fact list,
    handling constants and repeated variables by masking + shuffle."""
    vars_ = atom.variables()
    var_first_pos = {v: atom.terms.index(v) for v in vars_}
    needs_mask = any(isinstance(t, int) for t in atom.terms) or len(vars_) != len(
        atom.terms
    )
    out = SubstSet(vars_)
    arity = len(atom.terms)
    if not needs_mask:
        # distinct variables only: each meta-fact's columns, in order
        out.items = [(mf.columns, mf.length) for mf in facts if len(mf.columns) == arity]
        return out
    for mf in facts:
        if len(mf.columns) != arity:
            continue
        cols = tuple(mf.columns[var_first_pos[v]] for v in vars_)
        mask = torch.ones(mf.length, dtype=torch.bool, device=store.device)
        for pos, t in enumerate(atom.terms):
            if isinstance(t, int):  # constant
                mask &= store.unfold(mf.columns[pos]) == t
            elif pos != var_first_pos[t]:  # repeated variable
                mask &= store.unfold(mf.columns[pos]) == store.unfold(
                    mf.columns[var_first_pos[t]]
                )
        kept = int(mask.sum())  # one host read for any() and all()
        if kept == 0:
            continue
        if kept == mf.length:
            out.items.append((cols, mf.length))
            continue
        if inplace_splits:
            # in-place redefinition is only sound if *every* column of the
            # source meta-fact is co-split with the same mask
            split_of = {
                c: store.split(c, mask, inplace=True)
                for c in dict.fromkeys(mf.columns)
            }
            new_cols = tuple(split_of[mf.columns[var_first_pos[v]]] for v in vars_)
        else:
            new_cols = tuple(store.split(c, mask, inplace=False) for c in cols)
        out.items.append((new_cols, kept))
    return out


# --------------------------------------------------------------------- #
# semi-join (Algorithm 3)
# --------------------------------------------------------------------- #
def sjoin(
    filter_set: SubstSet,
    data_set: SubstSet,
    key_vars: tuple[str, ...],
    store: ColumnStore,
    inplace_splits: bool = False,
) -> SubstSet:
    """Filter ``data_set`` to the substitutions whose key tuple occurs in
    ``filter_set`` (one sorted-membership test; survivors re-expressed
    with structure sharing through ``shuffle``)."""
    if data_set.is_empty() or filter_set.is_empty():
        return SubstSet(data_set.vars)
    f_idx = [filter_set.vars.index(v) for v in key_vars]
    d_idx = [data_set.vars.index(v) for v in key_vars]
    filter_keys = _unfold_cols(store, filter_set.items, f_idx)
    data_keys = _unfold_cols(store, data_set.items, d_idx)
    mask = multicol_member(data_keys, filter_keys)
    return _filter_items(store, data_set, mask, inplace_splits)


# --------------------------------------------------------------------- #
# cross-join (Algorithm 5)
# --------------------------------------------------------------------- #
def xjoin(
    left: SubstSet,
    right: SubstSet,
    key_vars: tuple[str, ...],
    store: ColumnStore,
) -> SubstSet:
    """General equi-join with structure-shared output: each right key
    group's non-key columns are compressed **once**; every matching left
    row then emits meta-substitutions referencing the group's
    meta-constants, with its own values as RLE-constant columns (paper
    Alg. 5 lines 63-72).  Empty ``key_vars`` is a Cartesian product."""
    out_vars = tuple(left.vars) + tuple(v for v in right.vars if v not in left.vars)
    out = SubstSet(out_vars)
    if left.is_empty() or right.is_empty():
        return out

    l_key_idx = [left.vars.index(v) for v in key_vars]
    r_key_idx = [right.vars.index(v) for v in key_vars]
    r_rest_vars = [v for v in right.vars if v not in key_vars and v not in left.vars]
    r_rest_idx = [right.vars.index(v) for v in r_rest_vars]

    l_keys = _unfold_cols(store, left.items, l_key_idx)
    r_keys = _unfold_cols(store, right.items, r_key_idx)
    l_all = _unfold_cols(store, left.items, list(range(len(left.vars))))
    r_rest = _unfold_cols(store, right.items, r_rest_idx)

    codes_l, codes_r = factorize_rows(l_keys, r_keys)

    # sort right by (key code, rest columns, fewest-distinct first inside
    # the group) so each group is compression-ready; sort left by key code
    if r_rest.shape[1] > 0:
        col_order = fewest_distinct_first(r_rest)
        keys = [r_rest[:, j] for j in reversed(col_order)] + [codes_r]
        r_perm = lexsort(keys)
    else:
        r_perm = torch.sort(codes_r, stable=True).indices
    codes_r_s = codes_r[r_perm]
    r_rest_s = r_rest[r_perm]
    codes_l_s, l_perm = torch.sort(codes_l, stable=True)
    l_all_s = l_all[l_perm]

    # group boundaries on the right
    n_r = codes_r_s.shape[0]
    new_group = torch.ones(n_r, dtype=torch.bool, device=store.device)
    new_group[1:] = codes_r_s[1:] != codes_r_s[:-1]
    r_starts = torch.nonzero(new_group).flatten()
    uniq_r = codes_r_s[r_starts]
    r_ends = torch.empty_like(r_starts)
    r_ends[:-1] = r_starts[1:]
    r_ends[-1] = n_r
    # the left span of every right group (join_bounds span probe)
    l_lo, l_hi = join_bounds(uniq_r.contiguous(), codes_l_s.contiguous())
    has_match = l_hi > l_lo
    m_starts = r_starts[has_match]
    m_ends = r_ends[has_match]
    m_l_lo = l_lo[has_match]
    m_l_hi = l_hi[has_match]
    if m_starts.shape[0] == 0:
        return out

    if r_rest_s.shape[1] > 0:
        # the paper's T is a *set* (Alg. 5 line 65): drop duplicate
        # rest-rows within each group (consecutive after the sort)
        dup = torch.zeros(n_r, dtype=torch.bool, device=store.device)
        if n_r > 1:
            dup[1:] = (r_rest_s[1:] == r_rest_s[:-1]).all(dim=1) & (
                codes_r_s[1:] == codes_r_s[:-1]
            )
        keep_rows = ~dup
        if int(dup.sum()):
            # remap group boundaries to the deduplicated index space
            pos = torch.cumsum(keep_rows, 0) - 1
            m_starts = pos[m_starts]
            kept_idx = torch.nonzero(keep_rows).flatten()
            m_ends = join_bounds(m_ends.contiguous(), kept_idx)[0].to(_I64)
            r_rest_s = r_rest_s[keep_rows]
        groups = compress_grouped(
            m_starts.cpu().numpy(), m_ends.cpu().numpy(), r_rest_s, store
        )
    else:
        groups = [[((), 1)] for _ in range(m_starts.shape[0])]

    # the per-left-row emission loop runs on the host: bring the spans
    # and the matching left rows there once
    lo_list = m_l_lo.tolist()
    hi_list = m_l_hi.tolist()
    l_host = l_all_s.cpu().tolist()
    n_left_vars = len(left.vars)
    # every emitted constant leaf, in creation order, made in one batch
    values: list[int] = []
    counts: list[int] = []
    emitted = []
    for g, (llo, lhi) in enumerate(zip(lo_list, hi_list)):
        pieces = groups[g]
        for li in range(llo, lhi):
            lrow = l_host[li]
            for piece_cols, plen in pieces:
                values.extend(lrow[:n_left_vars])
                counts.extend([plen] * n_left_vars)
                emitted.append((piece_cols, plen))
    ids = store.new_constants(values, counts)
    for e, (piece_cols, plen) in enumerate(emitted):
        cols = tuple(ids[e * n_left_vars: (e + 1) * n_left_vars]) + tuple(piece_cols)
        out.items.append((cols, plen))
    return out
