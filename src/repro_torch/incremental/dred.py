"""Delete/Rederive (DRed) over meta-facts, per recursive stratum.

Incremental deletion for a recursive stratum runs the classic three
phases set-at-a-time over the compressed representation:

* **overdelete**: propagate the deleted delta through the stratum's rules
  (pivot = the delta, other atoms read the pre-deletion view), collecting
  every materialised fact whose derivation may have passed through a
  deleted fact;
* **delete**: remove the overdeleted rows; untouched meta-facts keep
  sharing their columns, partially hit ones are split copy-mode;
* **rederive (Backward/Forward)**: restore overdeleted facts that are
  still explicit, then run a backward-bounded probe per rule (every atom
  scan semi-joined against the missing head bindings first), and
  propagate the restorations forward semi-naively until the missing set
  stops shrinking.

All evaluation intermediates live in a :meth:`ColumnStore.mark` /
``release`` scratch region; only split survivors and restored meta-facts
persist.  Rows are int64 tensors on the store's device.
"""

from __future__ import annotations

import time

import torch

from ..core.compile import SRC_DELTA
from ..core.util import multicol_member, unique_rows
from ..obs import span
from .eval import (
    evaluate_rule,
    head_binding_filter,
    project_head,
    rows_to_metafacts,
)
from .index import merge_rows, setdiff_rows

__all__ = ["dred_stratum", "explicit_restores"]


def explicit_restores(
    missing: dict[str, torch.Tensor], explicit: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Overdeleted rows that are still explicit facts: they come back
    without any derivability probe (the first rederivation step, shared
    with the distributed engine's ``apply``)."""
    out: dict[str, torch.Tensor] = {}
    for pred, miss in missing.items():
        present = explicit.get(pred)
        if present is None or present.shape[0] == 0 or miss.shape[0] == 0:
            continue
        back = miss[multicol_member(miss, present)]
        if back.shape[0]:
            out[pred] = back
    return out


def dred_stratum(inc, stratum, seeds, head_dels, st) -> dict[str, torch.Tensor]:
    """Maintain one recursive stratum under deletion.

    ``seeds`` are the net-removed rows of lower-strata/EDB predicates;
    ``head_dels`` the explicit deletions of this stratum's head
    predicates.  Returns the net-removed rows per head predicate (the
    deltas later strata see).  ``inc`` is the :class:`IncrementalStore`.
    """
    store, facts = inc.store, inc.facts
    with span("dred.overdelete") as sp:
        over = _overdelete(inc, stratum, seeds, head_dels, st)
        sp.set(n_overdeleted=sum(int(r.shape[0]) for r in over.values()))
    if not over:
        return {}
    for pred, rows in over.items():
        inc.record_provenance("overdelete", pred, n_new=rows.shape[0])
    t0 = time.perf_counter()
    with span("dred.delete"):
        missing: dict[str, torch.Tensor] = {}
        for pred, rows in over.items():
            inc.delete_rows(pred, rows)
            missing[pred] = rows
    st.time_delete += time.perf_counter() - t0

    t0 = time.perf_counter()
    with span("dred.rederive") as rede:
        # --- rederive: explicit survivors come back without a probe --- #
        delta_mfs: dict[str, list] = {}
        for pred, back in explicit_restores(missing, inc.explicit).items():
            delta_mfs[pred] = inc.add_rows(pred, back)
            missing[pred] = setdiff_rows(missing[pred], back)
            st.n_rederived += int(back.shape[0])
            inc.record_provenance(
                "survive_explicit", pred,
                n_new=back.shape[0], out_mfs=delta_mfs[pred],
            )

        def current(pred: str, src: str = "") -> list:
            return facts.all(pred)

        # --- backward pass: bounded one-step rederivability check ----- #
        for rule in stratum:
            if not rule.body:
                continue
            pred = rule.head.predicate
            miss = missing.get(pred)
            if miss is None or miss.shape[0] == 0:
                continue
            mark = store.mark()
            hf = head_binding_filter(rule.head, miss, store)
            L = evaluate_rule(
                rule, None, current, store, inc.stats_view, inc.plan_cache,
                head_filter=hf,
            )
            st.n_rule_applications += 1
            if L is None:
                store.release(mark)
                continue
            rows, _ = project_head(rule.head, L, store)
            store.release(mark)
            back = rows[multicol_member(rows, miss)]
            if back.shape[0]:
                mfs = inc.add_rows(pred, back)
                delta_mfs.setdefault(pred, []).extend(mfs)
                missing[pred] = setdiff_rows(miss, back)
                st.n_rederived += int(back.shape[0])
                inc.record_provenance(
                    "survive_backward", pred,
                    rule_id=inc._rule_ids.get(rule, -1),
                    n_emitted=rows.shape[0], n_new=back.shape[0],
                    out_mfs=mfs,
                )

        # --- forward pass: restorations propagate semi-naively -------- #
        while delta_mfs:
            def sources(pred: str, src: str) -> list:
                if src == SRC_DELTA:
                    return delta_mfs.get(pred, [])
                return facts.all(pred)

            mark = store.mark()
            derived: dict[str, list[torch.Tensor]] = {}
            for rule in stratum:
                pred = rule.head.predicate
                miss = missing.get(pred)
                if miss is None or miss.shape[0] == 0:
                    continue
                hf = head_binding_filter(rule.head, miss, store)
                for i, atom in enumerate(rule.body):
                    if atom.predicate not in delta_mfs:
                        continue
                    L = evaluate_rule(
                        rule, i, sources, store, inc.stats_view,
                        inc.plan_cache, head_filter=hf,
                    )
                    st.n_rule_applications += 1
                    if L is None:
                        continue
                    rows, _ = project_head(rule.head, L, store)
                    derived.setdefault(pred, []).append(rows)
            store.release(mark)

            new_delta: dict[str, list] = {}
            for pred, blocks in derived.items():
                cand = unique_rows(torch.cat(blocks))
                back = cand[multicol_member(cand, missing[pred])]
                if back.shape[0]:
                    new_delta[pred] = inc.add_rows(pred, back)
                    missing[pred] = setdiff_rows(missing[pred], back)
                    st.n_rederived += int(back.shape[0])
                    inc.record_provenance(
                        "rederive", pred,
                        n_emitted=cand.shape[0], n_new=back.shape[0],
                        out_mfs=new_delta[pred],
                    )
            delta_mfs = new_delta
        rede.set(
            n_missing=sum(int(m.shape[0]) for m in missing.values())
        )
    st.time_rederive += time.perf_counter() - t0

    net = {p: m for p, m in missing.items() if m.shape[0]}
    st.n_deleted += sum(int(m.shape[0]) for m in net.values())
    return net


def _overdelete(inc, stratum, seeds, head_dels, st) -> dict[str, torch.Tensor]:
    """Propagate deletions through the stratum over the pre-deletion
    view; returns the overdeleted rows per head predicate."""
    t0 = time.perf_counter()
    store = inc.store
    over: dict[str, torch.Tensor] = {}
    delta: dict[str, torch.Tensor] = {
        p: r for p, r in seeds.items() if r.shape[0]
    }
    for pred, rows in head_dels.items():
        rows = rows[inc.rows.member_mask(pred, rows)]
        if rows.shape[0]:
            over[pred] = rows
            delta[pred] = merge_rows(delta.get(pred), rows)

    def pre_view(pred: str) -> list:
        return inc.pre_mfs.get(pred, [])

    while delta:
        mark = store.mark()
        delta_mfs = {
            p: rows_to_metafacts(p, r, store) for p, r in delta.items()
        }

        def sources(pred: str, src: str) -> list:
            if src == SRC_DELTA:
                return delta_mfs.get(pred, [])
            return pre_view(pred)

        match_cache: dict = {}
        derived: dict[str, list[torch.Tensor]] = {}
        for rule in stratum:
            if not rule.body:
                continue
            for i, atom in enumerate(rule.body):
                if atom.predicate not in delta_mfs:
                    continue
                L = evaluate_rule(
                    rule, i, sources, store, inc.stats_view, inc.plan_cache,
                    match_cache=match_cache,
                )
                st.n_rule_applications += 1
                if L is None:
                    continue
                rows, _ = project_head(rule.head, L, store)
                derived.setdefault(rule.head.predicate, []).append(rows)
        store.release(mark)

        new_delta: dict[str, torch.Tensor] = {}
        for pred, blocks in derived.items():
            cand = unique_rows(torch.cat(blocks))
            # only materialised facts can be overdeleted, each only once
            cand = cand[inc.rows.member_mask(pred, cand)]
            prev = over.get(pred)
            if prev is not None and prev.shape[0]:
                cand = setdiff_rows(cand, prev)
            if cand.shape[0]:
                over[pred] = merge_rows(prev, cand)
                new_delta[pred] = cand
        delta = new_delta

    st.n_overdeleted += sum(int(r.shape[0]) for r in over.values())
    st.time_overdelete += time.perf_counter() - t0
    return over
