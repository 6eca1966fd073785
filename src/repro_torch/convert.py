"""Carry compressed state across from numpy arrays into the port.

The JAX package's state (its ``ColumnStore`` nodes, its meta-facts, its
datasets) is handed over as plain numpy arrays and tuples, so the port
imports nothing of that package.  With these, the same compressed state
can be fed to the port's ``match`` / ``sjoin`` / ``xjoin`` / ``elim_dup``
and to the reference's; :func:`incremental_from_numpy` hands over a whole
incremental store, so a batch can be applied to the same state in both
packages.  :func:`model_params_from_numpy` does the same for a model's
parameter tree, and :func:`train_state_from_numpy` for a whole train
state (parameters, AdamW moments and step, error feedback), so that both
packages take the same step from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.columns import ColumnStore, _Concat, _Leaf
from .core.metafacts import FactStore, MetaFact
from .core.util import resolve_device
from .incremental import IncrementalStore
from .incremental.eval import PhaseStats

__all__ = [
    "dataset_to_device",
    "facts_from_numpy",
    "incremental_from_numpy",
    "model_params_from_numpy",
    "store_from_numpy",
    "train_state_from_numpy",
]


def store_from_numpy(nodes: dict, next_id: int, device=None) -> ColumnStore:
    """A :class:`ColumnStore` with exactly the given nodes under their
    ids: ``nodes`` maps a meta-constant id to ``("leaf", run_values,
    run_counts)`` or ``("concat", children)``; ``next_id`` is the next id
    the store hands out.  ``device=None`` is the card."""
    store = ColumnStore(resolve_device(device))
    dev = store.device
    for cid in sorted(nodes):
        kind, *payload = nodes[cid]
        if kind == "leaf":
            rv = torch.as_tensor(np.asarray(payload[0], dtype=np.int64)).to(dev)
            rc = torch.as_tensor(np.asarray(payload[1], dtype=np.int64)).to(dev)
            node = _Leaf(rv, rc, int(np.asarray(payload[1]).sum()))
        elif kind == "concat":
            children = [int(c) for c in payload[0]]
            node = _Concat(children, 0)
        else:
            raise ValueError(f"node {cid}: unknown kind {kind!r}")
        store._nodes[int(cid)] = node
    # composite lengths and parent links once every node exists
    for cid, node in store._nodes.items():
        if isinstance(node, _Concat):
            for c in node.children:
                store._parents.setdefault(c, set()).add(cid)

    def length(cid: int) -> int:
        node = store._nodes[cid]
        if isinstance(node, _Concat) and node.length == 0 and node.children:
            node.length = sum(length(c) for c in node.children)
        return node.length

    for cid, node in store._nodes.items():
        length(cid)
        store._account_add(cid, node)
    store._next_id = int(next_id)
    return store


def facts_from_numpy(store: ColumnStore, meta_facts) -> FactStore:
    """A :class:`FactStore` over ``store`` holding ``meta_facts``, a list
    of ``(pred, column_ids, length, round)`` in order."""
    facts = FactStore(store)
    for pred, cols, length, rnd in meta_facts:
        facts.add(MetaFact(pred, tuple(int(c) for c in cols), int(length), int(rnd)))
    return facts


def dataset_to_device(dataset: dict, device=None) -> dict[str, torch.Tensor]:
    """``{pred: (n, k) int64 tensor}`` on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return {
        pred: torch.as_tensor(np.asarray(rows, dtype=np.int64)).to(dev)
        for pred, rows in dataset.items()
    }


def incremental_from_numpy(program, *, nodes: dict, next_id: int, meta_facts,
                           explicit: dict, rows: dict, counts: dict, epoch: int,
                           round_no: int, counting: bool = True,
                           device=None) -> IncrementalStore:
    """A port :class:`IncrementalStore` holding a reference store's state:
    its mu-nodes and next id (as for :func:`store_from_numpy`), its
    meta-facts (as for :func:`facts_from_numpy`), the explicit rows, the
    row index's rows and the count columns (``{pred: array}``), the epoch
    and the round counter that tags added meta-facts.  The journal and
    the plan cache start empty."""
    inc = IncrementalStore(program, counting=counting, device=device)
    dev = inc.device
    store = store_from_numpy(nodes, next_id, dev)
    facts = facts_from_numpy(store, meta_facts)
    inc.engine.store = inc.store = store
    inc.engine.facts = inc.facts = facts

    def tensors(arrays: dict) -> dict[str, torch.Tensor]:
        # copies: the store updates counts in place, which must never
        # write into the caller's arrays
        return {p: torch.tensor(np.asarray(a, dtype=np.int64), device=dev)
                for p, a in arrays.items()}

    inc.explicit = tensors(explicit)
    for pred, r in inc.explicit.items():
        inc.arities.setdefault(pred, int(r.shape[1]))
    for pred, r in tensors(rows).items():
        inc.rows.seed_sorted(pred, r)
    if counting:
        inc.counts = tensors(counts)
    inc.stats_view = PhaseStats(facts, inc.arities)
    inc.epoch = int(epoch)
    inc._round = int(round_no)
    return inc


def _flat_tree(tree) -> dict[str, torch.Tensor]:
    """A nested dict/list tree of arrays as ``{dotted path: f32 tensor}``
    on the CPU."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        items = node.items() if isinstance(node, dict) else (
            enumerate(node) if isinstance(node, (list, tuple)) else None)
        if items is None:
            out[prefix] = torch.from_numpy(np.array(node, dtype=np.float32))
            return
        for key, child in items:
            walk(f"{prefix}.{key}" if prefix else str(key), child)

    walk("", tree)
    return out


def _model_layout(cfg, out: dict[str, torch.Tensor], what: str) -> dict[str, torch.Tensor]:
    """``out``, after checking its names and shapes are exactly those of
    ``cfg``'s model's ``state_dict``."""
    from .models.transformer import Transformer

    want = {k: tuple(v.shape) for k, v in Transformer(cfg, "meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{cfg.name}: the {what} differs from the model's layout: {diff[:8]}")
    return out


def model_params_from_numpy(cfg, tree) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``models.transformer.Transformer(cfg, ...)``
    from the JAX package's parameter tree as numpy arrays (each stage's
    leaves stacked ``(n, ...)`` on the layer axis, a list of stages): the
    tree flattened with dots, every leaf an f32 tensor on the CPU.  Raises
    ``ValueError`` unless its names and shapes are exactly those of
    ``cfg``'s model."""
    return _model_layout(cfg, _flat_tree(tree), "tree")


def train_state_from_numpy(cfg, state: dict, device=None) -> dict:
    """The port's train state (``train.init_train_state``'s layout) from
    the JAX package's, given as numpy: ``params``, ``opt`` with ``mu``,
    ``nu`` and ``step``, and ``error_feedback`` where it has one.  The
    parameters become a ``Transformer`` on ``device`` (``None``: the
    card), the moments and the error buffer f32 dicts keyed by the
    parameters' dotted names, the step an int32 scalar."""
    from .models.transformer import Transformer

    dev = resolve_device(device)
    net = Transformer(cfg, dev)
    net.load_state_dict(model_params_from_numpy(cfg, state["params"]))

    def leaves(tree, what):
        return {k: v.to(dev) for k, v in _model_layout(cfg, _flat_tree(tree), what).items()}

    out = {"params": net, "opt": {
        "mu": leaves(state["opt"]["mu"], "mu tree"),
        "nu": leaves(state["opt"]["nu"], "nu tree"),
        "step": torch.tensor(int(np.asarray(state["opt"]["step"])), dtype=torch.int32,
                             device=dev),
    }}
    if "error_feedback" in state:
        out["error_feedback"] = leaves(state["error_feedback"], "error-feedback tree")
    return out
