"""KB-to-token linearisation: where the paper's engine feeds LM training.

The knowledge base materialised by the port's ``CMatEngine`` (the
paper's CompMat) is linearised into token sequences for KB-grounded
language-model training:

    <S> predicate subject [object] <E> <S> ...

Token ids are offset so constants, predicates and specials occupy
disjoint id ranges inside the model's vocabulary.  The linearisation
iterates *meta-facts*: every column unfolds on the engine's device, in
one ``rle_expand`` for the leaves not yet unfolded, the tokens are laid
out there, and the stream is copied to the host once.  It equals the JAX
package's stream token for token, the hash-bucketing of constants that
outnumber the vocabulary included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.engine import CMatEngine

__all__ = ["KBTokenizer", "linearise_materialisation"]

TOK_BOS = 0
TOK_EOS = 1
TOK_SEP = 2
N_SPECIALS = 3


class KBTokenizer:
    """Maps predicates/constants into a model vocabulary."""

    def __init__(self, n_constants: int, predicates: list[str], vocab_size: int):
        self.pred_of = {p: N_SPECIALS + i for i, p in enumerate(sorted(predicates))}
        self.const_base = N_SPECIALS + len(self.pred_of)
        self.vocab_size = vocab_size
        if self.const_base + n_constants > vocab_size:
            # fold constants into the available range (hash-bucketing):
            # standard trick for entity vocabularies larger than the LM's
            self.n_buckets = vocab_size - self.const_base
        else:
            self.n_buckets = n_constants

    def constant(self, cid: int) -> int:
        return self.const_base + (int(cid) % max(self.n_buckets, 1))

    def predicate(self, pred: str) -> int:
        return self.pred_of[pred]


def linearise_materialisation(
    engine: CMatEngine, vocab_size: int, max_facts: int | None = None
) -> np.ndarray:
    """Emit an int32 token stream from a materialised ``CMatEngine``."""
    store = engine.store
    preds = sorted(engine.facts.predicates())
    meta_facts = [(pred, mf) for pred in preds for mf in engine.facts.all(pred)]
    cids = [c for _, mf in meta_facts for c in mf.columns]
    values = store.unfold_cat(cids)
    # every column of every meta-fact, emitted or not, sizes the vocabulary
    n_constants = int(values.max()) + 1 if values.numel() else 0
    tok = KBTokenizer(n_constants, preds, vocab_size)
    n_buckets = max(tok.n_buckets, 1)
    columns = iter(torch.split(values, [store.length(c) for c in cids]))
    blocks: list[torch.Tensor] = []
    emitted = 0
    stopped: set[str] = set()
    for pred, mf in meta_facts:
        cols = [next(columns) for _ in mf.columns]
        if pred in stopped:
            continue
        n = mf.length
        if max_facts is not None and emitted + n > max_facts:
            n = max_facts - emitted
            if n <= 0:
                stopped.add(pred)
                continue
        # layout per fact: BOS pred c1 [c2] EOS
        fill = torch.full((n, 1), TOK_BOS, dtype=torch.int64, device=values.device)
        block = torch.cat(
            [fill, fill + tok.predicate(pred)]
            + [(tok.const_base + col[:n] % n_buckets)[:, None] for col in cols]
            + [fill + TOK_EOS], dim=1,
        )
        blocks.append(block.to(torch.int32).reshape(-1))
        emitted += n
    if not blocks:
        return np.zeros((0,), dtype=np.int32)
    return torch.cat(blocks).cpu().numpy()
