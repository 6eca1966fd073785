"""GQA attention: chunked-causal training path + KV-cache decode path.

Training attention is *query-chunked*: scores are materialised only for
one query block at a time ((b, h, q_chunk, S) instead of (b, h, S, S)),
which bounds activation memory at long sequence lengths.  Scores and the
softmax run in f32, the products in the activation's dtype, as in the JAX
package; no library attention stands in for it.

``attention_decode`` writes the new token's K/V into the cache tensors in
place (at ``cache_len``) and returns them.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .layers import Params, apply_mrope, apply_rope, l2norm
from .sharding_policy import heads_mesh_dim

__all__ = ["NEG_INF", "Attention", "chunked_attention", "attention_apply",
           "attention_decode"]

NEG_INF = -1e30


class Attention(Params):
    def __init__(self, cfg, stack: int | None, device):
        super().__init__(stack, device)
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.add("wq", (d, h, hd))
        self.add("wk", (d, kv, hd))
        self.add("wv", (d, kv, hd))
        self.add("wo", (h, hd, d))
        if cfg.qk_norm:
            self.add("q_scale", (hd,), "ones")
            self.add("k_scale", (hd,), "ones")


def project(x, w):
    """``einsum("bsd,dhk->bshk")``."""
    w = w.to(x.dtype)
    if isinstance(w, DTensor) and any(p.is_shard(w.ndim - 1) for p in w.placements):
        return _project_gathered(x, w)
    return torch.einsum("bsd,dhk->bshk", x, w)


def _project_gathered(x, w):
    """:func:`project` of a weight whose head_dim is sharded (too few kv
    heads to shard them), on local tensors: DTensor would split the
    einsum's flattened (heads, head_dim) output over an axis that the heads
    cannot be split back from.  Every rank gathers the weight (a k or v
    projection, small) whole and projects its own tokens; the output keeps
    the tokens' layout, and the weight's gradient is a partial sum over the
    ranks that hold other tokens."""
    mesh = x.device_mesh
    x = x.redistribute(mesh, tuple(p if p.is_shard() and p.dim < 2 else Replicate()
                                   for p in x.placements))
    w_loc = w.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=tuple(Partial() if p.is_shard() else Replicate()
                              for p in x.placements))
    y = torch.einsum("bsd,dhk->bshk", x.to_local(), w_loc)
    return DTensor.from_local(y, mesh, x.placements)


def out_project(out, wo):
    """``einsum("bshk,hkd->bsd")``."""
    return torch.einsum("bshk,hkd->bsd", out, wo.to(out.dtype))


def _project_qkv(params, x, cfg, positions, mrope_positions=None):
    dtype = x.dtype
    q = project(x, params["wq"])
    k = project(x, params["wk"])
    v = project(x, params["wv"])
    if cfg.qk_norm:
        q = l2norm(q) * params["q_scale"].to(dtype)
        k = l2norm(k) * params["k_scale"].to(dtype)
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0):
    """Query-chunked attention.

    q: (b, s_q, h, hd); k, v: (b, s_kv, n_kv, hd).  GQA is expressed by
    reshaping q to (b, s, n_kv, group, hd) so the einsum never tiles KV.
    """
    if isinstance(q, DTensor):
        return _on_local_heads(functools.partial(chunked_attention, causal=causal, chunk=chunk,
                                                 q_offset=q_offset), q, k, v)
    b, s_q, h, hd = q.shape
    n_kv = k.shape[2]
    group = h // n_kv
    q = q.reshape(b, s_q, n_kv, group, hd) * hd**-0.5

    n_chunks = max(s_q // chunk, 1)
    chunk = s_q // n_chunks
    kv_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for idx in range(n_chunks):
        qc = q[:, idx * chunk:(idx + 1) * chunk]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qc, k).float()
        if causal:
            q_pos = q_offset + idx * chunk + torch.arange(chunk, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]  # (chunk, s_kv)
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(qc.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", probs, v))
    return torch.cat(outs, dim=1).reshape(b, s_q, h, hd)


def attention_apply(params, x, cfg, positions, *, causal: bool = True,
                    mrope_positions=None):
    """Full-sequence (training / prefill) attention."""
    q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
    out = chunked_attention(q, k, v, causal=causal, chunk=min(cfg.attn_chunk, x.shape[1]))
    return out_project(out, params["wo"])


def attention_decode(params, x, cfg, cache_k, cache_v, cache_len: int, *,
                     mrope_positions=None):
    """Single-token decode against a KV cache.

    x: (b, 1, d); cache_k/v: (b, S, n_kv, hd), written in place at
    ``cache_len`` — the number of valid entries before this token.
    """
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, mrope_positions)
    cache_k[:, cache_len] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v_new[:, 0].to(cache_v.dtype)
    if isinstance(q, DTensor):
        out = _on_local_heads(functools.partial(_decode_attend, cache_len=cache_len),
                              q, cache_k, cache_v)
    else:
        out = _decode_attend(q, cache_k, cache_v, cache_len)
    return out_project(out, params["wo"]), cache_k, cache_v


def _decode_attend(q, cache_k, cache_v, cache_len: int):
    """One query position against the cache's first ``cache_len + 1``."""
    dtype = q.dtype
    b, _, h, hd = q.shape
    n_kv = cache_k.shape[2]
    qg = q.reshape(b, 1, n_kv, h // n_kv, hd) * hd**-0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.to(dtype)).float()
    valid = torch.arange(cache_k.shape[1], device=q.device) <= cache_len
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.to(dtype)).reshape(b, 1, h, hd)


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (an attention over ``(b, s, heads, hd)`` tensors) on
    each rank's local tensors: its batch shard, its query heads where they
    divide the ``model`` axis, and the kv heads those group onto, with
    the sequences gathered.  The queries' grouping reshape splits the
    heads dimension, which DTensor cannot do where the heads are sharded
    over more ranks than there are kv heads, and whose redistributions
    it plans slowly on a three-axis mesh; every op of an attention is
    local to a batch shard and a kv group.  The kv gradients are partial
    sums over ``model`` where each rank holds kv heads that others hold
    too."""
    mesh = q.device_mesh
    heads = heads_mesh_dim(mesh, q.shape[2])
    q_at = tuple(Shard(2) if i == heads else Shard(0) if p.is_shard(0) else Replicate()
                 for i, p in enumerate(q.placements))
    kv_heads_split = heads is not None and k.shape[2] % mesh.size(heads) == 0
    kv_at = tuple(Replicate() if i == heads and not kv_heads_split else p
                  for i, p in enumerate(q_at))
    kv_grad = tuple(Partial() if i == heads and not kv_heads_split else p
                    for i, p in enumerate(q_at))
    q_loc = q.redistribute(mesh, q_at).to_local()
    k_loc = k.redistribute(mesh, kv_at).to_local(grad_placements=kv_grad)
    v_loc = v.redistribute(mesh, kv_at).to_local(grad_placements=kv_grad)
    if heads is not None and not kv_heads_split:
        group = q.shape[2] // k.shape[2]
        h_loc = q_loc.shape[2]
        h0 = mesh.get_local_rank(heads) * h_loc
        lo, hi = h0 // group, (h0 + h_loc - 1) // group + 1
        if h_loc % (hi - lo) or (hi - lo > 1 and h_loc != group * (hi - lo)):
            raise ValueError(f"{h_loc} query heads a rank do not group onto whole kv heads "
                             f"({q.shape[2]} heads, {k.shape[2]} kv heads)")
        k_loc, v_loc = k_loc[:, :, lo:hi], v_loc[:, :, lo:hi]
    return DTensor.from_local(fn(q_loc, k_loc, v_loc), mesh, q_at)
