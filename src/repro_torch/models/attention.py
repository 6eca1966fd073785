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

import torch

from .layers import Params, apply_mrope, apply_rope, l2norm

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
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


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
    dtype = x.dtype
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, mrope_positions)
    cache_k[:, cache_len] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v_new[:, 0].to(cache_v.dtype)
    b, _, h, hd = q.shape
    n_kv = cache_k.shape[2]
    qg = q.reshape(b, 1, n_kv, h // n_kv, hd) * hd**-0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.to(dtype)).float()
    valid = torch.arange(cache_k.shape[1], device=x.device) <= cache_len
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.to(dtype)).reshape(b, 1, h, hd)
    return out_project(out, params["wo"]), cache_k, cache_v
