"""Multi-head Latent Attention (DeepSeek-V2/V3).

Queries and KV are projected through low-rank latents; only the compressed
KV latent (kv_lora_rank) plus the shared RoPE key (qk_rope_dim) are cached
at decode time.  The decode path uses the *absorbed* formulation: W_UK is
folded into the query and W_UV into the output so scores and values are
computed directly against the cached latent.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .attention import NEG_INF, out_project, project
from .layers import Params, RMSNorm, apply_rope, rmsnorm
from .sharding_policy import heads_mesh_dim

__all__ = ["MLA", "mla_apply", "mla_decode"]


class MLA(Params):
    def __init__(self, cfg, stack: int | None, device):
        super().__init__(stack, device)
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        self.add("wq_a", (d, m.q_lora_rank))
        self.q_norm = RMSNorm(m.q_lora_rank, stack, device)
        self.add("wq_b", (m.q_lora_rank, h, m.qk_nope_dim + m.qk_rope_dim))
        self.add("wkv_a", (d, m.kv_lora_rank + m.qk_rope_dim))
        self.kv_norm = RMSNorm(m.kv_lora_rank, stack, device)
        self.add("wk_b", (m.kv_lora_rank, h, m.qk_nope_dim))
        self.add("wv_b", (m.kv_lora_rank, h, m.v_head_dim))
        self.add("wo", (h, m.v_head_dim, d))


def _project_latents(params, x, cfg, positions):
    """Shared Q/KV latent computation; returns per-head q and the caches."""
    m = cfg.mla
    dtype = x.dtype
    cq = rmsnorm(params["q_norm"], x @ params["wq_a"].to(dtype))
    q = project(cq, params["wq_b"])
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = x @ params["wkv_a"].to(dtype)
    c_kv = rmsnorm(params["kv_norm"], ckv_full[..., : m.kv_lora_rank])
    k_rope = ckv_full[..., m.kv_lora_rank:][:, :, None, :]  # (b, s, 1, rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(params, x, cfg, positions, *, causal: bool = True):
    """Training / prefill path: materialise per-head K/V and attend."""
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _project_latents(params, x, cfg, positions)
    k_nope = project(c_kv, params["wk_b"])
    v = project(c_kv, params["wv_b"])

    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    chunk = min(cfg.attn_chunk, q_nope.shape[1])
    attend = functools.partial(_attend, scale=scale, chunk=chunk, causal=causal)
    if isinstance(q_nope, DTensor):
        out = _on_local_heads(attend, (q_nope, q_rope, k_nope, v), (k_rope,))
    else:
        out = attend(q_nope, q_rope, k_nope, v, k_rope)
    return out_project(out, params["wo"])


def _attend(q_nope, q_rope, k_nope, v, k_rope, *, scale: float, chunk: int, causal: bool):
    """Query-chunked attention over per-head K/V and the shared RoPE key."""
    dtype = q_nope.dtype
    s = q_nope.shape[1]
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    kv_pos = torch.arange(s, device=q_nope.device)
    outs = []
    for idx in range(n_chunks):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        scores = (
            torch.einsum("bqhk,bshk->bhqs", q_nope[:, sl], k_nope)
            + torch.einsum("bqhk,bsk->bhqs", q_rope[:, sl], k_rope)
        ).float() * scale
        if causal:
            q_pos = idx * chunk + torch.arange(chunk, device=q_nope.device)
            scores = torch.where(kv_pos[None, :] <= q_pos[:, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        outs.append(torch.einsum("bhqs,bshk->bqhk", probs, v))
    return torch.cat(outs, dim=1)


def _on_local_heads(fn, heads: tuple, shared: tuple):
    """``fn(*heads, *shared)`` on each rank's local tensors: its batch
    shard and its heads (dimension 2 of each of ``heads``, split alike
    over ``model`` where they divide it), ``shared`` (no heads dimension) whole
    over ``model`` with their gradients partial sums there.  As
    ``attention._on_local_heads``: DTensor plans these einsums'
    redistributions slowly on a three-axis mesh, and every op of the
    attention is local to a batch shard and a head."""
    first = heads[0]
    mesh = first.device_mesh
    split = heads_mesh_dim(mesh, first.shape[2])
    at = tuple(Shard(2) if i == split else Shard(0) if p.is_shard(0) else Replicate()
               for i, p in enumerate(first.placements))
    whole = tuple(Replicate() if i == split else p for i, p in enumerate(at))
    grad = tuple(Partial() if i == split else p for i, p in enumerate(at))
    local = [t.redistribute(mesh, at).to_local() for t in heads]
    local += [t.redistribute(mesh, whole).to_local(grad_placements=grad) for t in shared]
    return DTensor.from_local(fn(*local), mesh, at)


def mla_decode(params, x, cfg, cache_ckv, cache_krope, cache_len: int):
    """Absorbed single-token decode; the caches are written in place.

    cache_ckv: (b, S, kv_lora_rank); cache_krope: (b, S, qk_rope_dim).
    Scores:  q_nope W_UK^T . c_kv  +  q_rope . k_rope
    Output:  (probs . c_kv) W_UV   -> heads -> W_O
    """
    m = cfg.mla
    dtype = x.dtype
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _project_latents(params, x, cfg, positions)
    cache_ckv[:, cache_len] = c_kv_new[:, 0].to(cache_ckv.dtype)
    cache_krope[:, cache_len] = k_rope_new[:, 0].to(cache_krope.dtype)
    # absorb W_UK into q: (b,1,h,nope) x (r,h,nope) -> (b,1,h,r)
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, params["wk_b"].to(dtype))
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    attend = functools.partial(_attend_latent, scale=scale, cache_len=cache_len)
    if isinstance(q_lat, DTensor):
        out_lat = _on_local_heads(attend, (q_lat, q_rope), (cache_ckv, cache_krope))
    else:
        out_lat = attend(q_lat, q_rope, cache_ckv, cache_krope)
    out = torch.einsum("bqhr,rhk->bqhk", out_lat, params["wv_b"].to(dtype))
    return out_project(out, params["wo"]), cache_ckv, cache_krope


def _attend_latent(q_lat, q_rope, cache_ckv, cache_krope, *, scale: float, cache_len: int):
    """One query position against the latent cache's first ``cache_len +
    1``; the attention-weighted latent ``(b, 1, h, r)``."""
    dtype = q_lat.dtype
    scores = (
        torch.einsum("bqhr,bsr->bhqs", q_lat, cache_ckv.to(dtype))
        + torch.einsum("bqhk,bsk->bhqs", q_rope, cache_krope.to(dtype))
    ).float() * scale
    valid = torch.arange(cache_ckv.shape[1], device=q_lat.device) <= cache_len
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqs,bsr->bqhr", probs, cache_ckv.to(dtype))
