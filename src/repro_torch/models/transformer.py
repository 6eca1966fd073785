"""Model composition: stage-structured transformer / SSM / hybrid LMs.

A model is a sequence of homogeneous *stages*; each stage is a stack of
identical layers whose parameters are stacked on a leading axis (the JAX
package's parameter tree, so that weights carry over leaf for leaf), run
one layer after another.  Stage kinds, one module each:

  attn_mlp   dense transformer block (GQA + SwiGLU)
  attn_moe   GQA + shared/routed MoE
  mla_mlp    multi-head latent attention + SwiGLU (DeepSeek dense prefix)
  mla_moe    MLA + MoE (DeepSeek-V3)
  mamba1     Mamba-1 selective-scan block
  mamba2     Mamba-2 (SSD) block; hybrid models inject a *shared*
             attention block every ``cfg.attn_every`` layers (Zamba2)
  xattn_mlp  decoder block with cross-attention (encoder-decoder)

Entry points: :class:`Transformer` (the parameters), ``init_params``,
``forward_train`` (loss), ``forward_logits`` (prefill), ``init_cache`` +
``decode_step`` (serving; the cache is written in place).  The forwards
take the module or its ``param_tree``.

Under a sharding policy (``sharding_policy``) the forwards pin a
DTensor's layout at the JAX package's four anchor points: the embedded
tokens and each layer's residual stream ``(batch, seq, -)``, the logits
``(batch, -, model)``; on plain tensors the anchors are no-ops.

While autograd records, each layer of a stage runs under activation
checkpointing (``REMAT_POLICY``, as in the JAX package's layer scan):
``"full"`` recomputes the whole layer in the backward pass, ``"dots"``
saves the projections' products and recomputes the rest.  Under
``torch.no_grad`` or ``torch.inference_mode`` nothing is checkpointed.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from . import attention, mla, moe, ssm
from .sharding_policy import constrain
from .layers import (
    COMPUTE_DTYPE,
    MLP,
    Embedding,
    RMSNorm,
    as_tree,
    embed_tokens,
    init_module_,
    mlp_apply,
    rmsnorm,
    tree_leaves,
    tree_map,
    unembed,
)

__all__ = ["stage_plan", "LAYER_KINDS", "Transformer", "init_params", "forward_hidden",
           "forward_logits", "forward_train", "init_cache", "decode_step", "REMAT_POLICY",
           "set_remat_policy"]


# --------------------------------------------------------------------- #
# stage plan
# --------------------------------------------------------------------- #
def stage_plan(cfg) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "vlm"):
        return [("attn_mlp", cfg.n_layers)]
    if cfg.family == "moe":
        dense, mixed = ("mla_mlp", "mla_moe") if cfg.mla is not None else ("attn_mlp", "attn_moe")
        plan = []
        if cfg.moe.first_k_dense:
            plan.append((dense, cfg.moe.first_k_dense))
        plan.append((mixed, cfg.n_layers - cfg.moe.first_k_dense))
        return plan
    if cfg.family in ("ssm", "hybrid"):
        return [("mamba2" if cfg.ssm.variant == "mamba2" else "mamba1", cfg.n_layers)]
    if cfg.family == "encdec":
        return [("xattn_mlp", cfg.n_layers)]
    raise ValueError(f"unknown family {cfg.family}")


# --------------------------------------------------------------------- #
# one module per layer kind (``stack`` layers, or one when None)
# --------------------------------------------------------------------- #
class AttnMLP(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.attn = attention.Attention(cfg, stack, device)
        self.norm2 = RMSNorm(cfg.d_model, stack, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, stack, device)


class AttnMoE(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.attn = attention.Attention(cfg, stack, device)
        self.norm2 = RMSNorm(cfg.d_model, stack, device)
        self.moe = moe.MoE(cfg, stack, device)


class MLAMLP(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.attn = mla.MLA(cfg, stack, device)
        self.norm2 = RMSNorm(cfg.d_model, stack, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, stack, device)


class MLAMoE(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.attn = mla.MLA(cfg, stack, device)
        self.norm2 = RMSNorm(cfg.d_model, stack, device)
        self.moe = moe.MoE(cfg, stack, device)


class Mamba1Layer(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.mixer = ssm.Mamba1(cfg, stack, device)


class Mamba2Layer(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.mixer = ssm.Mamba2(cfg, stack, device)


class XAttnMLP(nn.Module):
    def __init__(self, cfg, stack, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, stack, device)
        self.attn = attention.Attention(cfg, stack, device)
        self.norm_x = RMSNorm(cfg.d_model, stack, device)
        self.xattn = attention.Attention(cfg, stack, device)
        self.norm2 = RMSNorm(cfg.d_model, stack, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, stack, device)


LAYER_KINDS = {
    "attn_mlp": AttnMLP, "attn_moe": AttnMoE, "mla_mlp": MLAMLP, "mla_moe": MLAMoE,
    "mamba1": Mamba1Layer, "mamba2": Mamba2Layer, "xattn_mlp": XAttnMLP,
}


class Transformer(nn.Module):
    """Every parameter of a model, named and shaped as the JAX package's
    tree: ``stages.<i>.kind_params.<block>.<leaf>`` stacked ``(n, ...)``,
    ``embedding``, ``final_norm``, and ``shared_attn`` (hybrid),
    ``encoder`` (encdec), ``mtp`` / ``mtp_norm`` (multi-token prediction)
    where the config has them.  Leaves are f32 and left uninitialised
    (``init_params`` fills them); on ``meta`` they take no memory."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        self.embedding = Embedding(cfg.vocab_size, d, cfg.tie_embeddings, device)
        self.stages = nn.ModuleList(
            nn.ModuleDict({"kind_params": LAYER_KINDS[kind](cfg, n, device)})
            for kind, n in stage_plan(cfg)
        )
        self.final_norm = RMSNorm(d, None, device)
        if cfg.family == "hybrid" and cfg.attn_every:
            self.shared_attn = nn.ModuleDict({
                "norm": RMSNorm(d, None, device),
                "attn": attention.Attention(cfg, None, device),
            })
        if cfg.family == "encdec":
            self.encoder = nn.ModuleDict({
                "layers": AttnMLP(cfg, cfg.n_encoder_layers, device),
                "final_norm": RMSNorm(d, None, device),
            })
        if cfg.mtp_depth:
            self.mtp = AttnMLP(cfg, None, device)
            self.mtp_norm = RMSNorm(d, None, device)


def init_params(generator: torch.Generator, cfg) -> Transformer:
    """A :class:`Transformer` on ``generator``'s device, its leaves drawn
    from ``generator`` with the JAX package's init rules (the values are
    the generator's, not ``jax.random``'s)."""
    return init_module_(Transformer(cfg, generator.device), generator)


# --------------------------------------------------------------------- #
# forward layers
# --------------------------------------------------------------------- #
def _layer(stage, i: int):
    """Layer ``i``'s parameters: every stacked leaf indexed at ``i``."""
    return tree_map(lambda a: a[i], stage)


def _residual(x):
    """The residual stream pinned to its layout, (b@dp, s[, @model if
    SP], d): a sublayer's output arrives as a partial sum over ``model``
    (its tensor-parallel product), which DTensor would otherwise carry
    into the next sublayer's products and replicate their weights."""
    return constrain(x, ("batch", "seq", None))


def _apply_layer(kind, lp, x, cfg, positions, *, causal=True, memory=None,
                 mrope_positions=None):
    """One layer forward; returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn_mlp", "attn_moe", "mla_mlp", "mla_moe"):
        h = rmsnorm(lp["norm1"], x)
        if kind.startswith("mla"):
            x = _residual(x + mla.mla_apply(lp["attn"], h, cfg, positions, causal=causal))
        else:
            x = _residual(x + attention.attention_apply(
                lp["attn"], h, cfg, positions, causal=causal, mrope_positions=mrope_positions))
        h = rmsnorm(lp["norm2"], x)
        if kind.endswith("mlp"):
            x = _residual(x + mlp_apply(lp["mlp"], h))
        else:
            y, aux = moe.moe_apply(lp["moe"], h, cfg)
            x = _residual(x + y)
    elif kind == "mamba1":
        x = _residual(x + ssm.mamba1_apply(lp["mixer"], rmsnorm(lp["norm1"], x), cfg))
    elif kind == "mamba2":
        x = _residual(x + ssm.mamba2_apply(lp["mixer"], rmsnorm(lp["norm1"], x), cfg))
    elif kind == "xattn_mlp":
        h = rmsnorm(lp["norm1"], x)
        x = _residual(x + attention.attention_apply(lp["attn"], h, cfg, positions, causal=True))
        h = rmsnorm(lp["norm_x"], x)
        x = _residual(x + _cross_attention(lp["xattn"], h, memory, cfg))
        h = rmsnorm(lp["norm2"], x)
        x = _residual(x + mlp_apply(lp["mlp"], h))
    else:
        raise ValueError(kind)
    return x, aux


def _cross_attention(params, x, memory, cfg):
    """Decoder->encoder cross attention (no RoPE on memory keys)."""
    q = attention.project(x, params["wq"])
    k = attention.project(memory, params["wk"])
    v = attention.project(memory, params["wv"])
    out = attention.chunked_attention(q, k, v, causal=False,
                                      chunk=min(cfg.attn_chunk, x.shape[1]))
    return attention.out_project(out, params["wo"])


def _shared_attn(params, x, cfg, positions):
    """Zamba2-style shared attention block."""
    sa = params["shared_attn"]
    h = rmsnorm(sa["norm"], x)
    return _residual(x + attention.attention_apply(sa["attn"], h, cfg, positions, causal=True))


#: per-layer remat policy: 'full' recomputes everything in the backward
#: pass (least memory); 'dots' saves the outputs of the matrix products
#: without batch dimensions (``aten.mm`` / ``aten.addmm``: the
#: projections, not the attention scores' ``bmm``), as the JAX package's
#: ``dots_with_no_batch_dims_saveable``.  Either gives the same values.
REMAT_POLICY = "full"


def set_remat_policy(name: str) -> None:
    global REMAT_POLICY
    if name not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {name!r} (full or dots)")
    REMAT_POLICY = name


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, *args):
    """``fn(*args)``, checkpointed under ``REMAT_POLICY`` while autograd
    records.  The recompute replays the forward's MoE routes
    (``moe.route_tape``): a route hook is called once, and the
    recomputed tensors keep the forward's shapes."""
    if not torch.is_grad_enabled():
        return fn(*args)
    experts, runs = [], []

    def run(*a):
        with moe.route_tape(experts, replay=bool(runs)):
            runs.append(None)
            return fn(*a)

    extra = {}
    if REMAT_POLICY == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                _dots_saveable)
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **extra)


def _unstack(stage_params, n_layers: int) -> list:
    """Each layer's parameters, as views by ``unbind``: under autograd
    one gradient buffer per stacked leaf, where indexing layer by layer
    makes one for every layer."""
    rows = tree_map(lambda a: a.unbind(0), stage_params)
    return [tree_map(lambda r: r[i], rows) for i in range(n_layers)]


def _run_stage(stage_params, kind, x, cfg, positions, params, *, causal=True,
               memory=None, mrope_positions=None, layer_offset=0):
    """Run a layer stack, each layer rematerialised (``_remat``); returns
    (x, aux_sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_layers = tree_leaves(stage_params)[0].shape[0]
    shared = cfg.family == "hybrid" and cfg.attn_every and "shared_attn" in params
    for i, lp in enumerate(_unstack(stage_params, n_layers)):
        def body(x, lp=lp, i=i):
            # pin the residual stream: (b@dp, s[, @model if SP], d)
            x = constrain(x, ("batch", "seq", None))
            x, a = _apply_layer(kind, lp, x, cfg, positions, causal=causal, memory=memory,
                                mrope_positions=mrope_positions)
            if shared and (layer_offset + i + 1) % cfg.attn_every == 0:
                x = _shared_attn(params, x, cfg, positions)
            return x, a

        x, a = _remat(body, x)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------------- #
# top-level forwards
# --------------------------------------------------------------------- #
def _cast_stage_params(stage_params):
    """Cast stacked matrix weights (3 dims or more) to the compute dtype
    before the layer loop, as the JAX package does ahead of its layer
    scan; vectors (norm scales, biases) stay f32.  Leaves used in f32
    (Mamba-1's ``A_log`` and ``dt_proj``) are thereby rounded to bf16 on
    this path and not on the decode path, as in the JAX package."""
    return tree_map(
        lambda a: a.to(COMPUTE_DTYPE) if a.dim() >= 3 and a.dtype == torch.float32 else a,
        stage_params,
    )


def _backbone(params, cfg, x, positions, *, memory=None, mrope_positions=None):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    offset = 0
    for (kind, n), stage in zip(stage_plan(cfg), params["stages"]):
        x, aux = _run_stage(
            _cast_stage_params(stage["kind_params"]), kind, x, cfg, positions, params,
            memory=memory, mrope_positions=mrope_positions, layer_offset=offset,
        )
        aux_total = aux_total + aux
        offset += n
    return rmsnorm(params["final_norm"], x), aux_total


def _encode(params, cfg, src_embeds):
    """Encoder stack over precomputed frontend embeddings (audio stub)."""
    positions = torch.arange(src_embeds.shape[1], device=src_embeds.device)[None, :]
    x = src_embeds.to(COMPUTE_DTYPE)
    x, _ = _run_stage(params["encoder"]["layers"], "attn_mlp", x, cfg, positions, params,
                      causal=False)
    return rmsnorm(params["encoder"]["final_norm"], x)


def _make_mrope_positions(cfg, batch, n_vis, n_text, device=None):
    """Synthesized 3D (t, h, w) M-RoPE ids: vision patches on a grid, text
    linear after the vision span (stub frontend discipline)."""
    side = max(int(n_vis**0.5), 1)
    vis = torch.arange(n_vis, dtype=torch.int32, device=device)
    text = torch.arange(n_text, dtype=torch.int32, device=device) + side
    t = torch.cat([torch.zeros_like(vis), text])
    hh = torch.cat([vis // side, text])
    ww = torch.cat([vis % side, text])
    pos = torch.stack([t, hh, ww])  # (3, s)
    return pos[None].expand(batch, 3, n_vis + n_text)


def forward_hidden(params, cfg, batch):
    """Full-sequence forward -> final hidden states (pre-unembed)."""
    params = as_tree(params)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = constrain(embed_tokens(params["embedding"], tokens), ("batch", None, None))
    mrope_positions = None
    memory = None
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(COMPUTE_DTYPE)
        x = torch.cat([vis, x], dim=1)
        mrope_positions = _make_mrope_positions(cfg, b, vis.shape[1], tokens.shape[1], x.device)
    if cfg.family == "encdec":
        memory = _encode(params, cfg, batch["src_embeds"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _backbone(params, cfg, x, positions, memory=memory, mrope_positions=mrope_positions)


def forward_logits(params, cfg, batch):
    """Full-sequence forward -> logits (prefill / eval path)."""
    params = as_tree(params)
    h, aux = forward_hidden(params, cfg, batch)
    logits = constrain(unembed(params["embedding"], h), ("batch", None, "model"))
    return logits, aux


def _xent(logits, targets):
    lg = logits.float()
    # both (b, s, 1): a vocab-sharded DTensor's gather stays partial until
    # the difference, with its mask of the gather's own shape
    logz = torch.logsumexp(lg, dim=-1, keepdim=True)
    gold = torch.gather(lg, -1, targets[..., None].long())
    return (logz - gold).mean(), torch.square(logz).mean()


def forward_train(params, cfg, batch):
    """Next-token loss (+ router aux + MTP head if configured)."""
    params = as_tree(params)
    tokens = batch["tokens"]
    h, aux = forward_hidden(params, cfg, batch)
    h = h[:, -tokens.shape[1]:]  # score only the text span (vlm prefix)
    logits = constrain(unembed(params["embedding"], h), ("batch", None, "model"))
    xent, z2 = _xent(logits[:, :-1], tokens[:, 1:])
    zloss = 1e-4 * z2
    loss = xent + zloss + aux
    metrics = {"xent": xent, "aux": aux, "zloss": zloss}
    if cfg.mtp_depth and "mtp" in params:
        # DeepSeek-V3-style multi-token prediction: one extra dense block
        # over the trunk hiddens predicts token t+2 with the shared head.
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        h2, _ = _apply_layer("attn_mlp", params["mtp"], h, cfg, positions)
        h2 = rmsnorm(params["mtp_norm"], h2)
        mtp_logits = unembed(params["embedding"], h2)
        mtp_xent, _ = _xent(mtp_logits[:, :-2], tokens[:, 2:])
        loss = loss + 0.3 * mtp_xent
        metrics["mtp_xent"] = mtp_xent
    return loss, metrics


# --------------------------------------------------------------------- #
# serving: cache init + decode step
# --------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_len: int, device=None):
    """Per-stage stacked caches (bf16, SSM states f32; layer-major)."""
    hd, kv = cfg.head_dim, cfg.n_kv_heads

    def zeros(*shape, dtype=COMPUTE_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = []
    for kind, n in stage_plan(cfg):
        if kind in ("attn_mlp", "attn_moe", "xattn_mlp"):
            caches.append({"k": zeros(n, batch, max_len, kv, hd),
                           "v": zeros(n, batch, max_len, kv, hd)})
        elif kind in ("mla_mlp", "mla_moe"):
            m = cfg.mla
            caches.append({"ckv": zeros(n, batch, max_len, m.kv_lora_rank),
                           "krope": zeros(n, batch, max_len, m.qk_rope_dim)})
        elif kind in ("mamba1", "mamba2"):
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            conv_ch = d_in if kind == "mamba1" else d_in + 2 * s.state_dim
            entry = {"conv": zeros(n, batch, s.conv_dim - 1, conv_ch)}
            if kind == "mamba1":
                entry["ssm"] = zeros(n, batch, d_in, s.state_dim, dtype=torch.float32)
            else:
                nh = s.n_ssm_heads or max(d_in // 64, 1)
                entry["ssm"] = zeros(n, batch, nh, s.state_dim, d_in // nh, dtype=torch.float32)
            caches.append(entry)
        else:
            raise ValueError(kind)
    shared = None
    if cfg.family == "hybrid" and cfg.attn_every:
        n_shared = cfg.n_layers // cfg.attn_every
        shared = {"k": zeros(n_shared, batch, max_len, kv, hd),
                  "v": zeros(n_shared, batch, max_len, kv, hd)}
    return {"stages": caches, "shared_attn": shared}


def _decode_layer(kind, lp, x, cfg, sc, i: int, cache_len: int, memory=None):
    """Layer ``i`` of a stage for one decode step (``sc``: the stage's
    cache, whose entries at ``i`` are written in place); returns x."""
    h = rmsnorm(lp["norm1"], x)
    if kind in ("mamba1", "mamba2"):
        decode_fn = ssm.mamba1_decode if kind == "mamba1" else ssm.mamba2_decode
        y, conv, st = decode_fn(lp["mixer"], h, cfg, sc["conv"][i], sc["ssm"][i])
        sc["conv"][i] = conv
        sc["ssm"][i] = st
        return _residual(x + y)
    if kind in ("mla_mlp", "mla_moe"):
        y, _, _ = mla.mla_decode(lp["attn"], h, cfg, sc["ckv"][i], sc["krope"][i], cache_len)
    else:
        y, _, _ = attention.attention_decode(lp["attn"], h, cfg, sc["k"][i], sc["v"][i],
                                             cache_len)
    x = _residual(x + y)
    if kind == "xattn_mlp":
        x = _residual(x + _cross_attention(lp["xattn"], rmsnorm(lp["norm_x"], x), memory,
                                           cfg))
    h = rmsnorm(lp["norm2"], x)
    if kind in ("attn_mlp", "mla_mlp", "xattn_mlp"):
        return _residual(x + mlp_apply(lp["mlp"], h))
    return _residual(x + moe.moe_apply(lp["moe"], h, cfg)[0])


def decode_step(params, cfg, token, cache, cache_len: int, *, memory=None):
    """One serving step: token (b, 1) int -> (logits, cache).

    ``cache_len`` is the current number of valid positions; the new
    token's entries are written into ``cache`` in place, and the same
    cache is returned."""
    params = as_tree(params)
    if cfg.family == "encdec" and memory is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder decode step needs memory=")
    x = _residual(embed_tokens(params["embedding"], token))
    shared = cache.get("shared_attn")
    shared_idx = 0
    for (kind, n), stage, sc in zip(stage_plan(cfg), params["stages"], cache["stages"]):
        for i in range(n):
            x = _decode_layer(kind, _layer(stage["kind_params"], i), x, cfg, sc, i, cache_len,
                              memory)
            # shared attention block after each full segment (Zamba2)
            if (kind in ("mamba1", "mamba2") and cfg.family == "hybrid" and cfg.attn_every
                    and shared is not None and (i + 1) % cfg.attn_every == 0
                    and shared_idx < shared["k"].shape[0]):
                sa = params["shared_attn"]
                y, _, _ = attention.attention_decode(
                    sa["attn"], rmsnorm(sa["norm"], x), cfg, shared["k"][shared_idx],
                    shared["v"][shared_idx], cache_len)
                x = _residual(x + y)
                shared_idx += 1
    h = rmsnorm(params["final_norm"], x)
    return unembed(params["embedding"], h), cache
