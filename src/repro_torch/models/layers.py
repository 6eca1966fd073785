"""Shared model layers: norms, RoPE / M-RoPE, SwiGLU, embeddings.

The layer functions take nested dicts of tensors (``param_tree`` of a
module, or a tree carried over from numpy) and are ``apply(params, x,
...)``, as in the JAX package.  Parameters are stored f32 and cast to the
compute dtype (bf16) inside the blocks (mixed-precision discipline).

The modules here only hold parameters: :class:`Params` registers each
leaf with its init rule, stacked on a leading layer axis when the layer
repeats, so that a module's ``state_dict`` keys and shapes are the JAX
package's parameter tree flattened with dots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "COMPUTE_DTYPE", "PARAM_DTYPE", "Params", "RMSNorm", "MLP", "Embedding",
    "init_module_", "param_tree", "as_tree", "tree_map", "tree_leaves", "path_key",
    "rmsnorm", "l2norm", "rope_frequencies", "apply_rope", "apply_mrope",
    "swiglu", "mlp_apply", "embed_tokens", "unembed", "softplus",
]

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# --------------------------------------------------------------------- #
# parameter containers and init
# --------------------------------------------------------------------- #
class Params(nn.Module):
    """Parameters of one block, each ``(stack, *shape)`` when ``stack`` is
    set (a stage of identical layers) and ``shape`` otherwise.

    Init rules (per layer, as the JAX package's ``*_init``): ``dense``
    normal with std ``shape[0] ** -0.5``, ``embed`` normal with std 0.02,
    ``ones``, ``zeros``, ``a_log`` (Mamba-1's ``log(1..n)`` per row)."""

    def __init__(self, stack: int | None, device):
        super().__init__()
        self.stack = stack
        self._device = torch.device(device)
        self.inits: dict[str, str] = {}

    def add(self, name: str, shape: tuple[int, ...], init: str = "dense") -> None:
        full = tuple(shape) if self.stack is None else (self.stack, *shape)
        data = torch.empty(full, dtype=PARAM_DTYPE, device=self._device)
        self.register_parameter(name, nn.Parameter(data))
        self.inits[name] = init

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        lead = 0 if self.stack is None else 1
        for name, rule in self.inits.items():
            p = getattr(self, name)
            if p.is_meta:
                continue
            if rule == "dense":
                p.normal_(generator=generator).mul_(p.shape[lead] ** -0.5)
            elif rule == "embed":
                p.normal_(generator=generator).mul_(0.02)
            elif rule == "ones":
                p.fill_(1.0)
            elif rule == "zeros":
                p.zero_()
            elif rule == "a_log":
                n = p.shape[-1]
                p.copy_(torch.log(torch.arange(1, n + 1, dtype=PARAM_DTYPE)).expand_as(p))
            else:
                raise ValueError(f"unknown init rule {rule!r}")


def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every :class:`Params` leaf of ``module`` from ``generator``, in
    module order (the generator must live on the parameters' device)."""
    for m in module.modules():
        if isinstance(m, Params):
            m.init_(generator)
    return module


def param_tree(module: nn.Module):
    """The parameters as the JAX package's nested tree: dicts of tensors,
    a list for a ``ModuleList``."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    tree = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        tree[name] = param_tree(child)
    return tree


def as_tree(params):
    return param_tree(params) if isinstance(params, nn.Module) else params


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def path_key(name: str) -> tuple:
    """Sort key of a dotted leaf name in the JAX package's leaf order
    (``jax.tree_util``'s: dict keys sorted at every level, a list's items
    by index): the name's parts, list indices as integers."""
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in name.split("."))


# --------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------- #
class RMSNorm(Params):
    def __init__(self, d: int, stack: int | None, device):
        super().__init__(stack, device)
        self.add("scale", (d,), "ones")


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def l2norm(x, eps: float = 1e-6):
    """Head-dim L2 norm used by qk_norm variants without learned scale."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype)


# --------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def _rotate(x, angles):
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., s, h, d_head); positions: broadcastable to (..., s)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (d/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., s, 1, d/2)
    return _rotate(x, angles)


def apply_mrope(x, positions_3d, sections, theta: float = 10_000.0):
    """Multimodal RoPE (Qwen2-VL): the head dim is split into (t, h, w)
    sections, each rotated by its own position stream.

    x: (b, s, heads, d); positions_3d: (b, 3, s); sections: per-axis
    *pair* counts summing to d/2.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError("M-RoPE sections must sum to d_head/2")
    freqs = rope_frequencies(d, theta, x.device)  # (d/2,)
    sec_ids = torch.cat([
        torch.full((n,), i, dtype=torch.long, device=x.device)
        for i, n in enumerate(sections)
    ])  # (d/2,)
    pos = positions_3d[:, sec_ids].transpose(1, 2)  # (b, s, d/2)
    angles = pos[..., None, :].float() * freqs  # (b, s, 1, d/2)
    return _rotate(x, angles)


# --------------------------------------------------------------------- #
# SwiGLU MLP
# --------------------------------------------------------------------- #
class MLP(Params):
    def __init__(self, d: int, f: int, stack: int | None, device):
        super().__init__(stack, device)
        self.add("w_gate", (d, f))
        self.add("w_up", (d, f))
        self.add("w_down", (f, d))


def swiglu(x, w_gate, w_up, w_down):
    """``silu(x w_gate) * (x w_up) w_down`` in ``x``'s dtype, the gate's
    silu in f32; weights ``(d, f)`` / ``(f, d)``, already cast."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def mlp_apply(params, x):
    dtype = x.dtype
    return swiglu(x, params["w_gate"].to(dtype), params["w_up"].to(dtype),
                  params["w_down"].to(dtype))


# --------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------- #
class Embedding(Params):
    def __init__(self, vocab: int, d: int, tied: bool, device):
        super().__init__(None, device)
        self.add("embed", (vocab, d), "embed")
        if not tied:
            self.add("unembed", (d, vocab))


def embed_tokens(params, tokens):
    return params["embed"][tokens].to(COMPUTE_DTYPE)


def unembed(params, x):
    if "unembed" in params:
        return x @ params["unembed"].to(x.dtype)
    return x @ params["embed"].to(x.dtype).T


def softplus(x):
    """``log(1 + exp(x))`` without the cut-over to ``x`` of
    ``F.softplus``'s threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))

