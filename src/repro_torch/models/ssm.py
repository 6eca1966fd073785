"""State-space blocks: Mamba-1 (selective scan) and Mamba-2 (SSD).

Both use *chunked* scans: the sequence is split into blocks; within a
block the recurrence is computed in parallel (a log-depth scan with the
JAX package's ``associative_scan`` combine for Mamba-1, the matmul form
for Mamba-2/SSD), and a loop over the blocks carries the state across
them.  Decode is the O(1)-state single-step recurrence.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from . import sharding_policy
from .layers import Params, softplus

__all__ = ["Mamba1", "Mamba2", "mamba1_apply", "mamba1_decode", "mamba2_apply",
           "mamba2_decode"]


# ===================================================================== #
# Mamba-1
# ===================================================================== #
class Mamba1(Params):
    def __init__(self, cfg, stack: int | None, device):
        super().__init__(stack, device)
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        dt_rank = max(d // 16, 1)
        self.add("in_proj", (d, 2 * d_in))
        self.add("conv_w", (s.conv_dim, d_in))
        self.add("conv_b", (d_in,), "zeros")
        self.add("x_proj", (d_in, dt_rank + 2 * s.state_dim))
        self.add("dt_proj", (dt_rank, d_in))
        self.add("dt_bias", (d_in,), "zeros")
        self.add("A_log", (d_in, s.state_dim), "a_log")
        self.add("D", (d_in,), "ones")
        self.add("out_proj", (d_in, d))


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (b, l, d_in), w (k, d_in)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _mamba1_gates(params, x, cfg):
    """Common projections; returns (a, bx, C, z, x_conv) all (b,l,...)."""
    s = cfg.ssm
    dtype = x.dtype
    d_in = params["conv_b"].shape[0]
    dt_rank = params["dt_proj"].shape[0]
    xz = x @ params["in_proj"].to(dtype)
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = F.silu(_causal_conv(xi, params["conv_w"].to(dtype), params["conv_b"].to(dtype)).float())
    proj = (xc.to(dtype) @ params["x_proj"].to(dtype)).float()
    dt, B, C = (
        proj[..., :dt_rank],
        proj[..., dt_rank : dt_rank + s.state_dim],
        proj[..., dt_rank + s.state_dim :],
    )
    delta = softplus(dt @ params["dt_proj"].float() + params["dt_bias"])  # (b, l, d_in)
    A = -torch.exp(params["A_log"])  # (d_in, n)
    a = torch.exp(delta[..., None] * A[None, None])  # (b, l, d_in, n)
    bx = (delta * xc)[..., None] * B[:, :, None, :]  # (b, l, d_in, n)
    return a, bx, C, z, xc


def _prefix_scan(a, b):
    """Inclusive scan along dim 1 of ``h_t = a_t h_{t-1} + b_t`` pairs,
    with the combine ``(al, bl), (ar, br) -> (al ar, br + ar bl)``, in
    ceil(log2 l) doubling steps (Hillis-Steele)."""
    off = 1
    while off < a.shape[1]:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], b_cur + a_cur * b_prev], dim=1)
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        off *= 2
    return a, b


def mamba1_apply(params, x, cfg):
    """Training/prefill forward. x: (b, l, d)."""
    s = cfg.ssm
    dtype = x.dtype
    a, bx, C, z, xc = _mamba1_gates(params, x, cfg)
    b_, l, d_in, n = a.shape
    chunk = min(s.chunk, l)
    n_chunks = max(l // chunk, 1)
    chunk = l // n_chunks

    h = torch.zeros((b_, d_in, n), dtype=a.dtype, device=x.device)
    hs = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        pa, pb = _prefix_scan(a[:, sl], bx[:, sl])
        hc = pb + pa * h[:, None]  # (b, chunk, d_in, n)
        h = hc[:, -1]
        hs.append(hc)
    hs = torch.cat(hs, dim=1)
    y = torch.einsum("bldn,bln->bld", hs, C) + params["D"] * xc
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    return y @ params["out_proj"].to(dtype)


def mamba1_decode(params, x, cfg, conv_state, ssm_state):
    """Single-token decode. x: (b, 1, d); conv_state: (b, k-1, d_in);
    ssm_state: (b, d_in, n).  Returns the new states; the caller stores
    them."""
    s = cfg.ssm
    dtype = x.dtype
    d_in = params["conv_b"].shape[0]
    dt_rank = params["dt_proj"].shape[0]
    xz = x @ params["in_proj"].to(dtype)
    xi, z = xz[..., :d_in], xz[..., d_in:]
    window = torch.cat([conv_state.to(dtype), xi], dim=1)  # (b, k, d_in)
    conv_state_new = window[:, 1:]
    w = params["conv_w"].to(dtype)
    xc = torch.einsum("bkd,kd->bd", window, w) + params["conv_b"].to(dtype)
    xc = F.silu(xc.float())  # (b, d_in)
    # match the train path's precision: x_proj runs in compute dtype
    proj = (xc.to(dtype) @ params["x_proj"].to(dtype)).float()
    dt, B, C = (
        proj[..., :dt_rank],
        proj[..., dt_rank : dt_rank + s.state_dim],
        proj[..., dt_rank + s.state_dim :],
    )
    delta = softplus(dt @ params["dt_proj"].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    a = torch.exp(delta[..., None] * A[None])  # (b, d_in, n)
    h = a * ssm_state + (delta * xc)[..., None] * B[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C) + params["D"] * xc
    y = y.to(dtype) * F.silu(z[:, 0].float()).to(dtype)
    out = y @ params["out_proj"].to(dtype)
    return out[:, None, :], conv_state_new, h


# ===================================================================== #
# Mamba-2 (SSD)
# ===================================================================== #
class Mamba2(Params):
    def __init__(self, cfg, stack: int | None, device):
        super().__init__(stack, device)
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        nh = s.n_ssm_heads or max(d_in // 64, 1)
        self.add("in_proj", (d, 2 * d_in + 2 * s.state_dim + nh))
        self.add("conv_w", (s.conv_dim, d_in + 2 * s.state_dim))
        self.add("conv_b", (d_in + 2 * s.state_dim,), "zeros")
        self.add("A_log", (nh,), "zeros")
        self.add("dt_bias", (nh,), "zeros")
        self.add("D", (nh,), "ones")
        self.add("out_proj", (d_in, d))


def _mamba2_gates(params, x, cfg):
    s = cfg.ssm
    dtype = x.dtype
    d_in = s.expand * x.shape[-1]
    nh = params["A_log"].shape[0]
    hd = d_in // nh
    proj = x @ params["in_proj"].to(dtype)
    z = proj[..., :d_in]
    xBC = proj[..., d_in : 2 * d_in + 2 * s.state_dim]
    dt_raw = proj[..., 2 * d_in + 2 * s.state_dim :]  # (b, l, nh)
    xBC = F.silu(
        _causal_conv(xBC, params["conv_w"].to(dtype), params["conv_b"].to(dtype)).float()
    ).to(dtype)
    xi = xBC[..., :d_in]
    B = xBC[..., d_in : d_in + s.state_dim].float()
    C = xBC[..., d_in + s.state_dim :].float()
    dt = softplus(dt_raw.float() + params["dt_bias"])  # (b, l, nh)
    A = -torch.exp(params["A_log"])  # (nh,)
    xh = xi.reshape(*xi.shape[:-1], nh, hd)
    return xh, B, C, dt, A, z


def mamba2_apply(params, x, cfg):
    """SSD chunked forward (matmul formulation). x: (b, l, d)."""
    s = cfg.ssm
    dtype = x.dtype
    xh, B, C, dt, A, z = _mamba2_gates(params, x, cfg)
    b_, l, nh, hd = xh.shape
    chunk = min(s.chunk, l)
    if isinstance(xh, DTensor):
        y = _ssd_on_local_heads(functools.partial(_ssd, chunk=chunk), x, xh, B, C, dt, A)
    else:
        y = _ssd(xh, B, C, dt, A, chunk=chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b_, l, nh * hd).to(dtype)
    y = y * F.silu(z.float()).to(dtype)
    return y @ params["out_proj"].to(dtype)


def _ssd(xh, B, C, dt, A, *, chunk: int):
    """The SSD scan of ``xh`` ``(b, l, nh, hd)`` in chunks: ``y`` in f32."""
    b_, l, nh, hd = xh.shape
    n_chunks = max(l // chunk, 1)
    chunk = l // n_chunks
    loga = dt * A[None, None]  # (b, l, nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))

    h = torch.zeros((b_, nh, B.shape[-1], hd), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, Bc, Cc, dtc = xh[:, sl].float(), B[:, sl], C[:, sl], dt[:, sl]
        # cumulative decay within chunk: (b, chunk, nh)
        cum = torch.cumsum(loga[:, sl], dim=1)
        # intra-chunk (attention-like) term:
        # decay(t, s) = exp(cum_t - cum_s) for s <= t
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (b, t, s, nh)
        decay = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)  # (b, t, s)
        w = cb[..., None] * decay * dtc[:, None]  # (b, t, s, nh)
        y_intra = torch.einsum("btsh,bshd->bthd", w, xc)
        # inter-chunk: contribution of carried state
        y_inter = torch.einsum("btn,bhnd,bth->bthd", Cc, h, torch.exp(cum))
        # new carried state
        rem = cum[:, -1:, :] - cum  # decay from position to chunk end
        state_in = torch.einsum("bsn,bshd,bsh->bhnd", Bc, xc, torch.exp(rem) * dtc)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + state_in
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)


def _ssd_on_local_heads(fn, x, xh, B, C, dt, A):
    """``fn(xh, B, C, dt, A)`` on each rank's local tensors: the batch
    shard of the layer input ``x`` and, where they divide the ``model``
    axis, its heads; ``B`` and ``C`` (no heads) whole over ``model``, their
    gradients (and ``A``'s over the batch) partial sums.  DTensor plans
    the scan's 4-D einsums' redistributions on a three-axis mesh by a
    graph search that does not end in minutes; every op of the scan is
    local to a batch shard and a head."""
    mesh = x.device_mesh
    split = sharding_policy.heads_mesh_dim(mesh, xh.shape[2])
    batch = [p.is_shard(0) for p in x.placements]

    def at(heads_dim):
        """Batch at dim 0 (sharded as ``x``'s), heads at ``heads_dim``."""
        return tuple((Replicate() if heads_dim is None else Shard(heads_dim)) if i == split
                     else Shard(0) if b else Replicate() for i, b in enumerate(batch))

    shared_grad = tuple(Partial() if i == split else p for i, p in enumerate(at(None)))
    a_at = tuple(Shard(0) if i == split else Replicate() for i in range(len(batch)))
    a_grad = tuple(Shard(0) if i == split else Partial() if b else Replicate()
                   for i, b in enumerate(batch))
    xh_l, dt_l = (t.redistribute(mesh, at(2)).to_local() for t in (xh, dt))
    B_l, C_l = (t.redistribute(mesh, at(None)).to_local(grad_placements=shared_grad)
                for t in (B, C))
    A_l = A.redistribute(mesh, a_at).to_local(grad_placements=a_grad)
    return DTensor.from_local(fn(xh_l, B_l, C_l, dt_l, A_l), mesh, at(2))


def mamba2_decode(params, x, cfg, conv_state, ssm_state):
    """Single-token SSD decode. conv_state: (b, k-1, d_conv_in);
    ssm_state: (b, nh, n, hd).  Returns the new states."""
    s = cfg.ssm
    dtype = x.dtype
    d_in = s.expand * x.shape[-1]
    nh = params["A_log"].shape[0]
    hd = d_in // nh
    proj = x @ params["in_proj"].to(dtype)
    z = proj[..., :d_in][:, 0]
    xBC = proj[..., d_in : 2 * d_in + 2 * s.state_dim]
    dt_raw = proj[:, 0, 2 * d_in + 2 * s.state_dim :]
    window = torch.cat([conv_state.to(dtype), xBC], dim=1)
    conv_state_new = window[:, 1:]
    w = params["conv_w"].to(dtype)
    xBC = torch.einsum("bkd,kd->bd", window, w) + params["conv_b"].to(dtype)
    xBC = F.silu(xBC.float())
    xi = xBC[..., :d_in]
    B = xBC[..., d_in : d_in + s.state_dim]
    C = xBC[..., d_in + s.state_dim :]
    dt = softplus(dt_raw.float() + params["dt_bias"])  # (b, nh)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A[None])  # (b, nh)
    xh = xi.reshape(-1, nh, hd)
    h = ssm_state * a[:, :, None, None] + torch.einsum("bn,bhd,bh->bhnd", B, xh, dt)
    y = torch.einsum("bn,bhnd->bhd", C, h) + params["D"][None, :, None] * xh
    y = y.reshape(-1, d_in).to(dtype)
    y = y * F.silu(z.float()).to(dtype)
    out = y @ params["out_proj"].to(dtype)
    return out[:, None, :], conv_state_new, h
