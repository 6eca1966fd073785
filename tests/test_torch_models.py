"""The port's model blocks against the JAX package's, unit by unit, on the
CPU.

The same seeded inputs (numpy) and parameters (the reference's
``*_init``, handed over as numpy) go through each reference function and
its twin in ``repro_torch.models``: norms, RoPE and M-RoPE, the SwiGLU
MLP, embeddings, chunked attention and its KV-cache decode, the MoE
gather path (capacity drops and shared experts included), MLA and its
absorbed decode, and Mamba-1/2 with their decodes.  Everything runs in
f32, where the reference follows its input's dtype: ``rtol=1e-4,
atol=1e-5``, and ``rtol=1e-3, atol=1e-4`` for the two SSM scans, whose
exp and cumsum orders differ (the port's log-depth scan against
``associative_scan``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, list_configs
from repro_torch.models import attention, layers, mla, moe, ssm, transformer
from repro_torch.models.layers import tree_map

TOL = {"rtol": 1e-4, "atol": 1e-5}
SCAN_TOL = {"rtol": 1e-3, "atol": 1e-4}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _t(tree):
    """A numpy (or JAX) tree as torch tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), _np_tree(tree))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert_allclose(got, np.asarray(want, dtype=np.float32), **tol)


def _cfg(arch="qwen3-0.6b", **over):
    """The smoke config of ``arch`` in both packages, with ``over``."""
    return (dataclasses.replace(jget_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _jit(fn, cfg):
    """``fn(params, x, cfg, *rest)`` of the reference, compiled once for a
    loop of decode steps."""
    return jax.jit(lambda p, x, *rest: fn(p, x, cfg, *rest))


def _x(shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------- #
# configs and stage plans
# --------------------------------------------------------------------- #
def test_configs_are_the_reference_configs():
    """Every registered config, full and smoke, field for field."""
    from repro.configs import list_configs as jlist

    assert list_configs() == jlist()
    for name in list_configs():
        for smoke in (False, True):
            mine, ref = get_config(name, smoke=smoke), jget_config(name, smoke=smoke)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), (name, smoke)
            assert mine.param_count() == ref.param_count()
            assert mine.active_param_count() == ref.active_param_count()
            assert transformer.stage_plan(mine) == jtransformer.stage_plan(ref)


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def test_norms_match_reference():
    x = _x((2, 5, 16), scale=3.0)
    scale = _x((16,), seed=1)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(layers.l2norm(torch.from_numpy(x)), jlayers.l2norm(jnp.asarray(x)))
    # bf16 in, bf16 out: the f32 math rounds once at the end in both
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, xb)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    x = _x((2, 7, 3, 16))
    pos = np.arange(7)[None, :] + 5
    _close(layers.rope_frequencies(16, theta), jlayers.rope_frequencies(16, theta))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mrope_matches_reference():
    x = _x((2, 20, 3, 16))
    pos = jtransformer._make_mrope_positions(None, 2, 16, 4)
    tpos = transformer._make_mrope_positions(None, 2, 16, 4)
    assert_array_equal(tpos.numpy(), np.asarray(pos))
    _close(layers.apply_mrope(torch.from_numpy(x), tpos, (2, 3, 3), 1e6),
           jlayers.apply_mrope(jnp.asarray(x), pos, (2, 3, 3), 1e6))
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), tpos, (2, 3, 2))


def test_mlp_and_embeddings_match_reference():
    k = jax.random.PRNGKey(3)
    p = jlayers.mlp_init(k, 16, 24)
    x = _x((2, 5, 16))
    _close(layers.mlp_apply(_t(p), torch.from_numpy(x)), jlayers.mlp_apply(p, jnp.asarray(x)))
    tokens = _rng().integers(0, 50, (2, 5))
    h = _x((2, 5, 16))
    for tied in (True, False):
        e = jlayers.embedding_init(k, 50, 16, tied)
        te = _t(e)
        emb = layers.embed_tokens(te, torch.from_numpy(tokens))
        assert emb.dtype == torch.bfloat16
        assert_array_equal(emb.float().numpy(),
                           np.asarray(jlayers.embed_tokens(e, jnp.asarray(tokens)), np.float32))
        _close(layers.unembed(te, torch.from_numpy(h)), jlayers.unembed(e, jnp.asarray(h)))


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,chunk,offset", [(16, 16, 0), (20, 8, 0), (12, 4, 3)])
def test_chunked_attention_matches_reference(causal, s, chunk, offset):
    q, k, v = _x((2, s, 4, 16), 1), _x((2, s + offset, 2, 16), 2), _x((2, s + offset, 2, 16), 3)
    got = attention.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal, chunk=chunk,
                                      q_offset=offset)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, chunk=chunk, q_offset=offset)
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-20b", "qwen2-vl-72b"])
def test_attention_apply_and_decode_match_reference(arch):
    """qk_norm (qwen3), MQA (granite), M-RoPE (qwen2-vl): the full
    sequence, then each position decoded into a KV cache in turn."""
    jcfg, cfg = _cfg(arch, attn_chunk=8)
    p = jattn.attention_init(jax.random.PRNGKey(1), jcfg)
    tp = _t(p)
    if cfg.qk_norm:  # scales other than the init's ones
        p["q_scale"] = jnp.asarray(_x((cfg.head_dim,), 4))
        tp["q_scale"] = torch.from_numpy(np.array(p["q_scale"]))
    x = _x((2, 16, cfg.d_model))
    pos = np.arange(16)[None, :]
    mpos = None
    if cfg.mrope_sections is not None:
        mpos = jtransformer._make_mrope_positions(jcfg, 2, 9, 7)
    got = attention.attention_apply(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                                    mrope_positions=None if mpos is None else
                                    torch.from_numpy(np.array(mpos)))
    want = jattn.attention_apply(p, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 mrope_positions=mpos)
    _close(got, want)

    kv, hd = cfg.n_kv_heads, cfg.head_dim
    ck = jnp.zeros((2, 16, kv, hd), jnp.float32)
    cv = jnp.zeros((2, 16, kv, hd), jnp.float32)
    tk, tv = torch.zeros(2, 16, kv, hd), torch.zeros(2, 16, kv, hd)
    step = _jit(jattn.attention_decode, jcfg)
    for t in range(16):
        y, ck, cv = step(p, jnp.asarray(x[:, t:t + 1]), ck, cv, jnp.int32(t))
        ty, rk, rv = attention.attention_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg,
                                                tk, tv, t)
        assert rk is tk and rv is tv  # written in place
        _close(ty, y)
    _close(tk, ck)
    _close(tv, cv)


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_gather_matches_reference(arch, capacity_factor):
    """Routed top-k with shared experts; at capacity factor 0.25 tokens
    overflow their expert's capacity and are dropped."""
    jcfg, cfg = _cfg(arch)
    over = {"moe": dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)}
    jcfg, cfg = dataclasses.replace(jcfg, **over), dataclasses.replace(cfg, **over)
    p = jmoe.moe_init(jax.random.PRNGKey(2), jcfg)
    x = _x((2, 24, cfg.d_model))
    y, aux = moe.moe_apply(_t(p), torch.from_numpy(x), cfg)
    jy, jaux = jmoe._moe_gather(p, jnp.asarray(x), jcfg)
    _close(y, jy)
    _close(aux, jaux)
    assert moe._capacity(48, cfg) == jmoe._capacity(48, jcfg)


def test_moe_capacity_matches_reference():
    jcfg, cfg = _cfg("qwen2-moe-a2.7b")
    for n in (1, 7, 48, 1000, 32768):
        assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg)


# --------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------- #
def test_mla_apply_and_decode_match_reference():
    jcfg, cfg = _cfg("deepseek-v3-671b", attn_chunk=8)
    p = jmla.mla_init(jax.random.PRNGKey(3), jcfg)
    tp = _t(p)
    x = _x((2, 16, cfg.d_model))
    pos = np.arange(16)[None, :]
    for causal in (True, False):
        _close(mla.mla_apply(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                             causal=causal),
               jmla.mla_apply(p, jnp.asarray(x), jcfg, jnp.asarray(pos), causal=causal))
    m = cfg.mla
    cc = jnp.zeros((2, 16, m.kv_lora_rank))
    cr = jnp.zeros((2, 16, m.qk_rope_dim))
    tc, tr = torch.zeros(2, 16, m.kv_lora_rank), torch.zeros(2, 16, m.qk_rope_dim)
    step = _jit(jmla.mla_decode, jcfg)
    for t in range(16):
        y, cc, cr = step(p, jnp.asarray(x[:, t:t + 1]), cc, cr, jnp.int32(t))
        ty, _, _ = mla.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, tc, tr, t)
        _close(ty, y)
    _close(tc, cc)
    _close(tr, cr)


# --------------------------------------------------------------------- #
# SSM
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("length", [16, 40, 7])
def test_mamba1_matches_reference(length):
    """Chunks of 16: one, two of 20 (40 // (40 // 16)), one of 7."""
    jcfg, cfg = _cfg("falcon-mamba-7b")
    p = jssm.mamba1_init(jax.random.PRNGKey(4), jcfg)
    p["dt_bias"] = jnp.asarray(_x(p["dt_bias"].shape, 5))
    tp = _t(p)
    x = _x((2, length, cfg.d_model))
    _close(ssm.mamba1_apply(tp, torch.from_numpy(x), cfg),
           jssm.mamba1_apply(p, jnp.asarray(x), jcfg), SCAN_TOL)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    conv, st = jnp.zeros((2, s.conv_dim - 1, d_in)), jnp.zeros((2, d_in, s.state_dim))
    tconv, tst = torch.zeros(2, s.conv_dim - 1, d_in), torch.zeros(2, d_in, s.state_dim)
    step = _jit(jssm.mamba1_decode, jcfg)
    for t in range(length):
        y, conv, st = step(p, jnp.asarray(x[:, t:t + 1]), conv, st)
        ty, tconv, tst = ssm.mamba1_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, tconv, tst)
        _close(ty, y)
    _close(tconv, conv)
    _close(tst, st, SCAN_TOL)


def test_prefix_scan_is_the_recurrence():
    """The log-depth scan against the plain loop ``h = a h + b``."""
    a = torch.rand(2, 13, 3, 4)
    b = torch.randn(2, 13, 3, 4)
    pa, pb = ssm._prefix_scan(a, b)
    h, ap = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        ap = ap * a[:, t]
        torch.testing.assert_close(pb[:, t], h, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(pa[:, t], ap, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("length", [16, 40, 7])
def test_mamba2_matches_reference(length):
    jcfg, cfg = _cfg("zamba2-1.2b")
    p = jssm.mamba2_init(jax.random.PRNGKey(5), jcfg)
    p["A_log"] = jnp.asarray(_x(p["A_log"].shape, 6))
    p["dt_bias"] = jnp.asarray(_x(p["dt_bias"].shape, 7))
    tp = _t(p)
    x = _x((2, length, cfg.d_model))
    _close(ssm.mamba2_apply(tp, torch.from_numpy(x), cfg),
           jssm.mamba2_apply(p, jnp.asarray(x), jcfg), SCAN_TOL)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.n_ssm_heads
    conv = jnp.zeros((2, s.conv_dim - 1, d_in + 2 * s.state_dim))
    st = jnp.zeros((2, nh, s.state_dim, d_in // nh))
    tconv, tst = torch.zeros(conv.shape), torch.zeros(st.shape)
    step = _jit(jssm.mamba2_decode, jcfg)
    for t in range(length):
        y, conv, st = step(p, jnp.asarray(x[:, t:t + 1]), conv, st)
        ty, tconv, tst = ssm.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, tconv, tst)
        _close(ty, y)
    _close(tconv, conv)
    _close(tst, st, SCAN_TOL)


def test_causal_conv_matches_reference():
    x, w, b = _x((2, 9, 6)), _x((4, 6), 1), _x((6,), 2)
    _close(ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
