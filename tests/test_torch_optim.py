"""The port's optimizer substrate against the JAX package's, on the CPU.

``adamw_update`` over five steps at the ``warmup_cosine`` scale of each
step, ``clip_by_global_norm``, the schedules, and the int8 gradient
compression (its codes, scales and error buffers exactly) take the same
seeded numpy inputs in both packages.  The f32 arithmetic is the
reference's, operation for operation, but XLA and PyTorch evaluate
``pow``, ``sqrt`` and the norm's sums with their own kernels, so f32
results are held to ``1e-6`` of each leaf's largest magnitude (a few f32
units; element by element the relative error is unbounded where a
moment's two terms nearly cancel) and bf16 parameters to one bf16 unit.  The JAX package's
``TestAdamW`` and ``TestGradCompression`` cases close the file, on the
port.
"""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro import optim as jopt
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    compressed_grad_transform,
    constant,
    decompress_grads,
    init_error_feedback,
    warmup_cosine,
)

F32_RTOL = 1e-6
#: one bf16 unit, relative
BF16_RTOL = 2.0**-7
#: leaf name -> (shape, dtype): dotted names, as a model's parameters
LEAVES = {
    "embedding.embed": ((16, 8), np.float32),
    "stages.0.kind_params.attn.wq": ((2, 8, 12), np.float32),
    "stages.0.kind_params.norm1.scale": ((2, 8), np.float32),
    "stages.1.kind_params.mlp.w_up": ((3, 8, 4), "bfloat16"),
    "final_norm.scale": ((8,), np.float32),
}
CFG = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0}
WARMUP, TOTAL = 2, 5


def _np_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype


def _tree(rng, scale: float) -> dict[str, np.ndarray]:
    return {k: (rng.standard_normal(shape) * scale).astype(_np_dtype(dt))
            for k, (shape, dt) in LEAVES.items()}


def _torch(arrays: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)
        for k, a in arrays.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _hold(got, want, msg=""):
    """f32: within ``F32_RTOL`` of the leaf's largest magnitude; bf16:
    within one unit of each element."""
    want = np.asarray(want)
    if want.dtype == ml_dtypes.bfloat16:
        tol = {"rtol": BF16_RTOL, "atol": 0}
    else:
        tol = {"rtol": 0, "atol": F32_RTOL * float(np.abs(want).max())}
    assert_allclose(_np(got), want.astype(np.float32), err_msg=msg, **tol)


def test_adamw_matches_reference():
    """Five steps from the same parameters with gradients drawn per step,
    large enough that the clip acts: parameters (f32 and bf16), moments,
    the step counter and ``grad_norm`` at every step."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.adamw_init(jparams)
    tparams = _torch(params)
    tstate = adamw_init(tparams)
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    assert all(m.dtype == torch.float32 for m in tstate["mu"].values())
    jcfg, tcfg = jopt.AdamWConfig(**CFG), AdamWConfig(**CFG)
    for step in range(5):
        grads = _tree(rng, 3.0)
        jscale = jopt.warmup_cosine(jstate["step"], warmup=WARMUP, total=TOTAL)
        tscale = warmup_cosine(tstate["step"], warmup=WARMUP, total=TOTAL)
        _hold(tscale, jscale, "lr scale")
        jparams, jstate, jm = jopt.adamw_update(jcfg, jparams, {k: jnp.asarray(v) for k, v in
                                                                grads.items()}, jstate, jscale)
        tparams, tstate, tm = adamw_update(tcfg, tparams, _torch(grads), tstate, tscale)
        assert float(jm["grad_norm"]) > CFG["grad_clip"]
        _hold(tm["grad_norm"], jm["grad_norm"], f"step {step} grad_norm")
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for k in LEAVES:
            assert tparams[k].dtype == (torch.bfloat16 if LEAVES[k][1] == "bfloat16"
                                        else torch.float32)
            _hold(tparams[k], jparams[k], f"step {step} {k}")
            _hold(tstate["mu"][k], jstate["mu"][k], f"step {step} mu {k}")
            _hold(tstate["nu"][k], jstate["nu"][k], f"step {step} nu {k}")


@pytest.mark.parametrize("scale,max_norm", [(3.0, 1.0), (0.01, 1.0), (1.0, 0.5)])
def test_clip_by_global_norm_matches_reference(scale, max_norm):
    grads = _tree(np.random.default_rng(1), scale)
    jclipped, jgn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()},
                                             max_norm)
    tclipped, tgn = clip_by_global_norm(_torch(grads), max_norm)
    _hold(tgn, jgn)
    for k in LEAVES:
        # the f32 scale promotes bf16 leaves in both packages
        assert tclipped[k].dtype == torch.float32 and jclipped[k].dtype == jnp.float32
        _hold(tclipped[k], jclipped[k], k)


@pytest.mark.parametrize("step", [0, 1, 9, 10, 55, 100, 150])
def test_schedules_match_reference(step):
    """Steps 0, 1, the end of warmup and one before it, mid-run, total
    and past total."""
    for kw in ({"warmup": 10, "total": 100}, {"warmup": 10, "total": 100, "min_ratio": 0.0},
               {"warmup": 0, "total": 1}):
        want = jopt.warmup_cosine(jnp.int32(step), **kw)
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        _hold(got, want, str(kw))
    got = constant(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and float(got) == float(jopt.constant(jnp.int32(step)))


def test_compression_matches_reference_exactly():
    """Four rounds of ``compress_grads`` with the error buffer carried:
    int8 codes, scales and error buffers equal bit for bit; then
    ``decompress_grads`` and ``compressed_grad_transform``.  One leaf is
    all zeros (its scale floors at 1e-12) and one holds exact halves of
    its scale (round half to even)."""
    rng = np.random.default_rng(2)
    params = _tree(rng, 1.0)
    jerr = jopt.init_error_feedback({k: jnp.asarray(v) for k, v in params.items()})
    terr = init_error_feedback(_torch(params))
    for k, e in terr.items():
        assert e.dtype == torch.float32 and e.shape == params[k].shape
    for rnd in range(4):
        grads = _tree(rng, 0.05)
        grads["final_norm.scale"][:] = 0.0
        if rnd == 0:
            # scale 1 exactly (max 127): codes of +-0.5, 1.5, 2.5 round to even
            grads["embedding.embed"][0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
        jq, js, jerr_new = jopt.compress_grads({k: jnp.asarray(v) for k, v in grads.items()},
                                               jerr)
        tq, ts, terr_new = compress_grads(_torch(grads), terr)
        if rnd == 0:
            assert_array_equal(tq["embedding.embed"][0, :8].numpy(),
                               [127, 0, 2, 2, 0, -2, -2, 4])
        for k in LEAVES:
            assert tq[k].dtype == torch.int8
            assert_array_equal(tq[k].numpy(), np.asarray(jq[k]), err_msg=f"round {rnd} {k}")
            assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=f"round {rnd} {k}")
            assert_array_equal(terr_new[k].numpy(), np.asarray(jerr_new[k]),
                               err_msg=f"round {rnd} {k}")
        assert float(ts["final_norm.scale"]) == np.float32(1e-12)
        jd = jopt.decompress_grads(jq, js)
        td = decompress_grads(tq, ts)
        for k in LEAVES:
            assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        jg, jerr_rt = jopt.compressed_grad_transform(
            {k: jnp.asarray(v) for k, v in grads.items()}, jerr)
        tg, terr_rt = compressed_grad_transform(_torch(grads), terr)
        for k in LEAVES:
            assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            assert_array_equal(terr_rt[k].numpy(), np.asarray(jerr_rt[k]))
        jerr, terr = jerr_new, terr_new


# --------------------------------------------------------------------- #
# the JAX package's TestAdamW and TestGradCompression, on the port
# --------------------------------------------------------------------- #
class TestAdamW:
    def test_minimises_quadratic(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
        params = {"w": torch.tensor([3.0, -2.0])}
        state = adamw_init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, _ = adamw_update(cfg, params, grads, state)
        assert float(params["w"].abs().max()) < 0.05

    def test_grad_clip(self):
        grads = {"a": torch.full((4,), 100.0)}
        clipped, gn = clip_by_global_norm(grads, 1.0)
        assert float(gn) == pytest.approx(200.0)
        assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)

    def test_schedule_shape(self):
        def at(step):
            return float(warmup_cosine(torch.tensor(step, dtype=torch.int32), warmup=10,
                                       total=100))

        assert at(0) == 0.0 and at(10) == pytest.approx(1.0) and at(100) < 0.2


class TestGradCompression:
    def test_roundtrip_with_error_feedback(self):
        params = {"w": torch.zeros(64)}
        err = init_error_feedback(params)
        rng = np.random.default_rng(0)
        total_true = np.zeros(64)
        total_applied = np.zeros(64)
        for _ in range(50):
            g = {"w": torch.from_numpy(rng.standard_normal(64) * 0.01).float()}
            total_true += g["w"].numpy()
            gq, err = compressed_grad_transform(g, err)
            total_applied += gq["w"].numpy()
        # error feedback keeps the cumulative applied gradient unbiased
        assert_allclose(total_applied, total_true, atol=2e-4)
