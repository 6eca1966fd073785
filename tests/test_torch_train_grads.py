"""Gradients of the port's ``forward_train`` against the JAX package's
``jax.value_and_grad``, for all ten architectures at their smoke
configs, on the CPU.

The reference's ``init_params`` (carried over with
``convert.model_params_from_numpy``) and seeded numpy inputs go through
both packages; the port's gradients come from autograd through its
rematerialised layers (``REMAT_POLICY`` "full", as the reference's
default).  bf16 compute, so each gradient leaf is held by its relative
L2 error, ``||g - g_ref|| / ||g_ref||``, within ``GRAD_REL_L2`` (5e-2;
0.0035-0.0191 was measured on five of the ten before the port was
written); a leaf the reference's loss does not reach must be zero in
both.  The loss and its metrics are held as in
``tests/test_torch_model_archs.py``.

The reference runs in two subprocesses, side by side, with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (see that file).  Its
MoE calls record their experts through ``jax.debug.callback``: under
its remat each fires in the forward, layer by layer, and again in the
backward's recompute, in reverse; the forward's records are replayed
into the port's ``moe.route`` where the routers split a near tie
(``chip_smoke.route_ties``), as in that file.  The port's recompute
replays its own forward's routes (``moe.route_tape``), so the hook is
called once per MoE call.
"""

from __future__ import annotations

import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import moe, transformer

ARCHS = [
    "qwen3-0.6b",
    "granite-20b",
    "deepseek-7b",
    "llama3.2-1b",
    "qwen2-moe-a2.7b",
    "deepseek-v3-671b",
    "falcon-mamba-7b",
    "zamba2-1.2b",
    "seamless-m4t-large-v2",
    "qwen2-vl-72b",
]
#: the reference's two subprocesses
PARTS = (ARCHS[:5], ARCHS[5:])
B, S = 2, 32
GRAD_REL_L2 = 5e-2
BF16_TOL = {"rtol": 2e-2, "atol": 2e-2}
SSM_TOL = {"rtol": 0.1, "atol": 0.12}
ROOT = Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the router-tie rule the chip smoke holds the card to the CPU with
smoke = _load_smoke()


def _inputs(cfg) -> dict[str, np.ndarray]:
    """Seeded numpy inputs: tokens and the stub frontends' embeddings
    (float inputs become bf16 in both packages)."""
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal((B, 16, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = (rng.standard_normal((B, 2 * S, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def forward_routes(records: list, label: str) -> list:
    """The forward's half of a remat'd gradient run's MoE records (module
    doc), after checking the other half is the recompute's, in reverse."""
    n = len(records) // 2
    fwd, rec = records[:n], records[n:]
    if len(records) % 2 or any(not np.array_equal(f[1], r[1]) for f, r in zip(fwd, rec[::-1])):
        raise AssertionError(f"{label}: {len(records)} MoE records are not a forward and "
                             f"its recompute")
    return fwd


def record_routes():
    """Patch the reference's MoE gather to record each call's router
    probabilities and experts; returns the record list."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    routes: list = []
    gather = jmoe._moe_gather

    def recorded(params, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        lg = jnp.einsum("td,de->te", xt, params["router"].astype(x.dtype))
        probs = jax.nn.softmax(lg.astype(jnp.float32), axis=-1)
        ids = jax.lax.top_k(probs, cfg.moe.top_k)[1]
        jax.debug.callback(lambda p, i: routes.append((np.asarray(p), np.asarray(i))),
                           probs, ids, ordered=True)
        return gather(params, x, cfg)

    jmoe._moe_gather = recorded
    return routes


def host_tree(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _dump_reference(path: str, part: int) -> None:
    """The reference's parameters, loss, metrics, gradients and forward
    routes for ``PARTS[part]``, pickled to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jt

    routes = record_routes()
    out = {}
    for arch in PARTS[part]:
        cfg = jget_config(arch, smoke=True)
        params = jax.jit(jt.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
        inputs = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
                  for k, v in _inputs(cfg).items()}
        grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jt.forward_train(p, cfg, b),
                                             has_aux=True))
        (loss, metrics), grads = grad_fn(params, inputs)
        jax.effects_barrier()
        records, routes[:] = list(routes), []
        out[arch] = {
            "params": host_tree(params), "grads": host_tree(grads), "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "routes": forward_routes(records, arch),
        }
    with open(path, "wb") as f:
        pickle.dump(out, f)


def run_reference(tmp: Path, module: str, n_parts: int) -> dict:
    """``module._dump_reference(path, part)`` for each part in its own
    subprocess, side by side, with the XLA flag of the module doc; the
    merged pickles."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    code = (f"import sys, {module} as m; "
            "m._dump_reference(sys.argv[1], int(sys.argv[2]))")
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp / f"{i}.pkl"), str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=ROOT)
        for i in range(n_parts)
    ]
    out = {}
    try:
        for i, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"part {i}: stdout={stdout}\nstderr={stderr[-3000:]}"
            with open(tmp / f"{i}.pkl", "rb") as f:
                out.update(pickle.load(f))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("train_grads"), "test_torch_train_grads",
                         len(PARTS))


def flat(tree, prefix="") -> dict[str, np.ndarray]:
    """A nested dict/list tree as ``{dotted path: leaf}``."""
    if isinstance(tree, (dict, list)):
        out = {}
        for key, sub in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(flat(sub, f"{prefix}.{key}" if prefix else str(key)))
        return out
    return {prefix: tree}


@pytest.fixture
def routing(monkeypatch):
    """``routing(records)`` replays the reference's experts into
    ``moe.route``, each call's choice held to differ from the port's only
    at a near tie; returns the count dict (``ties``, ``rows``)."""
    route, queue, count = moe.route, [], {"ties": 0, "rows": 0}

    def replay(params, xt, cfg):
        assert queue, "the port routed more MoE calls than the reference"
        want_probs, want_ids = queue.pop(0)
        probs, ids = route(params, xt, cfg)
        ties, _ = smoke.route_ties(probs, ids, want_probs, want_ids, cfg.moe.top_k)
        count["ties"] += ties
        count["rows"] += ids.shape[0]
        return probs, torch.from_numpy(want_ids.astype(np.int64))

    monkeypatch.setattr(moe, "route", replay)

    def arm(records):
        assert not queue, f"{len(queue)} reference MoE calls left unmatched"
        queue.extend(records)
        return count

    yield arm
    assert not queue, f"{len(queue)} reference MoE calls left unmatched"
    smoke.check_tie_share("port vs reference", count["ties"], count["rows"])


def torch_batch(inputs: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in inputs.items()}


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """``||got - want|| / ||want||`` (0 where both are zero, inf where only
    ``want`` is)."""
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got - want))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def port_grads(cfg, net, batch) -> tuple:
    named = dict(net.named_parameters())
    loss, metrics = transformer.forward_train(net, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss, metrics, {k: (torch.zeros_like(p) if g is None else g).float().numpy()
                           for (k, p), g in zip(named.items(), grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(reference, routing, arch):
    cfg = get_config(arch, smoke=True)
    ref = reference[arch]
    net = transformer.Transformer(cfg, "cpu")
    net.load_state_dict(model_params_from_numpy(cfg, ref["params"]))
    count = routing(ref["routes"])
    loss, metrics, grads = port_grads(cfg, net, torch_batch(_inputs(cfg)))
    tol = SSM_TOL if cfg.family in ("ssm", "hybrid") else BF16_TOL
    assert set(metrics) == set(ref["metrics"])
    for key, value in [("loss", loss)] + sorted(metrics.items()):
        want = ref["loss"] if key == "loss" else ref["metrics"][key]
        assert_allclose(float(value.detach()), want, err_msg=key, **tol)
    want = flat(ref["grads"])
    assert sorted(grads) == sorted(want)
    errs = {k: rel_l2(grads[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    print(f"{arch}: largest relative L2 error {errs[worst]:.4g} at {worst}; "
          f"{count['ties']} of {count['rows']} routed rows replayed at a near tie")
    bad = {k: e for k, e in errs.items() if not e <= GRAD_REL_L2}
    assert not bad, f"{arch}: gradient leaves past {GRAD_REL_L2}: {bad}"
