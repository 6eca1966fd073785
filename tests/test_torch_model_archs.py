"""All ten architectures of the port against the JAX package's, on the CPU.

For each architecture at its smoke config, the reference's
``init_params`` (carried over with ``convert.model_params_from_numpy``)
and seeded numpy inputs go through both packages: ``forward_logits``,
``forward_train``'s loss and metrics, and 8 steps of ``decode_step``
(their logits and the cache after them).  bf16 compute, so
``rtol=atol=2e-2``; the SSM and hybrid families at the reference's own
``rtol=0.1, atol=0.12`` (``tests/test_models_smoke.py``).

The reference runs in two subprocesses, side by side, with
``XLA_FLAGS=--xla_allow_excess_precision=false``: by default XLA may keep
a fused computation's intermediates in f32 where the source rounds them
to bf16, while the port rounds where the source does.  With the flag the
compiled reference gives what its source says, as it does op by op
without ``jit``.  The port's own decode-vs-forward checks (dense and
SSM) and its init rules against the reference's close the file.

Routing is the one discontinuity.  f32 sums in another order leave a
bf16 value one unit apart now and then (a product's accumulation, a
norm's ``rsqrt``), and where a token's k-th and (k+1)-th router logits
lie closer than that can move them, the two packages pick different
experts.  So the reference records each MoE call's router probabilities
and top-k experts; the port's ``moe.route`` is wrapped to compare its
own choice with them, require every disagreement to be such a near tie
(``chip_smoke.route_ties``: a log-probability gap below
``chip_smoke.ROUTE_TIE`` in both packages) and at most
``chip_smoke.ROUTE_TIE_SHARE`` of the rows routed, and go on with the
reference's experts, so that everything after the router is held to the
tolerance above on the same routing.  The chip smoke holds the card to
the CPU with the same helpers.

End to end, one bf16 unit can grow past ``2e-2`` in the reference
itself: moving one element of one token's embedding by one bf16 unit
moved the reference's smoke logits by up to 0.086 (deepseek-v3, 469
elements past ``rtol=atol=2e-2``) and 0.055 (qwen2-moe, 134), against at
most 0.031 and 3 elements in the other families.  So deepseek-v3's
logits are held layer by layer only; every other architecture's logits, and all ten
losses and metrics, are held end to end on the reference's routing
(``test_logits_and_loss_match_reference``).  Every architecture is also
compared layer by layer (``test_layers_match_reference``): each layer of
``forward_logits`` and ``forward_train`` runs in the port on the
reference's own input to it, its output held to the reference's, and the
reference's output goes on to the next layer.
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
from numpy.testing import assert_allclose, assert_array_equal

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.layers import param_tree
from repro_torch.models.model import Model

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
B, S, STEPS = 2, 32, 8
BF16_TOL = {"rtol": 2e-2, "atol": 2e-2}
SSM_TOL = {"rtol": 0.1, "atol": 0.12}
#: the architectures whose end-to-end logits are held layer by layer only
#: (module doc)
LAYERWISE_LOGITS = ("deepseek-v3-671b",)
ROOT = Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the router-tie rule the chip smoke holds the card to the CPU with
smoke = _load_smoke()


def _tol(cfg):
    return SSM_TOL if cfg.family in ("ssm", "hybrid") else BF16_TOL


def _inputs(cfg) -> dict[str, np.ndarray]:
    """Seeded numpy inputs: tokens, and the stub frontends' embeddings
    (vision, audio) and the decoder's memory where the family has them
    (float inputs become bf16 in both packages)."""
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal((B, 16, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = (rng.standard_normal((B, 2 * S, cfg.d_model)) * 0.02).astype(np.float32)
        out["memory"] = (rng.standard_normal((B, 8, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _dump_reference(path: str, part: int) -> None:
    """The reference's parameters and outputs for ``PARTS[part]``,
    pickled to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jt

    from repro.models import moe as jmoe

    def host(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)

    routes: list = []
    layers: list = []
    gather = jmoe._moe_gather
    apply_layer = jt._apply_layer

    def recorded(params, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        lg = jnp.einsum("td,de->te", xt, params["router"].astype(x.dtype))
        probs = jax.nn.softmax(lg.astype(jnp.float32), axis=-1)
        ids = jax.lax.top_k(probs, cfg.moe.top_k)[1]
        jax.debug.callback(lambda p, i: routes.append((np.asarray(p), np.asarray(i))),
                           probs, ids, ordered=True)
        return gather(params, x, cfg)

    def recorded_layer(kind, lp, x, *args, **kw):
        y, aux = apply_layer(kind, lp, x, *args, **kw)
        jax.debug.callback(lambda a, b: layers.append((host(a), host(b))), x, y, ordered=True)
        return y, aux

    jmoe._moe_gather = recorded
    jt._apply_layer = recorded_layer

    def take(records):
        jax.effects_barrier()
        out, records[:] = list(records), []
        return out

    def take_routes():
        take(layers)
        return take(routes)

    out = {}
    for arch in PARTS[part]:
        cfg = jget_config(arch, smoke=True)
        params = jax.jit(jt.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
        inputs = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
                  for k, v in _inputs(cfg).items()}
        memory = inputs.pop("memory", None)
        take_routes()
        logits, aux = jax.jit(lambda p, b: jt.forward_logits(p, cfg, b))(params, inputs)
        layers_logits, routes_logits = take(layers), take(routes)
        loss, metrics = jax.jit(lambda p, b: jt.forward_train(p, cfg, b))(params, inputs)
        layers_train, routes_train = take(layers), take(routes)
        step = jax.jit(lambda p, t, c, n: jt.decode_step(p, cfg, t, c, n, memory=memory))
        cache = jt.init_cache(cfg, B, STEPS)
        steps = []
        for t in range(STEPS):
            lg, cache = step(params, inputs["tokens"][:, t:t + 1], cache, jnp.int32(t))
            steps.append(np.asarray(lg[:, 0], np.float32))
        out[arch] = {
            "routes": {"logits": routes_logits, "train": routes_train,
                       "decode": take_routes()},
            "layers": {"logits": layers_logits, "train": layers_train},
            "params": host(params), "logits": np.asarray(logits, np.float32),
            "aux": float(aux), "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "decode": np.stack(steps, axis=1),
            "cache": host(cache),
        }
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_archs")
    root = ROOT
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(root / "src"), str(root / "tests")])
    code = ("import sys, test_torch_model_archs as m; "
            "m._dump_reference(sys.argv[1], int(sys.argv[2]))")
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp / f"{i}.pkl"), str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=root)
        for i in range(len(PARTS))
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


def _port(cfg, params_np) -> transformer.Transformer:
    net = transformer.Transformer(cfg, "cpu")
    net.load_state_dict(model_params_from_numpy(cfg, params_np))
    return net


@pytest.fixture
def routing(monkeypatch):
    """Replays the reference's routing into ``moe.route`` (module doc):
    ``routing(records)`` arms it with one phase's records; ``routing()``
    checks that the port made exactly that many MoE calls and that at
    most ``ROUTE_TIE_SHARE`` of the rows routed so far were near ties
    replayed, prints the count and returns it."""
    from repro_torch.models import moe

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

    def arm(records=None):
        assert not queue, f"{len(queue)} reference MoE calls left unmatched"
        if records is None:
            smoke.check_tie_share("port vs reference", count["ties"], count["rows"])
            print(f"routing: {count['ties']} of {count['rows']} routed rows replayed "
                  f"at a near tie")
            return dict(count)
        queue.extend(records)

    yield arm
    assert not queue, f"{len(queue)} reference MoE calls left unmatched"
    smoke.check_tie_share("port vs reference", count["ties"], count["rows"])


def _torch_inputs(cfg):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in _inputs(cfg).items()}


def _close(got, want, tol, msg=""):
    assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), err_msg=msg,
                    **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(reference, routing, arch):
    """End to end on the reference's routing: the logits (but for
    ``LAYERWISE_LOGITS``), the loss and its metrics (module doc)."""
    cfg = get_config(arch, smoke=True)
    ref = reference[arch]
    net = _port(cfg, ref["params"])
    batch = _torch_inputs(cfg)
    batch.pop("memory", None)
    with torch.no_grad():
        routing(ref["routes"]["logits"])
        logits, aux = transformer.forward_logits(net, cfg, batch)
        routing(ref["routes"]["train"])
        loss, metrics = transformer.forward_train(net, cfg, batch)
    routing()
    total = S + (16 if cfg.family == "vlm" else 0)
    assert logits.shape == (B, total, cfg.vocab_size) == ref["logits"].shape
    tol = _tol(cfg)
    if arch not in LAYERWISE_LOGITS:
        _close(logits, ref["logits"], tol)
    assert set(metrics) == set(ref["metrics"])
    for key, value in [("aux", aux), ("loss", loss)] + sorted(metrics.items()):
        want = ref[key] if key in ("aux", "loss") else ref["metrics"][key]
        _close(value, want, tol, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_match_reference(reference, routing, monkeypatch, arch):
    """``forward_logits`` and ``forward_train`` with every layer run on the
    reference's input to it (module doc): the port's own input to each
    layer (the embedding, the vision prefix, a hybrid's shared attention
    before it) and each layer's output are held to the reference's, then
    the logits, the loss and its metrics."""
    cfg = get_config(arch, smoke=True)
    ref = reference[arch]
    net = _port(cfg, ref["params"])
    batch = _torch_inputs(cfg)
    batch.pop("memory", None)
    tol = _tol(cfg)
    apply_layer, queue = transformer._apply_layer, []

    def forced(kind, lp, x, *args, **kw):
        x_in, x_out = queue.pop(0)
        _close(x, x_in, tol, f"{kind} input")
        y, aux = apply_layer(kind, lp, torch.from_numpy(x_in).to(x.dtype), *args, **kw)
        _close(y, x_out, tol, f"{kind} output")
        return torch.from_numpy(x_out).to(y.dtype), aux

    monkeypatch.setattr(transformer, "_apply_layer", forced)
    with torch.no_grad():
        queue.extend(ref["layers"]["logits"])
        routing(ref["routes"]["logits"])
        logits, aux = transformer.forward_logits(net, cfg, batch)
        assert not queue
        queue.extend(ref["layers"]["train"])
        routing(ref["routes"]["train"])
        loss, metrics = transformer.forward_train(net, cfg, batch)
        assert not queue
    routing()
    n_layers = cfg.n_layers + cfg.n_encoder_layers
    assert len(ref["layers"]["logits"]) == n_layers
    assert len(ref["layers"]["train"]) == n_layers + (1 if cfg.mtp_depth else 0)
    _close(logits, ref["logits"], tol)
    for key, value in [("aux", aux), ("loss", loss)] + sorted(metrics.items()):
        want = ref[key] if key in ("aux", "loss") else ref["metrics"][key]
        _close(value, want, tol, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(reference, routing, arch):
    """8 decode steps from an empty cache: each step's logits, then every
    cache leaf (shape, dtype and values)."""
    cfg = get_config(arch, smoke=True)
    ref = reference[arch]
    net = _port(cfg, ref["params"])
    batch = _torch_inputs(cfg)
    model = Model(cfg, "cpu")
    cache = model.init_cache(B, STEPS)
    tol = _tol(cfg)
    routing(ref["routes"]["decode"])
    with torch.no_grad():
        for t in range(STEPS):
            logits, cache = model.decode_step(net, batch["tokens"][:, t:t + 1], cache, t,
                                              memory=batch.get("memory"))
            assert logits.shape == (B, 1, cfg.vocab_size)
            _close(logits[:, 0], ref["decode"][:, t], tol, f"step {t}")
    routing()
    want = ref["cache"]
    assert (cache["shared_attn"] is None) == (want["shared_attn"] is None)
    got_leaves, want_leaves = _leaves(cache), _leaves(want)
    assert list(got_leaves) == list(want_leaves)
    for path, g in got_leaves.items():
        assert g.dtype == (torch.float32 if path.endswith("ssm") else torch.bfloat16), path
        assert tuple(g.shape) == want_leaves[path].shape, path
        _close(g, want_leaves[path], tol, path)


def _leaves(tree, prefix="") -> dict:
    """``{dotted path: leaf}`` of a nested dict/list tree, sorted, without
    ``None`` subtrees."""
    if tree is None:
        return {}
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_leaves(sub, f"{prefix}.{key}" if prefix else str(key)))
        return dict(sorted(out.items()))
    return {prefix: tree}


@pytest.mark.parametrize("arch,tol", [("llama3.2-1b", BF16_TOL), ("falcon-mamba-7b", SSM_TOL)])
def test_decode_matches_forward(arch, tol):
    """Greedy decode logits equal teacher-forced forward logits, with the
    port's own seeded weights (the reference's test, on the port)."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "cpu")
    net = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = model.logits(net, {"tokens": tokens})
        cache = model.init_cache(1, 8)
        outs = []
        for t in range(8):
            logits, cache = model.decode_step(net, tokens[:, t:t + 1], cache, t)
            outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1).float(), full.float(), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_rules_match_reference(reference, arch):
    """``init_params`` from a generator: the reference's tree, leaf for
    leaf; its deterministic leaves (norm scales, biases, ``A_log``,
    ``D``) equal, its random leaves with the reference's std."""
    cfg = get_config(arch, smoke=True)
    want = model_params_from_numpy(cfg, reference[arch]["params"])
    got = transformer.init_params(torch.Generator().manual_seed(0), cfg).state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if torch.unique(w).numel() <= w.shape[-1]:  # ones, zeros, log(1..n)
            assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        else:
            assert abs(float(g.std() / w.std()) - 1) < 0.15, name
    assert len(param_tree(transformer.Transformer(cfg, "meta"))) == len(reference[arch]["params"])

