"""The port's expert-parallel MoE path against its gather path and the
JAX package's EP path, on the CPU.

``tests/test_moe_ep.py``'s case: the qwen2-moe-a2.7b smoke config at
``capacity_factor`` 8 (neither path drops a token), a (4, 8, d) bf16
input, and also the same block with 7 experts, which the model axis
does not divide (the stack is padded to 8, and each shard slices it).
Parameters and input are drawn with numpy from a seed, so both packages
take the same ones.

* **On four gloo ranks** (a 2x2 data x model mesh, parameters placed by
  ``param_shardings``): ``y`` against the port's gather path and against
  the reference's EP output on four forced CPU devices (in a subprocess)
  at the reference test's 5e-2, ``aux`` at rtol 5e-2, and the gradients
  of ``sum(y**2) + aux`` against the gather path's by relative L2 (the
  reference only checks its gradients for being finite).
* **In one process** (plain tensors under a logical policy, the shards
  in turn, as ``chip_smoke.py`` runs the block on the card): the same,
  at (data 2, model 2) and (data 2, model 4) layouts.
* The dispatch takes the EP path only where the reference does, and the
  EP path under remat replays its routes (bit-equal gradients).
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe, sharding_policy, transformer
from torch_ranks import run_ranks, run_reference

#: the reference test's bounds on y and on aux
Y_TOL = {"rtol": 5e-2, "atol": 5e-2}
AUX_RTOL = 5e-2
#: each parameter's gradient, EP against gather, by relative L2: the two
#: paths sum the same bf16 products in other orders (0.002-0.006 read on
#: the 2x2 ranks)
GRAD_REL_L2 = 2e-2
CASES = {"smoke": 8, "pad7": 7}


def _cfg(n_experts: int, get=get_config):
    cfg = get("qwen2-moe-a2.7b", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, n_experts=n_experts))


def _case(n_experts: int) -> tuple[dict, np.ndarray]:
    """Numpy parameters (dotted names, the JAX package's init scales) and
    input of the block."""
    cfg = _cfg(n_experts)
    rng = np.random.default_rng(n_experts)
    shapes = {k: tuple(p.shape) for k, p in moe.MoE(cfg, None, "meta").named_parameters()}
    params = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
              for k, s in sorted(shapes.items())}
    x = (rng.standard_normal((4, 8, cfg.d_model)) * 0.1).astype(np.float32)
    return params, x


def _tree(flat: dict) -> dict:
    tree = {k: v for k, v in flat.items() if not k.startswith("shared.")}
    tree["shared"] = {k[len("shared."):]: v for k, v in flat.items()
                      if k.startswith("shared.")}
    return tree


def _dump_reference(path: str) -> None:
    """The reference's gather and 2x2 EP outputs of each case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.configs import get_config as jget_config
    from repro.models import moe as jmoe
    from repro.models.sharding_policy import clear_policy, set_policy_from_mesh

    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    out = {}
    for name, n in CASES.items():
        cfg = _cfg(n, jget_config)
        params, x = _case(n)
        params = jax.tree_util.tree_map(jnp.asarray, _tree(params))
        x = jnp.asarray(x).astype(jnp.bfloat16)
        fn = jax.jit(lambda p, x, cfg=cfg: jmoe.moe_apply(p, x, cfg))
        clear_policy()
        y_g, aux_g = fn(params, x)
        set_policy_from_mesh(mesh)
        with set_mesh(mesh):
            y_ep, aux_ep = jax.jit(lambda p, x, cfg=cfg: jmoe.moe_apply(p, x, cfg))(params, x)
        clear_policy()
        out[name] = {"y_gather": np.asarray(y_g, np.float32), "aux_gather": float(aux_g),
                     "y_ep": np.asarray(y_ep, np.float32), "aux_ep": float(aux_ep)}
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _gather(n_experts: int) -> dict:
    """The port's gather path: y, aux and the gradients."""
    return _apply(n_experts, None)


def _apply(n_experts: int, policy) -> dict:
    params, x = _case(n_experts)
    flat = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    if policy is None:
        sharding_policy.clear_policy()
    else:
        sharding_policy.set_policy(*policy)
    try:
        y, aux = moe.moe_apply(_tree(flat), torch.from_numpy(x).to(torch.bfloat16),
                               _cfg(n_experts))
    finally:
        sharding_policy.clear_policy()
    grads = torch.autograd.grad((y.float() ** 2).sum() + aux, list(flat.values()))
    return {"y": y.detach().float().numpy(), "aux": float(aux.detach()),
            "grads": {k: g.numpy() for k, g in zip(flat, grads)}}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(got: dict, want: dict, label: str) -> None:
    np.testing.assert_allclose(got["y"], want["y"], err_msg=label, **Y_TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=AUX_RTOL, err_msg=label)
    assert sorted(got["grads"]) == sorted(want["grads"])
    errs = {k: _rel_l2(got["grads"][k], w) for k, w in want["grads"].items()}
    print(label, "grad rel L2:", errs)
    assert max(errs.values()) <= GRAD_REL_L2, (label, errs)
    for k, g in got["grads"].items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, (label, k)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_moe_ep", tmp_path_factory.mktemp("moe_ep_ref"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep_ranks")
    paths = []
    for name, n in CASES.items():
        params, x = _case(n)
        paths.append(str(tmp / f"{name}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump({"cfg": _cfg(n), "params": params, "x": x}, f)
    return run_ranks("ep", paths, tmp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_on_2x2_ranks_matches_gather_and_reference(ranks, reference, case):
    got, ref = ranks[case], reference[case]
    _check(got, _gather(CASES[case]), f"2x2 ranks {case}")
    np.testing.assert_allclose(got["y"], ref["y_ep"], **Y_TOL)
    np.testing.assert_allclose(got["aux"], ref["aux_ep"], rtol=AUX_RTOL)
    # the two gather paths agree as the model tests hold them
    np.testing.assert_allclose(_gather(CASES[case])["y"], ref["y_gather"], **Y_TOL)
    # the experts were sharded over model where the stack divides
    expert = got["placements"]["w_gate"]
    if CASES[case] % 2 == 0:
        assert expert == ("Shard(dim=1)", "Shard(dim=0)"), expert
    else:
        assert expert[1] == "Replicate()", expert


@pytest.mark.parametrize("layout", [(2, 2), (2, 4)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_in_turn_matches_gather(case, layout):
    data, model = layout
    policy = ("data", "model", {"data": data, "model": model})
    got = _apply(CASES[case], policy)
    _check(got, _gather(CASES[case]), f"in turn {case} {layout}")


def test_ep_dispatch_follows_the_reference():
    """EP only under a policy with a model axis, more than one data
    shard and a batch they divide."""
    calls = []
    real = moe._moe_ep_serial

    def spy(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    cfg = _cfg(8)
    params, _ = _case(8)
    tree = _tree({k: torch.from_numpy(v) for k, v in params.items()})
    x = torch.zeros(3, 8, cfg.d_model, dtype=torch.bfloat16)
    moe._moe_ep_serial = spy
    try:
        for policy, rows in [(("data", "model", {"data": 2, "model": 2}), 3),
                             (("data", "model", {"data": 1, "model": 2}), 4),
                             (("data", None, {"data": 2}), 4),
                             (None, 4),
                             (("data", "model", {"data": 2, "model": 2}), 4)]:
            sharding_policy.clear_policy()
            if policy:
                sharding_policy.set_policy(*policy)
            moe.moe_apply(tree, x[:1].expand(rows, -1, -1).contiguous(), cfg)
    finally:
        moe._moe_ep_serial = real
        sharding_policy.clear_policy()
    assert calls == [4]


def test_ep_path_under_remat_replays_routes(monkeypatch):
    """A MoE model's gradients through the EP path (logical 2x2, the
    shards in turn) with no remat and under ``"full"``: bit-equal, the
    recompute taking the forward's routes."""
    from test_torch_train_grads import port_grads

    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    net = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
    sharding_policy.set_policy("data", "model", {"data": 2, "model": 2})
    calls = []
    real = moe._moe_ep_serial
    monkeypatch.setattr(moe, "_moe_ep_serial", lambda *a: calls.append(1) or real(*a))
    try:
        with monkeypatch.context() as m:
            m.setattr(transformer, "_remat", lambda fn, *args: fn(*args))
            base_loss, _, base = port_grads(cfg, net, {"tokens": tokens})
        loss, _, grads = port_grads(cfg, net, {"tokens": tokens})
    finally:
        sharding_policy.clear_policy()
    assert calls, "the EP path never ran"
    assert torch.equal(loss, base_loss)
    for k, g in base.items():
        np.testing.assert_array_equal(grads[k], g, err_msg=k)


@pytest.mark.parametrize("layout", [(2, 4), (2, 8)])
def test_chip_ep_part_runs_on_cpu(layout):
    """``chip_smoke.py``'s part (e) 2 with the CPU as the card, at the
    smoke width (8 experts: 2 a shard at model 4, 1 at model 8)."""
    from test_torch_train_grads import smoke

    out = smoke._ep_block(layout, smoke=True, card="cpu")
    assert out["calls"] == layout[0] * layout[1]
    assert out["routed_rows"] == layout[1] * smoke.EP_B * smoke.EP_S
    assert max(out["grad_rel_l2"].values()) <= smoke.TRAIN_REL_L2
