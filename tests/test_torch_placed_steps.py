"""Train steps on placed (DTensor) states against the same steps on plain
tensors, in gloo ranks (``tests/torch_ranks.py``'s ``steps`` task), and
at 2x2 against the JAX package's steps on the same mesh:

* qwen2-moe-a2.7b's smoke config on the 1x1 mesh, the drivers' own: its
  MoE block takes the gather path (no data axis to split tokens over),
  which on DTensors runs on replicated local tensors (DTensor has no
  sharding rule for the routing's ``searchsorted``);
* granite-20b's smoke config on the 2x2 mesh: one kv head, so the k and v
  projections shard head_dim and the attention regroups head-sharded
  queries onto the replicated kv head on local tensors;
* zamba2-1.2b's smoke config on the 2x2 mesh: its Mamba-2 scan runs on
  local heads.

Each run takes three steps from one state (the 2x2 pair from the
reference's initial state); the losses and metrics are held at
``tests/test_torch_train.py``'s bf16 tolerance and each weight's change
over the steps at its relative-L2 bound.  The 2x2 pair's placed steps are
also held to the reference's 2x2 trajectory (``run_reference``: four
forced CPU devices): its losses at ``tests/test_torch_sharding.py``'s
``LOSS_TOL`` and each weight's change at the same relative-L2 bound.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
from numpy.testing import assert_allclose

from torch_ranks import run_ranks, run_reference

#: ``tests/test_torch_train.py``'s tolerances
BF16_TOL = {"rtol": 2e-2, "atol": 2e-2}
PARAM_DELTA_REL_L2 = 0.2
#: ``tests/test_torch_sharding.py``'s bound on a 2x2 loss against the
#: reference's
LOSS_TOL = 0.05
STEPS, SEQ, BATCH = 3, 16, 4
#: the archs run at 2x2, in both packages
REF_ARCHS = ("granite-20b", "zamba2-1.2b")
CASES = [("qwen2-moe-a2.7b", (1, 1)), *((arch, (2, 2)) for arch in REF_ARCHS)]


def _dump_reference(path: str) -> None:
    """Each of ``REF_ARCHS``' initial state and its 2x2 trajectory in the
    JAX package: the losses and the final parameters."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.data import DataConfig, SyntheticCorpus
    from repro.launch.sharding import batch_shardings, state_shardings
    from repro.models.sharding_policy import set_policy_from_mesh
    from repro.train import TrainConfig, init_train_state, make_train_step

    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    set_policy_from_mesh(mesh)
    out = {}
    for arch in REF_ARCHS:
        cfg = get_config(arch, smoke=True)
        tcfg = TrainConfig(total_steps=6, warmup_steps=1)
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                            global_batch=BATCH))
        init = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
        host = jax.tree_util.tree_map(np.asarray, init)
        with set_mesh(mesh):
            state = jax.tree_util.tree_map(jax.device_put, init, state_shardings(init, mesh))
            step = jax.jit(make_train_step(cfg, tcfg))
            losses = []
            for s in range(STEPS):
                b = {k: jnp.asarray(v) for k, v in corpus.batch(s).items()}
                b = jax.tree_util.tree_map(jax.device_put, b, batch_shardings(b, mesh))
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        out[arch] = {"init": host, "losses": losses,
                     "params": jax.tree_util.tree_map(np.asarray, state["params"])}
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_placed_steps", tmp_path_factory.mktemp("placed_ref"))


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Each case's plain and placed runs, made once for both tests."""
    made = {}

    def get(arch, mesh):
        if arch not in made:
            tmp = tmp_path_factory.mktemp(f"steps_{arch}")
            extra = []
            if arch in reference:
                init_path = tmp / "init.pkl"
                with open(init_path, "wb") as f:
                    pickle.dump(reference[arch]["init"], f)
                extra = [str(init_path)]
            made[arch] = run_ranks("steps", [arch, str(STEPS), str(SEQ), str(BATCH), *extra],
                                   tmp, mesh=mesh)
        return made[arch]

    return get


@pytest.mark.parametrize("arch,mesh", CASES)
def test_placed_steps_match_plain_steps(runs, arch, mesh):
    got_runs = runs(arch, mesh)
    plain, placed = got_runs["plain"], got_runs["placed"]
    assert len(placed["metrics"]) == STEPS
    for step, (want, got) in enumerate(zip(plain["metrics"], placed["metrics"])):
        assert set(got) == set(want)
        for key in want:
            if key == "grad_norm":
                continue
            assert_allclose(got[key], want[key], err_msg=f"step {step} {key}", **BF16_TOL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=2e-2)
    for k, want in plain["params"].items():
        moved = np.linalg.norm(want - plain["init"][k])
        assert moved > 0, k
        assert np.linalg.norm(placed["params"][k] - want) <= PARAM_DELTA_REL_L2 * moved, k
    if mesh == (1, 1):
        # one rank: the same local ops in the same order
        for k, want in plain["params"].items():
            np.testing.assert_array_equal(placed["params"][k], want, err_msg=k)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_placed_steps_match_reference_2x2(reference, runs, arch):
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_numpy

    both = runs(arch, (2, 2))
    placed, loaded = both["placed"], both["plain"]["init"]
    ref = reference[arch]
    losses = [m["loss"] for m in placed["metrics"]]
    print(f"{arch} port 2x2: {losses}\nref 2x2:  {ref['losses']}")
    for step, (got, want) in enumerate(zip(losses, ref["losses"], strict=True)):
        assert abs(got - want) < LOSS_TOL, (step, losses, ref["losses"])
    cfg = get_config(arch, smoke=True)
    init = model_params_from_numpy(cfg, ref["init"]["params"])
    final = model_params_from_numpy(cfg, ref["params"])
    assert set(placed["params"]) == set(final)
    for k, got in placed["params"].items():
        want, p0 = final[k].numpy(), init[k].numpy()
        # the port's initial state is the reference's, loaded
        np.testing.assert_array_equal(loaded[k], p0, err_msg=k)
        assert np.linalg.norm(got - want) <= PARAM_DELTA_REL_L2 * np.linalg.norm(want - p0), k

