"""The port's sharding (``launch/mesh.py``, ``launch/sharding.py``,
``models/sharding_policy.py``, ``reshard_state``, the DTensor train
step) against the JAX package's, on the CPU.

* **Specs.**  For the ten full configs, every parameter leaf's spec under
  ``fsdp_tp``, ``fsdp_ep`` and ``pure_fsdp`` at the (1, 1), (2, 2),
  (16, 16) and (2, 16, 16) meshes equals the reference's
  ``PartitionSpec``; so do ``state_shardings``, ``batch_shardings``
  (``train_4k``, ``prefill_32k``) and ``cache_shardings`` (a batch that
  divides the data axes and one that does not).  Both packages read an
  :class:`AbstractMesh` (axis names and sizes; the reference's
  ``NamedSharding`` is stubbed to hand back its spec), so the production
  meshes need no 512 ranks.
* **Sharded training.**  ``tests/test_sharded_training.py``'s case, the
  llama3.2-1b smoke config 4 steps on batch 4 x 32 tokens, on four gloo
  ranks as a 2x2 (data, model) mesh, from the reference's initial
  state: each step's loss within the reference's 0.05 of the port on
  one device and of the reference's own 2x2 run (four forced CPU
  devices, in a subprocess).
* **reshard_state.**  A state placed on a 1x1 mesh (one gloo rank, in
  this process) and on the 2x2 mesh, gathered back leaf for leaf.
* **Mesh and policy.**  ``make_production_mesh`` raises on too few ranks,
  importing the modules starts no process group, ``constrain`` is a
  no-op without a policy and on plain tensors, and redistributes a
  DTensor to the guarded placements.
"""

from __future__ import annotations

import functools
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (
    AbstractMesh,
    init_process_group,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models import model, transformer
from repro_torch.models import sharding_policy
from repro_torch.optim import adamw_init, init_error_feedback
from torch_ranks import ROOT, run_ranks, run_reference

ARCHS = list_configs()
MESHES = {
    "1x1": AbstractMesh(("data", "model"), (1, 1)),
    "2x2": AbstractMesh(("data", "model"), (2, 2)),
    "16x16": AbstractMesh(("data", "model"), (16, 16)),
    "2x16x16": AbstractMesh(("pod", "data", "model"), (2, 16, 16)),
}
STRATEGIES = ("fsdp_tp", "fsdp_ep", "pure_fsdp")
#: the reference's bound on a step's loss, sharded against one device
LOSS_TOL = 0.05
#: a weight's change over the steps, 2x2 against one device, by relative
#: L2 (``tests/test_torch_train.py``'s bound across packages)
PARAM_DELTA_REL_L2 = 0.2
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = "llama3.2-1b", 4, 32, 4


class _Spec:
    """The stub of the reference's ``NamedSharding``: a leaf holding the
    spec (``jax.tree_util`` never looks into it)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def jspecs(monkeypatch):
    monkeypatch.setattr(jsharding, "NamedSharding", _Spec)
    return jsharding


def _ref_flat(tree) -> dict:
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, _Spec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf.spec
            for path, leaf in leaves}


def _port_flat(tree, prefix="") -> dict:
    if tree is None:
        return {}
    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(_port_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree.spec}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch: str):
    return jmodel.abstract_params(jget_config(arch))


@functools.lru_cache(maxsize=None)
def _port_abstract(arch: str):
    return transformer.Transformer(get_config(arch), "meta")


# --------------------------------------------------------------------- #
# spec parity
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(jspecs, arch, mesh, strategy):
    m = MESHES[mesh]
    want = _ref_flat(jspecs.param_shardings(_ref_abstract(arch), m, strategy))
    got = {k: v.spec for k, v in sharding.param_shardings(_port_abstract(arch), m,
                                                          strategy).items()}
    assert got == want
    if mesh != "1x1" and strategy != "pure_fsdp":
        assert any(s != (None,) * len(s) for s in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(jspecs, arch, mesh):
    import jax

    m = MESHES[mesh]
    ref_params = _ref_abstract(arch)
    zeros = jax.tree_util.tree_map(lambda a: a, ref_params)
    ref_state = {"params": ref_params, "opt": {"mu": zeros, "nu": zeros,
                                               "step": jax.ShapeDtypeStruct((), np.int32)},
                 "error_feedback": zeros}
    named = dict(_port_abstract(arch).named_parameters())
    state = {"params": _port_abstract(arch), "opt": adamw_init(named),
             "error_feedback": init_error_feedback(named)}
    got = _port_flat(sharding.state_shardings(state, m))
    want = _ref_flat(jspecs.state_shardings(ref_state, m))
    assert got == want
    assert got["opt.step"] == ()


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(jspecs, arch, mesh, shape):
    m = MESHES[mesh]
    got = _port_flat(sharding.batch_shardings(model.input_specs(get_config(arch),
                                                                SHAPES[shape]), m))
    want = _ref_flat(jspecs.batch_shardings(jmodel.input_specs(jget_config(arch),
                                                               JSHAPES[shape]), m))
    assert got == want and got


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(jspecs, arch, mesh, batch):
    import jax

    m = MESHES[mesh]
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = _port_flat(sharding.cache_shardings(
        transformer.init_cache(cfg, batch, 64, device="meta"), m, batch))
    want = _ref_flat(jspecs.cache_shardings(
        jax.eval_shape(lambda: jtransformer.init_cache(jcfg, batch, 64)), m, batch))
    assert got == want and got


def test_guarded_spec_and_placements():
    m = MESHES["2x16x16"]
    assert sharding.guarded_spec(m, (64, 30, 0), (("pod", "data"), "model", "model")) == (
        ("pod", "data"), None, None)
    placed = sharding.NamedSharding(m, (("pod", "data"), None, "model")).placements
    assert [repr(p) for p in placed] == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"]
    with pytest.raises(ValueError):
        sharding.param_shardings(_port_abstract("llama3.2-1b"), m, "tp_only")


# --------------------------------------------------------------------- #
# one rank in this process: the 1x1 mesh
# --------------------------------------------------------------------- #
@pytest.fixture
def one_rank():
    init_process_group(1, device="cpu")
    yield make_host_mesh(1, 1)
    sharding_policy.clear_policy()


def test_production_mesh_needs_its_ranks(one_rank):
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} ranks, have 1"):
            make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError):
        make_host_mesh(2, 2)
    assert one_rank.mesh_dim_names == ("data", "model")


def test_import_starts_no_process_group():
    code = ("import torch.distributed as dist; import repro_torch.launch, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.models.sharding_policy, repro_torch.models.moe; "
            "assert not dist.is_initialized(); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_reshard_state_round_trips_one_rank(one_rank):
    from torch.distributed.tensor import DTensor

    from repro_torch.train import TrainConfig, init_train_state, reshard_state, state_leaves

    cfg = get_config("llama3.2-1b", smoke=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             TrainConfig(grad_compression=True))
    host = {k: v.detach().clone() for k, v in state_leaves(state)}
    placed = reshard_state(state, one_rank, sharding.state_shardings)
    leaves = dict(state_leaves(placed))
    assert sorted(leaves) == sorted(host)
    for k, v in leaves.items():
        assert isinstance(v, DTensor), k
        assert torch.equal(v.full_tensor(), host[k]), k
    assert isinstance(placed["params"], torch.nn.Module)


def test_constrain(one_rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.ones(4, 6, 8)
    assert sharding_policy.constrain(x, ("batch", None, "model")) is x
    sharding_policy.set_policy_from_mesh(AbstractMesh(("data", "model"), (2, 2)))
    assert sharding_policy.constrain(x, ("batch", None, "model")) is x
    assert sharding_policy.guarded_dims((4, 6, 7), ("batch", "seq", "model")) == (
        "data", None, None)
    sharding_policy.set_policy_from_mesh(AbstractMesh(("data", "model"), (2, 2)),
                                         sequence_parallel=True)
    assert sharding_policy.guarded_dims((4, 6, 7), ("batch", "seq", None)) == (
        "data", "model", None)
    sharding_policy.set_policy_from_mesh(one_rank)
    d = distribute_tensor(x, one_rank, [Shard(1), Shard(1)])
    c = sharding_policy.constrain(d, ("batch", None, "model"))
    # redistributed; on the 1x1 mesh a shard is the whole tensor: replicated
    assert tuple(c.placements) == (Replicate(), Replicate())
    assert torch.equal(c.full_tensor(), x)
    assert sharding_policy.constrain(c, ("batch", None, "model")) is c


def test_train_driver_runs_under_the_host_mesh(one_rank):
    from repro_torch.launch import train as train_driver

    res = train_driver.run(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                            "--seq", "16"])
    policy = sharding_policy._POLICY
    assert policy["sizes"] == {"data": 1, "model": 1} and policy["model"] == "model"
    assert not any(type(p) is not torch.nn.Parameter
                   for p in res.state["params"].parameters())
    assert len(res.losses) == 2


# --------------------------------------------------------------------- #
# four gloo ranks: the 2x2 mesh
# --------------------------------------------------------------------- #
def _dump_reference(path: str) -> None:
    """The reference's initial state and its single-device and 2x2 loss
    trajectories (``tests/test_sharded_training.py``'s script)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.data import DataConfig, SyntheticCorpus
    from repro.launch.sharding import batch_shardings, state_shardings
    from repro.models.sharding_policy import clear_policy, set_policy_from_mesh
    from repro.train import TrainConfig, init_train_state, make_train_step

    cfg = jget_config(TRAIN_ARCH, smoke=True)
    tcfg = TrainConfig(total_steps=6, warmup_steps=1)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    batches = [{k: jnp.asarray(v) for k, v in corpus.batch(s).items()}
               for s in range(TRAIN_STEPS)]

    def run(mesh=None):
        if mesh is None:
            clear_policy()
            state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
            step = jax.jit(make_train_step(cfg, tcfg))
            return _losses(step, state, batches)
        set_policy_from_mesh(mesh)
        with set_mesh(mesh):
            state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
            state = jax.tree_util.tree_map(jax.device_put, state, state_shardings(state, mesh))
            step = jax.jit(make_train_step(cfg, tcfg))
            placed = [jax.tree_util.tree_map(jax.device_put, b, batch_shardings(b, mesh))
                      for b in batches]
            return _losses(step, state, placed)

    init = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    host = jax.tree_util.tree_map(lambda a: np.asarray(a), init)
    single = run()
    sharded = run(Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model")))
    with open(path, "wb") as f:
        pickle.dump({"init": host, "single": single, "sharded": sharded}, f)


def _losses(step, state, batches) -> list[float]:
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_sharding", tmp_path_factory.mktemp("sharding_ref"))


def test_sharded_training_matches_single_device_and_reference(reference, tmp_path):
    from repro_torch.convert import model_params_from_numpy, train_state_from_numpy
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.train import TrainConfig, make_train_step

    init_path = tmp_path / "init.pkl"
    with open(init_path, "wb") as f:
        pickle.dump(reference["init"], f)
    got = run_ranks("train", [str(init_path), TRAIN_ARCH, str(TRAIN_STEPS), str(TRAIN_SEQ),
                              str(TRAIN_BATCH)], tmp_path)

    cfg = get_config(TRAIN_ARCH, smoke=True)
    state = train_state_from_numpy(cfg, reference["init"], device="cpu")
    step = make_train_step(cfg, TrainConfig(total_steps=6, warmup_steps=1))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    single = []
    for s in range(TRAIN_STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in corpus.batch(s).items()})
        single.append(float(m["loss"]))

    print("port single:", single, "\nport 2x2:   ", got["losses"],
          "\nref single: ", reference["single"], "\nref 2x2:    ", reference["sharded"])
    for step_i, (a, b, c) in enumerate(zip(got["losses"], single, reference["sharded"])):
        assert abs(a - b) < LOSS_TOL, (step_i, got["losses"], single)
        assert abs(a - c) < LOSS_TOL, (step_i, got["losses"], reference["sharded"])
    assert len(got["losses"]) == TRAIN_STEPS
    # the weights were sharded, FSDP over data and TP over model
    assert got["placements"]["stages.0.kind_params.attn.wq"] == (
        "Shard(dim=1)", "Shard(dim=2)")
    # and moved each weight as the single-device step did: its change
    # p_4 - p_0 by relative L2 within test_torch_train's bound
    final = dict(state["params"].named_parameters())
    init = model_params_from_numpy(cfg, reference["init"]["params"])
    for k, w in got["params"].items():
        want, p0 = final[k].detach().numpy(), init[k].numpy()
        assert np.linalg.norm(w - want) <= PARAM_DELTA_REL_L2 * np.linalg.norm(want - p0), k


def test_reshard_state_round_trips_2x2(tmp_path):
    got = run_ranks("reshard", [TRAIN_ARCH], tmp_path)
    assert sorted(got["gathered"]) == sorted(got["host"])
    for k, want in got["host"].items():
        assert got["is_dtensor"][k], k
        np.testing.assert_array_equal(got["gathered"][k], want, err_msg=k)
    assert got["placements"]["opt.step"] == ("Replicate()", "Replicate()")
    assert got["placements"]["params.embedding.embed"] == ("Replicate()", "Shard(dim=0)")
    embed = got["host"]["params.embedding.embed"].shape
    assert got["local_shapes"]["params.embedding.embed"] == (embed[0] // 2, embed[1])
    assert got["placements"]["opt.mu.stages.0.kind_params.mlp.w_down"] == (
        "Shard(dim=2)", "Shard(dim=1)")


def test_chip_sharding_part_runs_on_cpu(one_rank, monkeypatch):
    """``chip_smoke.py``'s part (e) 1 with the CPU as the card, at the
    smoke config and a 2 x 32 batch: the placed steps equal the plain
    ones."""
    from test_torch_train_grads import smoke

    monkeypatch.setattr(smoke, "SHARD_B", 2)
    monkeypatch.setattr(smoke, "SHARD_S", 32)
    out = smoke._sharded_train(smoke=True, card="cpu")
    assert len(out["losses_placed"]) == smoke.SHARD_STEPS
    assert out["params_delta_rel_l2"] <= smoke.TRAIN_PARAM_DELTA_REL_L2
    assert out["losses_placed"][0] == pytest.approx(out["losses_plain"][0], rel=1e-5)
