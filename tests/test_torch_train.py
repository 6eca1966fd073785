"""The port's training substrate against the JAX package's, on the CPU.

* **Train steps.**  Three ``make_train_step`` steps from the reference's
  ``init_train_state``, carried over with
  ``convert.train_state_from_numpy``, on the same synthetic batches, for
  llama3.2-1b (plain, with two microbatches, and with int8 gradient
  compression) and qwen2-moe-a2.7b (the reference's experts replayed
  where the routers split a near tie, as in
  ``tests/test_torch_train_grads.py``).  The reference runs in a
  subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=false``.
  The losses and metrics are held at the bf16 tolerance, ``grad_norm``
  and the first moments by relative L2 error at the gradients' bound,
  the second moments (averages of squared gradients) at twice it, each
  parameter leaf's change over the three steps by relative L2 error
  within ``PARAM_DELTA_REL_L2``.  With
  compression, each step's quantised input ``g + e_old`` (continuous in
  the gradients) is held at the gradients' bound and each residual
  within half its quantisation step, in both packages
  (``chip_smoke._check_compression``): the int8 codes are a rounding,
  which a gradient difference below one step moves, so the error
  buffers differ element by element (relative L2 0.5-1.35 measured).
* **Remat.**  No remat, ``"full"`` and ``"dots"`` give bit-equal
  gradients.
* **Checkpoints.**  A checkpoint the port writes loads in the reference
  with ``load_checkpoint(d, state_like)`` leaf for leaf, and the
  reverse; both keep two steps.
* **Recovery and fault tolerance.**  The JAX package's
  ``test_recovery_loop_is_exact`` (at its rtol 1e-5, atol 1e-6) and
  ``TestFaultTolerance``, ``TestCheckpoint``, on the port.
* **The driver.**  ``launch.train.main`` on a smoke config with
  ``--device cpu``, plain and with ``--kb-corpus``, returns 0; without
  ``--device`` and without a card it raises.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.configs import get_config as jget_config
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro.train import TrainConfig as JTrainConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.launch import train as train_driver
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig
from repro_torch.train import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerMonitor,
    TrainConfig,
    init_train_state,
    latest_step,
    load_checkpoint,
    make_train_step,
    reshard_state,
    run_with_recovery,
    save_checkpoint,
    state_leaves,
)
from test_torch_train_grads import (
    BF16_TOL,
    GRAD_REL_L2,
    flat,
    forward_routes,
    host_tree,
    port_grads,
    rel_l2,
    routing,  # noqa: F401  (fixture)
    run_reference,
    torch_batch,
)

LR, N_STEPS, SEQ, BATCH = 1e-3, 3, 32, 4
#: (name, arch, microbatches, grad compression)
RUNS = [
    ("llama-plain", "llama3.2-1b", 1, False),
    ("llama-micro2", "llama3.2-1b", 2, False),
    ("llama-compressed", "llama3.2-1b", 1, True),
    ("moe-plain", "qwen2-moe-a2.7b", 1, False),
]
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` as a module (its compression checks, and its
    training phase rehearsed on the CPU below)."""
    from test_torch_train_grads import smoke

    return smoke
#: the learning-rate scale of each step: warmup_cosine(t, warmup=1,
#: total=3) at t = 0, 1, 2 (the first step moves no parameter)
LR_SCALES = (0.0, 1.0, 0.55)
#: each parameter leaf's change over the three steps, ``p_3 - p_0``, by
#: relative L2 error against the reference's change.  Adam's normalised
#: update passes a gradient's relative error on undamped where the
#: gradient is small, and flips its sign where a rounding difference
#: decides it: the sound runs read 0.0011-0.0117 (plain), 0.0019-0.0233
#: (two microbatches), 0.0027-0.0397 (compressed) and 0.0011-0.1042 (MoE,
#: its embedding largest), twice the largest is the bound.  A step that
#: never writes the parameters reads 1.
PARAM_DELTA_REL_L2 = 0.2


def _train_cfg(cls, adamw, micro: int, compress: bool):
    return cls(optimizer=adamw(lr=LR), microbatches=micro, grad_compression=compress,
               warmup_steps=1, total_steps=N_STEPS)


def _batches(cfg) -> list[np.ndarray]:
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
    return [corpus.batch(s)["tokens"] for s in range(N_STEPS)]


def _dump_reference(path: str, part: int) -> None:
    """Each of ``RUNS``: the reference's initial state, each step's
    metrics and forward routes, and the state after the last step,
    pickled to ``path``."""
    import pickle

    from repro.train import make_train_step as jmake_train_step
    from test_torch_train_grads import record_routes

    from repro.train import train_step as jtrain_step

    routes = record_routes()
    compressed: list = []
    transform = jtrain_step.compressed_grad_transform

    def recorded(grads, err):
        out, new = transform(grads, err)
        quantised = jax.tree_util.tree_map(lambda g, e: g.astype(jnp.float32) + e, grads, err)
        jax.debug.callback(lambda a, b: compressed.append((host_tree(a), host_tree(b))),
                           quantised, new, ordered=True)
        return out, new

    jtrain_step.compressed_grad_transform = recorded
    out = {}
    for name, arch, micro, compress in RUNS:
        cfg = jget_config(arch, smoke=True)
        tcfg = _train_cfg(JTrainConfig, JAdamWConfig, micro, compress)
        state = jinit_train_state(jax.random.PRNGKey(0), cfg, tcfg)
        init = host_tree(state)
        init["opt"]["step"] = np.asarray(state["opt"]["step"])
        step_fn = jax.jit(jmake_train_step(cfg, tcfg))
        metrics, step_routes = [], []
        for tokens in _batches(cfg):
            state, m = step_fn(state, {"tokens": jnp.asarray(tokens)})
            metrics.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            records, routes[:] = list(routes), []
            step_routes.append(forward_routes(records, name))
        final = host_tree(state)
        final["opt"]["step"] = np.asarray(state["opt"]["step"])
        steps, compressed[:] = [_by_leaf(*c) for c in compressed], []
        out[name] = {"init": init, "metrics": metrics, "routes": step_routes, "final": final,
                     "compressed": steps}
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _by_leaf(quantised, residual) -> dict:
    """One step's compression records as ``{dotted leaf: (g + e_old,
    e_new)}`` of f32 tensors."""
    q, e = flat(quantised), flat(residual)
    return {k: (torch.from_numpy(q[k]), torch.from_numpy(e[k])) for k in q}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("train_steps"), "test_torch_train", 1)


def _leaves(state) -> dict[str, np.ndarray]:
    return {k: v.detach().float().numpy() for k, v in state_leaves(state)}


@pytest.mark.parametrize("name,arch,micro,compress", RUNS)
def test_train_steps_match_reference(reference, routing, smoke, name, arch, micro,
                                     compress):
    cfg = get_config(arch, smoke=True)
    ref = reference[name]
    state = train_state_from_numpy(cfg, ref["init"], device="cpu")
    step_fn = make_train_step(cfg, _train_cfg(TrainConfig, AdamWConfig, micro, compress))
    metrics = []
    with smoke._compression_records() as compressed:
        for tokens, routes in zip(_batches(cfg), ref["routes"]):
            routing(routes)
            state, m = step_fn(state, {"tokens": torch.from_numpy(tokens)})
            metrics.append({k: float(v) for k, v in m.items()})
    assert len(compressed) == (N_STEPS if compress else 0)
    smoke._check_compression(name, compressed, ref["compressed"])
    for step, (got, want) in enumerate(zip(metrics, ref["metrics"])):
        assert set(got) == set(want), step
        for key in want:
            if key == "grad_norm":
                assert rel_l2(np.float32(got[key]), np.float32(want[key])) <= GRAD_REL_L2
            else:
                assert_allclose(got[key], want[key], err_msg=f"step {step} {key}", **BF16_TOL)
    got, want, init = _leaves(state), flat(ref["final"]), flat(ref["init"])
    assert sorted(got) == sorted(want)
    assert int(state["opt"]["step"]) == int(want["opt.step"]) == N_STEPS
    for k, w in want.items():
        if k.startswith(("opt.mu", "opt.nu")):
            # nu averages squared gradients: a square doubles a relative error
            assert rel_l2(got[k], w) <= GRAD_REL_L2 * (2 if k.startswith("opt.nu") else 1), k
        elif k.startswith("params"):
            assert rel_l2(got[k] - init[k], w - init[k]) <= PARAM_DELTA_REL_L2, k
        elif k.startswith("error_feedback"):
            assert_array_equal(got[k], compressed[-1][k[len("error_feedback."):]][1].numpy())
    assert any(k.startswith("error_feedback") for k in want) == compress


def test_lr_scales_are_the_schedules():
    from repro_torch.optim import warmup_cosine

    got = [float(warmup_cosine(torch.tensor(t), warmup=1, total=N_STEPS)) for t in range(3)]
    assert_allclose(got, LR_SCALES, rtol=1e-6)


def test_first_step_moves_no_parameter():
    """The schedule is read at the step counter before the update: 0 at
    the first step, so only the moments and the counter change."""
    cfg = get_config("llama3.2-1b", smoke=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, TrainConfig())
    before = {k: v.clone() for k, v in state["params"].state_dict().items()}
    tokens = torch.from_numpy(_batches(cfg)[0])
    state, metrics = make_train_step(cfg, TrainConfig())(state, {"tokens": tokens})
    assert int(state["opt"]["step"]) == 1
    for k, v in state["params"].state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(float(m.abs().max()) > 0 for m in state["opt"]["mu"].values())
    assert set(metrics) == {"loss", "xent", "aux", "zloss", "grad_norm"}


# --------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_remat_policies_give_equal_gradients(monkeypatch, arch):
    """No remat, ``"full"`` and ``"dots"``: the loss and every gradient
    leaf equal bit for bit (a MoE recompute replays its forward's
    routes; a hybrid's shared attention and an encoder stack are
    rematerialised with their layers)."""
    from test_torch_train_grads import _inputs

    cfg = get_config(arch, smoke=True)
    net = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    batch = torch_batch(_inputs(cfg))
    runs = {}
    with monkeypatch.context() as m:
        m.setattr(transformer, "_remat", lambda fn, *args: fn(*args))
        runs["none"] = port_grads(cfg, net, batch)
    for policy in ("full", "dots"):
        monkeypatch.setattr(transformer, "REMAT_POLICY", policy)
        runs[policy] = port_grads(cfg, net, batch)
    base_loss, _, base = runs["none"]
    for policy in ("full", "dots"):
        loss, _, grads = runs[policy]
        assert torch.equal(loss, base_loss), policy
        for k, g in base.items():
            assert_array_equal(grads[k], g, err_msg=f"{policy} {k}")
    with pytest.raises(ValueError):
        transformer.set_remat_policy("none")


def test_dots_saves_the_projections():
    """Under ``"dots"`` the recompute replays the layers' ``mm`` outputs
    and reruns the rest: fewer matrix products in the backward pass than
    under ``"full"``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = get_config("llama3.2-1b", smoke=True)
    net = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.from_numpy(_batches(cfg)[0])}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for policy in ("full", "dots"):
        transformer.set_remat_policy(policy)
        try:
            loss, _ = transformer.forward_train(net, cfg, batch)
            with Count() as c:
                loss.backward()
            counts[policy] = c.mm
        finally:
            transformer.set_remat_policy("full")
    assert counts["dots"] < counts["full"], counts


# --------------------------------------------------------------------- #
# checkpoints across the two packages
# --------------------------------------------------------------------- #
def _reference_state():
    cfg = jget_config("llama3.2-1b", smoke=True)
    tcfg = JTrainConfig(grad_compression=True)
    state = jinit_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    # moments and error buffer that differ from the parameters and zero
    rng = np.random.default_rng(5)
    noisy = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), state["params"])
    state["opt"]["mu"] = noisy
    state["opt"]["nu"] = jax.tree_util.tree_map(jnp.abs, noisy)
    state["error_feedback"] = jax.tree_util.tree_map(lambda a: a * 1e-3, noisy)
    state["opt"]["step"] = jnp.int32(17)
    return cfg, state


def _host_ref(state):
    out = host_tree(state)
    out["opt"]["step"] = np.asarray(state["opt"]["step"])
    return out


def test_port_checkpoint_loads_in_reference(tmp_path):
    jcfg, jstate = _reference_state()
    cfg = get_config("llama3.2-1b", smoke=True)
    state = train_state_from_numpy(cfg, _host_ref(jstate), device="cpu")
    with torch.no_grad():
        for p in state["params"].parameters():
            p.mul_(2.0)
    state["opt"]["step"].fill_(23)
    for s in (5, 6, 7):
        save_checkpoint(str(tmp_path), s, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000006", "step_0000000007"]
    assert jckpt.latest_step(str(tmp_path)) == 7
    like = jinit_train_state(jax.random.PRNGKey(1), jcfg, JTrainConfig(grad_compression=True))
    restored, step = jckpt.load_checkpoint(str(tmp_path), like)
    assert step == 7
    got = flat(_host_ref(restored))
    want = {k: v.detach().numpy() for k, v in state_leaves(state)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert_array_equal(got[k], w, err_msg=k)
    assert np.asarray(restored["opt"]["step"]).dtype == np.int32
    assert int(restored["opt"]["step"]) == 23


def test_reference_checkpoint_loads_in_port(tmp_path):
    jcfg, jstate = _reference_state()
    for s in (1, 2, 3):
        jckpt.save_checkpoint(str(tmp_path), s, jstate, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002", "step_0000000003"]
    cfg = get_config("llama3.2-1b", smoke=True)
    like = init_train_state(torch.Generator().manual_seed(1), cfg,
                            TrainConfig(grad_compression=True))
    assert latest_step(str(tmp_path)) == 3
    restored, step = load_checkpoint(str(tmp_path), like)
    assert step == 3 and restored is like
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 17
    want = flat(_host_ref(jstate))
    got = {k: v.detach().numpy() for k, v in state_leaves(restored)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert_array_equal(got[k], w, err_msg=k)
    # the leaf order is jax.tree_util's: the reference's own flattening
    names = [k for k, _ in state_leaves(restored)]
    ref_paths = [".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert names == ref_paths
    # a state of another shape is refused
    other = init_train_state(torch.Generator().manual_seed(1), get_config("qwen3-0.6b",
                                                                           smoke=True),
                             TrainConfig(grad_compression=True))
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), other)


# --------------------------------------------------------------------- #
# the JAX package's TestCheckpoint and TestFaultTolerance, on the port
# --------------------------------------------------------------------- #
class TestCheckpoint:
    def test_save_load_roundtrip(self):
        state = {"a": torch.arange(5), "nested": {"b": torch.ones((2, 3))}}
        like = {"a": torch.zeros(5, dtype=torch.int64), "nested": {"b": torch.zeros((2, 3))}}
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, 7, state)
            restored, step = load_checkpoint(d, like)
            assert step == 7
            assert torch.equal(restored["a"], state["a"])
            assert torch.equal(restored["nested"]["b"], state["nested"]["b"])

    def test_double_buffering_gc(self):
        state = {"a": torch.zeros(3)}
        with tempfile.TemporaryDirectory() as d:
            for s in (1, 2, 3, 4):
                save_checkpoint(d, s, state, keep=2)
            assert len(os.listdir(d)) == 2
            assert latest_step(d) == 4

    def test_recovery_loop_is_exact(self):
        """Kill the run mid-way; the supervised loop must continue and
        produce the same final state as an uninterrupted run."""
        cfg = get_config("llama3.2-1b", smoke=True)
        tcfg = TrainConfig(total_steps=12, warmup_steps=1)
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                            global_batch=2))
        batches = [{k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
                   for s in range(12)]
        step_fn = make_train_step(cfg, tcfg)

        def fresh_state():
            return init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)

        ref = fresh_state()
        for b in batches:
            ref, _ = step_fn(ref, b)
        with tempfile.TemporaryDirectory() as d:
            state, last, failures = run_with_recovery(
                step_fn, fresh_state(), batches, ckpt_dir=d, ckpt_every=3, fail_at={5, 9})
        assert failures == 2 and last == 12
        for (k, r), (_, g) in zip(state_leaves(ref["params"]), state_leaves(state["params"])):
            assert_allclose(g.detach().numpy(), r.detach().numpy(), rtol=1e-5, atol=1e-6,
                            err_msg=k)


class TestFaultTolerance:
    def test_heartbeat(self):
        clock = [0.0]
        mon = HeartbeatMonitor([0, 1, 2], deadline_s=10, clock=lambda: clock[0])
        clock[0] = 5.0
        mon.beat(0)
        mon.beat(1)
        clock[0] = 12.0
        assert mon.failed_hosts() == [2]

    def test_straggler_detection(self):
        mon = StragglerMonitor(threshold=1.5, min_flags=3)
        flagged = []
        for _ in range(8):  # flags accrue per periodic check
            for h in range(4):
                mon.record(h, 2.0 if h == 2 else 1.0)
            flagged = mon.stragglers()
        assert flagged == [2]
        for _ in range(8):  # a recovered host is un-flagged
            for h in range(4):
                mon.record(h, 1.0)
            flagged = mon.stragglers()
        assert flagged == []

    def test_elastic_plan(self):
        plan = ElasticPlan(total_hosts=64, chips_per_host=4, model_parallel=16)
        assert plan.pick(64) == (16, 16)
        assert plan.pick(63) == (8, 16)  # lost a host -> shrink data axis
        with pytest.raises(RuntimeError):
            plan.pick(2)

    def test_reshard_state_places_every_leaf(self):
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.mesh import init_process_group, make_host_mesh
        from repro_torch.launch.sharding import state_shardings

        cfg = get_config("llama3.2-1b", smoke=True)
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 TrainConfig(grad_compression=True))
        n_leaves = len(state_leaves(state))
        init_process_group(1, device="cpu")
        moved = reshard_state(state, make_host_mesh(1, 1), state_shardings)
        leaves = state_leaves(moved)
        assert len(leaves) == n_leaves
        assert all(isinstance(leaf, DTensor) for _, leaf in leaves)


# --------------------------------------------------------------------- #
# the driver and the examples
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("extra", [[], ["--kb-corpus"], ["--microbatches", "2",
                                                         "--grad-compression"]])
def test_driver_trains_on_cpu(capsys, extra):
    rc = train_driver.main(["--smoke", "--device", "cpu", "--steps", "30", "--batch", "4",
                            "--seq", "64", "--log-every", "10"] + extra)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "done: loss" in out


def test_driver_resumes_from_checkpoint(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_driver.main(argv)
    assert latest_step(str(tmp_path)) == 5
    res = train_driver.run(argv[:4] + ["8"] + argv[5:])
    assert res.start == 6 and len(res.losses) == 2
    assert "resuming at step 6" in capsys.readouterr().out


def test_driver_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_driver.main(["--smoke", "--steps", "1"])


def test_examples_run_on_cpu(capsys):
    from repro_torch.examples import elastic_restart, kb_train

    assert kb_train.main(["--steps", "40", "--device", "cpu"]) == 0
    state, last, failures = elastic_restart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert (last, failures) == (24, 2)
    assert "stragglers detected: [3]" in out
    assert int(state["opt"]["step"]) == 24


# --------------------------------------------------------------------- #
# chip_smoke.py's training phase, rehearsed on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_chip_train_phase_runs_on_cpu(smoke, arch):
    """Part (d) 1 with the CPU as the card: the routes recorded and
    replayed through the remat'd steps, every leaf compared (equal here)."""
    out = smoke._train_smoke(arch, card="cpu")
    assert out["near_ties"] == 0 and out["params"] == 0.0 and out["moments"] == 0.0
    assert len(out["losses"]) == smoke.TRAIN_STEPS
    assert out["routed_rows"] == (3 * 2 * BATCH * SEQ if arch == "qwen2-moe-a2.7b" else 0)


def test_chip_recovery_phase_runs_on_cpu(smoke):
    out = smoke._train_recovery(card="cpu")
    assert out["uninterrupted_spread"] == 0.0 and out["max_abs_err"] == 0.0
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ


def test_chip_full_width_phase_runs_on_cpu(smoke, monkeypatch):
    """Part (d) 2 through the driver at the smoke config on the CPU (no
    launches to count here, and the smoke vocabulary's stream length)."""
    for name in ("empty_cache", "reset_peak_memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "TRAIN_KERNELS", ())
    argv = ["--arch", "llama3.2-1b", "--smoke", "--kb-corpus", "--steps", "20", "--device",
            "cpu", "--seq", "32"]
    cfg = get_config("llama3.2-1b", smoke=True)
    stream = train_driver.build_kb_stream(cfg, DataConfig(cfg.vocab_size, 32, 8), "cpu")
    monkeypatch.setattr(smoke, "KB_STREAM_TOKENS", stream.tokens.shape[0])
    out = smoke._train_full(argv)
    assert out["steps"] == 20 and out["tokens_per_step"] == 8 * 32
    assert out["loss_first_last"][1] < out["loss_first_last"][0]
    assert not any(out["step_launches"].values())
    # phase 1a (f): the first step was counted, and the dry run of the same
    # step on the 1x1 mesh counts the same FLOPs (it raises otherwise)
    assert out["step_cost"]["batch_shape"] == [8, 32] and out["step_cost"]["flops"] > 0
    roof = smoke._roofline_counts(out)
    assert roof["dryrun"]["flops_per_device"] == out["step_cost"]["flops"]
    assert roof["bottleneck"] in ("compute", "memory") and roof["mfu"] > 0
