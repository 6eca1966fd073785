"""Gloo ranks on the CPU for the port's sharding tests.

``run_ranks(task, args, tmp)`` starts a process per rank of ``MESH``, each
``python tests/torch_ranks.py <rank> <store> <data>x<model> <task> <args>``:
one thread each (``torch.set_num_threads(1)``), meeting in one
``FileStore`` under ``tmp``, every process killed at ``timeout`` (a hung
rendezvous fails the test instead of stalling the run).  ``run_reference`` runs a test
module's ``_dump_reference`` in a subprocess with four CPU devices.  Each task builds the
(data, model) mesh, 2x2 unless ``run_ranks`` is given another, and writes
rank 0's results to ``tmp/<task>.pkl``;
this module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MESH = (2, 2)


def run_ranks(task: str, args: list[str], tmp: Path, timeout: float = 300,
              mesh: tuple[int, int] = MESH) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    store = tmp / f"{task}.store"
    shape = "x".join(map(str, mesh))
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(store), shape, task,
                               *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT)
             for rank in range(mesh[0] * mesh[1])]
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, (f"{task} rank {rank}: stdout={stdout}\n"
                                          f"stderr={stderr[-4000:]}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    with open(tmp / f"{task}.pkl", "rb") as f:
        return pickle.load(f)


def run_reference(module: str, tmp: Path, timeout: float = 600) -> dict:
    """``module._dump_reference(path)`` in a subprocess with four forced
    CPU devices (``XLA_FLAGS``) and one Eigen thread; its pickle."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    path = tmp / f"{module}.pkl"
    code = f"import sys, {module} as m; m._dump_reference(sys.argv[1])"
    proc = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr[-4000:]}"
    with open(path, "rb") as f:
        return pickle.load(f)


def _numpy(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


# --------------------------------------------------------------------- #
# tasks (run inside each rank)
# --------------------------------------------------------------------- #
def task_train(mesh, out: Path, init_path: str, arch: str, n_steps: str, seq: str,
               batch: str) -> dict:
    """``n_steps`` train steps of the smoke config from the initial state
    pickled at ``init_path`` (the JAX package's layout), the state and
    each batch placed by ``state_shardings`` / ``batch_shardings``; the
    losses, the placements and the final parameters."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.sharding import batch_shardings, state_shardings
    from repro_torch.train import TrainConfig, make_train_step, reshard_state

    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(total_steps=6, warmup_steps=1)
    with open(init_path, "rb") as f:
        init = pickle.load(f)
    state = reshard_state(train_state_from_numpy(cfg, init, device="cpu"), mesh,
                          state_shardings)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=int(seq),
                                        global_batch=int(batch)))
    step = make_train_step(cfg, tcfg)
    losses = []
    for s in range(int(n_steps)):
        b = {k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
        sh = batch_shardings(b, mesh)
        state, metrics = step(state, {k: sh[k].place(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    named = dict(state["params"].named_parameters())
    return {"losses": losses,
            "placements": {k: tuple(map(repr, p.placements)) for k, p in named.items()},
            "params": {k: _numpy(p) for k, p in named.items()}}


def task_steps(mesh, out: Path, arch: str, n_steps: str, seq: str, batch: str,
               init_path: str = "") -> dict:
    """``n_steps`` train steps of the smoke config from a seeded state (or
    the one pickled at ``init_path``, in the JAX package's layout), plain
    and placed by ``state_shardings`` (each batch by ``batch_shardings``):
    each run's losses and metrics, the initial and the final parameters,
    gathered."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.sharding import batch_shardings, state_shardings
    from repro_torch.train import TrainConfig, init_train_state, make_train_step, reshard_state

    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(total_steps=6, warmup_steps=1)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=int(seq),
                                        global_batch=int(batch)))
    batches = [{k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
               for s in range(int(n_steps))]
    step = make_train_step(cfg, tcfg)
    runs = {}
    init_state = None
    if init_path:
        with open(init_path, "rb") as f:
            init_state = pickle.load(f)
    for name in ("plain", "placed"):
        if init_state is None:
            state = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
        else:
            state = train_state_from_numpy(cfg, init_state, device="cpu")
        init = {k: _numpy(p).copy() for k, p in state["params"].named_parameters()}
        if name == "placed":
            state = reshard_state(state, mesh, state_shardings)
        metrics = []
        for b in batches:
            if name == "placed":
                sh = batch_shardings(b, mesh)
                b = {k: sh[k].place(v) for k, v in b.items()}
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = {"metrics": metrics, "init": init,
                      "params": {k: _numpy(p) for k, p in state["params"].named_parameters()}}
    return runs


def task_reshard(mesh, out: Path, arch: str) -> dict:
    """A seeded state placed on the mesh by ``reshard_state`` and
    gathered back: every leaf, its placements and its local shape."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import state_shardings
    from repro_torch.train import TrainConfig, init_train_state, reshard_state, state_leaves

    cfg = get_config(arch, smoke=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             TrainConfig(grad_compression=True))
    host = {k: v.detach().float().numpy().copy() for k, v in state_leaves(state)}
    placed = reshard_state(state, mesh, state_shardings)
    leaves = dict(state_leaves(placed))
    return {"host": host,
            "gathered": {k: _numpy(v) for k, v in leaves.items()},
            "is_dtensor": {k: isinstance(v, DTensor) for k, v in leaves.items()},
            "placements": {k: tuple(map(repr, v.placements)) for k, v in leaves.items()},
            "local_shapes": {k: tuple(v.to_local().shape) for k, v in leaves.items()}}


def task_ep(mesh, out: Path, *case_paths: str) -> dict:
    """The MoE block of each pickled case (``cfg``, numpy ``params`` and
    ``x``) on the mesh: parameters placed by ``param_shardings`` under a
    stage's name, ``x`` by ``batch_shardings``; ``y``, ``aux`` and the
    gradients of ``sum(y**2) + aux``, gathered, by case file."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharding import batch_shardings, param_shardings
    from repro_torch.models import moe

    results = {}
    for case_path in case_paths:
        with open(case_path, "rb") as f:
            case = pickle.load(f)
        cfg = case["cfg"]
        prefix = "stages.0.kind_params.moe."
        flat = {k: torch.from_numpy(v) for k, v in case["params"].items()}
        sh = param_shardings({prefix + k: v for k, v in flat.items()}, mesh)
        params = {k: sh[prefix + k].place(v).requires_grad_(True) for k, v in flat.items()}
        x = torch.from_numpy(case["x"]).to(torch.bfloat16)
        x = batch_shardings({"x": x}, mesh)["x"].place(x)
        tree = {k: v for k, v in params.items() if not k.startswith("shared.")}
        shared = {k[len("shared."):]: v for k, v in params.items() if k.startswith("shared.")}
        if shared:
            tree["shared"] = shared
        with implicit_replication():
            y, aux = moe.moe_apply(tree, x, cfg)
            loss = (y.float() ** 2).sum() + aux
            grads = torch.autograd.grad(loss, list(params.values()))
        results[Path(case_path).stem] = {
            "y": _numpy(y), "aux": float(aux.full_tensor()),
            "grads": {k: _numpy(g) for k, g in zip(params, grads)},
            "placements": {k: tuple(map(repr, p.placements)) for k, p in params.items()}}
    return results


def main(argv: list[str]) -> None:
    rank, store, shape, task, *args = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    data, model = map(int, shape.split("x"))
    init_process_group(data * model, int(rank), device="cpu", store_path=store)
    try:
        from repro_torch.models.sharding_policy import set_policy_from_mesh

        mesh = make_host_mesh(data, model)
        set_policy_from_mesh(mesh)
        out = Path(store).parent
        result = globals()[f"task_{task}"](mesh, out, *args)
        if int(rank) == 0:
            with open(out / f"{task}.pkl", "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
