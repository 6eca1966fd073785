"""Launch layer: meshes, sharding rules, and the entry points
:mod:`.serve_datalog`, the query server (static and ``--live``),
:mod:`.serve`, the model serving loop (prefill and greedy decode), and
:mod:`.train`, the training driver, and the dry runs :mod:`.dryrun`
(every model cell on a fake group of 256 or 512 ranks) and
:mod:`.dryrun_datalog` (a reasoning round at 256 and 512 shards).
``python -m repro_torch.launch.serve_datalog --help``, ``python -m
repro_torch.launch.serve --help``, ``python -m repro_torch.launch.train
--help``, ``python -m repro_torch.launch.dryrun --help``."""

from .mesh import (
    DP_AXES,
    AbstractMesh,
    data_axes,
    init_process_group,
    make_host_mesh,
    make_production_mesh,
)
from .sharding import (
    NamedSharding,
    batch_shardings,
    cache_shardings,
    guarded_spec,
    param_shardings,
    state_shardings,
)

__all__ = [
    "DP_AXES",
    "AbstractMesh",
    "NamedSharding",
    "batch_shardings",
    "cache_shardings",
    "data_axes",
    "guarded_spec",
    "init_process_group",
    "make_host_mesh",
    "make_production_mesh",
    "param_shardings",
    "state_shardings",
]
