"""Training substrate: steps, checkpointing, fault tolerance."""

from .checkpoint import (
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    save_checkpoint,
    state_leaves,
)
from .ft import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerMonitor,
    reshard_state,
    run_with_recovery,
)
from .train_step import (
    TrainConfig,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "AsyncCheckpointer",
    "ElasticPlan",
    "HeartbeatMonitor",
    "StragglerMonitor",
    "TrainConfig",
    "init_train_state",
    "latest_step",
    "load_checkpoint",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "reshard_state",
    "run_with_recovery",
    "save_checkpoint",
    "state_leaves",
]
