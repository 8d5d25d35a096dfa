"""Multi-process training: the ("data", "model") mesh and the sharded state
(counterpart of awm_tpu/parallel)."""

from awm_tpu_torch.parallel.mesh import (
    full_grads,
    full_state_dicts,
    initialize_distributed,
    make_global_mesh,
    make_mesh,
    param_spec,
    shard_batch,
    shard_batch_from_process_local,
    shard_state,
    shutdown,
    state_shardings,
)
from awm_tpu_torch.parallel.spawn import spawn_ranks

__all__ = [
    "full_grads",
    "full_state_dicts",
    "initialize_distributed",
    "make_global_mesh",
    "make_mesh",
    "param_spec",
    "shard_batch",
    "shard_batch_from_process_local",
    "shard_state",
    "shutdown",
    "spawn_ranks",
    "state_shardings",
]
