"""Device mesh for multi-process training (counterpart of
awm_tpu/parallel/mesh.py).

One process per card, started by torchrun; a ("data", "model")
DeviceMesh over every rank, row-major as the JAX package lays out its device
grid (awm_tpu/parallel/mesh.py:49-52): a model group is consecutive ranks,
so it stays inside one host, and the data axis spans hosts, where the one
gradient all-reduce a step crosses the slower links.

Under JAX's SPMD semantics a jitted step on sharded inputs computes the step
on the global batch.  The port makes its sharded step that same function by
hand, without DistributedDataParallel, whose defaults compute another one:
- the batch is cut over "data": each rank holds B / data rows (shard_batch);
- the message table (2^16 x C, the one large parameter) is cut by rows over
  "model", with its Adam moments (shard_state); models.layers.Embedding
  then looks up the rows it owns and sums the lookup over the model group,
  with an identity backward;
- BatchNorm's train-mode statistics are sums over the data group
  (models.layers.BatchNorm), with flax's biased variance in the running
  statistics (torch.nn.SyncBatchNorm keeps the unbiased one there);
- dec_loss's per-bit weights use the data group's mean (losses.dec_loss);
- train.train_step draws the global batch's messages and attacks and keeps
  its rows, averages the table shards' gradients over the data group and
  every other gradient over all ranks before Adam (the mean over the data
  group where a model group's ranks agree, and bit-equal replicated
  parameters where a nondeterministic card reduction makes them differ),
  and returns the global means of the loss terms.
Every collective is an all-reduce or a broadcast (parallel/collectives.py),
and one over a group of one rank is not issued.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from awm_tpu_torch.parallel.collectives import all_reduce_

AXES = ("data", "model")


def _backend_for(device) -> str:
    if torch.device(device).type != "cuda":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("multi-process training on cuda needs NCCL, which this torch build "
                           "lacks; pass --device cpu to train over gloo on the CPU")
    return "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
) -> int:
    """Wire this process into the group of processes; returns the world size.

    With no arguments: torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT) where it is set, else a group of this one
    process.  Elsewhere pass the rendezvous ("host:port", or any URL
    init_process_group takes, e.g. file:///path), the number of processes
    and this one's rank.  The backend is NCCL for a cuda device (raises
    without NCCL) and gloo for the CPU; `backend` overrides it (gloo on
    CUDA tensors carries all_reduce and broadcast, which is all this path
    issues).  Idempotent: an initialised process returns its world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    backend = backend or _backend_for(device)
    if coordinator_address is None and num_processes is None and process_id is None:
        if all(k in os.environ for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")):
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, where this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """("data", "model") mesh of shape (n // K, K) over the n ranks of the
    initialised group (one card each); n defaults to, and must equal, the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if n != world:
        raise ValueError(f"a mesh spans every rank: {n} devices asked, world size {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel), mesh_dim_names=AXES)


def make_global_mesh(model_parallel: int = 1):
    """The mesh over every process's card.  torchrun numbers the ranks of a
    host consecutively, so with model_parallel <= cards per host each model
    group stays inside one host and the data axis spans hosts."""
    return make_mesh(None, model_parallel)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank along the axis, or None where the axis
    has one rank (no collective to issue)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def world_group(mesh):
    """The group of every rank of the mesh, or None where it has one rank."""
    return None if mesh is None or mesh.size() == 1 else dist.group.WORLD


def is_lead(mesh) -> bool:
    """Whether this process writes the run's files (rank 0, or no mesh)."""
    return mesh is None or dist.get_rank() == 0


def _is_embedding_table(name: str) -> bool:
    return name.split(".")[-2:] == ["embedding", "weight"]


def param_spec(name: str, leaf: torch.Tensor, mesh) -> Tuple:
    """Sharding rule of one leaf, by its dotted name: the message table's
    rows over "model" when they divide, ("model", None); every other leaf
    replicated, ()."""
    if _is_embedding_table(name) and leaf.ndim == 2 and leaf.shape[0] % axis_size(mesh, "model") == 0:
        return ("model", None)
    return ()


def state_shardings(state, mesh) -> Dict[str, Tuple]:
    """{"gen.<name>" / "det.<name>": spec} over both networks' parameters
    and buffers.  Adam's moments follow their parameter."""
    out = {}
    for net in ("gen", "det"):
        module = getattr(state, net)
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            out[f"{net}.{name}"] = param_spec(name, t, mesh)
    return out


def _broadcast_from_lead(tensors) -> None:
    """Every tensor of the list set to rank 0's values: one broadcast per
    dtype of a flat copy."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def _tables(state):
    """(net, name, module) of each message-table Embedding of the state."""
    from awm_tpu_torch.models.layers import Embedding

    for net in ("gen", "det"):
        for name, mod in getattr(state, net).named_modules():
            if isinstance(mod, Embedding):
                yield net, name, mod


def lead_values(values, device) -> list:
    """Rank 0's values of a list of numbers (exact below 2^53), on every
    rank: one broadcast."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    if dist.get_world_size() > 1:
        dist.broadcast(t, src=0)
    return t.tolist()


def _sync_optimizer(state, device) -> None:
    """state.step and the Adam state set to rank 0's, where each rank may
    have resumed from its own checkpoint directory, or found none: rank 0's
    step counts, then its moments, a rank lacking them starting from zeros.
    Adam keeps its counts as CPU tensors, which NCCL cannot carry, so they
    travel as numbers."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    counts = lead_values([state.step] + [float(opt.state[p]["step"]) if "step" in opt.state.get(p, {})
                                         else -1.0 for p in params], device)
    state.step = int(counts[0])
    moments = []
    for p, n in zip(params, counts[1:]):
        if n < 0:
            opt.state.pop(p, None)
            continue
        st = opt.state[p]
        for key in ("exp_avg", "exp_avg_sq"):
            if key not in st:
                st[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
            moments.append(st[key])
        st["step"] = torch.tensor(n, dtype=torch.float32)
    _broadcast_from_lead(moments)


@torch.no_grad()
def shard_state(state, mesh):
    """Place a TrainState (train.py) on the mesh, in place: every parameter
    and buffer, the step count and the Adam state broadcast from rank 0 (so
    a checkpoint that rank 0 alone resumed from holds on every rank); each
    message table, and its Adam moments, cut to this rank's rows of the
    model axis; the BatchNorm layers told their data group.  Returns the
    state, which now carries the mesh (train_step reads it)."""
    from awm_tpu_torch.models.layers import BatchNorm

    if dist.get_world_size() > 1:
        _broadcast_from_lead([t for net in (state.gen, state.det)
                              for t in list(net.parameters()) + list(net.buffers())])
        _sync_optimizer(state, next(state.gen.parameters()).device)
    data = axis_group(mesh, "data")
    for net in (state.gen, state.det):
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                mod.group = data
    k = axis_size(mesh, "model")
    for _, name, mod in _tables(state):
        if k == 1 or param_spec(f"{name}.weight", mod.weight, mesh) == ():
            continue
        rows = mod.weight.shape[0] // k
        lo = axis_index(mesh, "model") * rows
        moments = state.optimizer.state.get(mod.weight, {})
        mod.weight.data = mod.weight.data[lo:lo + rows].clone()
        for key in ("exp_avg", "exp_avg_sq"):
            if key in moments:
                moments[key] = moments[key][lo:lo + rows].clone()
        mod.group, mod.vocab_start = axis_group(mesh, "model"), lo
    state.mesh = mesh
    return state


def gather_rows(local: torch.Tensor, mod) -> torch.Tensor:
    """The whole table (or a tensor of its shape, such as its gradient)
    from each model rank's rows: an all-reduce of a zero-filled full-size
    tensor (gloo carries no all_gather of CUDA tensors)."""
    rows = local.shape[0]
    full = local.new_zeros((rows * dist.get_world_size(mod.group),) + tuple(local.shape[1:]))
    full[mod.vocab_start:mod.vocab_start + rows] = local
    return all_reduce_(full, mod.group)


@torch.no_grad()
def full_state_dicts(state) -> Dict[str, dict]:
    """{"gen", "det", "optimizer"} state dicts of a TrainState, with every
    sharded message table and its Adam moments gathered whole, so that a
    checkpoint restores on any layout.  A collective under a mesh: every
    rank calls it."""
    out = {"gen": state.gen.state_dict(), "det": state.det.state_dict(),
           "optimizer": state.optimizer.state_dict()}
    index = {id(p): i for i, p in enumerate(p for g in state.optimizer.param_groups
                                            for p in g["params"])}
    for net, name, mod in _tables(state):
        if mod.group is None:
            continue
        out[net][f"{name}.weight"] = gather_rows(mod.weight.detach(), mod)
        i = index.get(id(mod.weight))
        moments = out["optimizer"]["state"].get(i)
        if moments:  # a copy: the packed state shares its dicts with the optimizer
            out["optimizer"]["state"][i] = {k: gather_rows(v, mod) if k in ("exp_avg", "exp_avg_sq")
                                            else v for k, v in moments.items()}
    return out


@torch.no_grad()
def full_grads(state) -> Dict[str, torch.Tensor]:
    """{"gen.<name>" / "det.<name>": gradient} of every parameter that has
    one, each sharded table's gathered whole.  After train_step these are
    the averaged gradients that Adam took.  A collective under a mesh:
    every rank calls it."""
    tables = {id(mod.weight): mod for _, _, mod in _tables(state) if mod.group is not None}
    out = {}
    for net in ("gen", "det"):
        for name, p in getattr(state, net).named_parameters():
            if p.grad is not None:
                mod = tables.get(id(p))
                out[f"{net}.{name}"] = p.grad.detach() if mod is None else gather_rows(p.grad, mod)
    return out


def shard_batch(batch, mesh):
    """This rank's rows of a (B, ...) global batch (a tensor or an array)
    along the data axis; B must divide by its size."""
    n, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not divide over data={n}")
    b = batch.shape[0] // n
    return batch[r * b:(r + 1) * b]


def shard_batch_from_process_local(local_batch, mesh):
    """This rank's shard when each process feeds only its own rows: its
    (B / data, ...) local batch, the rows of its place on the data axis
    (the ranks of one model group feed the same rows).  The global batch is
    never assembled; train_step takes the shard as it is."""
    del mesh  # one card a process: the local rows are the shard
    return local_batch
