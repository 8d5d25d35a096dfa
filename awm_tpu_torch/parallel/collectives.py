"""The collectives of the sharded train step, each an all-reduce-sum.

Gloo takes CUDA tensors for all_reduce and broadcast only, and NCCL refuses
two ranks on one card, so the one multi-rank run a single card allows (two
ranks over gloo) needs every collective of the path to be one of those two.
A group of None means a group of one rank: nothing to reduce, so nothing is
issued, as XLA elides a collective over an axis of size 1.

`stats` counts the collectives issued (forward and backward alike).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

stats = {"count": 0}


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t in place over the group's ranks (no autograd)."""
    if group is None:
        return t
    stats["count"] += 1
    dist.all_reduce(t, group=group)
    return t


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _SumOverRanks(torch.autograd.Function):
    """y = sum over the group of each rank's x.  Each rank's loss depends on
    y, so the gradient of x is the sum of every rank's gradient of y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReplicatedSum(torch.autograd.Function):
    """y = sum over the group of each rank's partial x, where every rank of
    the group then computes the same loss from y (the model group of the
    vocab-parallel table: Megatron's reduce-from-model-parallel).  The
    gradient of x is y's own, unreduced: summing it would count the one loss
    once per rank."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce-sum whose backward sums the gradients (the
    ranks hold different rows of one batch)."""
    return x if group is None else _SumOverRanks.apply(x, group)


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce-sum whose backward is the identity (the
    ranks compute the same loss from the sum)."""
    return x if group is None else _ReplicatedSum.apply(x, group)


def mean_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group of each rank's x, without autograd (a new
    tensor; x is left as it is)."""
    if group is None:
        return x
    return all_reduce_(x.detach().clone(), group) / group_size(group)
