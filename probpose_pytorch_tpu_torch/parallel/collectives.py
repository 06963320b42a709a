"""The collectives the scale-out path calls, and their autograd forms.

GSPMD inserts JAX's collectives from shardings; the port calls them by
hand, on the process groups of a mesh's axes (`DeviceMesh.get_group`).
Gloo moves CUDA tensors for all_reduce and broadcast only, so on a gloo
group a CUDA tensor's all_gather goes through host memory: a rule of the
backend, stated here, not a reaction to a failure. NCCL and CPU tensors
run every collective in place.

Autograd forms, each with the backward its forward needs when every rank
of the group computes the same global loss:
  * `all_reduce_sum`: sum forward, sum backward (BatchNorm's batch sums);
  * `gather_rows`: all_gather along dim 0 forward, this rank's rows of the
    gradient backward (every rank's loss is the one global loss);
  * `scatter_rows`: this rank's rows of a tensor that every rank of the
    group holds forward, the rows of every rank's gradient gathered
    backward (the head's share of the batch on a model group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["group_size", "group_rank", "all_reduce_", "all_gather_cat", "broadcast_",
           "all_reduce_sum", "gather_rows", "scatter_rows"]


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a gather of `t` on `group` goes through host memory: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place and return it."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    """`t` of the group's rank `src_group_rank` on every rank, in place."""
    if group_size(group) > 1:
        dist.broadcast(t, dist.get_global_rank(group, src_group_rank), group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (one shape on all) concatenated along `dim`, in the
    group's rank order."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    host = _staged(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, differentiable (its backward sums the
    gradients over the group)."""
    if group is None or group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        r = group_rank(ctx.group) * ctx.rows
        return grad[r:r + ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of `x` stacked in the group's rank order. Its
    backward keeps this rank's rows of the gradient: the ranks compute one
    loss from the gathered rows, each the same."""
    if group is None or group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[0] // group_size(group)
        r = group_rank(group) * n
        return x[r:r + n]

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.group), None


def scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the rows of `x`, which every rank of `group`
    holds alike; its backward gathers the shares' gradients, so the
    gradient of `x` is whole on every rank."""
    if group is None or group_size(group) == 1:
        return x
    return _ScatterRows.apply(x, group)
