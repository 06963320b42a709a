"""The Megatron boundaries of a tensor-parallel block, and the microbatch
count (the parts of probpose_pytorch_tpu/parallel/pipeline.py that
tensor parallelism uses).

`tp_enter` and `tp_leave` are JAX's custom-VJP boundaries as autograd
Functions over a model group (models/vit.py places them): where a
replicated activation enters the column-parallel matmul, and where the
row-parallel matmul's partial sums leave it. With both in place every
activation and its gradient between blocks is whole and the same on every
rank of the group, so the gradients of the replicated parameters need no
reduction over the model axis.

The pipeline schedules of that file (`pipeline_spmd`, `pipeline_1f1b`, the
interleaved one) are ROADMAP item 13b.
"""

from __future__ import annotations

import torch

from probpose_pytorch_tpu_torch.parallel.collectives import all_reduce_, group_size

__all__ = ["tp_enter", "tp_leave", "pick_microbatches", "pipeline_spmd"]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron "f": identity forward, the gradient summed over `group`
    backward."""
    if group is None or group_size(group) == 1:
        return x
    return _Enter.apply(x, group)


def tp_leave(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron "g": the partial sums summed over `group` forward, identity
    backward."""
    if group is None or group_size(group) == 1:
        return x
    return _Leave.apply(x, group)


def pick_microbatches(local_batch: int, n_stages: int) -> int:
    """Largest microbatch count <= 2 S that divides the per-device batch."""
    cap = min(2 * n_stages, local_batch)
    for m in range(cap, 0, -1):
        if local_batch % m == 0:
            return m
    return 1


def pipeline_spmd(*args, **kwargs):
    """JAX's GPipe schedule over a "pipe" axis: ROADMAP item 13b."""
    raise NotImplementedError("pipeline_spmd (pipeline parallelism) is not ported to PyTorch "
                              "yet (ROADMAP item 13b)")
