"""Sparsemax over heatmap pixels (port of probpose_pytorch_tpu/ops/sparsemax.py).

`sparsemax(z)` projects each row of the last axis onto the probability
simplex. Its forward is kernel K2 on a CUDA tensor and the plain bisection
on a CPU tensor; both live in ops/kernels/sparsemax.py, the plain one
(`sparsemax_reference`) as the counterpart of the JAX `_sparsemax_fwd_impl`. Its backward is the closed-form
Jacobian of the JAX `_bwd`:
    dz = where(p > 0, g - mean(g over the support), 0),
in plain torch; the TPU package has no backward kernel either.
"""

from __future__ import annotations

import torch

from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_rows

__all__ = ["sparsemax", "sparsemax_backward"]


def sparsemax_backward(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Closed-form vector-Jacobian product (JAX ops/sparsemax.py:77-82)."""
    support = p > 0
    k = support.sum(dim=-1, keepdim=True).clamp_min(1)
    gsum = torch.where(support, g, 0.0).sum(dim=-1, keepdim=True)
    return torch.where(support, g - gsum / k, 0.0).to(g.dtype)


class _Sparsemax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z: torch.Tensor) -> torch.Tensor:
        shape = z.shape
        p = sparsemax_rows(z.float().reshape(-1, shape[-1]).contiguous())
        p = p.reshape(shape).to(z.dtype)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (p,) = ctx.saved_tensors
        return sparsemax_backward(p, g)


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """Sparsemax along the last axis (Martins & Astudillo, 2016)."""
    return _Sparsemax.apply(z)
