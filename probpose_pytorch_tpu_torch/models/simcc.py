"""SimCC coordinate-classification head (port of
probpose_pytorch_tpu/models/simcc.py).

Each keypoint is located by two 1-D classifications over sub-pixel bins: a
1x1 conv maps the (h, w) feature grid to K channels, each keypoint's map is
flattened row-major over (h, w) -- token i * w + j, JAX's
`transpose(0, 3, 1, 2).reshape(B, K, h * w)` -- and two Linears shared by
all keypoints give Wb = int(W * split_ratio) x logits and Hb y logits. The
four scalar branches are ProbMapHead's (models/head.py), so the head keeps
the 5-tuple contract with pred[0] a pair (x_logits (B, K, Wb), y_logits
(B, K, Hb)), both float32.

Numerics follow flax's `Conv` and `Dense` with dtype=bf16: input and kernel
rounded to the compute dtype, the product accumulated in f32 and rounded
to the compute dtype, then the bias added in that dtype. Both projections
are plain products outside any kernel in JAX too.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from probpose_pytorch_tpu_torch.models.head import ProbMapHead, _ScalarBranch

__all__ = ["SimCCHead"]


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=...)`: x @ W^T in `dtype`, then + bias in `dtype`."""
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


class SimCCHead(nn.Module):
    """(B, h, w, C) features on an (h, w) `grid` -> ((x_logits, y_logits),
    probability, visibility, oks, error), the scalars (B, K, 1, 1).
    `input_size` is the crop's (H, W). The scalar branches read detached
    features, as ProbMapHead's do (JAX's detach_probability and
    detach_visibility defaults; oks and error always detach)."""

    BRANCHES = ProbMapHead.BRANCHES

    def __init__(self, in_channels: int, out_channels: int, input_size: tuple[int, int],
                 grid: tuple[int, int], split_ratio: float = 2.0,
                 pool_sizes: Sequence = ((4, 4), (2, 2), (2, 2)),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        H, W = input_size
        h, w = grid
        self.bins = (int(W * split_ratio), int(H * split_ratio))
        self.dtype = dtype
        self.final = nn.Conv2d(in_channels, out_channels, 1)
        self.mlp_x = nn.Linear(h * w, self.bins[0])
        self.mlp_y = nn.Linear(h * w, self.bins[1])
        self.branches = nn.ModuleDict({
            name: _ScalarBranch(in_channels, out_channels, pool_sizes, act, dtype)
            for name, act in self.BRANCHES
        })

    def logits(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """NHWC features -> (x_logits (B, K, Wb), y_logits (B, K, Hb)), f32."""
        B, h, w, C = feats.shape
        K = self.final.out_channels
        # The 1x1 conv over the channels of the NHWC grid, then each
        # keypoint's map flattened row-major over (h, w).
        x = _dense(feats, self.final.weight.reshape(K, C), self.final.bias, self.dtype)
        tokens = x.permute(0, 3, 1, 2).reshape(B, K, h * w)
        lx = _dense(tokens, self.mlp_x.weight, self.mlp_x.bias, self.dtype)
        ly = _dense(tokens, self.mlp_y.weight, self.mlp_y.bias, self.dtype)
        return lx.float(), ly.float()

    def forward(self, feats: torch.Tensor) -> tuple:
        x = feats.permute(0, 3, 1, 2).detach()
        return (self.logits(feats), *(self.branches[name](x) for name, _ in self.BRANCHES))
