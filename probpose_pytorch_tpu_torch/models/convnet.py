"""Small residual conv backbone family (port of
probpose_pytorch_tpu/models/convnet.py).

Same contract as the ViT trunk: a (B, H, W, 3) image in [0, 1] -> the NHWC
feature grid (B, H/16, W/16, C), so the heads and the serving path do not
care which trunk they sit on. NCHW inside. Convolutions run in the compute
dtype on the image cast to it; BatchNorm runs in float32 (models/head.py's
flax-equivalent `batch_norm`) and its output stays float32, so a block's
residual `relu(x + y)` adds float32 tensors.

flax's `nn.Conv` pads "SAME" by default, which is zero padding for the
1x1 `proj` (stride 2 included); the 3x3 and 7x7 convs take explicit
padding 1 and 3, as in JAX.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from probpose_pytorch_tpu_torch.models.head import BN_EPS, batch_norm, conv

__all__ = ["CONV_PRESETS", "ConvBackbone", "init_conv_weights"]

CONV_PRESETS = {
    # name: (stage_channels, blocks_per_stage); total stride 16, the
    # ViT/p16 feature-grid geometry.
    "conv-s": ((64, 128, 256, 384), (2, 2, 2, 2)),
    "conv-t": ((32, 64, 128, 256), (1, 1, 2, 2)),
}


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)


class _ResBlock(nn.Module):
    """conv3x3(stride) -> BN -> ReLU -> conv3x3 -> BN, plus the input (a
    1x1 `proj` + BN where the width or the stride changes) -> ReLU."""

    def __init__(self, in_channels: int, channels: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, padding=1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = _bn(channels)
        self.proj = self.proj_bn = None
        if in_channels != channels or stride != 1:
            self.proj = nn.Conv2d(in_channels, channels, 1, stride, bias=False)
            self.proj_bn = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(batch_norm(conv(x, self.conv1, self.dtype), self.bn1))
        y = batch_norm(conv(y, self.conv2, self.dtype), self.bn2)
        if self.proj is not None:
            x = batch_norm(conv(x, self.proj, self.dtype), self.proj_bn)
        return F.relu(x + y)


class ConvBackbone(nn.Module):
    """Residual conv trunk of output stride 16: a 7x7 stride-2 stem, then
    stages of strides 1, 2, 2, 2. `frozen` detaches the output."""

    def __init__(self, stage_channels: Sequence[int] = (64, 128, 256, 384),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.bfloat16, frozen: bool = False):
        super().__init__()
        self.dtype = dtype
        self.frozen = frozen
        self.stem = nn.Conv2d(3, stage_channels[0], 7, 2, padding=3, bias=False)
        self.stem_bn = _bn(stage_channels[0])
        blocks, c = [], stage_channels[0]
        for s, (ch, nb) in enumerate(zip(stage_channels, stage_blocks)):
            for b in range(nb):
                blocks.append(_ResBlock(c, ch, 2 if (b == 0 and s > 0) else 1, dtype))
                c = ch
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/16, W/16, C) float32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(batch_norm(conv(x, self.stem, self.dtype), self.stem_bn))
        for block in self.blocks:
            x = block(x)
        if self.frozen:
            x = x.detach()
        return x.permute(0, 2, 3, 1)


def init_conv_weights(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults for every Conv2d under `module`: kernels lecun-normal
    (the normal truncated at +-2 std, scaled by 1 / sqrt(fan_in) / 0.8796),
    biases zero; BatchNorm keeps its unit scale and zero bias. Drawn on the
    CPU from `generator`, in module order."""
    from probpose_pytorch_tpu_torch.models.model import _trunc_normal

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                _trunc_normal(m.weight, 1.0 / math.sqrt(fan_in) / 0.87962566103423978,
                              generator)
                if m.bias is not None:
                    m.bias.zero_()
