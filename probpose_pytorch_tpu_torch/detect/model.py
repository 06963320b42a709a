"""Anchor-free person detector (port of probpose_pytorch_tpu/detect/model.py):
CenterNet-style heads on the residual conv trunk (models/convnet.py).

The trunk (stride 16) is followed by two nearest 2x resizes, each with a
3x3 conv + BN + ReLU, and a 3x3 head conv + BN + ReLU, so the maps come out
at stride 4; the prediction heads are float32 1x1 convs on the float32
features. The nearest resize at exactly 2x takes source pixel i // 2, as
`jax.image.resize(..., "nearest")` does there. Convs run in the compute
dtype, BatchNorm in float32 (models/head.py). Module names are the flax
ones, so compat/from_jax.py maps weights one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from probpose_pytorch_tpu_torch.models.convnet import CONV_PRESETS, ConvBackbone, init_conv_weights
from probpose_pytorch_tpu_torch.models.head import BN_EPS, batch_norm, conv

__all__ = ["FOCAL_PRIOR_BIAS", "PersonDetector", "init_detector_weights"]

# Focal-loss prior of the center (and joint) heat logits: sigmoid(-4.6) is
# about 0.01, so the first steps are not drowned by the easy negatives.
FOCAL_PRIOR_BIAS = -4.6


class PersonDetector(nn.Module):
    """image (B, H, W, 3) in [0, 1] -> dict of float32 maps in JAX's NHWC
    layout: center (B, H/4, W/4, 1) logits, size (.., 2), offset (.., 2).

    With `num_keypoints` K > 0 the trunk is a single-stage multi-person pose
    model: `kpts` (.., 2K) regresses each joint's displacement from the
    person's center cell; with `kpt_heatmaps` also `kpt_heat` (.., K) joint
    heat logits and a shared sub-cell `kpt_offset` (.., 2), for the snap
    refinement at decode (detect/codec.py:decode_poses)."""

    def __init__(self, img_size: tuple[int, int] = (512, 512), preset: str = "conv-t",
                 head_channels: int = 64, dtype: torch.dtype = torch.bfloat16,
                 out_stride: int = 4, num_keypoints: int = 0, kpt_heatmaps: bool = False):
        super().__init__()
        self.img_size = tuple(img_size)
        self.preset = preset
        self.dtype = dtype
        self.out_stride = out_stride
        self.num_keypoints = num_keypoints
        self.kpt_heatmaps = kpt_heatmaps
        chans, blocks = CONV_PRESETS[preset]
        self.backbone = ConvBackbone(chans, blocks, dtype=dtype)
        c = self.backbone.out_channels
        for i, ch in enumerate((head_channels * 2, head_channels)):
            setattr(self, f"up{i}_conv", nn.Conv2d(c, ch, 3, padding=1, bias=False))
            setattr(self, f"up{i}_bn", nn.BatchNorm2d(ch, eps=BN_EPS, momentum=0.1))
            c = ch
        self.head_conv = nn.Conv2d(c, head_channels, 3, padding=1, bias=False)
        self.head_bn = nn.BatchNorm2d(head_channels, eps=BN_EPS, momentum=0.1)
        outs = dict(center=1, size=2, offset=2)
        if num_keypoints > 0:
            outs["kpts"] = 2 * num_keypoints
            if kpt_heatmaps:
                outs.update(kpt_heat=num_keypoints, kpt_offset=2)
        self.outputs = tuple(outs)
        for name, n in outs.items():
            setattr(self, name, nn.Conv2d(head_channels, n, 1))

    @property
    def feat_hw(self) -> tuple[int, int]:
        return (self.img_size[0] // self.out_stride, self.img_size[1] // self.out_stride)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        y = self.backbone(x).permute(0, 3, 1, 2)  # stride 16, float32
        for i in range(2):
            y = F.interpolate(y.float(), scale_factor=2, mode="nearest").to(self.dtype)
            y = F.relu(batch_norm(conv(y, getattr(self, f"up{i}_conv"), self.dtype),
                                  getattr(self, f"up{i}_bn")))
        y = F.relu(batch_norm(conv(y, self.head_conv, self.dtype), self.head_bn)).float()
        return {name: conv(y, getattr(self, name), torch.float32).permute(0, 2, 3, 1)
                for name in self.outputs}


def init_detector_weights(model: PersonDetector, generator: torch.Generator) -> None:
    """flax's defaults (models/convnet.py:init_conv_weights) from
    `generator`, then the focal prior on the center and joint heat biases."""
    init_conv_weights(model, generator)
    with torch.no_grad():
        model.center.bias.fill_(FOCAL_PRIOR_BIAS)
        if "kpt_heat" in model.outputs:
            model.kpt_heat.bias.fill_(FOCAL_PRIOR_BIAS)
