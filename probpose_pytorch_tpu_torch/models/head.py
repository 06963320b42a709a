"""Five-branch probabilistic keypoint head (port of
probpose_pytorch_tpu/models/head.py).

Takes the NHWC feature grid, runs NCHW inside, and returns the JAX head's
layouts: heatmaps (B, K, H, W) and four (B, K, 1, 1) scalar maps
(probability, visibility, oks, error).

Numerics follow the flax modules: convolutions run in the compute dtype,
BatchNorm in float32 (eps 1e-5) -- from its running statistics in eval
mode, from the batch's statistics in train mode, where it also updates the
running ones -- and the heatmap branch goes to float32 before sparsemax
(temperature 0.5, then x normalize and clamp to [0, 1]). Sparsemax is kernel K2 on the card.
A flax `ConvTranspose(k, s=2, padding="SAME")` is a
`conv_transpose2d(stride=2)` with the kernel flipped spatially (compat/
from_jax.py does the flip when it loads the weights) and, for k = 4,
padding 1; for k = 2, padding 0; for k = 3, whose SAME padding flax splits
unevenly, padding 0 (2n + 1 outputs) and the last row and column dropped.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from probpose_pytorch_tpu_torch.ops.sparsemax import sparsemax
from probpose_pytorch_tpu_torch.parallel.collectives import all_reduce_sum, group_size

__all__ = ["ProbMapHead", "bn_sync"]

# The process group whose ranks' rows make one batch for train-mode
# BatchNorm statistics (models/model.py sets it on a mesh); None: this
# rank's rows are the batch.
_BN_GROUP = contextvars.ContextVar("bn_group", default=None)


@contextlib.contextmanager
def bn_sync(group):
    """Train-mode BatchNorm inside takes the statistics of every rank of
    `group`'s rows, as JAX's BatchNorm of the global batch does."""
    token = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(token)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch
TEMPERATURE = 0.5  # sparsemax temperature of the reference head


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv(dtype=...)` in NCHW: input, kernel and bias in `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias,
                    stride=layer.stride, padding=layer.padding)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax `nn.BatchNorm(use_running_average=not bn.training,
    momentum=0.9, dtype=float32)` over NCHW.

    Train mode: the f32 batch mean and flax's fast variance, E[x^2] - E[x]^2
    clamped at 0 (biased), normalise x and carry gradients; the running
    statistics become 0.9 * running + 0.1 * batch, biased variance included
    (`F.batch_norm(training=True)` would store the unbiased one). Under
    `bn_sync(group)` the two means are of the rows of every rank of the
    group: their sums are summed over it (the ranks hold equal counts)."""
    x = x.float()
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, training=False, eps=bn.eps)
    group = _BN_GROUP.get()
    if group is None:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    else:
        count = x.numel() // x.shape[1] * group_size(group)
        sums = all_reduce_sum(torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]),
                              group)
        mean = sums[0] / count
        var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
    with torch.no_grad():
        for stat, batch in ((bn.running_mean, mean), (bn.running_var, var)):
            stat.copy_(BN_MOMENTUM * stat + (1.0 - BN_MOMENTUM) * batch)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class _ScalarBranch(nn.Module):
    """[3x3 conv, BN, maxpool, ReLU] per pool stage -> max over what is
    left of the grid -> 1x1 conv -> sigmoid or ReLU."""

    def __init__(self, channels: int, out_channels: int,
                 pool_sizes: Sequence, final_activation: str, dtype: torch.dtype):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(channels, channels, 3, padding=1) for _ in pool_sizes
        )
        self.bns = nn.ModuleList(
            nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1) for _ in pool_sizes
        )
        self.final = nn.Conv2d(channels, out_channels, 1)
        self.pool_sizes = [
            (p, p) if isinstance(p, int) else tuple(p) for p in pool_sizes
        ]
        self.final_activation = final_activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv_i, bn_i, (ph, pw) in zip(self.convs, self.bns, self.pool_sizes):
            x = batch_norm(conv(x, conv_i, self.dtype), bn_i)
            # Windows are clamped to the remaining extent, as in JAX.
            ph, pw = min(ph, x.shape[2]), min(pw, x.shape[3])
            x = F.relu(F.max_pool2d(x, (ph, pw), stride=(ph, pw)))
        if x.shape[2] > 1 or x.shape[3] > 1:
            x = x.amax(dim=(2, 3), keepdim=True)
        x = conv(x, self.final, self.dtype).float()
        return torch.sigmoid(x) if self.final_activation == "sigmoid" else F.relu(x)


class ProbMapHead(nn.Module):
    """Heatmap branch (deconv stack -> optional convs -> final conv ->
    sparsemax) plus four scalar branches off the same features."""

    BRANCHES = (("probability", "sigmoid"), ("visibility", "sigmoid"),
                ("oks", "sigmoid"), ("error", "relu"))

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        pool_sizes: Sequence = ((4, 4), (2, 2), (2, 2)),
        deconv_out_channels: Sequence[int] = (256, 256),
        deconv_kernel_sizes: Sequence[int] = (4, 4),
        conv_out_channels: Sequence[int] = (),
        conv_kernel_sizes: Sequence[int] = (),
        final_layer_kernel_size: int | None = 1,
        normalize: float | None = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        for k in deconv_kernel_sizes:
            if k not in (2, 3, 4):
                raise ValueError(f"unsupported deconv kernel size {k}")
        self.dtype = dtype
        self.normalize = normalize
        c = in_channels
        self.deconvs = nn.ModuleList()
        self.deconv_bns = nn.ModuleList()
        for ch, k in zip(deconv_out_channels, deconv_kernel_sizes):
            self.deconvs.append(nn.ConvTranspose2d(c, ch, k, stride=2, padding=int(k == 4),
                                                   bias=False))
            self.deconv_bns.append(nn.BatchNorm2d(ch, eps=BN_EPS, momentum=0.1))
            c = ch
        self.convs = nn.ModuleList()
        self.conv_bns = nn.ModuleList()
        for ch, k in zip(conv_out_channels, conv_kernel_sizes):
            self.convs.append(nn.Conv2d(c, ch, k, padding=(k - 1) // 2))
            self.conv_bns.append(nn.BatchNorm2d(ch, eps=BN_EPS, momentum=0.1))
            c = ch
        k = final_layer_kernel_size
        self.final = None if k is None else nn.Conv2d(c, out_channels, k, padding=k // 2)
        self.branches = nn.ModuleDict({
            name: _ScalarBranch(in_channels, out_channels, pool_sizes, act, dtype)
            for name, act in self.BRANCHES
        })

    def heatmaps(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW features -> (B, K, H, W) float32 heatmaps."""
        for deconv, bn in zip(self.deconvs, self.deconv_bns):
            x = F.conv_transpose2d(x.to(self.dtype), deconv.weight.to(self.dtype),
                                   stride=2, padding=deconv.padding)
            if deconv.kernel_size[0] == 3:
                x = x[:, :, :-1, :-1]
            x = F.relu(batch_norm(x, bn))
        for conv_i, bn in zip(self.convs, self.conv_bns):
            x = F.relu(batch_norm(conv(x, conv_i, self.dtype), bn))
        if self.final is not None:
            x = conv(x, self.final, self.dtype)
        B, K, H, W = x.shape
        flat = x.float().reshape(B, K, H * W)
        if self.normalize is not None:
            flat = sparsemax(flat / TEMPERATURE) * self.normalize
        return flat.clamp(0.0, 1.0).reshape(B, K, H, W)

    @staticmethod
    def frozen_param_labels(
        names: Sequence[str],
        freeze_heatmaps: bool = False,
        freeze_probability: bool = False,
        freeze_visibility: bool = False,
        freeze_oks: bool = False,
        freeze_error: bool = False,
        prefix: str = "head",
    ) -> list[str]:
        """"frozen" or "trainable" for each parameter name, as the JAX
        head labels its tree for an optimizer mask (the reference's
        per-branch requires_grad flags): a scalar branch
        (`<prefix>.branches.<name>.*`) by its flag, the heatmap branch
        (`<prefix>.{deconvs,deconv_bns,convs,conv_bns,final}.*`) by
        `freeze_heatmaps`; names outside `prefix` train."""
        frozen = {branch for branch, flag in (
            ("probability", freeze_probability), ("visibility", freeze_visibility),
            ("oks", freeze_oks), ("error", freeze_error)) if flag}

        def label(name: str) -> str:
            parts = name.split(".")
            if prefix not in parts:
                return "trainable"
            sub = parts[parts.index(prefix) + 1:] + [""]
            if sub[0] == "branches":
                sub = sub[1:]
            if sub[0] in frozen or (freeze_heatmaps
                                    and sub[0].startswith(("deconv", "conv", "final"))):
                return "frozen"
            return "trainable"

        return [label(n) for n in names]

    def forward(self, feats: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, h, w, C) features -> (heatmaps (B, K, H, W), probability,
        visibility, oks, error, each (B, K, 1, 1))."""
        x = feats.permute(0, 3, 1, 2)
        heatmaps = self.heatmaps(x)
        # The scalar branches read detached features (the flagship's
        # detach_probability / detach_visibility defaults; oks and error
        # always detach): their losses train their own convs and BNs only.
        x = x.detach()
        return (heatmaps, *(self.branches[name](x) for name, _ in self.BRANCHES))
