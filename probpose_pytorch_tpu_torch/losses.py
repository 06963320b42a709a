"""Losses and accuracy metrics (port of probpose_pytorch_tpu/losses.py).

Every term follows the JAX function of the same name. `ProbPoseLoss`
derives its OKS and error targets from an argmax + UDP decode of both
heatmaps inside the step, under `torch.no_grad()`: the targets are
constants to autograd, as `jax.lax.stop_gradient` makes them in JAX.
Plain tensor code: no JAX loss term is a kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from probpose_pytorch_tpu_torch.codec import Codec
from probpose_pytorch_tpu_torch.ops.heatmap import (
    calc_distances,
    distance_acc,
    expected_value_decode,
    heatmap_maximum,
)
from probpose_pytorch_tpu_torch.ops.oks import oks_targets_from_coords

__all__ = [
    "oks_heatmap_loss",
    "binary_cross_entropy",
    "mse_loss",
    "l1_log_loss",
    "pose_pck_accuracy",
    "balanced_binary_accuracy",
    "masked_mae",
    "ProbPoseLoss",
]

_SOBEL_X = np.array([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]], np.float32)
_SOBEL_Y = _SOBEL_X.T.copy()
# binary_cross_entropy's probability clip: the smallest normal float32 and
# 1 - 2^-24, which keep both logs finite.
BCE_CLIP = (1.1754944e-38, 1.0 - 6e-8)


@functools.lru_cache(maxsize=8)
def _sobel_kernels(device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The two (1, 1, 3, 3) Sobel kernels on `device`, copied there once."""
    return tuple(torch.as_tensor(k, device=device, dtype=dtype).reshape(1, 1, 3, 3)
                 for k in (_SOBEL_X, _SOBEL_Y))


def _sobel_gradient_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared Sobel gradient magnitude with zero ('same') padding."""
    B, K, H, W = x.shape
    inp = x.reshape(B * K, 1, H, W)
    kx, ky = _sobel_kernels(x.device, x.dtype)
    gx = F.conv2d(inp, kx, padding=1)
    gy = F.conv2d(inp, ky, padding=1)
    return (gx**2 + gy**2).reshape(B, K, H, W)


def _combine_mask(target, target_weights, mask, skip_empty_channel):
    out = mask
    if target_weights is not None:
        tw = target_weights.reshape(
            target_weights.shape + (1,) * (target.dim() - target_weights.dim()))
        out = tw if out is None else out * tw
    if skip_empty_channel:
        ne = (target != 0).any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
        out = ne if out is None else out * ne
    return out


def oks_heatmap_loss(output, target, target_weights=None, mask=None, *,
                     oks_type: str = "minus", smoothing_weight: float = 0.2,
                     gaussian_weight: float = 0.0, skip_empty_channel: bool = False,
                     per_pixel: bool = False, per_keypoint: bool = False,
                     loss_weight: float = 1.0) -> torch.Tensor:
    """Expected-OKS heatmap loss: oks_w * oks_term + smoothing_w *
    sobel_grad^2 + gaussian_w * mse, with oks_term output * (1 - target)
    ("minus"), (1 - output) * target ("plus") or their mean ("both");
    reduced per pixel, per keypoint or to a scalar mean."""
    if oks_type not in ("minus", "plus", "both"):
        raise ValueError(f"oks_type {oks_type!r}")
    B, K, H, W = output.shape
    _mask = _combine_mask(target, target_weights, mask, skip_empty_channel)
    oks_minus = output * (1.0 - target)
    oks_plus = (1.0 - output) * target
    oks = {"minus": oks_minus, "plus": oks_plus,
           "both": (oks_minus + oks_plus) / 2.0}[oks_type]
    mse = (output - target) ** 2
    gradient = _sobel_gradient_sq(output)
    if _mask is not None:
        oks, mse, gradient = oks * _mask, mse * _mask, gradient * _mask
    oks_w = 1.0 - smoothing_weight - gaussian_weight
    if per_pixel:
        loss = smoothing_weight * gradient + oks_w * oks + gaussian_weight * mse
    else:
        max_grad = gradient.reshape(B, K, H * W).amax(dim=-1)
        loss = (oks_w * oks.sum(dim=(2, 3)) + smoothing_weight * max_grad
                + gaussian_weight * mse.mean(dim=(2, 3)))
        if not per_keypoint:
            loss = loss.mean()
    return loss * loss_weight


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with its gradient: 1 inside, 0 outside, 1/2 at a bound
    (min/max split ties), where torch.clamp passes 1 at the bounds."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def binary_cross_entropy(output, target, target_weight=None, *,
                         from_probs: bool = False, reduction: str = "mean",
                         loss_weight: float = 1.0) -> torch.Tensor:
    """BCE on probabilities (`from_probs`) or on logits. Probabilities are
    clipped to BCE_CLIP with zero gradient outside it, so a saturated
    branch (p exactly 0 or 1) gets a finite loss and no gradient; this is
    not F.binary_cross_entropy, whose log clamp at -100 gives other values
    and gradients."""
    if from_probs:
        p = _clip(output.float(), *BCE_CLIP)
        loss = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
    else:
        loss = (torch.clamp_min(output, 0) - output * target
                + torch.log1p(torch.exp(-output.abs())))
    if target_weight is not None:
        if target_weight.dim() == 1:
            target_weight = target_weight[:, None]
        loss = loss * target_weight
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    return loss * loss_weight


def mse_loss(output, target, target_weight=None, *, loss_weight: float = 1.0):
    """mean((output * w - target * w)^2)."""
    if target_weight is not None:
        output = output * target_weight
        target = target * target_weight
    return ((output - target) ** 2).mean() * loss_weight


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x**2, ax - 0.5)


def l1_log_loss(output, target, target_weight=None, *, loss_weight: float = 1.0):
    """Smooth-L1 on log(1 + x)."""
    output = torch.log1p(output)
    target = torch.log1p(target)
    if target_weight is not None:
        w = target_weight.reshape(
            target_weight.shape + (1,) * (output.dim() - target_weight.dim()))
        output, target = output * w, target * w
    return _smooth_l1(output - target).mean() * loss_weight


def pose_pck_accuracy(output, target, mask, thr: float = 0.05, normalize=None,
                      method: str = "argmax", conv_ops=None):
    """PCK from heatmaps: (per-keypoint acc, average acc, count). Keeps the
    reference's [H, W] normalisation. method="expected" decodes with
    `conv_ops` = (row_op, col_op) from `ProbMap.conv_operators`."""
    N, K, H, W = output.shape
    if normalize is None:
        normalize = torch.tensor([[H, W]], dtype=torch.float32,
                                 device=output.device).expand(N, 2)
    if method == "expected":
        if conv_ops is None:
            raise ValueError("method='expected' requires conv_ops")
        pred, _ = expected_value_decode(output, *conv_ops)
        gt, _ = expected_value_decode(target, *conv_ops)
    elif method == "argmax":
        pred, _ = heatmap_maximum(output)
        gt, _ = heatmap_maximum(target)
    else:
        raise ValueError(f"invalid method {method!r}")
    acc = distance_acc(calc_distances(pred, gt, mask, normalize), thr)
    valid = acc >= 0
    cnt = valid.sum()
    avg = torch.where(valid, acc, 0.0).sum() / cnt.clamp_min(1)
    return acc, torch.where(cnt > 0, avg, 0.0), cnt


def balanced_binary_accuracy(dt, gt, mask):
    """Best balanced accuracy (TPR + TNR) / 2 over thresholds 0.1 .. 0.95
    (step 0.05), and its threshold; 0 if either class is empty."""
    thresholds = torch.arange(0.1, 1.0, 0.05, dtype=torch.float32, device=dt.device)
    m = mask.reshape(-1)
    d = dt.reshape(-1)
    g = gt.reshape(-1) > 0.5
    pos, neg = m & g, m & ~g
    npos, nneg = pos.sum(), neg.sum()
    preds = d[:, None] > thresholds[None, :]
    tpr = (preds & pos[:, None]).sum(dim=0) / npos.clamp_min(1)
    tnr = (~preds & neg[:, None]).sum(dim=0) / nneg.clamp_min(1)
    bal = (tpr + tnr) / 2.0
    best = bal.argmax()
    ok = (npos > 0) & (nneg > 0)
    return torch.where(ok, bal[best], 0.0), torch.where(ok, thresholds[best], 0.0)


def masked_mae(dt, gt, mask):
    m = mask.float()
    return ((dt - gt).abs() * m).sum() / m.sum().clamp_min(1.0)


@dataclass(frozen=True)
class ProbPoseLoss:
    """The five-term ProbPose loss with in-step target derivation:
    `loss(gt, pred)` returns a dict of scalar losses (and an accuracy dict
    with `compute_acc`)."""

    codec: Codec
    freeze_error: bool = True
    freeze_oks: bool = False
    heatmap_smoothing_weight: float = 0.05
    heatmap_oks_type: str = "minus"

    @torch.no_grad()
    def _decode_coords(self, heatmaps: torch.Tensor) -> torch.Tensor:
        coords, _ = self.codec.probmap.decode(heatmaps)
        return coords

    def __call__(self, gt: dict[str, torch.Tensor], pred: tuple[torch.Tensor, ...],
                 keypoint_weights: torch.Tensor | None = None,
                 learn_heatmaps_from_zeros: bool = False,
                 compute_acc: bool = False) -> Any:
        dt_heatmaps, dt_probs, dt_vis, dt_oks, dt_errs = pred
        B, C, H, W = dt_heatmaps.shape
        f32 = torch.float32
        gt_heatmaps = gt["heatmaps"].to(dt_heatmaps.dtype).reshape(B, C, H, W)
        gt_probs = gt["in_image"].reshape(B, C).int()
        gt_annotated = gt["keypoints_visible"].reshape(B, C).int()
        gt_vis = gt["keypoints_visibility"].reshape(B, C).int()
        if keypoint_weights is None:
            keypoint_weights = torch.ones((B, C), dtype=dt_heatmaps.dtype,
                                          device=dt_heatmaps.device)
        keypoint_weights = keypoint_weights.reshape(B, C)
        dt_probs, dt_vis = dt_probs.reshape(B, C), dt_vis.reshape(B, C)
        dt_oks, dt_errs = dt_oks.reshape(B, C), dt_errs.reshape(B, C)

        if not self.freeze_oks or not self.freeze_error:
            gt_coords = self._decode_coords(gt_heatmaps.float())
            dt_coords = self._decode_coords(dt_heatmaps.float())
        if self.freeze_error:
            gt_errs = torch.zeros((B, C), dtype=dt_errs.dtype, device=dt_errs.device)
        else:
            gt_errs = torch.linalg.norm(gt_coords - dt_coords, dim=-1).to(dt_errs.dtype)
        if self.freeze_oks:
            gt_oks = torch.zeros((B, C), dtype=dt_oks.dtype, device=dt_oks.device)
        else:
            gt_oks, _ = oks_targets_from_coords(
                gt_coords, dt_coords, (gt_probs & gt_annotated).to(f32),
                self.codec.probmap.sigmas_on(dt_oks.device), (W, H))
            gt_oks = gt_oks.to(dt_oks.dtype)
        annotated_in = (gt_annotated & (gt_probs > 0.5).int()).to(f32)

        heatmap_weights = (gt_annotated.to(dt_heatmaps.dtype)
                           if learn_heatmaps_from_zeros else keypoint_weights)
        losses = dict(
            kpt=oks_heatmap_loss(
                dt_heatmaps, gt_heatmaps, heatmap_weights,
                oks_type=self.heatmap_oks_type,
                smoothing_weight=self.heatmap_smoothing_weight, per_pixel=True,
            ).mean(),
            probability=binary_cross_entropy(dt_probs, gt_probs.to(f32), from_probs=True),
            # The reference builds visible/invisible weights but its BCE
            # ignores them (use_target_weight=False): a plain mean BCE.
            visibility=binary_cross_entropy(dt_vis, gt_vis.to(f32), from_probs=True),
            oks=mse_loss(dt_oks, gt_oks, annotated_in),
            error=l1_log_loss(dt_errs, gt_errs, annotated_in),
        )
        if not compute_acc:
            return losses
        _, acc_pose, _ = pose_pck_accuracy(
            dt_heatmaps.float(), gt_heatmaps.float(), keypoint_weights > 0.5)
        acc_prob, _ = balanced_binary_accuracy(dt_probs, gt_probs.to(f32), gt_annotated > 0.5)
        acc_vis, _ = balanced_binary_accuracy(dt_vis, gt_vis.to(f32), annotated_in > 0.5)
        return losses, dict(
            kpt=acc_pose,
            probability=acc_prob,
            visibility=acc_vis,
            oks=masked_mae(dt_oks, gt_oks, annotated_in > 0.5),
            error=masked_mae(dt_errs, gt_errs, annotated_in > 0.5),
        )
