"""The SimCC head family's loss (port of probpose_pytorch_tpu/losses_simcc.py).

`SimCCLoss` keeps `losses.ProbPoseLoss`'s contract -- `loss(gt, pred)` with
the terms kpt, probability, visibility, oks and error, and the same
accuracies with `compute_acc` -- with the localisation term a soft cross
entropy between each axis's bin logits and the codec's 1-D Gaussian
labels. The OKS and error targets decode both the labels (through
log(labels + 1e-12): argmax and parabola only need a monotone map) and the
logits with the codec's decoder under `torch.no_grad()`, constants to
autograd as `jax.lax.stop_gradient` makes them. Plain tensor code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from probpose_pytorch_tpu_torch.codec_simcc import SimCCCodec, _axis_decode
from probpose_pytorch_tpu_torch.losses import (
    balanced_binary_accuracy,
    binary_cross_entropy,
    l1_log_loss,
    masked_mae,
    mse_loss,
)
from probpose_pytorch_tpu_torch.ops.oks import oks_targets_from_coords

__all__ = ["SimCCLoss"]


def _soft_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over (B, K) of -sum(labels * log_softmax(logits))."""
    ce = -(labels * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)
    w = weights.float()
    return (ce * w).sum() / w.sum().clamp_min(1.0)


@dataclass(frozen=True)
class SimCCLoss:
    codec: SimCCCodec
    freeze_error: bool = True
    freeze_oks: bool = False

    @torch.no_grad()
    def _decode_bins(self, x_logits: torch.Tensor, y_logits: torch.Tensor) -> torch.Tensor:
        """Logits (or the log of label distributions) -> (B, K, 2)
        coordinates in bins, outside autograd."""
        cx, _ = _axis_decode(x_logits)
        cy, _ = _axis_decode(y_logits)
        return torch.stack([cx, cy], dim=-1)

    def __call__(self, gt: dict[str, torch.Tensor], pred: tuple[Any, ...],
                 keypoint_weights: torch.Tensor | None = None,
                 learn_heatmaps_from_zeros: bool = False,
                 compute_acc: bool = False) -> Any:
        (dt_x, dt_y), dt_probs, dt_vis, dt_oks, dt_errs = pred
        B, C = dt_x.shape[:2]
        f32 = torch.float32
        gt_x = gt["x_labels"].to(f32).reshape(B, C, -1)
        gt_y = gt["y_labels"].to(f32).reshape(B, C, -1)
        gt_probs = gt["in_image"].reshape(B, C).int()
        gt_annotated = gt["keypoints_visible"].reshape(B, C).int()
        gt_vis = gt["keypoints_visibility"].reshape(B, C).int()
        if keypoint_weights is None:
            keypoint_weights = gt.get("keypoint_weights")
            if keypoint_weights is None:
                keypoint_weights = torch.ones((B, C), device=dt_x.device)
        keypoint_weights = keypoint_weights.to(f32).reshape(B, C)
        dt_probs, dt_vis = dt_probs.reshape(B, C), dt_vis.reshape(B, C)
        dt_oks, dt_errs = dt_oks.reshape(B, C), dt_errs.reshape(B, C)

        if not self.freeze_oks or not self.freeze_error or compute_acc:
            gt_coords = self._decode_bins(torch.log(gt_x + 1e-12), torch.log(gt_y + 1e-12))
            dt_coords = self._decode_bins(dt_x, dt_y)
        Wb, Hb = self.codec.label.bins
        if self.freeze_error:
            gt_errs = torch.zeros((B, C), dtype=dt_errs.dtype, device=dt_errs.device)
        else:
            gt_errs = torch.linalg.norm(gt_coords - dt_coords, dim=-1).to(dt_errs.dtype)
        if self.freeze_oks:
            gt_oks = torch.zeros((B, C), dtype=dt_oks.dtype, device=dt_oks.device)
        else:
            gt_oks, _ = oks_targets_from_coords(
                gt_coords, dt_coords, (gt_probs & gt_annotated).to(f32),
                self.codec.label.sigmas_on(dt_oks.device), (Wb, Hb))
            gt_oks = gt_oks.to(dt_oks.dtype)
        annotated_in = (gt_annotated & (gt_probs > 0.5).int()).to(f32)

        # A softmax over bins cannot emit ProbMap's all-zero maps, so
        # learn_heatmaps_from_zeros trains the annotated keypoints inside
        # the crop, as in JAX.
        label_weights = annotated_in if learn_heatmaps_from_zeros else keypoint_weights
        losses = dict(
            kpt=0.5 * (_soft_cross_entropy(dt_x, gt_x, label_weights)
                       + _soft_cross_entropy(dt_y, gt_y, label_weights)),
            probability=binary_cross_entropy(dt_probs, gt_probs.to(f32), from_probs=True),
            visibility=binary_cross_entropy(dt_vis, gt_vis.to(f32), from_probs=True),
            oks=mse_loss(dt_oks, gt_oks, annotated_in),
            error=l1_log_loss(dt_errs, gt_errs, annotated_in),
        )
        if not compute_acc:
            return losses
        # PCK@0.05 on the bin grid, normalised per axis by bins / 10.
        norm = torch.tensor([Wb / 10.0, Hb / 10.0], dtype=f32, device=dt_x.device)
        dist = torch.linalg.norm((gt_coords - dt_coords) / norm, dim=-1)
        mask = keypoint_weights > 0.5
        acc_pose = ((dist < 0.5) & mask).sum() / mask.sum().clamp_min(1)
        acc_prob, _ = balanced_binary_accuracy(dt_probs, gt_probs.to(f32), gt_annotated > 0.5)
        acc_vis, _ = balanced_binary_accuracy(dt_vis, gt_vis.to(f32), annotated_in > 0.5)
        return losses, dict(
            kpt=acc_pose,
            probability=acc_prob,
            visibility=acc_vis,
            oks=masked_mae(dt_oks, gt_oks, annotated_in > 0.5),
            error=masked_mae(dt_errs, gt_errs, annotated_in > 0.5),
        )
