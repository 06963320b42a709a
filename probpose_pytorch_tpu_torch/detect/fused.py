"""Fused two-stage serving (port of probpose_pytorch_tpu/detect/fused.py):
detector -> crops -> top-down pose with the boxes never leaving the card.

The standalone top-down path (`TopDownPredictor(detector=...)`) reads the
detector's boxes back to the host, thresholds and expands them there and
uploads them again for the pose program. `FusedTwoStagePredictor` keeps
them on the device: the frames cross to the card once, the detector's
forward and static top-k decode run on them, `expand_boxes_jax` conditions
the first `max_people` boxes there, and the pose stage
(`TopDownPredictor.predict`, kernels K1 and K2 in the ViT trunk and the
ProbMap head) crops them from the same frames by index. No host copy and
no synchronisation between the stages: every frame yields `max_people`
pose slots, detector-score-descending, thresholded on the host afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["FusedTwoStagePredictor", "expand_boxes_jax"]


def expand_boxes_jax(boxes: torch.Tensor, input_size: tuple[int, int],
                     scale: float) -> torch.Tensor:
    """The device twin of detect/pipeline.py:expand_detections (aspect-pad
    to the pose crop's W/H and expand about the center; degenerate
    detections floor at 1 px), under the JAX package's name. boxes (N, 4)
    xywh -> (N, 4)."""
    H, W = input_size
    aspect = W / H
    boxes = boxes.float()
    x, y = boxes[:, 0], boxes[:, 1]
    w = torch.clamp_min(boxes[:, 2], 1.0)
    h = torch.clamp_min(boxes[:, 3], 1.0)
    cx, cy = x + w / 2.0, y + h / 2.0
    wide = w / h > aspect
    h2 = torch.where(wide, w / aspect, h) * scale
    w2 = torch.where(wide, w, h * aspect) * scale
    return torch.stack([cx - w2 / 2.0, cy - h2 / 2.0, w2, h2], dim=-1)


@dataclasses.dataclass
class FusedTwoStagePredictor:
    """Frame -> poses over a live DetectorPredictor and TopDownPredictor on
    one device. The pose predictor's flip and scale test and temperatures
    apply in the pose stage; `return_heatmaps` must stay off (per-slot maps
    would dominate the readback)."""

    detector: Any  # detect.pipeline.DetectorPredictor
    pose: Any  # inference.TopDownPredictor
    max_people: int = 8  # pose slots per frame (top-k by detector score)
    bbox_scale: float = 1.25  # expand_bbox conditioning, as in training
    score_threshold: float = 0.3  # predict_frame's host-side cut

    def __post_init__(self):
        if not hasattr(self.detector, "predict") or not hasattr(self.pose, "predict"):
            raise ValueError("fusing composes the LIVE predictors' programs; exported bundles "
                             "are already-traced programs (export the fused program itself: "
                             "serve.export --fused-detector)")
        if self.detector.mesh is not None or self.pose.mesh is not None:
            raise ValueError("fused two-stage serving is single-device; scale the two "
                             "stages' own mesh= knobs instead")
        if self.pose.return_heatmaps:
            raise ValueError("fused two-stage serving needs return_heatmaps=False (per-crop "
                             "heatmaps for every pose slot would dominate the output transfer)")
        if self.max_people < 1:
            raise ValueError(f"max_people must be >= 1: {self.max_people}")
        if self.max_people > self.detector.max_detections:
            raise ValueError(f"max_people ({self.max_people}) exceeds the detector's "
                             f"max_detections ({self.detector.max_detections})")

    @torch.inference_mode()
    def predict(self, frames: torch.Tensor) -> dict[str, torch.Tensor]:
        """frames (B, Hf, Wf, 3) uint8 already on the card -> every pose
        field shaped (B, max_people, ...), plus `boxes` (B, max_people, 4)
        (the expanded crop geometry, frame px) and `det_scores` (B,
        max_people), on the device; no host copy, no synchronisation."""
        B, K = frames.shape[0], self.max_people
        det_boxes, det_scores = self.detector.predict(frames)
        crop_boxes = expand_boxes_jax(det_boxes[:, :K].reshape(B * K, 4),
                                      self.pose.input_size, self.bbox_scale)
        ids = torch.arange(B, device=frames.device).repeat_interleave(K)
        out = self.pose.predict(frames, crop_boxes, ids)
        out = {k: v.reshape((B, K) + v.shape[1:]) for k, v in out.items()}
        out["boxes"] = crop_boxes.reshape(B, K, 4)
        out["det_scores"] = det_scores[:, :K]
        return out

    def dispatch(self, frames: np.ndarray) -> dict[str, torch.Tensor]:
        """Upload frames (B, Hf, Wf, 3) uint8 once and launch both stages;
        the outputs stay on the device, still being computed."""
        dev = self.pose.device
        return self.predict(torch.as_tensor(np.ascontiguousarray(frames, np.uint8)).to(dev))

    def __call__(self, frames: np.ndarray) -> dict[str, np.ndarray]:
        """Blocking batched form of `dispatch` (numpy outputs)."""
        return {k: v.float().cpu().numpy() for k, v in self.dispatch(frames).items()}

    def predict_frame(self, frame: np.ndarray,
                      score_threshold: float | None = None) -> dict[str, np.ndarray]:
        """One frame -> predict_frame(boxes=None)'s contract: keypoints (n,
        K, 2), scores, probabilities, visibilities, oks, errors, boxes (n,
        4) and det_scores (n,) for the n detections above the threshold."""
        thr = self.score_threshold if score_threshold is None else score_threshold
        out = self(np.asarray(frame, np.uint8)[None])
        keep = out["det_scores"][0] >= thr
        return {k: v[0][keep] for k, v in out.items()}
