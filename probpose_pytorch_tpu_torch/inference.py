"""Batched top-down predictor (port of the serving path of
probpose_pytorch_tpu/inference.py:TopDownPredictor).

frames + person boxes -> crop_resize ("bilinear_matmul") -> ProbPoseModel
(ViT trunk with kernel K1, ProbMap head with kernel K2) -> Codec.decode ->
keypoints mapped back to frame space. Returns the JAX predictor's dict of
numpy arrays: keypoints (B, K, 2), scores (B, K), and probabilities,
visibilities, oks, errors (B, 1, K), plus heatmaps (B, K, H, W) with
`return_heatmaps`.

Not ported yet (ROADMAP item 8): flip-test and scale-test TTA, calibration,
quantisation, mesh serving, `predict_stream`, and `predict_frame` with
its buckets.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from probpose_pytorch_tpu_torch.codec import Codec
from probpose_pytorch_tpu_torch.models.model import ProbPoseModel
from probpose_pytorch_tpu_torch.ops.preprocess import (
    crop_resize,
    untransform_keypoints,
)

__all__ = ["TopDownPredictor"]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP item 8)"
    )


@dataclasses.dataclass
class TopDownPredictor:
    model: ProbPoseModel
    codec: Codec
    input_size: tuple[int, int]  # (H, W)
    preprocess_method: str = "bilinear_matmul"
    return_heatmaps: bool = False
    flip_test: bool = False
    scale_test: tuple[float, ...] = ()
    calibration: dict | None = None
    quantize: str | None = None
    mesh: Any = None

    def __post_init__(self):
        for name, value in (
            ("flip_test", self.flip_test), ("scale_test", self.scale_test),
            ("calibration", self.calibration), ("quantize", self.quantize),
            ("mesh", self.mesh),
        ):
            if value:
                raise _unported(f"TopDownPredictor({name}=...)")
        self.model.eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def predict(self, frames: torch.Tensor, boxes: torch.Tensor,
                frame_ids: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """The serving path on tensors already on the model's device; the
        outputs stay there (no host copy, no synchronisation)."""
        if frame_ids is not None:
            # indexed serving: frames holds each unique frame once.
            frames = frames.index_select(0, frame_ids)
        crops = crop_resize(frames, boxes, self.input_size, self.preprocess_method)
        pred = self.model(crops)
        (kpts, scores), probs, vis, oks, errs = self.codec.decode(pred)
        out = dict(
            keypoints=untransform_keypoints(kpts, boxes, self.input_size),
            scores=scores,
            probabilities=probs,
            visibilities=vis,
            oks=oks,
            errors=errs,
        )
        if self.return_heatmaps:
            out["heatmaps"] = pred[0]
        return out

    def __call__(self, frames: np.ndarray, boxes: np.ndarray,
                 frame_ids: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """frames (B, Hs, Ws, 3) uint8, boxes (B, 4) xywh -> dict of numpy
        arrays with frame-space keypoints. With frame_ids (B,), frames holds
        each unique frame once and crop i reads frames[frame_ids[i]]."""
        dev = self.device
        f = torch.as_tensor(np.asarray(frames)).to(dev)
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
        ids = None
        if frame_ids is not None:
            ids = torch.as_tensor(np.asarray(frame_ids, np.int64)).to(dev)
        out = self.predict(f, b, ids)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def predict_stream(self, batches, depth: int = 2):
        raise _unported("TopDownPredictor.predict_stream")
