"""Person detection (port of probpose_pytorch_tpu/detect): the detector
that makes the top-down pipeline standalone (frame -> boxes -> pose), the
single-stage (bottom-up) pose family on the same trunk, and the fused
two-stage predictor."""

from probpose_pytorch_tpu_torch.detect.codec import (
    decode_boxes,
    decode_poses,
    encode_boxes,
    gaussian_radius,
)
from probpose_pytorch_tpu_torch.detect.data import FrameDetectionDataset
from probpose_pytorch_tpu_torch.detect.fused import FusedTwoStagePredictor, expand_boxes_jax
from probpose_pytorch_tpu_torch.detect.loss import detection_loss
from probpose_pytorch_tpu_torch.detect.model import PersonDetector
from probpose_pytorch_tpu_torch.detect.pipeline import (
    BottomUpPredictor,
    DetectorPredictor,
    box_iou_matrix,
    detection_pr,
    evaluate_bottomup,
    evaluate_detector_topdown,
)
from probpose_pytorch_tpu_torch.detect.train import (
    DetectorTrainer,
    load_bottomup,
    load_detector,
)

__all__ = [
    "BottomUpPredictor",
    "DetectorPredictor",
    "DetectorTrainer",
    "FrameDetectionDataset",
    "FusedTwoStagePredictor",
    "PersonDetector",
    "box_iou_matrix",
    "decode_boxes",
    "decode_poses",
    "detection_loss",
    "detection_pr",
    "encode_boxes",
    "evaluate_bottomup",
    "evaluate_detector_topdown",
    "expand_boxes_jax",
    "gaussian_radius",
    "load_bottomup",
    "load_detector",
]
