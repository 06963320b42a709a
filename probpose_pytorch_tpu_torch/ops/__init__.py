"""Tensor ops of the port: preprocessing, sparsemax, heatmap decode, OKS
targets, int8 products, and the hand-written kernels under `kernels/`."""

from probpose_pytorch_tpu_torch.ops.heatmap import (
    build_oks_conv_operators,
    calc_distances,
    distance_acc,
    expected_value_decode,
    heatmap_maximum,
    oks_conv,
    subpixel_refine,
)
from probpose_pytorch_tpu_torch.ops.oks import oks_targets_from_coords, per_keypoint_oks
from probpose_pytorch_tpu_torch.ops.probmaps import generate_probmaps, oks_spread
from probpose_pytorch_tpu_torch.ops.quant import (
    dynamic_quantize_rows,
    int8_matmul,
    quantize_weight,
    weight_only_matmul,
)
from probpose_pytorch_tpu_torch.ops.sparsemax import sparsemax
from probpose_pytorch_tpu_torch.ops.udp import (
    build_gaussian_blur_operators,
    gaussian_blur_modulate,
    refine_keypoints_dark_udp,
)

__all__ = [
    "build_gaussian_blur_operators",
    "build_oks_conv_operators",
    "calc_distances",
    "distance_acc",
    "dynamic_quantize_rows",
    "expected_value_decode",
    "gaussian_blur_modulate",
    "generate_probmaps",
    "heatmap_maximum",
    "int8_matmul",
    "oks_conv",
    "oks_spread",
    "per_keypoint_oks",
    "quantize_weight",
    "refine_keypoints_dark_udp",
    "sparsemax",
    "subpixel_refine",
    "weight_only_matmul",
]
