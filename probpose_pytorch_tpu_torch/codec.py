"""Keypoint decoding (port of the decode half of probpose_pytorch_tpu/codec.py).

Decode quirks of the reference are kept for output parity: keypoints are
rescaled by input_size / (heatmap_size - 1), scores are the raw heatmap
value at the integer argmax, scalars come out as (B, 1, K), and errors are
divided by the heatmap diagonal sqrt(H^2 + W^2). Encoding is training work
and is not ported yet (ROADMAP item 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from probpose_pytorch_tpu_torch.ops.heatmap import (
    build_oks_conv_operators,
    expected_value_decode,
)

__all__ = ["ProbMap", "Codec"]


@dataclass(frozen=True)
class ProbMap:
    """Expected-value codec: OKS-kernel convolution + argmax + sub-pixel
    Taylor refinement. Sizes are (W, H), as in the JAX codec."""

    input_size: tuple[int, int]
    heatmap_size: tuple[int, int]
    sigmas: tuple[float, ...]
    sigma: float = 2.0  # the encode's fixed sigma; decode does not read it

    def __post_init__(self):
        object.__setattr__(
            self, "sigmas", tuple(float(s) for s in np.asarray(self.sigmas).ravel())
        )
        object.__setattr__(self, "_ops_by_device", {})

    def conv_operators(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(row_op, col_op) float32 tensors on `device`, built once each."""
        device = torch.device(device)
        ops = self._ops_by_device.get(device)
        if ops is None:
            W, H = self.heatmap_size
            host = build_oks_conv_operators(np.asarray(self.sigmas, np.float32), H, W)
            ops = (torch.from_numpy(host.row_op).to(device),
                   torch.from_numpy(host.col_op).to(device))
            self._ops_by_device[device] = ops
        return ops

    def _rescale_to_input(self, kpts: torch.Tensor) -> torch.Tensor:
        W, H = self.heatmap_size
        scale = torch.tensor(self.input_size, dtype=torch.float32, device=kpts.device)
        return kpts * (scale / torch.tensor([W - 1, H - 1], dtype=torch.float32,
                                            device=kpts.device))

    def decode(self, heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, K, H, W) or (K, H, W) heatmaps -> input-space keypoints
        (B, K, 2) and scores (B, K)."""
        hm = heatmaps.float()
        if hm.dim() == 3:
            hm = hm[None]
        row_op, col_op = self.conv_operators(hm.device)
        locs, vals = expected_value_decode(hm, row_op, col_op)
        return self._rescale_to_input(locs), vals


@dataclass(frozen=True)
class Codec:
    """Decodes the head's 5-tuple (heatmaps, probabilities, visibilities,
    oks, errors)."""

    probmap: ProbMap

    def decode(self, pred: tuple[torch.Tensor, ...]):
        heatmaps, probabilities, visibilities, oks, errors = pred
        B, C, H, W = heatmaps.shape
        preds = self.probmap.decode(heatmaps)
        return (
            preds,
            probabilities.reshape(B, 1, C),
            visibilities.reshape(B, 1, C),
            oks.reshape(B, 1, C),
            errors.reshape(B, 1, C) / float(np.sqrt(H**2 + W**2)),
        )
