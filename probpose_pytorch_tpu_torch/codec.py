"""Keypoint codecs: target encoding and prediction decoding (port of
probpose_pytorch_tpu/codec.py).

Quirks of the reference are kept for output parity: encode scales input
coordinates by (input - 1) / (heatmap - 1) while decode rescales by
input_size / (heatmap_size - 1); scores are the raw heatmap value at the
integer argmax; scalars come out as (B, 1, K); errors are divided by the
heatmap diagonal sqrt(H^2 + W^2). Sizes are (W, H), as in the JAX codec.
Band operators and constants are built once per geometry in numpy and
copied once per device: a blocking host-to-device copy waits for the
stream, and the train step encodes and decodes every step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from probpose_pytorch_tpu_torch.ops.heatmap import (
    build_oks_conv_operators,
    expected_value_decode,
    heatmap_maximum,
)
from probpose_pytorch_tpu_torch.ops.probmaps import generate_probmaps
from probpose_pytorch_tpu_torch.ops.udp import (
    build_gaussian_blur_operators,
    refine_keypoints_dark_udp,
)

__all__ = ["ProbMap", "ArgMaxProbMap", "Codec"]


def _as_batched(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return t[None] if t.dim() == 2 else t


@dataclass(frozen=True)
class _ProbMapBase:
    """Encode shared by both codecs (the reference's two encodes are the
    same)."""

    input_size: tuple[int, int]
    heatmap_size: tuple[int, int]
    sigmas: tuple[float, ...]
    sigma: float
    blur_kernel_size: int = 11

    def __post_init__(self):
        object.__setattr__(
            self, "sigmas", tuple(float(s) for s in np.asarray(self.sigmas).ravel())
        )
        object.__setattr__(self, "_ops_by_device", {})

    @property
    def scale_factor(self) -> np.ndarray:
        """(input - 1) / (heatmap - 1), float32."""
        return ((np.array(self.input_size, np.float64) - 1)
                / (np.array(self.heatmap_size, np.float64) - 1)).astype(np.float32)

    @property
    def sigmas_array(self) -> np.ndarray:
        return np.asarray(self.sigmas, np.float32)

    def _on(self, device: torch.device, key: str, build) -> Any:
        """build() -- numpy arrays, or a tuple of them -- as float32
        tensors on `device`, built and copied once per (device, key)."""
        device = torch.device(device)
        value = self._ops_by_device.get((device, key))
        if value is None:
            host = build()
            to = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
            value = tuple(map(to, host)) if isinstance(host, tuple) else to(host)
            self._ops_by_device[(device, key)] = value
        return value

    def sigmas_on(self, device: torch.device) -> torch.Tensor:
        """The (K,) keypoint sigmas as a float32 tensor on `device`."""
        return self._on(device, "sigmas", lambda: self.sigmas_array)

    def encode(self, keypoints, keypoints_visible=None, keypoints_visibility=None,
               id_similarity: float = 0.0) -> dict[str, Any]:
        """Single-instance poses (B, K, 2) -- or (K, 2) -- in input space
        -> dict of heatmaps (B, K, H, W), keypoint_weights (B, K), annotated
        and in_image (B, K) bool, keypoints_scaled, heatmap_keypoints,
        keypoints_visibility and identification_similarity, on the device of
        `keypoints` when it is a tensor."""
        device = keypoints.device if isinstance(keypoints, torch.Tensor) else None
        kpts = _as_batched(keypoints, device)
        B, K, _ = kpts.shape
        if keypoints_visible is None:
            keypoints_visible = torch.ones((B, K), device=kpts.device)
        if keypoints_visibility is None:
            keypoints_visibility = torch.zeros((B, K), device=kpts.device)
        vis = torch.as_tensor(keypoints_visible, dtype=torch.float32,
                              device=kpts.device).reshape(B, K)
        hm_kpts = kpts / self._on(kpts.device, "scale", lambda: self.scale_factor)
        heatmaps, weights = generate_probmaps(
            self.heatmap_size, hm_kpts, vis, self.sigmas_on(kpts.device), self.sigma)
        in_w, in_h = self.input_size
        x, y = kpts[..., 0], kpts[..., 1]
        in_image = (x >= 0) & (x < in_w) & (y >= 0) & (y < in_h)
        return dict(
            heatmaps=heatmaps,
            keypoint_weights=weights,
            annotated=vis > 0,
            in_image=in_image,
            keypoints_scaled=kpts,
            heatmap_keypoints=hm_kpts,
            keypoints_visibility=torch.as_tensor(
                keypoints_visibility, dtype=torch.float32, device=kpts.device
            ).reshape(B, K),
            identification_similarity=id_similarity,
        )

    def _rescale_to_input(self, kpts: torch.Tensor) -> torch.Tensor:
        W, H = self.heatmap_size
        return kpts * self._on(kpts.device, "rescale", lambda: (
            np.asarray(self.input_size, np.float32) / np.asarray([W - 1, H - 1], np.float32)))


@dataclass(frozen=True)
class ProbMap(_ProbMapBase):
    """Expected-value codec: encode with the fixed spread `sigma` (2.0);
    decode = OKS-kernel convolution + argmax + sub-pixel Taylor step."""

    sigma: float = 2.0

    def conv_operators(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(row_op (K, H, H), col_op (K, W, W)) float32 on `device`."""
        W, H = self.heatmap_size
        return self._on(device, "oks_conv",
                        lambda: tuple(build_oks_conv_operators(self.sigmas_array, H, W)))

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
class ArgMaxProbMap(_ProbMapBase):
    """Argmax + DarkPose/UDP codec: `sigma=-1` keeps each keypoint's own
    spread in encode; `udp_max_step` optionally bounds the Newton step."""

    sigma: float = -1.0
    udp_max_step: float | None = None

    def blur_operators(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(row_op (H, H), col_op (W, W)) float32 on `device`."""
        W, H = self.heatmap_size
        return self._on(device, "blur",
                        lambda: tuple(build_gaussian_blur_operators(self.blur_kernel_size, H, W)))

    def decode(self, heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Argmax peak + UDP refinement, rescaled to input space."""
        hm = heatmaps.float()
        if hm.dim() == 3:
            hm = hm[None]
        locs, vals = heatmap_maximum(hm)
        row_op, col_op = self.blur_operators(hm.device)
        refined = refine_keypoints_dark_udp(locs, hm, row_op, col_op,
                                            max_step=self.udp_max_step)
        return self._rescale_to_input(refined), vals


@dataclass(frozen=True)
class Codec:
    """A probmap codec plus decoding of the head's 5-tuple (heatmaps,
    probabilities, visibilities, oks, errors)."""

    probmap: _ProbMapBase

    def encode(self, keypoints, keypoints_visible=None, keypoints_visibility=None,
               id_similarity: float = 0.0) -> dict[str, Any]:
        return self.probmap.encode(keypoints, keypoints_visible,
                                   keypoints_visibility=keypoints_visibility,
                                   id_similarity=id_similarity)

    def decode_heatmap(self, heatmaps: torch.Tensor):
        return self.probmap.decode(heatmaps)

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
