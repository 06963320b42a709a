"""SimCC codec: 1-D bin labels and coordinate decoding, batched (port of
probpose_pytorch_tpu/codec_simcc.py).

Keypoints encode into two normalised 1-D Gaussians over sub-pixel bins,
`split_ratio` bins per input pixel, one per axis; decode is a softmax, the
argmax (the first maximum, as `jnp.argmax`) and a 3-tap parabola on the
probabilities. `SimCCCodec` has `codec.Codec`'s surface, so the predictor,
the eval pipeline and the front ends take a SimCC model unchanged: its
`decode` takes the head's 5-tuple ((x_logits, y_logits), probability,
visibility, oks, error) and returns ((keypoints, scores), probabilities,
visibilities, oks, errors) in the ProbMap facade's shapes, errors divided
by the bin grid's diagonal. Plain tensor code: JAX runs no kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = ["SimCCLabel", "SimCCCodec"]


def _axis_labels(coords_bins: torch.Tensor, n_bins: int, sigma: float) -> torch.Tensor:
    """(B, K) bin-space coordinates -> (B, K, n_bins) Gaussians that sum to 1
    over the bins (all zero where every bin underflows)."""
    bins = torch.arange(n_bins, dtype=torch.float32, device=coords_bins.device)
    g = torch.exp(-((bins[None, None, :] - coords_bins[..., None]) ** 2) / (2.0 * sigma**2))
    return g / g.sum(dim=-1, keepdim=True).clamp_min(1e-12)


def _axis_decode(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K, N) logits -> (coordinates in bins (B, K), peak probability
    (B, K)): softmax, the first argmax, then the parabola through the
    maximum and its two neighbours where |denominator| > 1e-12, clipped to
    +-0.5 bin and zero at the two end bins."""
    probs = torch.softmax(logits.float(), dim=-1)
    idx = probs.argmax(dim=-1)
    N = probs.shape[-1]
    at = lambda i: probs.gather(-1, i.clamp(0, N - 1)[..., None])[..., 0]
    center, left, right = at(idx), at(idx - 1), at(idx + 1)
    denom = left - 2.0 * center + right
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (left - right) / denom, 0.0)
    delta = delta.clamp(-0.5, 0.5)
    delta = torch.where((idx > 0) & (idx < N - 1), delta, 0.0)
    return idx.float() + delta, center


@dataclass(frozen=True)
class SimCCLabel:
    """Per-axis bin label codec.

    input_size: (in_w, in_h) crop extent in pixels (the ProbMap codec's
    convention); split_ratio: bins per pixel; sigma: the Gaussian's spread
    in bins; sigmas: per-keypoint OKS sigmas (the loss's targets)."""

    input_size: tuple[int, int]
    split_ratio: float = 2.0
    sigma: float = 6.0
    sigmas: tuple[float, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "sigmas", tuple(float(s) for s in np.asarray(self.sigmas).ravel()))
        object.__setattr__(self, "_sigmas_by_device", {})

    @property
    def bins(self) -> tuple[int, int]:
        """(Wb, Hb)."""
        in_w, in_h = self.input_size
        return int(in_w * self.split_ratio), int(in_h * self.split_ratio)

    @property
    def sigmas_array(self) -> np.ndarray:
        return np.asarray(self.sigmas, np.float32)

    def sigmas_on(self, device: torch.device) -> torch.Tensor:
        """The (K,) keypoint sigmas as a float32 tensor on `device`, copied
        there once (a blocking copy would wait for the stream every step)."""
        device = torch.device(device)
        if device not in self._sigmas_by_device:
            self._sigmas_by_device[device] = torch.as_tensor(self.sigmas_array, device=device)
        return self._sigmas_by_device[device]

    def encode(self, keypoints, keypoints_visible=None, keypoints_visibility=None,
               id_similarity: float = 0.0) -> dict[str, Any]:
        """Poses (B, K, 2) -- or (K, 2) -- in input space -> x_labels (B, K,
        Wb), y_labels (B, K, Hb), keypoint_weights (labelled and inside the
        crop), annotated, in_image, keypoints_scaled, keypoints_visibility
        and identification_similarity, on the device of `keypoints` when it
        is a tensor."""
        device = keypoints.device if isinstance(keypoints, torch.Tensor) else None
        kpts = torch.as_tensor(keypoints, dtype=torch.float32, device=device)
        if kpts.dim() == 2:
            kpts = kpts[None]
        B, K, _ = kpts.shape
        if keypoints_visible is None:
            keypoints_visible = torch.ones((B, K), device=kpts.device)
        if keypoints_visibility is None:
            keypoints_visibility = torch.zeros((B, K), device=kpts.device)
        vis = torch.as_tensor(keypoints_visible, dtype=torch.float32,
                              device=kpts.device).reshape(B, K)
        Wb, Hb = self.bins
        x_labels = _axis_labels(kpts[..., 0] * self.split_ratio, Wb, self.sigma)
        y_labels = _axis_labels(kpts[..., 1] * self.split_ratio, Hb, self.sigma)
        in_w, in_h = self.input_size
        x, y = kpts[..., 0], kpts[..., 1]
        in_image = (x >= 0) & (x < in_w) & (y >= 0) & (y < in_h)
        return dict(
            x_labels=x_labels,
            y_labels=y_labels,
            # Off-grid keypoints weigh nothing (ProbMap's weight semantics).
            keypoint_weights=vis * in_image.float(),
            annotated=vis > 0,
            in_image=in_image,
            keypoints_scaled=kpts,
            keypoints_visibility=torch.as_tensor(
                keypoints_visibility, dtype=torch.float32, device=kpts.device).reshape(B, K),
            identification_similarity=id_similarity,
        )

    def decode_axis_pair(self, x_logits: torch.Tensor,
                         y_logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Logits -> (keypoints (B, K, 2) in input pixels, scores (B, K))."""
        cx, sx = _axis_decode(x_logits)
        cy, sy = _axis_decode(y_logits)
        return torch.stack([cx, cy], dim=-1) / self.split_ratio, 0.5 * (sx + sy)


@dataclass(frozen=True)
class SimCCCodec:
    """`codec.Codec`'s surface for the SimCC family."""

    label: SimCCLabel

    def encode(self, keypoints, keypoints_visible=None, keypoints_visibility=None,
               id_similarity: float = 0.0) -> dict[str, Any]:
        return self.label.encode(keypoints, keypoints_visible,
                                 keypoints_visibility=keypoints_visibility,
                                 id_similarity=id_similarity)

    def decode(self, pred: tuple[Any, ...]):
        """The head's 5-tuple -> Codec.decode's return: scalars as (B, 1, K),
        errors divided by the bin grid's diagonal sqrt(Wb^2 + Hb^2)."""
        (x_logits, y_logits), probabilities, visibilities, oks, errors = pred
        B, C = x_logits.shape[:2]
        preds = self.label.decode_axis_pair(x_logits, y_logits)
        Wb, Hb = self.label.bins
        return (
            preds,
            probabilities.reshape(B, 1, C),
            visibilities.reshape(B, 1, C),
            oks.reshape(B, 1, C),
            errors.reshape(B, 1, C) / float(np.sqrt(Wb**2 + Hb**2)),
        )
