"""OKS probability-map target encoding (port of
probpose_pytorch_tpu/ops/probmaps.py).

The whole batch is one broadcast expression, (B, K, H, W) at once, on the
device the keypoints live on. Plain tensor code: the JAX encode is XLA, not
a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["oks_spread", "generate_probmaps"]


def oks_spread(kpt_sigmas, heatmap_size: tuple[int, int], sigma: float | None,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-keypoint spread s = clip((2 sigma_k)^2 * bbox_area * 2, 0.55, 3)
    with bbox_area = sqrt(H/1.25 * W/1.25); a positive fixed `sigma`
    overrides it. Returns (K,) float32 on `device` (pass the sigmas as a
    tensor already there to keep the step free of host copies)."""
    W, H = heatmap_size
    bbox_area = np.sqrt(H / 1.25 * W / 1.25)
    s = (torch.as_tensor(kpt_sigmas, dtype=torch.float32, device=device) * 2.0) ** 2
    s = torch.clamp(s * float(bbox_area) * 2.0, 0.55, 3.0)
    if sigma is not None and sigma > 0:
        s = torch.full_like(s, sigma)
    return s


def generate_probmaps(
    heatmap_size: tuple[int, int],
    keypoints: torch.Tensor,
    keypoints_visible: torch.Tensor,
    kpt_sigmas,
    sigma: float = 0.55,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expected-OKS target maps of single-instance poses.

    keypoints (B, K, 2) in heatmap space, keypoints_visible (B, K) (>= 0.5
    means labeled), heatmap_size (W, H). Returns heatmaps (B, K, H, W) f32,
    zero for unlabeled keypoints, and keypoint_weights (B, K): the
    visibility, replaced by 1/0 {map has a nonzero pixel} where labeled."""
    W, H = heatmap_size
    kpts = keypoints.float()
    vis = keypoints_visible.float()
    s = oks_spread(kpt_sigmas, heatmap_size, sigma, kpts.device)
    xs = torch.arange(W, dtype=torch.float32, device=kpts.device)
    ys = torch.arange(H, dtype=torch.float32, device=kpts.device)
    dx = xs[None, None, None, :] - kpts[:, :, 0, None, None]  # (B, K, 1, W)
    dy = ys[None, None, :, None] - kpts[:, :, 1, None, None]  # (B, K, H, 1)
    maps = torch.exp(-(dx**2 + dy**2) / (2.0 * s[None, :, None, None]))
    labeled = vis >= 0.5
    maps = torch.where(labeled[:, :, None, None], maps, 0.0)
    nonzero = maps.amax(dim=(2, 3)) > 0
    weights = torch.where(labeled, nonzero.float(), vis)
    return maps, weights
