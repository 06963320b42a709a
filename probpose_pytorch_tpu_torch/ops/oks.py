"""Object Keypoint Similarity, batched (port of
probpose_pytorch_tpu/ops/oks.py). Plain tensor code."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["per_keypoint_oks", "oks_targets_from_coords"]

_EPS = float(np.spacing(1))


def per_keypoint_oks(gt_kpts: torch.Tensor, dt_kpts: torch.Tensor,
                     gt_vis: torch.Tensor, sigmas, area: float) -> torch.Tensor:
    """exp(-d^2 / (2 sigma)^2 / (0.53 area + eps) / 2) per keypoint, zero
    where gt is invisible. gt/dt (..., K, 2), gt_vis (..., K), sigmas (K,)."""
    sig = torch.as_tensor(sigmas, dtype=torch.float32, device=gt_kpts.device)
    var = (2.0 * sig) ** 2
    dx = dt_kpts[..., 0] - gt_kpts[..., 0]
    dy = dt_kpts[..., 1] - gt_kpts[..., 1]
    e = (dx**2 + dy**2) / var / (area * 0.53 + _EPS) / 2.0
    return torch.where(gt_vis > 0, torch.exp(-e), 0.0).float()


def oks_targets_from_coords(gt_coords: torch.Tensor, dt_coords: torch.Tensor,
                            weight: torch.Tensor, sigmas,
                            heatmap_size: tuple[int, int]):
    """OKS targets (B, K) and per-sample weights (B,) from decoded
    coordinates: coordinates zeroed by the 0/1 weight, visibility 2 * weight,
    samples without a valid keypoint all zero. The area stays in heatmap
    space while the coordinates are in input space, a reference quirk."""
    W, H = heatmap_size
    w = weight.float()
    vis = w * 2.0
    oks = per_keypoint_oks(gt_coords * w[..., None], dt_coords * w[..., None],
                           vis, sigmas, float(W * H))
    any_valid = (vis > 0).any(dim=-1)
    return torch.where(any_valid[:, None], oks, 0.0), any_valid.float()
