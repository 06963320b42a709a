"""DarkPose/UDP sub-pixel refinement, batched (port of
probpose_pytorch_tpu/ops/udp.py).

The modulation blur is a separable Gaussian with zero boundary, applied as
two batched products against (H, H) and (W, W) band operators built once
in numpy per geometry; the 2x2 Hessian pseudo-inverse is the closed-form
symmetric eigen-decomposition of the JAX version. Plain tensor code: the
JAX refinement is XLA, not a kernel. On the card the float32 products need
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default), as the
JAX decode runs them at HIGHEST precision.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "GaussianBlurOperators",
    "build_gaussian_blur_operators",
    "gaussian_blur_modulate",
    "refine_keypoints_dark_udp",
]


class GaussianBlurOperators(NamedTuple):
    row_op: np.ndarray  # (H, H)
    col_op: np.ndarray  # (W, W)


def _cv2_gaussian_kernel(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, 0): sigma = 0.3 ((ksize - 1) / 2 - 1)
    + 0.8, normalised to sum 1."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    g = np.exp(-(t**2) / (2.0 * sigma**2))
    return g / g.sum()


def _zeropad_conv1d_operator(g: np.ndarray, n: int) -> np.ndarray:
    """(n, n) operator of centred 1-D correlation with zero boundary."""
    r = len(g) // 2
    M = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for t in range(-r, r + 1):
            if 0 <= i + t < n:
                M[i, i + t] += g[t + r]
    return M


@functools.lru_cache(maxsize=32)
def _build_blur_cached(ksize: int, H: int, W: int) -> GaussianBlurOperators:
    g = _cv2_gaussian_kernel(ksize)
    return GaussianBlurOperators(
        row_op=_zeropad_conv1d_operator(g, H).astype(np.float32),
        col_op=_zeropad_conv1d_operator(g, W).astype(np.float32),
    )


def build_gaussian_blur_operators(blur_kernel_size: int, H: int, W: int) -> GaussianBlurOperators:
    if blur_kernel_size % 2 != 1:
        raise ValueError(f"blur kernel size {blur_kernel_size} must be odd")
    return _build_blur_cached(int(blur_kernel_size), int(H), int(W))


def gaussian_blur_modulate(heatmaps: torch.Tensor, row_op: torch.Tensor,
                           col_op: torch.Tensor) -> torch.Tensor:
    """Blur each (..., H, W) map, then rescale it to its original max:
    blurred * origin_max / (new_max + 1e-12)."""
    origin_max = heatmaps.amax(dim=(-2, -1), keepdim=True)
    y = torch.einsum("wv,...hv->...hw", col_op, heatmaps)
    blurred = torch.einsum("hg,...gw->...hw", row_op, y)
    new_max = blurred.amax(dim=(-2, -1), keepdim=True)
    return blurred * (origin_max / (new_max + 1e-12))


def _sym2x2_pinv(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Closed-form pseudo-inverse of symmetric [[a, b], [b, c]] with
    np.linalg.pinv's relative cutoff (1e-15 of the largest |eigenvalue|).
    Returns its three unique entries."""
    mean = (a + c) / 2.0
    rad = torch.sqrt(torch.clamp_min(((a - c) / 2.0) ** 2 + b**2, 0.0))
    l1 = mean + rad
    l2 = mean - rad
    cutoff = 1e-15 * torch.maximum(l1.abs(), l2.abs())

    def inv_eig(lam):
        keep = lam.abs() > cutoff
        return torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)

    il1, il2 = inv_eig(l1), inv_eig(l2)
    # Eigenvector of l1: (b, l1 - a), or an axis where the matrix is diagonal.
    has_b = b.abs() > 0
    a_ge_c = a >= c
    vx = torch.where(has_b, b, a_ge_c.to(a.dtype))
    vy = torch.where(has_b, l1 - a, (~a_ge_c).to(a.dtype))
    norm = torch.sqrt(vx**2 + vy**2)
    norm = torch.where(norm > 0, norm, 1.0)
    vx, vy = vx / norm, vy / norm
    pa = il1 * vx * vx + il2 * vy * vy
    pb = il1 * vx * vy - il2 * vx * vy
    pc = il1 * vy * vy + il2 * vx * vx
    return pa, pb, pc


def refine_keypoints_dark_udp(
    keypoints: torch.Tensor,
    heatmaps: torch.Tensor,
    row_op: torch.Tensor,
    col_op: torch.Tensor,
    max_step: float | None = None,
) -> torch.Tensor:
    """Gaussian modulation -> clip(1e-3, 50) -> log -> edge-pad by 1 ->
    first and second central differences at the integer peak -> Newton
    step with the Hessian pseudo-inverse. keypoints (B, K, 2) from
    `heatmap_maximum` (-1 entries read the padded corner, as in the
    reference), heatmaps (B, K, H, W). Returns (B, K, 2) float32."""
    B, K, H, W = heatmaps.shape
    hm = gaussian_blur_modulate(heatmaps, row_op, col_op)
    hm = torch.log(torch.clamp(hm, 1e-3, 50.0))
    hm = F.pad(hm, (1, 1, 1, 1), mode="replicate")
    Wp = W + 2
    flat = hm.reshape(B, K, (H + 2) * Wp)
    # Truncation toward zero, as the reference's .astype(int).
    x = keypoints[..., 0].long() + 1
    y = keypoints[..., 1].long() + 1
    base = x + y * Wp
    L = flat.shape[-1]

    def at(offset: int) -> torch.Tensor:
        # An empty map's -1 peak reads index -Wp - 1, which wraps to the
        # end of the map as jnp.take_along_axis's negative indices do.
        return torch.gather(flat, -1, torch.remainder(base + offset, L)[..., None])[..., 0]

    i_, ix1, iy1 = at(0), at(1), at(Wp)
    ix1y1, ix1_y1_ = at(Wp + 1), at(-Wp - 1)
    ix1_, iy1_ = at(-1), at(-Wp)
    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2.0 * i_ + ix1_
    dyy = iy1 - 2.0 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2.0 * i_ - ix1_ - iy1_ + ix1_y1_)
    eps = float(np.finfo(np.float32).eps)
    pa, pb, pc = _sym2x2_pinv(dxx + eps, dxy, dyy + eps)
    step = torch.stack([pa * dx + pb * dy, pb * dx + pc * dy], dim=-1)
    if max_step is not None:
        norm = torch.linalg.norm(step, dim=-1, keepdim=True)
        step = step * torch.clamp_max(max_step / torch.clamp_min(norm, 1e-12), 1.0)
    return (keypoints - step).float()
