"""Expected-value heatmap decode (port of probpose_pytorch_tpu/ops/heatmap.py).

The OKS-kernel convolution under reflect boundary is separable and linear,
so it is two batched products with precomputed (K, H, H) and (K, W, W) band
matrices. The matrices are built on the host in numpy (copied from the JAX
package, which this package must not import). The JAX decode runs its
products at HIGHEST precision; on the card the port needs
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default) for the
same float32 products.

Plain tensor code: on the JAX main path the decode is XLA, not a kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "OKSConvOperators",
    "build_oks_conv_operators",
    "oks_conv",
    "heatmap_maximum",
    "subpixel_refine",
    "expected_value_decode",
    "decode_convolved",
    "calc_distances",
    "distance_acc",
]


def heatmap_maximum(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major flat argmax (first occurrence wins ties) of (..., H, W)
    maps. Returns (..., 2) float (x, y) locations, -1 where the peak value is
    <= 0, and the (...,) peak values."""
    *lead, H, W = heatmaps.shape
    flat = heatmaps.reshape(*lead, H * W)
    vals = flat.amax(dim=-1)
    idx = flat.argmax(dim=-1)  # documented first-occurrence on ties
    locs = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    locs = torch.where((vals <= 0.0)[..., None], -1.0, locs)
    return locs, vals


def subpixel_refine(heatmaps: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """One Newton step per axis from central differences at integer peaks
    strictly inside the border (JAX `subpixel_refine`)."""
    *lead, H, W = heatmaps.shape
    x = locs[..., 0].long()
    y = locs[..., 1].long()
    valid = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
    xc = x.clamp(1, W - 2)
    yc = y.clamp(1, H - 2)
    flat = heatmaps.reshape(*lead, H * W)

    def at(dy: int, dx: int) -> torch.Tensor:
        idx = ((yc + dy) * W + (xc + dx))[..., None]
        return torch.gather(flat, -1, idx)[..., 0]

    c = at(0, 0)
    dx1 = (at(0, 1) - at(0, -1)) / 2.0
    dy1 = (at(1, 0) - at(-1, 0)) / 2.0
    dxx = at(0, 1) + at(0, -1) - 2.0 * c
    dyy = at(1, 0) + at(-1, 0) - 2.0 * c
    dxx = torch.where(dxx != 0, dxx, 1e-6)
    dyy = torch.where(dyy != 0, dyy, 1e-6)
    shift = torch.stack([-dx1 / dxx, -dy1 / dyy], dim=-1)
    return torch.where(valid[..., None], locs + shift, locs).float()


class OKSConvOperators(NamedTuple):
    """Per-keypoint reflect-boundary band matrices: row_op (K, H, H) acts
    along H, col_op (K, W, W) along W; `row_op @ img @ col_op.T` equals
    scipy.ndimage.convolve(img, oks_kernel, mode='reflect')."""

    row_op: np.ndarray
    col_op: np.ndarray


def _oks_sigma_to_s(kpt_sigmas: np.ndarray, H: int, W: int) -> np.ndarray:
    bbox_area = np.sqrt(H / 1.25 * W / 1.25)
    s = (np.asarray(kpt_sigmas, dtype=np.float64) * 2.0) ** 2 * bbox_area * 2.0
    return np.clip(s, 0.55, 3.0)


def _reflect_conv1d_operator(g: np.ndarray, n: int) -> np.ndarray:
    d = len(g)
    r = d // 2
    if d % 2 != 1 or r > n:
        raise ValueError(f"kernel of length {d} does not fit a reflect operator of size {n}")
    M = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for t in range(-r, r + 1):
            m = i + t
            if m < 0:
                m = -m - 1
            elif m >= n:
                m = 2 * n - 1 - m
            M[i, m] += g[t + r]
    return M


@functools.lru_cache(maxsize=32)
def _build_operators_cached(sigmas_key: tuple[float, ...], H: int, W: int) -> OKSConvOperators:
    svals = _oks_sigma_to_s(np.asarray(sigmas_key, dtype=np.float64), H, W)
    row_ops, col_ops = [], []
    for s in svals:
        radius = int(np.ceil(s * 3))
        t = np.arange(-radius, radius + 1, dtype=np.float64)
        g = np.exp(-(t**2) / (2.0 * s))
        g = g / g.sum()
        row_ops.append(_reflect_conv1d_operator(g, H))
        col_ops.append(_reflect_conv1d_operator(g, W))
    return OKSConvOperators(
        row_op=np.stack(row_ops).astype(np.float32),
        col_op=np.stack(col_ops).astype(np.float32),
    )


def build_oks_conv_operators(kpt_sigmas: np.ndarray, H: int, W: int) -> OKSConvOperators:
    """Separable reflect-conv operators for (sigmas, H, W), cached."""
    key = tuple(float(s) for s in np.asarray(kpt_sigmas).reshape(-1))
    return _build_operators_cached(key, int(H), int(W))


def oks_conv(heatmaps: torch.Tensor, row_op: torch.Tensor, col_op: torch.Tensor) -> torch.Tensor:
    """Convolve (B, K, H, W) maps with their per-keypoint OKS kernels."""
    y = torch.einsum("kwv,bkhv->bkhw", col_op, heatmaps)
    return torch.einsum("khg,bkgw->bkhw", row_op, y)


def expected_value_decode(
    heatmaps: torch.Tensor, row_op: torch.Tensor, col_op: torch.Tensor,
    return_heatmap: bool = False,
):
    """OKS convolution -> first-occurrence argmax -> sub-pixel Taylor step on
    the convolved map -> raw (unconvolved) value at the integer argmax.
    heatmaps (B, K, H, W) float32 -> locs (B, K, 2), vals (B, K)."""
    conv = oks_conv(heatmaps, row_op, col_op)
    locs, vals = decode_convolved(heatmaps, conv)
    if return_heatmap:
        return locs, vals, conv
    return locs, vals


def decode_convolved(heatmaps: torch.Tensor,
                     conv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode after the convolution: first-occurrence argmax of conv,
    sub-pixel Taylor step on conv, raw heatmap value at the integer argmax."""
    B, K, H, W = heatmaps.shape
    idx = conv.reshape(B, K, H * W).argmax(dim=-1)
    x = (idx % W).float()
    y = (idx // W).float()
    locs = subpixel_refine(conv, torch.stack([x, y], dim=-1))
    xi = torch.round(x).long().clamp(0, W - 1)
    yi = torch.round(y).long().clamp(0, H - 1)
    vals = torch.gather(heatmaps.reshape(B, K, H * W), -1, (yi * W + xi)[..., None])[..., 0]
    return locs, vals


def calc_distances(preds: torch.Tensor, gts: torch.Tensor, mask: torch.Tensor,
                   norm_factor: torch.Tensor) -> torch.Tensor:
    """Normalised distances (K, N) between (N, K, D) predictions and
    targets, -1 where masked; instances with a zero norm factor are masked
    and non-positive factors become 1e6 (the reference's quirks)."""
    mask = mask & ~(norm_factor == 0).any(dim=1)[:, None]
    norm = torch.where(norm_factor <= 0, 1e6, norm_factor)
    d = torch.linalg.norm((preds - gts) / norm[:, None, :], dim=-1)
    return torch.where(mask, d, -1.0).T.float()


def distance_acc(distances: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Fraction of valid (!= -1) distances below `thr` along the last axis;
    -1 where none is valid."""
    valid = distances != -1
    n = valid.sum(dim=-1)
    acc = ((distances < thr) & valid).sum(dim=-1) / n.clamp_min(1)
    return torch.where(n > 0, acc, -1.0)
