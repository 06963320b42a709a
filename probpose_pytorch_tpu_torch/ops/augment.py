"""On-device augmentation for top-down training (port of
probpose_pytorch_tpu/ops/augment.py).

The JAX transforms draw with `jax.random` inside the step, which torch
cannot replay. Here each transform is split into a draw and a pure function
of the drawn values: `draw_augment` draws every value a step needs with
explicit `torch.Generator`s on the step's device, and the transforms below
compute what their JAX counterparts compute from the same values, in the
same order of operations. Tests hand the transforms the values `jax.random`
drew.

The draws come from three independent streams, as JAX's key domains are:
flip, rotation and colour; box jitter; half-body boxes. Each stream is
seeded from (seed, its domain, step) alone, so a resumed run draws what an
uninterrupted one would, and no draw reads the device back.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "AugmentDraws",
    "draw_augment",
    "augment_boxes",
    "half_body_boxes",
    "flip_crops_and_keypoints",
    "rotate_crops",
    "color_jitter",
    "average_flip_pred",
    "average_flip_pred_simcc",
]

# Stream domains: flip, rotation and colour; box jitter; half-body boxes.
_MAIN, _BOX, _HALF_BODY = 0, 1, 2


@dataclass
class AugmentDraws:
    """Every value one augmented step draws, for a batch of B samples."""

    flip: torch.Tensor  # (B,) bool
    scale: torch.Tensor  # (B, 1), box scale 1 + scale_jitter * U[-1, 1]
    shift: torch.Tensor  # (B, 2), box shift shift_jitter * U[-1, 1]
    half_coin: torch.Tensor  # (B,) bool, upper half w.p. 0.5
    half_u: torch.Tensor  # (B,) U[0, 1), applied where < half_body_prob
    theta: torch.Tensor  # (B,) radians, rotation_deg * U[-1, 1]
    brightness: torch.Tensor  # (B, 1, 1, 1), brightness * U[-1, 1]
    contrast: torch.Tensor  # (B, 1, 1, 1), 1 + contrast * U[-1, 1]

    def to(self, device: torch.device | str) -> "AugmentDraws":
        return AugmentDraws(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def _generator(device: torch.device, seed: int, domain: int, step: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, domain, step) alone."""
    state = np.random.SeedSequence([seed, domain, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def draw_augment(seed: int, step: int, B: int, cfg, device: torch.device | str) -> AugmentDraws:
    """The draws of step `step` for B samples under the AugmentConfig
    `cfg`, on `device`. Bernoulli draws are `U[0, 1) < p`, as
    jax.random.bernoulli's."""
    device = torch.device(device)

    def uniform(g, *shape):  # U[-1, 1)
        return torch.rand(shape, generator=g, device=device) * 2.0 - 1.0

    g = _generator(device, seed, _MAIN, step)
    flip = torch.rand(B, generator=g, device=device) < cfg.flip_prob
    theta = uniform(g, B) * math.radians(cfg.rotation_deg)
    brightness = cfg.brightness * uniform(g, B, 1, 1, 1)
    contrast = 1.0 + cfg.contrast * uniform(g, B, 1, 1, 1)
    g = _generator(device, seed, _BOX, step)
    scale = 1.0 + cfg.scale_jitter * uniform(g, B, 1)
    shift = cfg.shift_jitter * uniform(g, B, 2)
    g = _generator(device, seed, _HALF_BODY, step)
    half_coin = torch.rand(B, generator=g, device=device) < 0.5
    half_u = torch.rand(B, generator=g, device=device)
    return AugmentDraws(flip=flip, scale=scale, shift=shift, half_coin=half_coin,
                        half_u=half_u, theta=theta, brightness=brightness, contrast=contrast)


def augment_boxes(boxes: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Scale (B, 1) and shift (B, 2) jitter of (B, 4) xywh boxes about their
    centers; the shift is a fraction of the box size."""
    cx = boxes[:, 0:1] + boxes[:, 2:3] / 2 + shift[:, 0:1] * boxes[:, 2:3]
    cy = boxes[:, 1:2] + boxes[:, 3:4] / 2 + shift[:, 1:2] * boxes[:, 3:4]
    w = boxes[:, 2:3] * scale
    h = boxes[:, 3:4] * scale
    return torch.cat([cx - w / 2, cy - h / 2, w, h], dim=1)


def half_body_boxes(boxes: torch.Tensor, keypoints: torch.Tensor, labeled: torch.Tensor,
                    coin: torch.Tensor, u: torch.Tensor, cfg,
                    aspect: float | None = None) -> torch.Tensor:
    """Half-body crop boxes (the HRNet / MMPose RandomHalfBody recipe) as a
    where-select. A sample takes the padded bbox of its chosen half's
    labeled keypoints where u < half_body_prob, it has more than
    half_body_min_total labeled keypoints and the half has at least
    half_body_min_half. The coin picks the upper half only when the upper
    half has enough; otherwise the lower half is chosen. `keypoints` are
    frame-space (B, K, 2), `labeled` (B, K) is > 0 where annotated."""
    upper = _upper_mask(tuple(cfg.upper_body_ids), keypoints.shape[1], keypoints.device)
    lab = labeled > 0
    upper_lab = upper[None, :] & lab
    lower_lab = ~upper[None, :] & lab
    use_upper = coin & (upper_lab.sum(dim=1) >= cfg.half_body_min_half)
    half = torch.where(use_upper[:, None], upper_lab, lower_lab)
    apply = ((u < cfg.half_body_prob)
             & (lab.sum(dim=1) > cfg.half_body_min_total)
             & (half.sum(dim=1) >= cfg.half_body_min_half))

    x = keypoints[..., 0].float()
    y = keypoints[..., 1].float()
    xmin = torch.where(half, x, 1e9).amin(dim=1)
    xmax = torch.where(half, x, -1e9).amax(dim=1)
    ymin = torch.where(half, y, 1e9).amin(dim=1)
    ymax = torch.where(half, y, -1e9).amax(dim=1)
    cx, cy = (xmin + xmax) / 2, (ymin + ymax) / 2
    # Floor at 1 px: collinear keypoints would give a zero-size crop.
    w = torch.clamp_min(xmax - xmin, 1.0)
    h = torch.clamp_min(ymax - ymin, 1.0)
    if aspect is not None:
        wide = w > h * aspect
        h = torch.where(wide, w / aspect, h)
        w = torch.where(wide, w, h * aspect)
    w = w * cfg.half_body_padding
    h = h * cfg.half_body_padding
    nb = torch.stack([cx - w / 2, cy - h / 2, w, h], dim=1)
    return torch.where(apply[:, None], nb, boxes.float())


# Index tensors made once per device: one built from host data inside the
# step would be a blocking copy, which waits for the device to drain.
@functools.lru_cache(maxsize=32)
def _pair_perm(pairs: tuple[tuple[int, int], ...], K: int, device: torch.device) -> torch.Tensor:
    perm = np.arange(K)
    for a, b in pairs:
        if a < K and b < K:
            perm[a], perm[b] = perm[b], perm[a]
    return torch.as_tensor(perm, device=device)


@functools.lru_cache(maxsize=32)
def _upper_mask(ids: tuple[int, ...], K: int, device: torch.device) -> torch.Tensor:
    upper = np.zeros(K, bool)
    upper[[i for i in ids if i < K]] = True
    return torch.as_tensor(upper, device=device)


def _swap_pairs(arr: torch.Tensor, pairs: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Swap left/right keypoint channels along axis 1."""
    return arr[:, _pair_perm(tuple(map(tuple, pairs)), arr.shape[1], arr.device)]


def flip_crops_and_keypoints(flip: torch.Tensor, crops: torch.Tensor, keypoints: torch.Tensor,
                             visible: torch.Tensor, visibility: torch.Tensor, cfg):
    """Horizontal flip of the (B, H, W, C) crops where `flip` (B,) is true,
    with the keypoints mirrored and left/right identities swapped."""
    W = crops.shape[2]
    crops = torch.where(flip[:, None, None, None], crops.flip(2), crops)
    kx = W - 1 - keypoints[..., 0]
    flipped = _swap_pairs(torch.stack([kx, keypoints[..., 1]], dim=-1), cfg.flip_pairs)
    keypoints = torch.where(flip[:, None, None], flipped, keypoints)
    visible = torch.where(flip[:, None], _swap_pairs(visible, cfg.flip_pairs), visible)
    visibility = torch.where(flip[:, None], _swap_pairs(visibility, cfg.flip_pairs), visibility)
    return crops, keypoints, visible, visibility


def rotate_crops(images: torch.Tensor, keypoints: torch.Tensor,
                 theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate (B, H, W, C) crops and their (B, K, 2) crop-space keypoints by
    `theta` (B,) radians, counter-clockwise in image coordinates, about the
    crop center. Pixels: inverse-map bilinear resample, a 4-tap gather with
    black outside the crop (the cropper's convention). Keypoints: the
    forward rotation, so they stay on the rotated content."""
    B, H, W, C = images.shape
    # cos and sin in float64, rounded once: the same float32 on every device.
    cos = torch.cos(theta.double()).float()[:, None, None]
    sin = torch.sin(theta.double()).float()[:, None, None]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=images.device),
                            torch.arange(W, dtype=torch.float32, device=images.device),
                            indexing="ij")
    dx, dy = xx - cx, yy - cy
    # destination -> source: R(-theta)
    sx = cos * dx + sin * dy + cx
    sy = -sin * dx + cos * dy + cy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0
    flat = images.float().reshape(B, H * W, C)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = (iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()).reshape(B, H * W, 1)
        g = torch.gather(flat, 1, idx.expand(B, H * W, C)).reshape(B, H, W, C)
        return torch.where(valid[..., None], g, 0.0)

    # The four weighted taps summed in the JAX order.
    out = (((1 - wx) * (1 - wy))[..., None] * tap(x0, y0)
           + (wx * (1 - wy))[..., None] * tap(x0 + 1, y0)
           + ((1 - wx) * wy)[..., None] * tap(x0, y0 + 1)
           + (wx * wy)[..., None] * tap(x0 + 1, y0 + 1))
    cos, sin = cos[:, :, 0], sin[:, :, 0]
    kx = keypoints[..., 0] - cx
    ky = keypoints[..., 1] - cy
    nkx = cos * kx - sin * ky + cx
    nky = sin * kx + cos * ky + cy
    return out.to(images.dtype), torch.stack([nkx, nky], dim=-1).to(keypoints.dtype)


def color_jitter(crops: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor) -> torch.Tensor:
    """Per-sample brightness (added) and contrast (a factor about the
    sample's mean over H, W and C) on [0, 1] float crops, clipped to
    [0, 1]."""
    mean = crops.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((crops - mean) * contrast + mean + brightness, 0.0, 1.0)


def average_flip_pred(pred: Sequence[torch.Tensor], pred_flipped: Sequence[torch.Tensor],
                      pairs: Sequence[tuple[int, int]]) -> tuple[torch.Tensor, ...]:
    """Average a head 5-tuple with its twin on the W-mirrored crops
    (flip-test TTA): the twin's heatmaps (B, K, H, W) mirror back along W
    and swap left/right channels, its per-keypoint scalars (B, K, 1, 1)
    swap channels only; each pair is added, then halved, in the JAX order.
    Under the codec's x_hm in [0, W_hm - 1] affine a reverse along W is the
    exact mirror, so no sub-pixel shift is needed."""
    hm, *scalars = pred
    hm_f, *scalars_f = pred_flipped
    out = [(hm + _swap_pairs(hm_f.flip(-1), pairs)) * 0.5]
    for s, sf in zip(scalars, scalars_f):
        out.append((s + _swap_pairs(sf, pairs)) * 0.5)
    return tuple(out)


def _mirror_x_bins(p: torch.Tensor, split_ratio: float) -> torch.Tensor:
    """The crop mirror x -> (W - 1) - x on SimCC x-bin distributions: bin b
    (pixel b / split) maps to Wb - split - b, a reverse along the bins then
    a left shift by round(split) - 1 bins, zero-filled at the end (mass
    that would land at x < 0). A non-integer ratio rounds, a sub-half-bin
    error."""
    rev = p.flip(-1)
    s = int(round(split_ratio)) - 1
    if s > 0:
        rev = torch.cat([rev[..., s:], torch.zeros_like(rev[..., :s])], dim=-1)
    return rev


def average_flip_pred_simcc(pred: Sequence, pred_flipped: Sequence,
                            pairs: Sequence[tuple[int, int]], split_ratio: float) -> tuple:
    """Flip-test averaging for the SimCC family, in probability space (the
    two forwards' logits share no scale): each axis's softmax, the twin's x
    distributions mirrored by `_mirror_x_bins`, both twins' channels
    swapped left/right, the pair added and halved, and log(average +
    1e-12) returned, which the decoder's softmax maps back to the average.
    The scalars average as in `average_flip_pred`."""
    (x, y), *scalars = pred
    (xf, yf), *scalars_f = pred_flipped
    px, py = torch.softmax(x.float(), dim=-1), torch.softmax(y.float(), dim=-1)
    pxf, pyf = torch.softmax(xf.float(), dim=-1), torch.softmax(yf.float(), dim=-1)
    avg_x = 0.5 * (px + _swap_pairs(_mirror_x_bins(pxf, split_ratio), pairs))
    avg_y = 0.5 * (py + _swap_pairs(pyf, pairs))
    out = [(torch.log(avg_x + 1e-12), torch.log(avg_y + 1e-12))]
    for s, sf in zip(scalars, scalars_f):
        out.append((s + _swap_pairs(sf, pairs)) * 0.5)
    return tuple(out)
