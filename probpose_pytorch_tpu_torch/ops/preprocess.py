"""Batched crop + resize of person boxes (port of
probpose_pytorch_tpu/ops/preprocess.py) and the matching keypoint maps.

Only the serving method "bilinear_matmul" is ported: per sample, the 2-tap
bilinear resample is two matrix products, crop[b] = R[b] @ image[b] @ C[b]^T,
with weights built from the box. The JAX version rounds the weights, the
image and the intermediate product to bfloat16 and accumulates in float32,
whatever the model's dtype; this port rounds at the same three places and
accumulates in float32 (on the card with TF32 off, so the f32 products are
exact), so the crops agree with JAX's to float32 summation order.
"""

from __future__ import annotations

import torch

__all__ = ["crop_resize", "transform_keypoints", "untransform_keypoints"]


def _to_float01(images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images.float()


def _axis_weights(n_out: int, n_in: int, start: torch.Tensor,
                  extent: torch.Tensor) -> torch.Tensor:
    """(B, n_out, n_in) 2-tap bilinear weights; zero outside the source."""
    o = torch.arange(n_out, dtype=torch.float32, device=start.device)
    src = (o[None, :] + 0.5) * (extent[:, None] / n_out) + start[:, None] - 0.5
    i = torch.arange(n_in, dtype=torch.float32, device=start.device)
    return torch.clamp_min(1.0 - torch.abs(i[None, None, :] - src[:, :, None]), 0.0)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def crop_resize(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: tuple[int, int],
    method: str = "bilinear_matmul",
) -> torch.Tensor:
    """Crop each (Hs, Ws, C) image to its (x, y, w, h) box and resize to
    `out_hw`. images: (B, Hs, Ws, C) uint8 (scaled to [0, 1]) or float;
    boxes: (B, 4). Returns (B, H, W, C) float32 crops, black outside the
    image."""
    if method != "bilinear_matmul":
        raise NotImplementedError(
            f"crop_resize method {method!r} is not ported; the port has "
            "'bilinear_matmul' only (ROADMAP item 3)"
        )
    images = _to_float01(images)
    boxes = boxes.float()
    B, Hs, Ws, C = images.shape
    H, W = out_hw
    rows = _round_bf16(_axis_weights(H, Hs, boxes[:, 1], boxes[:, 3]))
    cols = _round_bf16(_axis_weights(W, Ws, boxes[:, 0], boxes[:, 2]))
    img = _round_bf16(images)
    y = torch.bmm(rows, img.reshape(B, Hs, Ws * C)).reshape(B, H, Ws, C)
    y = _round_bf16(y)
    return torch.einsum("bws,bhsc->bhwc", cols, y)


def transform_keypoints(keypoints: torch.Tensor, boxes: torch.Tensor,
                        out_hw: tuple[int, int]) -> torch.Tensor:
    """Frame keypoints (B, K, 2) -> crop coordinates for xywh boxes (B, 4)."""
    H, W = out_hw
    scale = torch.tensor([W, H], dtype=torch.float32, device=keypoints.device)
    return (keypoints - boxes[:, None, 0:2]) / boxes[:, None, 2:4] * scale


def untransform_keypoints(keypoints: torch.Tensor, boxes: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop coordinates (B, K, 2) -> frame coordinates (inverse map)."""
    H, W = out_hw
    scale = torch.tensor([W, H], dtype=torch.float32, device=keypoints.device)
    return keypoints / scale * boxes[:, None, 2:4] + boxes[:, None, 0:2]
