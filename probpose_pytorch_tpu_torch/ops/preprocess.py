"""Batched crop + resize of person boxes (port of
probpose_pytorch_tpu/ops/preprocess.py) and the matching keypoint maps.

Two of the JAX methods are ported:
  * "bilinear_matmul", the serving method: per sample, the 2-tap bilinear
    resample is two matrix products, crop[b] = R[b] @ image[b] @ C[b]^T,
    with weights built from the box. The JAX version rounds the weights, the
    image and the intermediate product to bfloat16 and accumulates in
    float32, whatever the model's dtype; this port rounds at the same three
    places and accumulates in float32 (on the card with TF32 off, so the f32
    products are exact), so the crops agree with JAX's to float32 summation
    order.
  * "bilinear_gather": the 4-tap gather in float32, JAX's
    `_crop_one_bilinear` over the batch; the native data plane
    (native/dataplane.cpp) samples in the same convention.
"linear", "lanczos3" and "cubic" are not ported (ROADMAP item 3).
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


def _crop_bilinear_gather(images: torch.Tensor, boxes: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """4-tap bilinear gather with zero padding outside the image, JAX's
    `_crop_one_bilinear` (ops/preprocess.py) for every box at once, in its
    order of float32 operations."""
    B, Hs, Ws, C = images.shape
    H, W = out_hw
    x0, y0, bw, bh = boxes.unbind(-1)
    dev = images.device
    ox = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) * (bw / W)[:, None] \
        + x0[:, None] - 0.5
    oy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) * (bh / H)[:, None] \
        + y0[:, None] - 0.5
    xf, yf = torch.floor(ox), torch.floor(oy)
    wx, wy = ox - xf, oy - yf
    b = torch.arange(B, device=dev)

    def take_rows(yi):  # (B, H, Ws, C)
        valid = ((yi >= 0) & (yi < Hs)).to(images.dtype)
        return images[b[:, None], yi.clamp(0, Hs - 1)] * valid[:, :, None, None]

    def take_cols(rows, xi):  # (B, H, W, C)
        valid = ((xi >= 0) & (xi < Ws)).to(images.dtype)
        cols = rows[b[:, None, None], torch.arange(H, device=dev)[None, :, None],
                    xi.clamp(0, Ws - 1)[:, None, :]]
        return cols * valid[:, None, :, None]

    y0i, x0i = yf.long(), xf.long()
    top, bot = take_rows(y0i), take_rows(y0i + 1)
    tl, tr = take_cols(top, x0i), take_cols(top, x0i + 1)
    bl, br = take_cols(bot, x0i), take_cols(bot, x0i + 1)
    wxc = wx[:, None, :, None]
    wyc = wy[:, :, None, None]
    return (tl * (1 - wxc) * (1 - wyc) + tr * wxc * (1 - wyc)
            + bl * (1 - wxc) * wyc + br * wxc * wyc)


def crop_resize(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: tuple[int, int],
    method: str = "bilinear_matmul",
) -> torch.Tensor:
    """Crop each (Hs, Ws, C) image to its (x, y, w, h) box and resize to
    `out_hw`. images: (B, Hs, Ws, C) uint8 (scaled to [0, 1]) or float;
    boxes: (B, 4). `method`: "bilinear_matmul" or "bilinear_gather".
    Returns (B, H, W, C) float32 crops, black outside the image."""
    if method == "bilinear_gather":
        return _crop_bilinear_gather(_to_float01(images), boxes.float(), out_hw)
    if method != "bilinear_matmul":
        raise NotImplementedError(
            f"crop_resize method {method!r} is not ported; the port has "
            "'bilinear_matmul' and 'bilinear_gather' (ROADMAP item 3)"
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
    d = (keypoints - boxes[:, None, 0:2]) / boxes[:, None, 2:4]
    return torch.stack([d[..., 0] * W, d[..., 1] * H], dim=-1)


def untransform_keypoints(keypoints: torch.Tensor, boxes: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop coordinates (B, K, 2) -> frame coordinates (inverse map). The
    crop size divides as Python scalars, which needs no host-to-device copy
    (a tensor of [W, H] would be one, and would block the host)."""
    H, W = out_hw
    crop = torch.stack([keypoints[..., 0] / W, keypoints[..., 1] / H], dim=-1)
    return crop * boxes[:, None, 2:4] + boxes[:, None, 0:2]
