"""Batched crop + resize of person boxes (port of
probpose_pytorch_tpu/ops/preprocess.py) and the matching keypoint maps.

Every method of the JAX `Method` is ported:
  * "linear" (the default, as in JAX), "lanczos3" and "cubic": JAX's
    `jax.image.scale_and_translate` per box, antialiased. Its resample is
    separable, so each crop is two float32 products with per-box weight
    matrices, rows then columns; the weights are computed as
    jax/_src/image/scale.py's `compute_weight_mat` computes them (the
    kernel widened by 1/scale when shrinking, columns normalised by their
    sum, samples outside the source zeroed, so out-of-frame content is
    black). JAX runs the products at HIGHEST precision; on the card the
    port needs `torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's
    default) for the same float32 products. The summation order differs
    from XLA's einsum, so the crops agree with JAX's to float32 rounding,
    not bit for bit.
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
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["METHODS", "crop_resize", "transform_keypoints", "untransform_keypoints"]

# JAX's `Method`
METHODS = ("linear", "lanczos3", "cubic", "bilinear_gather", "bilinear_matmul")


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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = -0.5) of jax/_src/image/scale.py."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    """The Lanczos kernel of radius 3 of jax/_src/image/scale.py."""
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * (x * x), 1.0), 1.0)
    return torch.where(x > 3.0, 0.0, out)


_KERNELS = {"linear": _triangle, "lanczos3": _lanczos3, "cubic": _keys_cubic}
_SUM_EPS = 1000.0 * float(np.finfo(np.float32).eps)


def _scale_translate_weights(n_in: int, n_out: int, start: torch.Tensor,
                             extent: torch.Tensor, kernel) -> torch.Tensor:
    """(B, n_in, n_out) antialiased weights of one axis for per-box `start`
    and `extent` (B,): scale n_out / extent, translation -start * n_out /
    extent, as jax/_src/image/scale.py:compute_weight_mat computes them in
    the float32 operations XLA compiles JAX's jitted crop_resize into: the
    inverse scale is extent times the rounded 1 / n_out, and the sample
    positions take one fused multiply-add, (o + 0.5) * inv - t * inv
    rounded once (here in float64, where the product is exact)."""
    dev = extent.device
    inv_scale = (extent * float(np.float32(1.0 / n_out)))[:, None]
    shift = ((-start * n_out / extent)[:, None] * inv_scale).double()
    o = torch.arange(n_out, dtype=torch.float64, device=dev) + 0.5
    sample_f = (o * inv_scale.double() - shift).float() - 0.5  # (B, n_out)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    i = torch.arange(n_in, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - i[None, :, None]).abs() / kernel_scale[:, :, None]
    weights = kernel(x)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > _SUM_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _crop_scale_translate(images: torch.Tensor, boxes: torch.Tensor,
                          out_hw: tuple[int, int], method: str) -> torch.Tensor:
    """JAX's `_crop_one_scale_translate` for every box: scale H / h and
    translation -y H / h on rows (likewise on columns), as two float32
    products."""
    B, Hs, Ws, C = images.shape
    H, W = out_hw
    x0, y0, bw, bh = boxes.unbind(-1)
    kernel = _KERNELS[method]
    rows = _scale_translate_weights(Hs, H, y0, bh, kernel)  # (B, Hs, H)
    cols = _scale_translate_weights(Ws, W, x0, bw, kernel)  # (B, Ws, W)
    y = torch.bmm(rows.transpose(1, 2), images.reshape(B, Hs, Ws * C))
    return torch.einsum("bsw,bhsc->bhwc", cols, y.reshape(B, H, Ws, C))


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
    method: str = "linear",
) -> torch.Tensor:
    """Crop each (Hs, Ws, C) image to its (x, y, w, h) box and resize to
    `out_hw`. images: (B, Hs, Ws, C) uint8 (scaled to [0, 1]) or float;
    boxes: (B, 4). `method`: one of METHODS, JAX's default "linear".
    Returns (B, H, W, C) float32 crops, black outside the image."""
    if method in _KERNELS:
        return _crop_scale_translate(_to_float01(images), boxes.float(), out_hw, method)
    if method == "bilinear_gather":
        return _crop_bilinear_gather(_to_float01(images), boxes.float(), out_hw)
    if method != "bilinear_matmul":
        raise ValueError(f"unknown crop_resize method {method!r}; expected one of {METHODS}")
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
