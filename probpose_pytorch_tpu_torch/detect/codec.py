"""Detection codec (port of probpose_pytorch_tpu/detect/codec.py): person
boxes <-> center-point targets, on the device of the inputs.

Layouts are JAX's: maps (B, H, W, C), boxes xywh. `encode_boxes` splats a
Gaussian around each box's INTEGER center cell (exactly exp(0) = 1.0 there:
the focal loss keys positives off heat >= 1 - 1e-6) and supervises size and
offset as a gather at `ind = cyi * W + cxi`. `decode_boxes` and
`decode_poses` keep static shapes: 3x3 max-pool peak NMS (padded with -inf,
as `reduce_window` pads), then the top k. Every non-peak cell is exactly
0.0, so a frame with fewer than k peaks ties in its tail; `lax.top_k` puts
the lower index first among equal values, and so does `_top_k` here (a
stable descending sort; `torch.topk` promises no order among ties on
CUDA). The masked argmin of the snap refinement keeps the first index, as
`jnp.argmin` does. Thresholding is left to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gaussian_radius", "encode_boxes", "decode_boxes", "decode_poses"]


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_iou: float = 0.7) -> torch.Tensor:
    """Largest center-splat radius (in feature cells) such that any corner
    within it still yields IoU >= min_iou with the true box: the smallest
    root of the three quadratics (both corners inside, both outside, one in
    and one out)."""
    t = min_iou
    b1 = height + width
    c1 = width * height * (1.0 - t) / (1.0 + t)
    r1 = (b1 - torch.sqrt(torch.clamp_min(b1**2 - 4 * 1.0 * c1, 0.0))) / (2 * 1.0)
    b2 = 2.0 * (height + width)
    c2 = (1.0 - t) * width * height
    r2 = (b2 - torch.sqrt(torch.clamp_min(b2**2 - 4 * 4.0 * c2, 0.0))) / (2 * 4.0)
    a3 = 4.0 * t
    b3 = -2.0 * t * (height + width)
    c3 = (t - 1.0) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3**2 - 4 * a3 * c3, 0.0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def _splat(xs: torch.Tensor, ys: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
           sigma: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """max over M of the (B, M) integer-cell Gaussians -> (B, H, W)."""
    d2 = ((xs[None, None, None, :] - xi[..., None, None]) ** 2
          + (ys[None, None, :, None] - yi[..., None, None]) ** 2)
    g = torch.exp(-d2 / (2.0 * sigma[..., None, None] ** 2))
    return torch.where(valid[..., None, None], g, 0.0).amax(dim=1)


def encode_boxes(
    boxes: torch.Tensor,
    mask: torch.Tensor,
    feat_hw: tuple[int, int],
    stride: int,
    ignore_boxes: torch.Tensor | None = None,
    ignore_mask: torch.Tensor | None = None,
    min_iou: float = 0.7,
    keypoints: torch.Tensor | None = None,
    kpt_heatmaps: bool = False,
) -> dict[str, torch.Tensor]:
    """Padded person boxes (B, M, 4) xywh in input pixels with valid flags
    (B, M) -> center-point targets: heat (B, H, W), ind (B, M) int32, size
    and offset (B, M, 2) in cells, mask (B, M) (valid and center in the
    grid), neg_weight (B, H, W) (0 at cell centers inside an ignore box).
    With keypoints (B, M, K, 3): kpts (B, M, K, 2) joint minus center cell
    and kpt_mask (B, M, K); with `kpt_heatmaps` also kpt_heat (B, H, W, K),
    kpt_ind (B, M, K) int32, kpt_off (B, M, K, 2) and kpt_cell_mask. The
    per-joint maps are built one joint type at a time, so the transient
    stays one (B, M, H, W) buffer, as JAX's `lax.map` keeps it."""
    H, W = feat_hw
    boxes = boxes.float()
    x, y, w, h = boxes.unbind(-1)
    cx = (x + w / 2.0) / stride
    cy = (y + h / 2.0) / stride
    cxi, cyi = torch.floor(cx), torch.floor(cy)
    in_grid = (cxi >= 0) & (cxi < W) & (cyi >= 0) & (cyi < H)
    valid = mask.bool() & in_grid & (w > 0) & (h > 0)
    cxi, cyi = cxi.clamp(0, W - 1), cyi.clamp(0, H - 1)
    radius = torch.clamp_min(gaussian_radius(h / stride, w / stride, min_iou), 1.0)
    sigma = (2.0 * radius + 1.0) / 6.0
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)
    heat = _splat(xs, ys, cxi, cyi, sigma, valid)
    out = dict(
        heat=heat,
        ind=(cyi * W + cxi).int(),
        size=torch.stack([w, h], dim=-1) / stride,
        offset=torch.stack([cx - cxi, cy - cyi], dim=-1),
        mask=valid,
    )
    if ignore_boxes is not None:
        ix, iy, iw, ih = (ignore_boxes.float() / stride).unbind(-1)
        im = (ignore_mask.bool() if ignore_mask is not None
              else torch.ones_like(iw, dtype=torch.bool)) & (iw > 0) & (ih > 0)
        px = xs[None, None, None, :] + 0.5  # cell-center membership
        py = ys[None, None, :, None] + 0.5
        inside = ((px >= ix[..., None, None]) & (px <= (ix + iw)[..., None, None])
                  & (py >= iy[..., None, None]) & (py <= (iy + ih)[..., None, None])
                  & im[..., None, None])
        out["neg_weight"] = 1.0 - inside.any(dim=1).float()
    else:
        out["neg_weight"] = torch.ones_like(heat)
    if keypoints is None:
        return out
    kp = keypoints.float()
    out["kpts"] = torch.stack([kp[..., 0] / stride - cxi[..., None],
                               kp[..., 1] / stride - cyi[..., None]], dim=-1)
    out["kpt_mask"] = (kp[..., 2] > 0) & valid[..., None]
    if kpt_heatmaps:
        jx, jy = kp[..., 0] / stride, kp[..., 1] / stride
        jxi, jyi = torch.floor(jx), torch.floor(jy)
        j_in = (jxi >= 0) & (jxi < W) & (jyi >= 0) & (jyi < H)
        jvalid = (kp[..., 2] > 0) & valid[..., None] & j_in
        jxi, jyi = jxi.clamp(0, W - 1), jyi.clamp(0, H - 1)
        out["kpt_ind"] = (jyi * W + jxi).int()
        out["kpt_off"] = torch.stack([jx - jxi, jy - jyi], dim=-1)
        out["kpt_cell_mask"] = jvalid
        # One channel per joint type, with the PERSON's sigma.
        out["kpt_heat"] = torch.stack(
            [_splat(xs, ys, jxi[..., k], jyi[..., k], sigma, jvalid[..., k])
             for k in range(kp.shape[2])], dim=-1)
    return out


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis: values descending, the lower index
    first among equal values."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _peaks(logits: torch.Tensor) -> torch.Tensor:
    """sigmoid(logits) (B, H, W, C) kept where it is its 3x3 neighbourhood's
    max (>=, -inf padding), else exactly 0.0."""
    p = torch.sigmoid(logits.float())
    pmax = F.max_pool2d(p.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    return torch.where(p >= pmax, p, 0.0)


def _gather(m: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) map at the flat cells ind (B, k) -> (B, k, C)."""
    B, C = m.shape[0], m.shape[-1]
    flat = m.float().reshape(B, -1, C)
    return torch.gather(flat, 1, ind[..., None].expand(-1, -1, C))


def _boxes_at(ind: torch.Tensor, W: int, size: torch.Tensor, offset: torch.Tensor,
              stride: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(boxes (B, k, 4) xywh px, xi, yi) of the peaks at ind."""
    xi = (ind % W).float()
    yi = torch.div(ind, W, rounding_mode="floor").float()
    off = _gather(offset, ind)
    wh = torch.clamp_min(_gather(size, ind), 0.0)
    cxp = (xi + off[..., 0]) * stride
    cyp = (yi + off[..., 1]) * stride
    bw, bh = wh[..., 0] * stride, wh[..., 1] * stride
    return torch.stack([cxp - bw / 2, cyp - bh / 2, bw, bh], dim=-1), xi, yi


def decode_boxes(center_logits: torch.Tensor, size: torch.Tensor, offset: torch.Tensor,
                 k: int = 64, stride: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """center_logits (B, H, W, 1), size/offset (B, H, W, 2) -> the top-k
    boxes (B, k, 4) xywh in input pixels and scores (B, k), descending."""
    B, H, W, _ = center_logits.shape
    scores, ind = _top_k(_peaks(center_logits).reshape(B, H * W), k)
    boxes, _, _ = _boxes_at(ind, W, size, offset, stride)
    return boxes, scores


def decode_poses(
    center_logits: torch.Tensor,
    size: torch.Tensor,
    offset: torch.Tensor,
    kpts: torch.Tensor,
    k: int = 32,
    stride: int = 4,
    kpt_heat: torch.Tensor | None = None,
    kpt_offset: torch.Tensor | None = None,
    snap_candidates: int = 16,
    snap_threshold: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-stage pose decode: -> (boxes (B, k, 4), scores (B, k), poses
    (B, k, Kj, 2) px, kpt_scores (B, k, Kj)), score-descending. Joints are
    the regressed displacements from each peak's integer cell, each with its
    person's score; with `kpt_heat` (B, H, W, Kj) each joint snaps to the
    nearest same-type heat peak (top `snap_candidates` per type after 3x3
    NMS, shifted by `kpt_offset` when given) that clears `snap_threshold`
    and lies inside its person's box, and scores that peak's probability
    (unsnapped: the heat probability at the regressed cell)."""
    B, H, W, _ = center_logits.shape
    Kj = kpts.shape[-1] // 2
    scores, ind = _top_k(_peaks(center_logits).reshape(B, H * W), k)
    boxes, xi, yi = _boxes_at(ind, W, size, offset, stride)
    jo = _gather(kpts, ind).reshape(B, k, Kj, 2)  # cells from the int cell
    poses = torch.stack([(xi[..., None] + jo[..., 0]) * stride,
                         (yi[..., None] + jo[..., 1]) * stride], dim=-1)
    if kpt_heat is None:
        return boxes, scores, poses, scores[..., None].expand(B, k, Kj).clone()

    P = min(snap_candidates, H * W)
    ph = torch.sigmoid(kpt_heat.float())  # (B, H, W, Kj)
    jflat = _peaks(kpt_heat).permute(0, 3, 1, 2).reshape(B, Kj, H * W)
    cs, ci = _top_k(jflat, P)  # (B, Kj, P)
    cxi = (ci % W).float()
    cyi = torch.div(ci, W, rounding_mode="floor").float()
    if kpt_offset is not None:
        joff = _gather(kpt_offset, ci.reshape(B, Kj * P)).reshape(B, Kj, P, 2)
        cxi, cyi = cxi + joff[..., 0], cyi + joff[..., 1]
    cand_x, cand_y = cxi * stride, cyi * stride  # (B, Kj, P)
    d2 = ((poses[..., 0][..., None] - cand_x[:, None]) ** 2
          + (poses[..., 1][..., None] - cand_y[:, None]) ** 2)  # (B, k, Kj, P)
    x0 = boxes[..., 0][..., None, None]
    y0 = boxes[..., 1][..., None, None]
    x1 = (boxes[..., 0] + boxes[..., 2])[..., None, None]
    y1 = (boxes[..., 1] + boxes[..., 3])[..., None, None]
    cx4, cy4 = cand_x[:, None], cand_y[:, None]
    ok = ((cs[:, None] >= snap_threshold) & (cx4 >= x0) & (cx4 <= x1)
          & (cy4 >= y0) & (cy4 <= y1))
    best = torch.argmin(torch.where(ok, d2, torch.inf), dim=-1)  # first index wins
    any_ok = ok.any(dim=-1)

    def pick(c: torch.Tensor) -> torch.Tensor:  # (B, Kj, P) -> (B, k, Kj)
        return torch.gather(c[:, None].expand(B, k, Kj, P), -1, best[..., None])[..., 0]

    snapped = torch.stack([pick(cand_x), pick(cand_y)], dim=-1)
    poses_out = torch.where(any_ok[..., None], snapped, poses)
    rxi = torch.round(poses[..., 0] / stride).clamp(0, W - 1)
    ryi = torch.round(poses[..., 1] / stride).clamp(0, H - 1)
    comb = (ryi * W + rxi).long() * Kj + torch.arange(Kj, device=ph.device)
    reg_val = torch.gather(ph.reshape(B, H * W * Kj), 1, comb.reshape(B, k * Kj)).reshape(B, k, Kj)
    return boxes, scores, poses_out, torch.where(any_ok, pick(cs), reg_val)
