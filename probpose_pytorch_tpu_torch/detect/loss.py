"""Detection loss (port of probpose_pytorch_tpu/detect/loss.py): the
penalty-reduced focal loss on the center heat map plus L1 on size and
offset gathered at the encoded center cells (the CenterNet objective), and
with the pose heads the gathered joint L1 and the joint heat focal + joint
offset L1. Float32 throughout."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["detection_loss"]


def _focal(logits: torch.Tensor, heat: torch.Tensor,
           neg_weight: torch.Tensor | float) -> torch.Tensor:
    """Focal form (alpha 2, beta 4): positives are the exactly-1.0 splat
    cells, every other cell a negative weighted by (1 - heat)^4 (and by
    neg_weight: 0 inside ignore regions); normalised by the positive count,
    at least 1."""
    pos = heat >= 1.0 - 1e-6
    p = torch.sigmoid(logits)
    pos_term = -((1.0 - p) ** 2) * F.logsigmoid(logits)
    neg_term = -((1.0 - heat) ** 4) * (p**2) * F.logsigmoid(-logits) * neg_weight
    return torch.where(pos, pos_term, neg_term).sum() / torch.clamp_min(pos.sum(), 1.0)


def _gathered_l1(m: torch.Tensor, ind: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked mean L1 of the (B, H, W, C) map at the flat cells `ind` (B, n)
    against target (B, n, C) (or (B, n, Kj, 2) for C = 2 Kj); the mean is
    over 2 * the mask's count, at least 1."""
    B, C = m.shape[0], m.shape[-1]
    at = torch.gather(m.float().reshape(B, -1, C), 1, ind.long()[..., None].expand(-1, -1, C))
    at = at.reshape(target.shape)
    mask = mask.float()[..., None]
    return (torch.abs(at - target) * mask).sum() / torch.clamp_min(mask.sum() * 2.0, 1.0)


def detection_loss(
    pred: dict,
    targets: dict,
    size_weight: float = 0.1,
    offset_weight: float = 1.0,
    kpt_weight: float = 1.0,
    kpt_heat_weight: float = 1.0,
    kpt_offset_weight: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """pred: PersonDetector's maps; targets: encode_boxes'. Returns (total,
    the terms by name, total included)."""
    neg_weight = targets.get("neg_weight", 1.0)
    center = _focal(pred["center"].float()[..., 0], targets["heat"], neg_weight)
    ind, mask = targets["ind"], targets["mask"]
    size = _gathered_l1(pred["size"], ind, targets["size"], mask)
    offset = _gathered_l1(pred["offset"], ind, targets["offset"], mask)
    total = center + size_weight * size + offset_weight * offset
    terms = dict(center=center, size=size, offset=offset)
    if "kpts" in pred and "kpts" in targets:
        terms["kpts"] = _gathered_l1(pred["kpts"], ind, targets["kpts"], targets["kpt_mask"])
        total = total + kpt_weight * terms["kpts"]
    if "kpt_heat" in pred and "kpt_heat" in targets:
        kneg = targets["neg_weight"][..., None] if "neg_weight" in targets else 1.0
        terms["kpt_heat"] = _focal(pred["kpt_heat"].float(), targets["kpt_heat"], kneg)
        total = total + kpt_heat_weight * terms["kpt_heat"]
        B, M, Kj = targets["kpt_ind"].shape
        terms["kpt_offset"] = _gathered_l1(pred["kpt_offset"],
                                           targets["kpt_ind"].reshape(B, M * Kj),
                                           targets["kpt_off"], targets["kpt_cell_mask"])
        total = total + kpt_offset_weight * terms["kpt_offset"]
    terms["total"] = total
    return total, terms
