"""Host-side (NumPy) metrics (a copy of probpose_pytorch_tpu/eval/
metrics_host.py) reproducing the reference's exact validation semantics —
including its randomized balanced subsampling — for offline evaluation
and cross-checking the deterministic on-device versions in losses.py.

Reference: pose PCK (loss.py:767-866), balanced binary accuracy with random
equal-count subsampling (loss.py:653-697), masked MAE (loss.py:699-712).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "keypoint_pck_accuracy",
    "pose_pck_accuracy",
    "balanced_binary_accuracy_sampled",
    "masked_mae",
]


def _distances(preds, gts, mask, norm_factor):
    N, K, _ = preds.shape
    _mask = mask.copy()
    _mask[(norm_factor == 0).any(axis=1)] = False
    norm = norm_factor.copy().astype(np.float64)
    norm[norm <= 0] = 1e6
    d = np.full((N, K), -1.0, np.float32)
    d[_mask] = np.linalg.norm(((preds - gts) / norm[:, None, :])[_mask], axis=-1)
    return d.T


def keypoint_pck_accuracy(pred, gt, mask, thr, norm_factor):
    """Per-keypoint and averaged PCK for coordinates. Returns
    (acc (K,), avg_acc, valid_count)."""
    dists = _distances(pred, gt, mask, norm_factor)
    accs = []
    for row in dists:
        valid = row != -1
        accs.append(
            float((row[valid] < thr).sum() / valid.sum()) if valid.any() else -1.0
        )
    accs = np.asarray(accs)
    valid_accs = accs[accs >= 0]
    return accs, (valid_accs.mean() if len(valid_accs) else 0.0), len(valid_accs)


def pose_pck_accuracy(output, target, mask, thr=0.05, normalize=None):
    """PCK from heatmaps via argmax peaks (keeps the reference's [H, W]
    normalization order)."""
    N, K, H, W = output.shape
    if normalize is None:
        normalize = np.tile(np.array([[H, W]], np.float32), (N, 1))
    flat_o = output.reshape(N, K, -1)
    flat_t = target.reshape(N, K, -1)

    def peaks(flat):
        idx = flat.argmax(-1)
        vals = flat.max(-1)
        locs = np.stack([idx % W, idx // W], -1).astype(np.float32)
        locs[vals <= 0] = -1
        return locs

    return keypoint_pck_accuracy(peaks(flat_o), peaks(flat_t), mask, thr, normalize)


def balanced_binary_accuracy_sampled(
    dt: np.ndarray,
    gt: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator | None = None,
) -> tuple[float, float]:
    """The reference's randomized balanced accuracy: subsample equal numbers
    of positives/negatives, sweep thresholds 0.1..0.95 (step 0.05), return the
    best (accuracy, threshold)."""
    rng = rng or np.random.default_rng()
    dt = dt[mask]
    gt = gt[mask].astype(bool)
    pos_idx = np.where(gt)[0]
    neg_idx = np.where(~gt)[0]
    num = min(len(pos_idx), len(neg_idx))
    if num == 0:
        return 0.0, 0.0
    rng.shuffle(pos_idx)
    rng.shuffle(neg_idx)
    idx = np.concatenate([pos_idx[:num], neg_idx[:num]])
    dt, gt = dt[idx], gt[idx]
    thresholds = np.arange(0.1, 1.0, 0.05)
    correct = ((dt[:, None] > thresholds) == gt[:, None]).sum(axis=0)
    best = int(np.argmax(correct))
    return float(correct[best] / len(gt)), float(thresholds[best])


def masked_mae(dt: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    return float(np.abs(dt[mask] - gt[mask]).mean())
