"""OKS-based non-maximum suppression for multi-person pose candidates (a
copy of probpose_pytorch_tpu/ops/oks_nms.py, which the port cannot import).

Top-down pipelines inherit duplicate person detections from the detector;
without pose-level NMS each duplicate box yields a near-identical pose that
counts as a false positive under the COCO protocol. Greedy OKS-NMS (and the
soft rescoring variant) suppresses candidates whose pose similarity to an
already-kept higher-scored pose exceeds a threshold.

Host-side NumPy by design: candidate sets are tiny (tens of poses per frame),
so a device round-trip would cost more than the O(N²·K) arithmetic. The OKS
here is the detection-vs-detection form (average of the two instance areas),
distinct from the train-target form in ops/oks.py (reference
loss.py:715-757, which fixes area to the heatmap size).

The reference has no multi-person pipeline at all (SURVEY.md §2.4); this is
part of the superset serving stack around `TopDownPredictor`.
"""

from __future__ import annotations

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import COCO_SIGMAS

__all__ = ["pairwise_oks", "oks_nms", "soft_oks_nms"]


def pairwise_oks(
    keypoints: np.ndarray,
    areas: np.ndarray,
    sigmas: np.ndarray | None = None,
    visible: np.ndarray | None = None,
) -> np.ndarray:
    """Pairwise OKS matrix between N poses.

    keypoints: (N, K, 2); areas: (N,) instance areas (e.g. box w*h);
    visible: optional (N, K) — keypoint k contributes to OKS(i, j) only when
    visible in pose i (the reference pose of the comparison). Returns (N, N).
    """
    kpts = np.asarray(keypoints, np.float32)
    n, k = kpts.shape[0], kpts.shape[1]
    if sigmas is None:
        # COCO sigmas for the COCO-17 skeleton; uniform at the COCO mean
        # for any other keypoint count.
        sig = (
            np.asarray(COCO_SIGMAS, np.float32)
            if k == len(COCO_SIGMAS)
            else np.full((k,), float(np.mean(COCO_SIGMAS)), np.float32)
        )
    else:
        sig = np.asarray(sigmas, np.float32)
    if sig.shape[0] != k:
        raise ValueError(f"sigmas K={sig.shape[0]} != keypoints K={k}")
    var = (2.0 * sig) ** 2  # (K,)
    d2 = np.sum(
        (kpts[:, None, :, :] - kpts[None, :, :, :]) ** 2, axis=-1
    )  # (N, N, K)
    a = np.asarray(areas, np.float32)
    mean_area = 0.5 * (a[:, None] + a[None, :])  # (N, N)
    e = d2 / var[None, None, :] / (mean_area[..., None] + np.spacing(1)) / 2.0
    oks_k = np.exp(-e)  # (N, N, K)
    if visible is not None:
        w = (np.asarray(visible, np.float32) > 0).astype(np.float32)
        num = np.einsum("ijk,ik->ij", oks_k, w)
        den = np.maximum(w.sum(axis=1)[:, None], 1.0)
        return num / den
    return oks_k.mean(axis=-1)


def _prep(keypoints, scores, areas):
    kpts = np.asarray(keypoints, np.float32)
    sc = np.asarray(scores, np.float32).reshape(-1)
    if areas is None:
        wh = kpts.max(axis=1) - kpts.min(axis=1)  # (N, 2)
        areas = wh[:, 0] * wh[:, 1]
    return kpts, sc, np.asarray(areas, np.float32)


def oks_nms(
    keypoints: np.ndarray,
    scores: np.ndarray,
    areas: np.ndarray | None = None,
    threshold: float = 0.9,
    sigmas: np.ndarray | None = None,
    visible: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy OKS-NMS. Returns indices of kept poses, descending score.

    areas default to each pose's keypoint bounding-box area when the caller
    has no detector boxes at hand.
    """
    kpts, sc, ar = _prep(keypoints, scores, areas)
    if len(kpts) == 0:
        return np.zeros((0,), np.int64)
    oks = pairwise_oks(kpts, ar, sigmas, visible)
    order = np.argsort(-sc)
    keep = []
    alive = np.ones(len(sc), bool)
    for i in order:
        if not alive[i]:
            continue
        keep.append(i)
        alive &= oks[i] <= threshold
        alive[i] = False
    return np.asarray(keep, np.int64)


def soft_oks_nms(
    keypoints: np.ndarray,
    scores: np.ndarray,
    areas: np.ndarray | None = None,
    threshold: float = 0.9,
    sigmas: np.ndarray | None = None,
    visible: np.ndarray | None = None,
    max_poses: int = 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Soft OKS-NMS: instead of removing overlapping poses, decay their
    scores by exp(-oks²/threshold) and re-rank. Returns (kept indices,
    rescored scores for those indices), both descending by final score,
    truncated to max_poses."""
    kpts, sc, ar = _prep(keypoints, scores, areas)
    if len(kpts) == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
    oks = pairwise_oks(kpts, ar, sigmas, visible)
    sc = sc.copy()
    alive = np.ones(len(sc), bool)
    keep, kept_scores = [], []
    while alive.any() and len(keep) < max_poses:
        i = int(np.argmax(np.where(alive, sc, -np.inf)))
        keep.append(i)
        kept_scores.append(sc[i])
        alive[i] = False
        decay = np.exp(-(oks[i] ** 2) / threshold)
        sc = np.where(alive, sc * decay, sc)
    return np.asarray(keep, np.int64), np.asarray(kept_scores, np.float32)
