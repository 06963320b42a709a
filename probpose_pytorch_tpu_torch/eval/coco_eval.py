"""COCO-protocol keypoint AP/AR evaluation (pure NumPy; a copy of
probpose_pytorch_tpu/eval/coco_eval.py, which the port cannot import).

Greenfield subsystem (SURVEY.md §2.4: the reference has no AP evaluation,
only training-time PCK/OKS metrics). Implements the standard COCO keypoint
evaluation protocol exactly — per-image greedy matching of score-sorted
detections to ground truths by OKS with the ignored-GT rules (a detection
falls back to an ignored GT only when no live GT matches; non-crowd GTs are
consumed once while crowd GTs absorb any number of detections, pycocotools'
iscrowd exception; unmatched out-of-range detections are ignored rather than
counted as false positives), AP/AR averaged over OKS thresholds
0.50:0.05:0.95 with 101-point interpolated precision, and the medium/large
area-range splits.

Verified equivalent to the reference pycocotools COCOeval algorithm by a
structurally independent transcription of that protocol in
tests/test_coco_protocol.py (pycocotools itself is not a dependency).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["oks_matrix", "detection_areas", "COCOKeypointEvaluator"]

_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
# Inclusive [lo, hi] bounds, exactly the protocol's areaRng values (an
# instance is ignored when area < lo or area > hi; "all" is capped at 1e10).
_AREA_RANGES = {
    "all": (0.0**2, 1e5**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
}


def oks_matrix(
    dt_kpts: np.ndarray,
    gt_kpts: np.ndarray,
    gt_areas: np.ndarray,
    sigmas: np.ndarray,
    gt_boxes: np.ndarray | None = None,
) -> np.ndarray:
    """(D, G) OKS between D detections and G ground truths.

    dt_kpts: (D, K, 3) [x, y, score]; gt_kpts: (G, K, 3) [x, y, v].
    For GTs with no labeled keypoints, the COCO protocol falls back to a
    distance-to-expanded-box measure; that requires gt_boxes (G, 4) xywh.
    """
    D, G = len(dt_kpts), len(gt_kpts)
    if D == 0 or G == 0:
        return np.zeros((D, G), np.float64)
    # Fully batched over (D, G, K) — the per-pair Python loop cost ~minutes
    # of host time at real COCO val scale (5k images x 20 dets); identical
    # outputs pinned by tests/test_coco_protocol.py + the pycocotools
    # fixture cross-check.
    var = (2.0 * np.asarray(sigmas, np.float64)) ** 2  # (K,)
    dt = np.asarray(dt_kpts, np.float64)
    gt = np.asarray(gt_kpts, np.float64)
    xd, yd = dt[:, None, :, 0], dt[:, None, :, 1]  # (D, 1, K)
    xg, yg = gt[None, :, :, 0], gt[None, :, :, 1]  # (1, G, K)
    vg = gt[:, :, 2]  # (G, K)
    k1 = (vg > 0).sum(-1)  # (G,) labeled-keypoint counts
    dx, dy = xd - xg, yd - yg  # (D, G, K)
    if gt_boxes is not None and (k1 == 0).any():
        # Zero-keypoint GTs: distance to the doubly-expanded box instead.
        bx = np.asarray(gt_boxes, np.float64)
        x0, y0, w, h = (bx[None, :, i, None] for i in range(4))
        dxb = np.maximum(0.0, (x0 - w) - xd) + np.maximum(0.0, xd - (x0 + 2 * w))
        dyb = np.maximum(0.0, (y0 - h) - yd) + np.maximum(0.0, yd - (y0 + 2 * h))
        use_box = (k1 == 0)[None, :, None]
        dx = np.where(use_box, dxb, dx)
        dy = np.where(use_box, dyb, dy)
    e = (
        (dx**2 + dy**2)
        / var[None, None]
        / (np.asarray(gt_areas, np.float64)[None, :, None] + np.spacing(1))
        / 2.0
    )
    ee = np.exp(-e)  # (D, G, K)
    # k1 > 0: mean over labeled keypoints; k1 == 0 with boxes: mean over
    # all K; k1 == 0 without boxes: 0.
    lab_mean = (ee * (vg > 0)[None]).sum(-1) / np.maximum(k1, 1)[None]
    if gt_boxes is not None:
        fallback = ee.mean(-1)
    else:
        fallback = np.zeros((D, G), np.float64)
    return np.where((k1 > 0)[None], lab_mean, fallback)


def detection_areas(dt_kpts: np.ndarray) -> np.ndarray:
    """Per-detection area from the keypoint bounding box, as the COCO results
    loader derives it for keypoint detections (used to ignore unmatched
    detections outside an area-range split)."""
    x, y = dt_kpts[..., 0], dt_kpts[..., 1]
    return (x.max(-1) - x.min(-1)) * (y.max(-1) - y.min(-1))


@dataclass
class COCOKeypointEvaluator:
    """Streaming evaluator: feed per-image (detections, ground truths) as the
    val set is processed; `summarize()` yields AP / AP50 / AP75 / AP-m / AP-l
    / AR (the COCO keypoint headline numbers)."""

    sigmas: np.ndarray
    max_dets: int = 20
    _images: list = field(default_factory=list)

    def add_image(
        self,
        dt_kpts: np.ndarray,
        dt_scores: np.ndarray,
        gt_kpts: np.ndarray,
        gt_areas: np.ndarray,
        gt_boxes: np.ndarray | None = None,
        gt_ignore: np.ndarray | None = None,
        gt_crowd: np.ndarray | None = None,
    ) -> None:
        """dt_kpts (D, K, 3), dt_scores (D,), gt_kpts (G, K, 3),
        gt_areas (G,); gt_ignore marks annotations that are ignore-regions
        (crowds, zero-keypoint instances). gt_crowd marks iscrowd
        annotations, which are always ignored AND may absorb multiple
        detections (the protocol's iscrowd re-match exception)."""
        G = len(gt_kpts)
        # Stable score sort, truncated to max_dets (the protocol's per-image
        # detection cap).
        order = np.argsort(-np.asarray(dt_scores), kind="stable")[: self.max_dets]
        dt_kpts = np.asarray(dt_kpts)[order]
        dt_scores = np.asarray(dt_scores)[order]
        if gt_ignore is None:
            gt_ignore = np.zeros(G, bool)
        if gt_crowd is None:
            gt_crowd = np.zeros(G, bool)
        gt_ignore = np.asarray(gt_ignore, bool) | np.asarray(gt_crowd, bool)
        ious = (
            oks_matrix(dt_kpts, gt_kpts, gt_areas, self.sigmas, gt_boxes)
            if len(dt_kpts) and G
            else np.zeros((len(dt_kpts), G))
        )
        self._images.append(
            dict(
                ious=ious,
                dt_scores=dt_scores,
                dt_areas=detection_areas(dt_kpts)
                if len(dt_kpts)
                else np.zeros(0),
                gt_areas=np.asarray(gt_areas, np.float64),
                gt_ignore=gt_ignore,
                gt_crowd=np.asarray(gt_crowd, bool),
            )
        )

    def _match_image(
        self, img: dict, lo: float, hi: float
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Protocol-exact greedy matching for one image over all thresholds.

        Returns (tp (T, D), dt_ignore (T, D), dt_scores (D,), n_gt_live).
        GTs out of the area range are treated as ignored; live GTs are
        offered to each detection before ignored ones; a non-crowd GT can be
        taken once while a crowd GT absorbs any number of detections (the
        iscrowd exception); a detection matched to an ignored GT — or left
        unmatched with its own area outside the range — is excluded from
        both TP and FP counts.
        """
        ious = img["ious"]
        D, G = ious.shape
        gt_ig = img["gt_ignore"] | (img["gt_areas"] < lo) | (img["gt_areas"] > hi)
        # live GTs first, ignored last (stable), as the protocol sorts them
        gt_order = np.argsort(gt_ig, kind="stable")
        gt_ig_sorted = gt_ig[gt_order]
        crowd_sorted = img["gt_crowd"][gt_order] if G else img["gt_crowd"]
        ious_s = ious[:, gt_order] if G else ious
        T = len(_THRESHOLDS)
        tp = np.zeros((T, D), bool)
        dt_ig = np.zeros((T, D), bool)
        out_of_range = (img["dt_areas"] < lo) | (img["dt_areas"] > hi)
        # Vectorized greedy matching: thresholds are independent greedy
        # passes, so the t-loop vectorizes wholesale; only the d-loop is
        # inherently sequential (the `taken` state). Because GTs are
        # sorted live-first, the scalar protocol scan reduces per (t, d)
        # to "best live candidate, else best ignored candidate", an
        # argmax with LAST index winning ties (the scalar loop replaces
        # on iou >= best). ~10x over both the per-(t, d) masking and the
        # original triple loop at COCO-like G (scripts/bench_coco_eval.py).
        live = ~gt_ig_sorted
        if G:
            thr0 = np.minimum(_THRESHOLDS, 1 - 1e-10)[:, None]  # (T, 1)
            taken = np.zeros((T, G), bool)
            t_idx = np.arange(T)
            for d in range(D):
                cand = (~taken | crowd_sorted) & (ious_s[d] >= thr0)
                pool = cand & live
                any_live = pool.any(axis=1)
                pool = np.where(any_live[:, None], pool, cand & ~live)
                matched = pool.any(axis=1)
                vals = np.where(pool, ious_s[d], -1.0)
                m = G - 1 - np.argmax(vals[:, ::-1], axis=1)  # last max
                mt, mm = t_idx[matched], m[matched]
                taken[mt, mm] = True
                dt_ig[matched, d] = gt_ig_sorted[mm]
                tp[matched, d] = ~gt_ig_sorted[mm]
                # unmatched detection outside the split's area range is
                # ignored, not a false positive
                dt_ig[~matched, d] = out_of_range[d]
        else:
            dt_ig[:] = out_of_range[None, :]
        n_live = int((~gt_ig).sum())
        return tp, dt_ig, img["dt_scores"], n_live

    def _evaluate_range(self, area_range: tuple[float, float]) -> dict[str, float]:
        lo, hi = area_range
        T = len(_THRESHOLDS)
        all_tp, all_ig, all_scores = [], [], []
        n_gt = 0
        for img in self._images:
            tp, dt_ig, scores, n_live = self._match_image(img, lo, hi)
            all_tp.append(tp)
            all_ig.append(dt_ig)
            all_scores.append(scores)
            n_gt += n_live
        if n_gt == 0:
            return {
                "AP": -1.0, "AP50": -1.0, "AP75": -1.0,
                "AR": -1.0, "AR50": -1.0, "AR75": -1.0,
            }
        tp = np.concatenate(all_tp, axis=1) if all_tp else np.zeros((T, 0), bool)
        ig = np.concatenate(all_ig, axis=1) if all_ig else np.zeros((T, 0), bool)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        # global stable sort by score across the dataset
        order = np.argsort(-scores, kind="stable")
        tp, ig = tp[:, order], ig[:, order]

        aps, ars = [], []
        rec_thrs = np.linspace(0.0, 1.0, 101)
        for t in range(T):
            keep = ~ig[t]
            tps = tp[t][keep]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            recall = tp_cum / n_gt
            precision = tp_cum / (tp_cum + fp_cum + np.spacing(1))
            prec_interp = np.zeros(101)
            if len(precision):
                pr = precision.copy()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                idx = np.searchsorted(recall, rec_thrs, side="left")
                valid = idx < len(pr)
                prec_interp[valid] = pr[idx[valid]]
            aps.append(prec_interp.mean())
            ars.append(recall[-1] if len(recall) else 0.0)
        return {
            "AP": float(np.mean(aps)),
            "AP50": float(aps[0]),
            "AP75": float(aps[5]),
            "AR": float(np.mean(ars)),
            "AR50": float(ars[0]),
            "AR75": float(ars[5]),
        }

    def summarize(self) -> dict[str, float]:
        """All ten COCO keypoint headline stats, matching pycocotools'
        COCOeval stats vector: AP, AP50, AP75, AP_medium, AP_large, AR,
        AR50, AR75, AR_medium, AR_large
        (cross-check: scripts/cross_check_pycocotools.py)."""
        out = self._evaluate_range(_AREA_RANGES["all"])
        med = self._evaluate_range(_AREA_RANGES["medium"])
        lar = self._evaluate_range(_AREA_RANGES["large"])
        out["AP_medium"] = med["AP"]
        out["AP_large"] = lar["AP"]
        out["AR_medium"] = med["AR"]
        out["AR_large"] = lar["AR"]
        return out
