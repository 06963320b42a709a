"""Streaming COCO val evaluation (port of
probpose_pytorch_tpu/eval/pipeline.py): GT boxes -> crop batches -> batched
pose decode on the predictor's device -> frame-space keypoints -> streaming
AP on the host.

Host loading rides the port's batch_iterator (vectorized `get_batch` for
the COCO loader and the crop cache, a thread pool otherwise) behind a
Prefetcher, so sample decode overlaps device work; the predictor is called
on the caller's thread. The tail batch is left ragged (eager PyTorch has no
fixed program shape to keep); every crop's result depends on that crop
alone, so the summary does not depend on the batch size.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import COCO_KEYPOINT_NAMES, COCO_SIGMAS
from probpose_pytorch_tpu_torch.data.pipeline import Prefetcher, batch_iterator
from probpose_pytorch_tpu_torch.eval.calibration import calibration_report
from probpose_pytorch_tpu_torch.eval.coco_eval import COCOKeypointEvaluator
from probpose_pytorch_tpu_torch.eval.results import keypoint_result

__all__ = ["evaluate_topdown"]


def _limit(dataset: Any, n: int) -> Any:
    """Length-limited view preserving a vectorized get_batch if present."""
    if n >= len(dataset):
        return dataset

    class _View:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return dataset[i]

    if hasattr(dataset, "get_batch"):
        _View.get_batch = staticmethod(dataset.get_batch)
    return _View()


def evaluate_topdown(
    predictor: Any,
    dataset: Any,
    batch_size: int = 32,
    sigmas: np.ndarray = COCO_SIGMAS,
    score_key: str = "scores",
    max_samples: int | None = None,
    num_workers: int = 4,
    prefetch_depth: int = 2,
    verbose: bool = False,
    calibration: bool = False,
    per_joint: bool = False,
    track_instances: bool = False,
    collect_predictions: bool = False,
) -> dict[str, Any]:
    """Run top-down evaluation over a COCO-style crop dataset.

    The dataset must yield samples with `image` (crop), `bbox` (frame-space
    xywh used for the crop), `image_id`, `area`, and frame-space GT implied by
    the crop keypoints. Detections for each image_id are pooled, then fed to
    the streaming evaluator. Datasets exposing `ignores_by_image` (crowds /
    zero-keypoint instances, COCOPoseDataset) have those regions threaded to
    the evaluator so the detections they absorb are not false positives.

    Returns the COCO keypoint summary (AP, AP50, AP75, AP_medium, AP_large,
    AR). With `calibration=True` the summary also carries a `calibration`
    sub-dict: reliability/ECE/Brier/temperature reports for the presence
    probability branch and (when the predictor exposes `visibilities`) the
    visibility branch — see eval/calibration.py. With `per_joint=True` it
    carries a `per_joint` sub-dict: {joint name: {n, EPE, PCK@0.2}} over
    labeled keypoints (COCO-17 names when K == 17, indices otherwise) —
    the standard which-joints-hurt breakdown. With `track_instances=True`
    it carries an `instances` list (one record per GT-matched instance:
    dataset index, image_id, instance-matched OKS, EPE, score, crop-space
    predicted keypoints + probabilities) — the input to
    eval/analysis.dump_worst_cases error triage. With
    `collect_predictions=True` it carries a `predictions` list in the
    official COCO keypoint-results format (eval/results.py) — dump with
    `save_results`, re-score offline with `score_results`, or feed to
    real pycocotools / the COCO evaluation server.
    """
    # Resolve ignore-regions from the original dataset before any view wrap.
    ignores_by_image = getattr(dataset, "ignores_by_image", {})
    if max_samples is not None:
        dataset = _limit(dataset, max_samples)
    n = len(dataset)
    per_image: dict[int, dict[str, list]] = defaultdict(
        lambda: dict(dt=[], scores=[], gt=[], areas=[], boxes=[])
    )
    kp_dists: list[np.ndarray] = []  # per-sample labeled-keypoint errors, px
    kp_norms: list[np.ndarray] = []  # matching bbox normalizers
    kp_joints: list[np.ndarray] = []  # matching joint indices
    # Calibration pairs for the probabilistic branches (labeled kpts only —
    # unlabeled keypoints have no ground truth for either branch).
    cal_presence_p: list[np.ndarray] = []
    cal_presence_y: list[np.ndarray] = []
    cal_vis_p: list[np.ndarray] = []
    cal_vis_y: list[np.ndarray] = []
    instances: list[dict[str, Any]] = []  # track_instances records
    predictions: list[dict[str, Any]] = []  # collect_predictions records
    sig = np.asarray(sigmas, np.float64)

    H, W = predictor.input_size
    batches = Prefetcher(
        batch_iterator(
            dataset,
            batch_size,
            shuffle=False,
            drop_last=False,
            num_workers=num_workers,
        ),
        depth=prefetch_depth,
    )
    t0 = time.perf_counter()
    done = 0
    for batch in batches:
        bs = len(batch["image"])
        crops = batch["image"]
        if bs < batch_size and hasattr(predictor, "buckets"):
            # an exported bundle runs its buckets only: pad the tail
            crops = np.concatenate([crops, np.repeat(crops[-1:], batch_size - bs, axis=0)])
        # The predictor re-crops from frames; here samples are already crops,
        # so feed identity boxes and un-map with the true boxes.
        ident = np.tile(
            np.array([0, 0, W, H], np.float32), (len(crops), 1)
        )
        out = predictor(crops, ident)
        kpts = out["keypoints"][:bs]  # crop space
        scores = out[score_key][:bs]
        probs = out["probabilities"][:bs, 0]
        viss = (
            np.asarray(out["visibilities"])[:bs, 0]
            if calibration and "visibilities" in out
            else None
        )

        for i in range(bs):
            kp, sc, pr = kpts[i], scores[i], probs[i]
            x0, y0, bw, bh = batch["bbox"][i]
            frame_kp = np.empty_like(kp)
            frame_kp[:, 0] = kp[:, 0] / W * bw + x0
            frame_kp[:, 1] = kp[:, 1] / H * bh + y0
            dt = np.concatenate([frame_kp, sc.reshape(-1, 1)], axis=1)
            if "keypoints_frame" in batch:
                # Score against the original annotation: crop-clipped
                # keypoints and the raw 0/1/2 visibility levels intact.
                gt = np.asarray(batch["keypoints_frame"][i], np.float64)
            else:
                src = batch["keypoints"][i]
                gt_xy = np.empty_like(src)
                gt_xy[:, 0] = src[:, 0] / W * bw + x0
                gt_xy[:, 1] = src[:, 1] / H * bh + y0
                gt = np.concatenate(
                    [
                        gt_xy,
                        batch["keypoints_visible"][i].reshape(-1, 1) * 2,
                    ],
                    axis=1,
                )
            rec = per_image[int(batch["image_id"][i])]
            rec["dt"].append(dt)
            # Standard top-down instance score: detector/box confidence is
            # unavailable here, so use mean keypoint score weighted by
            # predicted presence (validated against the COCOeval-protocol
            # oracle in tests/test_coco_protocol.py).
            rec["scores"].append(float(np.mean(sc * pr)))
            if collect_predictions:
                predictions.append(
                    keypoint_result(
                        int(batch["image_id"][i]),
                        frame_kp,
                        sc,
                        float(np.mean(sc * pr)),
                    )
                )
            rec["gt"].append(gt)
            rec["areas"].append(float(batch["area"][i]))
            rec["boxes"].append(
                np.asarray(
                    batch.get("bbox_frame", batch["bbox"])[i], np.float64
                )
            )
            # Instance-matched keypoint errors (the crop dataset is
            # GT-box-driven, so det i IS gt i): feeds EPE / PCK / AUC.
            labeled = gt[:, 2] > 0
            if labeled.any():
                d = np.linalg.norm(
                    frame_kp[labeled] - gt[labeled, :2], axis=-1
                )
                kp_dists.append(d)
                kp_norms.append(
                    np.full(len(d), max(float(bw), float(bh), 1.0))
                )
                kp_joints.append(np.nonzero(labeled)[0])
                if track_instances:
                    # Instance-matched OKS vs this crop's own GT (the COCO
                    # per-pair kernel: e = d^2 / (2*(2 sigma)^2 * area)).
                    var = (2.0 * sig[labeled]) ** 2
                    area = max(float(batch["area"][i]), np.spacing(1))
                    e = (d.astype(np.float64) ** 2) / (2.0 * var * area)
                    instances.append(dict(
                        index=done + i,
                        image_id=int(batch["image_id"][i]),
                        oks=float(np.exp(-e).mean()),
                        epe=float(d.mean()),
                        score=float(np.mean(sc * pr)),
                        pred=np.asarray(kp, np.float64),
                        probs=np.asarray(pr, np.float64),
                    ))
            if calibration and labeled.any():
                # Presence branch: trained against the codec's in_image
                # (keypoint inside the crop region); here the crop region
                # is the frame-space bbox the crop was resampled from.
                in_crop = (
                    (gt[labeled, 0] >= x0)
                    & (gt[labeled, 0] < x0 + bw)
                    & (gt[labeled, 1] >= y0)
                    & (gt[labeled, 1] < y0 + bh)
                )
                cal_presence_p.append(np.asarray(pr)[labeled])
                cal_presence_y.append(in_crop.astype(np.float64))
                if viss is not None:
                    # Visibility branch: COCO v == 2 (visible) among
                    # labeled keypoints.
                    cal_vis_p.append(np.asarray(viss[i])[labeled])
                    cal_vis_y.append(
                        (gt[labeled, 2] >= 2).astype(np.float64)
                    )
        done += bs
        if verbose and done % (batch_size * 16) < batch_size:
            dt_s = time.perf_counter() - t0
            print(
                f"[eval] {done}/{n} crops, {done / dt_s:.0f} crops/s",
                flush=True,
            )
    if verbose:
        dt_s = time.perf_counter() - t0
        print(
            f"[eval] stream done: {done} crops in {dt_s:.1f}s "
            f"({done / max(dt_s, 1e-9):.0f} crops/s incl. kernel builds)",
            flush=True,
        )

    evaluator = COCOKeypointEvaluator(np.asarray(sigmas))
    for image_id, rec in per_image.items():
        gt = np.stack(rec["gt"])
        areas = list(rec["areas"])
        boxes = list(rec["boxes"])
        # Live instances with no labeled keypoints are themselves
        # ignore-regions, not targets.
        ignore = list((gt[:, :, 2] > 0).sum(axis=1) == 0)
        crowd = [False] * len(ignore)
        extra = ignores_by_image.get(image_id, [])
        if extra:
            K = gt.shape[1]
            pads = []
            for ig in extra:
                kp = np.asarray(ig["keypoints"], np.float64)
                if kp.shape[0] != K:  # category mismatch; pad/trim
                    kp = np.zeros((K, 3), np.float64)
                pads.append(kp)
                areas.append(float(ig["area"]))
                boxes.append(np.asarray(ig["bbox"], np.float64))
                ignore.append(True)
                crowd.append(bool(ig["iscrowd"]))
            gt = np.concatenate([gt, np.stack(pads)], axis=0)
        evaluator.add_image(
            np.stack(rec["dt"]),
            np.asarray(rec["scores"]),
            gt,
            np.asarray(areas),
            np.stack(boxes),
            gt_ignore=np.asarray(ignore, bool),
            gt_crowd=np.asarray(crowd, bool),
        )
    summary = evaluator.summarize()
    if kp_dists:
        # Instance-matched auxiliary metrics (MMPose-style): EPE in frame
        # pixels; PCK@0.2 with the bbox long side as the normalizer; AUC =
        # mean normalized PCK over thresholds 0..0.5 (51 steps).
        d = np.concatenate(kp_dists)
        norm = np.concatenate(kp_norms)
        rel = d / norm
        summary["EPE"] = float(d.mean())
        summary["PCK@0.2"] = float((rel <= 0.2).mean())
        ts = np.linspace(0.0, 0.5, 51)
        summary["AUC"] = float((rel[None, :] <= ts[:, None]).mean())
        if per_joint:
            joints = np.concatenate(kp_joints)
            # K from the GT rows (joints.max() would undercount when the
            # highest-index joints are never labeled in this split); `gt`
            # is bound — kp_dists non-empty means the batch loop ran.
            n_joints = gt.shape[1]
            names = (
                COCO_KEYPOINT_NAMES if n_joints == 17 else
                tuple(str(k) for k in range(n_joints))
            )
            per: dict[str, dict[str, float]] = {}
            for k in range(n_joints):
                m = joints == k
                if not m.any():
                    continue
                per[names[k]] = {
                    "n": int(m.sum()),
                    "EPE": float(d[m].mean()),
                    "PCK@0.2": float((rel[m] <= 0.2).mean()),
                }
            summary["per_joint"] = per
    if calibration:
        cal: dict[str, Any] = {}
        if cal_presence_p:
            cal["presence"] = calibration_report(
                np.concatenate(cal_presence_p), np.concatenate(cal_presence_y)
            )
        if cal_vis_p:
            cal["visibility"] = calibration_report(
                np.concatenate(cal_vis_p), np.concatenate(cal_vis_y)
            )
        summary["calibration"] = cal
    if track_instances:
        summary["instances"] = instances
    if collect_predictions:
        summary["predictions"] = predictions
    return summary
