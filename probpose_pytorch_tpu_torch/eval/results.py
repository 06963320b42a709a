"""COCO keypoint-results interchange (a copy of probpose_pytorch_tpu/eval/
results.py, on the port's data/coco.py): dump predictions in the official
results format and re-score a results file against a dataset's ground truth
without re-running the model.

Greenfield subsystem (SURVEY.md §2.4: the reference has no evaluation path
at all). The dump is the standard COCO keypoint-results layout —
``[{"image_id", "category_id", "keypoints": [x1, y1, s1, ...], "score"}]``
— i.e. exactly what ``pycocotools.coco.COCO.loadRes`` consumes, so
framework predictions can be scored by the official COCOeval wherever
pycocotools is installed, submitted to the COCO evaluation server, or
re-scored here offline with `score_results`. The one-shot cross-check of
the in-repo protocol implementation (eval/coco_eval.py) against the real
COCOeval ships as `scripts/cross_check_pycocotools.py` with a committed
fixture pair — one command wherever pycocotools exists.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Any

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import COCO_SIGMAS
from probpose_pytorch_tpu_torch.eval.coco_eval import COCOKeypointEvaluator

__all__ = [
    "keypoint_result",
    "save_results",
    "load_results",
    "score_results",
]


def keypoint_result(
    image_id: int,
    keypoints_xy: np.ndarray,
    keypoint_scores: np.ndarray,
    score: float,
    category_id: int = 1,
) -> dict[str, Any]:
    """One COCO keypoint-results record from frame-space (K, 2) keypoints
    and per-keypoint scores."""
    kp = np.concatenate(
        [
            np.asarray(keypoints_xy, np.float64),
            np.asarray(keypoint_scores, np.float64).reshape(-1, 1),
        ],
        axis=1,
    )
    return {
        "image_id": int(image_id),
        "category_id": int(category_id),
        "keypoints": [round(float(v), 3) for v in kp.reshape(-1)],
        "score": round(float(score), 5),
    }


def save_results(results: list[dict[str, Any]], path: str | Path) -> None:
    Path(path).write_text(json.dumps(results))


def load_results(path: str | Path) -> list[dict[str, Any]]:
    results = json.loads(Path(path).read_text())
    if not isinstance(results, list):
        raise ValueError(f"{path}: expected a JSON list of result records")
    for r in results:
        for k in ("image_id", "keypoints", "score"):
            if k not in r:
                raise ValueError(f"{path}: result record missing '{k}'")
    return results


def score_results(
    results: list[dict[str, Any]],
    dataset: Any,
    sigmas: np.ndarray = COCO_SIGMAS,
) -> dict[str, Any]:
    """Score loaded results against `dataset`'s ground truth (COCO keypoint
    AP/AR), model-free.

    The dataset must expose `records` (frame-space `keypoints` (K, 3),
    `bbox`, `area`, `image_id` — COCOPoseDataset's parse output) and may
    expose `ignores_by_image` (crowds / zero-keypoint instances). GT
    assembly follows eval/pipeline.evaluate_topdown exactly: live instances
    with no labeled keypoints are themselves ignore-regions, and images
    with annotations but no detections still count their false negatives.
    Detections on images absent from the GT are dropped (the protocol
    scores the GT image set).
    """
    gt_by_image: dict[int, list[dict]] = defaultdict(list)
    for rec in dataset.records:
        gt_by_image[int(rec["image_id"])].append(rec)
    ignores_by_image = getattr(dataset, "ignores_by_image", {})

    dt_by_image: dict[int, dict[str, list]] = defaultdict(
        lambda: dict(dt=[], scores=[])
    )
    K = dataset.records[0]["keypoints"].shape[0] if dataset.records else 17
    for r in results:
        image_id = int(r["image_id"])
        if image_id not in gt_by_image and image_id not in ignores_by_image:
            continue
        kp = np.asarray(r["keypoints"], np.float64).reshape(-1, 3)
        if kp.shape[0] != K:
            raise ValueError(
                f"result for image {image_id} has {kp.shape[0]} keypoints, "
                f"dataset has {K}"
            )
        dt_by_image[image_id]["dt"].append(kp)
        dt_by_image[image_id]["scores"].append(float(r["score"]))

    evaluator = COCOKeypointEvaluator(np.asarray(sigmas))
    image_ids = set(gt_by_image) | set(ignores_by_image)
    for image_id in image_ids:
        recs = gt_by_image.get(image_id, [])
        gt = [np.asarray(rec["keypoints"], np.float64) for rec in recs]
        areas = [float(rec["area"]) for rec in recs]
        boxes = [np.asarray(rec["bbox"], np.float64) for rec in recs]
        ignore = [bool((g[:, 2] > 0).sum() == 0) for g in gt]
        crowd = [False] * len(gt)
        for ig in ignores_by_image.get(image_id, []):
            kp = np.asarray(ig["keypoints"], np.float64)
            if kp.shape[0] != K:
                kp = np.zeros((K, 3), np.float64)
            gt.append(kp)
            areas.append(float(ig["area"]))
            boxes.append(np.asarray(ig["bbox"], np.float64))
            ignore.append(True)
            crowd.append(bool(ig["iscrowd"]))
        rec = dt_by_image.get(image_id, dict(dt=[], scores=[]))
        evaluator.add_image(
            np.stack(rec["dt"]) if rec["dt"] else np.zeros((0, K, 3)),
            np.asarray(rec["scores"], np.float64),
            np.stack(gt) if gt else np.zeros((0, K, 3)),
            np.asarray(areas, np.float64),
            np.stack(boxes) if boxes else None,
            gt_ignore=np.asarray(ignore, bool),
            gt_crowd=np.asarray(crowd, bool),
        )
    summary = evaluator.summarize()
    summary["n_results"] = sum(len(v["dt"]) for v in dt_by_image.values())
    summary["n_images"] = len(image_ids)
    return summary
