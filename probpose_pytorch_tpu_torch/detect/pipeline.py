"""Detector serving and the standalone end-to-end pipeline (port of
probpose_pytorch_tpu/detect/pipeline.py): frame -> person boxes ->
top-down pose -> COCO AP, and the single-stage (bottom-up) family.

On the model's device, per batch of frames of one size: the full-frame
resize to the detector's input (`crop_resize`, "bilinear_matmul"), the
forward, the peak decode and the un-mapping to frame pixels; the outputs
stay there until read. Score thresholding and the box handoff run on the
host, where shapes are free.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from probpose_pytorch_tpu_torch.data.coco import COCO_SIGMAS, expand_bbox, parse_coco_annotations
from probpose_pytorch_tpu_torch.detect.codec import decode_boxes, decode_poses
from probpose_pytorch_tpu_torch.detect.model import PersonDetector
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize
from probpose_pytorch_tpu_torch.parallel.collectives import all_gather_cat
from probpose_pytorch_tpu_torch.parallel.mesh import mesh_shape
from probpose_pytorch_tpu_torch.parallel.sharding import shard_batch

__all__ = [
    "DetectorPredictor",
    "BottomUpPredictor",
    "expand_detections",
    "box_iou_matrix",
    "detection_pr",
    "evaluate_detector_topdown",
    "evaluate_bottomup",
]


def full_frame_boxes(frames: torch.Tensor) -> torch.Tensor:
    """(B, 4) boxes [0, 0, Wf, Hf] made on the frames' device: filled there,
    with no host-to-device copy (which would block the host)."""
    B, Hf, Wf, _ = frames.shape
    full = torch.zeros(B, 4, dtype=torch.float32, device=frames.device)
    full[:, 2], full[:, 3] = Wf, Hf
    return full


def scale_xy(t: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """(..., 2m) xy pairs times (sx, sy): each a float32 product, as JAX's
    product with the f32 array [sx, sy, ...], with no host-to-device copy."""
    xy = t.unflatten(-1, (-1, 2))
    return torch.stack([xy[..., 0] * sx, xy[..., 1] * sy], dim=-1).flatten(-2)


def _forward(model: PersonDetector, frames: torch.Tensor) -> tuple[dict, float, float]:
    """frames (B, Hf, Wf, 3) uint8 on the model's device -> (the model's maps
    on the whole frames resized to its input, Wf / Wd, Hf / Hd)."""
    _, Hf, Wf, _ = frames.shape
    Hd, Wd = model.img_size
    imgs = crop_resize(frames, full_frame_boxes(frames), (Hd, Wd), "bilinear_matmul")
    return model(imgs), Wf / Wd, Hf / Hd


def _download(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.float().cpu().numpy() for k, v in out.items()}


class _FramePredictor:
    """What both predictors share: the model in eval mode on its device,
    frames uploaded to it and the model's maps of them. On a `mesh` (JAX's
    `_device_frames`, detect/pipeline.py:38-52 there) every rank is called
    with the same frames, pads them with zero frames to a multiple of the
    data axis, runs its rows and gathers the maps over the data axis before
    the one decode; the weights are whole on every rank."""

    def __post_init__(self):
        self.model.eval()

    def _maps(self, frames: torch.Tensor):
        """(the model's maps of every frame, Wf / Wd, Hf / Hd)."""
        if self.mesh is None:
            return _forward(self.model, frames)
        n, dp = frames.shape[0], mesh_shape(self.mesh)["data"]
        if n % dp:
            frames = torch.cat([frames, frames.new_zeros((dp - n % dp, *frames.shape[1:]))])
        pred, sx, sy = _forward(self.model, shard_batch(frames, self.mesh))
        group = self.mesh.get_group("data")
        return {k: all_gather_cat(v, group)[:n] for k, v in pred.items()}, sx, sy

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(frames, np.uint8)).to(self.device)


@dataclasses.dataclass
class DetectorPredictor(_FramePredictor):
    """Batched frames -> person boxes: the full-frame resize, the forward
    and the top-k peak decode on the model's device, boxes mapped back to
    frame pixels."""

    model: PersonDetector
    score_threshold: float = 0.3
    max_detections: int = 64
    mesh: Any = None  # data-parallel serving (_FramePredictor)

    @torch.inference_mode()
    def predict(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """frames (B, Hf, Wf, 3) uint8 already on the model's device ->
        (boxes (B, k, 4), scores (B, k)) there, frame pixels,
        score-descending, unthresholded; no host synchronisation."""
        pred, sx, sy = self._maps(frames)
        boxes, scores = decode_boxes(pred["center"], pred["size"], pred["offset"],
                                     k=self.max_detections, stride=self.model.out_stride)
        return scale_xy(boxes, sx, sy), scores

    def __call__(self, frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """frames (B, H, W, 3) uint8 -> (boxes (B, k, 4), scores (B, k)) in
        frame pixels, score-descending, unthresholded."""
        boxes, scores = self.predict(self._upload(frames))
        return boxes.cpu().numpy(), scores.cpu().numpy()

    def detect_frame(self, frame: np.ndarray,
                     score_threshold: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One frame -> (boxes (n, 4), scores (n,)) above the threshold."""
        thr = self.score_threshold if score_threshold is None else score_threshold
        boxes, scores = self(np.asarray(frame)[None])
        keep = scores[0] >= thr
        return boxes[0][keep], scores[0][keep]


@dataclasses.dataclass
class BottomUpPredictor(_FramePredictor):
    """Single-stage multi-person pose: batched frames -> every person's pose
    in one forward (the objects-as-points decode, detect/codec.py:
    decode_poses; with joint heat heads the joints snap to heat peaks and
    carry their own confidences)."""

    model: PersonDetector
    score_threshold: float = 0.3
    max_detections: int = 32
    mesh: Any = None  # data-parallel serving (_FramePredictor)

    @torch.inference_mode()
    def predict(self, frames: torch.Tensor) -> dict[str, torch.Tensor]:
        """frames on the model's device -> dict of boxes (B, k, 4), scores
        (B, k), keypoints (B, k, Kj, 2), keypoint_scores (B, k, Kj) there,
        frame pixels, score-descending, unthresholded."""
        pred, sx, sy = self._maps(frames)
        boxes, scores, poses, kscores = decode_poses(
            pred["center"], pred["size"], pred["offset"], pred["kpts"],
            k=self.max_detections, stride=self.model.out_stride,
            kpt_heat=pred.get("kpt_heat"), kpt_offset=pred.get("kpt_offset"))
        return dict(boxes=scale_xy(boxes, sx, sy), scores=scores,
                    keypoints=scale_xy(poses, sx, sy), keypoint_scores=kscores)

    def dispatch(self, frames: np.ndarray) -> dict[str, torch.Tensor]:
        """Upload frames (B, H, W, 3) uint8 and launch; the outputs stay on
        the device, still being computed (the server's completion thread
        reads them back)."""
        return self.predict(self._upload(frames))

    def __call__(self, frames: np.ndarray) -> tuple[np.ndarray, ...]:
        """frames -> (boxes, scores, poses, keypoint_scores) as numpy."""
        out = _download(self.dispatch(frames))
        return out["boxes"], out["scores"], out["keypoints"], out["keypoint_scores"]

    def predict_frame(self, frame: np.ndarray,
                      score_threshold: float | None = None) -> dict[str, np.ndarray]:
        """One frame -> dict(keypoints (n, Kj, 2), scores (n,), boxes (n, 4),
        keypoint_scores (n, Kj)) above the threshold, frame pixels."""
        thr = self.score_threshold if score_threshold is None else score_threshold
        boxes, scores, poses, kscores = self(np.asarray(frame)[None])
        keep = scores[0] >= thr
        return dict(keypoints=poses[0][keep], scores=scores[0][keep], boxes=boxes[0][keep],
                    keypoint_scores=kscores[0][keep])


def expand_detections(det_boxes: np.ndarray, input_size: tuple[int, int],
                      bbox_scale: float = 1.25) -> np.ndarray:
    """Detector boxes -> pose crop boxes: each padded to the pose input's
    aspect and expanded by `bbox_scale` about its center (`expand_bbox`, the
    conditioning pose training used); zero-size detections floor at 1 px.
    (n, 4) xywh in and out."""
    det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
    if len(det_boxes) == 0:
        return np.zeros((0, 4), np.float32)
    det_boxes = det_boxes.copy()
    det_boxes[:, 2:] = np.maximum(det_boxes[:, 2:], 1.0)
    H, W = input_size
    return np.stack([expand_bbox(b, scale=bbox_scale, aspect=W / H)
                     for b in det_boxes]).astype(np.float32)


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between xywh box sets a (N, 4) and b (M, 4) -> (N, M)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    ix = np.maximum(np.minimum((a[:, 0] + a[:, 2])[:, None], (b[:, 0] + b[:, 2])[None])
                    - np.maximum(a[:, 0][:, None], b[:, 0][None]), 0.0)
    iy = np.maximum(np.minimum((a[:, 1] + a[:, 3])[:, None], (b[:, 1] + b[:, 3])[None])
                    - np.maximum(a[:, 1][:, None], b[:, 1][None]), 0.0)
    inter = ix * iy
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-12)


def detection_pr(images: list[dict], iou_threshold: float = 0.5) -> dict[str, float]:
    """Single-class detection AP and recall at one IoU threshold.

    images: [{dt_boxes (D, 4), dt_scores (D,), gt_boxes (G, 4),
    ignore_boxes (I, 4)}]. Greedy score-descending matching; a detection
    covering an ignore region by `iou_threshold` of its own area is neither
    TP nor FP. AP is the area under the all-point interpolated curve."""
    rows = []  # (score, is_tp)
    n_gt = 0
    for im in images:
        dt = np.asarray(im["dt_boxes"], np.float64).reshape(-1, 4)
        sc = np.asarray(im["dt_scores"], np.float64).reshape(-1)
        gt = np.asarray(im["gt_boxes"], np.float64).reshape(-1, 4)
        ig = np.asarray(im.get("ignore_boxes", np.zeros((0, 4))), np.float64).reshape(-1, 4)
        n_gt += len(gt)
        ious = box_iou_matrix(dt, gt) if len(dt) and len(gt) else None
        taken = np.zeros(len(gt), bool)
        for d in np.argsort(-sc, kind="stable"):
            if ious is not None and (~taken).any():
                cand = np.where(~taken, ious[d], -1.0)
                g = int(np.argmax(cand))
                if cand[g] >= iou_threshold:
                    taken[g] = True
                    rows.append((sc[d], 1))
                    continue
            absorbed = False
            if len(ig):
                box = dt[d]
                ix = np.maximum(np.minimum(box[0] + box[2], ig[:, 0] + ig[:, 2])
                                - np.maximum(box[0], ig[:, 0]), 0)
                iy = np.maximum(np.minimum(box[1] + box[3], ig[:, 1] + ig[:, 3])
                                - np.maximum(box[1], ig[:, 1]), 0)
                absorbed = bool(((ix * iy) / max(box[2] * box[3], 1e-12)
                                 >= iou_threshold).any())
            if not absorbed:
                rows.append((sc[d], 0))
    if not rows or n_gt == 0:
        return dict(ap=0.0, recall=0.0, n_gt=n_gt, n_dt=len(rows))
    rows.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in rows])
    fp = np.cumsum([1 - r[1] for r in rows])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    ap, prev_r = 0.0, 0.0
    for r, p in zip(recall, prec_env):
        ap += (r - prev_r) * p
        prev_r = r
    return dict(ap=float(ap), recall=float(recall[-1]), n_gt=int(n_gt), n_dt=len(rows))


def _eval_images(annotation_file, image_root, max_images) -> Iterator[tuple]:
    """(index, image count, frame, gts, igs) of each val image with a ground
    truth or an ignore record, in image-id order."""
    import PIL.Image

    records, ignores = parse_coco_annotations(annotation_file, image_root, include_ignore=True)
    gt_by_image: dict[int, list] = defaultdict(list)
    for rec in records:
        gt_by_image[int(rec["image_id"])].append(rec)
    ignores_by_image: dict[int, list] = defaultdict(list)
    for rec in ignores:
        ignores_by_image[int(rec["image_id"])].append(rec)
    raw = json.loads(Path(annotation_file).read_text())
    images = sorted(raw["images"], key=lambda im: im["id"])
    if max_images is not None:
        images = images[:max_images]
    for n_done, im in enumerate(images):
        gts = gt_by_image.get(int(im["id"]), [])
        igs = ignores_by_image.get(int(im["id"]), [])
        if not gts and not igs:
            continue
        frame = np.asarray(PIL.Image.open(Path(image_root) / im["file_name"]).convert("RGB"),
                           np.uint8)
        yield n_done, len(images), frame, gts, igs


def _det_record(dt_boxes, dt_scores, gts, igs) -> dict:
    return dict(dt_boxes=dt_boxes, dt_scores=dt_scores,
                gt_boxes=np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
                ignore_boxes=np.asarray([g["bbox"] for g in igs], np.float64).reshape(-1, 4))


def _add_image(evaluator, dts: list, scores: list, gts: list, igs: list, K: int | None,
               gt_dtype: type = np.float64) -> None:
    """One image into the evaluator: the ground truths (in `gt_dtype`, as
    each JAX function stacks them), then each ignore record as an ignored
    (crowd where flagged) ground truth."""
    Kk = K if K is not None else len(igs[0]["keypoints"]) if igs else 17
    gt = (np.stack([g["keypoints"] for g in gts]).astype(gt_dtype) if gts
          else np.zeros((0, Kk, 3)))
    areas = [float(g["area"]) for g in gts]
    boxes = [np.asarray(g["bbox"], np.float64) for g in gts]
    ignore = list((gt[:, :, 2] > 0).sum(axis=1) == 0) if gts else []
    crowd = [False] * len(ignore)
    for ig in igs:
        kp = np.asarray(ig["keypoints"], np.float64)
        if kp.shape[0] != Kk:
            kp = np.zeros((Kk, 3), np.float64)
        gt = np.concatenate([gt, kp[None]], axis=0)
        areas.append(float(ig["area"]))
        boxes.append(np.asarray(ig["bbox"], np.float64))
        ignore.append(True)
        crowd.append(bool(ig["iscrowd"]))
    evaluator.add_image(
        np.stack(dts) if dts else np.zeros((0, gt.shape[1], 3)), np.asarray(scores), gt,
        np.asarray(areas), np.stack(boxes) if boxes else None,
        gt_ignore=np.asarray(ignore, bool), gt_crowd=np.asarray(crowd, bool))


def evaluate_detector_topdown(
    pose_predictor: Any,
    detector: DetectorPredictor,
    annotation_file: str | Path,
    image_root: str | Path,
    bbox_scale: float = 1.25,
    score_threshold: float | None = None,
    max_images: int | None = None,
    nms: str | None = None,
    sigmas: np.ndarray | None = None,
    verbose: bool = False,
) -> dict[str, float]:
    """COCO keypoint AP with the detector's boxes (the real protocol; the
    GT-box path, eval/pipeline.py, isolates pose quality). Per val image:
    detect, expand each box to the pose crop (`expand_detections`),
    `predict_frame`, instance score = det score x mean(keypoint score x
    presence), the streaming evaluator with the ignore machinery. Also the
    detector's box AP@0.5 (`det_ap50`), recall and detections per image."""
    from probpose_pytorch_tpu_torch.eval.coco_eval import COCOKeypointEvaluator

    evaluator = COCOKeypointEvaluator(np.asarray(COCO_SIGMAS if sigmas is None else sigmas))
    det_images = []
    K = None
    for n_done, n_images, frame, gts, igs in _eval_images(annotation_file, image_root,
                                                          max_images):
        det_boxes, det_scores = detector.detect_frame(frame, score_threshold)
        det_images.append(_det_record(det_boxes, det_scores, gts, igs))
        if K is None and gts:
            K = gts[0]["keypoints"].shape[0]
        dts, scores = [], []
        if len(det_boxes):
            crops = expand_detections(det_boxes, pose_predictor.input_size, bbox_scale)
            out = pose_predictor.predict_frame(frame, crops, nms=nms)
            if nms is not None and "keep" in out:
                det_scores = det_scores[out["keep"]]
            kpts, sc, pr = out["keypoints"], out["scores"], out["probabilities"][:, 0]
            for j in range(len(kpts)):
                dts.append(np.concatenate([kpts[j], sc[j].reshape(-1, 1)], axis=1))
                scores.append(float(det_scores[j]) * float(np.mean(sc[j] * pr[j])))
        _add_image(evaluator, dts, scores, gts, igs, K, np.float32)
        if verbose and (n_done + 1) % 25 == 0:
            print(f"[detect-eval] {n_done + 1}/{n_images} images", flush=True)
    summary = evaluator.summarize()
    det = detection_pr(det_images)
    summary["det_ap50"] = det["ap"]
    summary["det_recall50"] = det["recall"]
    summary["det_per_image"] = det["n_dt"] / max(len(det_images), 1)
    return summary


def evaluate_bottomup(
    predictor: BottomUpPredictor,
    annotation_file: str | Path,
    image_root: str | Path,
    score_threshold: float | None = None,
    max_images: int | None = None,
    sigmas: np.ndarray | None = None,
    verbose: bool = False,
) -> dict[str, float]:
    """COCO keypoint AP of the single-stage family: one forward per frame
    gives every pose. Ground truths and ignores as in
    `evaluate_detector_topdown`; each joint carries its keypoint score and
    the instance score is center score x mean(keypoint scores). Also the
    center head's box AP@0.5 (`det_ap50`) and recall."""
    from probpose_pytorch_tpu_torch.eval.coco_eval import COCOKeypointEvaluator

    evaluator = COCOKeypointEvaluator(np.asarray(COCO_SIGMAS if sigmas is None else sigmas))
    det_images = []
    K = None
    for n_done, n_images, frame, gts, igs in _eval_images(annotation_file, image_root,
                                                          max_images):
        out = predictor.predict_frame(frame, score_threshold)
        det_images.append(_det_record(out["boxes"], out["scores"], gts, igs))
        if K is None and gts:
            K = gts[0]["keypoints"].shape[0]
        dts, scores = [], []
        js = out.get("keypoint_scores")
        for j in range(len(out["keypoints"])):
            s = float(out["scores"][j])
            if js is not None:
                col = np.asarray(js[j], np.float64).reshape(-1, 1)
                inst = s * float(np.mean(js[j]))
            else:
                col = np.full((out["keypoints"].shape[1], 1), s)
                inst = s
            dts.append(np.concatenate([out["keypoints"][j], col], axis=1))
            scores.append(inst)
        _add_image(evaluator, dts, scores, gts, igs, K)
        if verbose and (n_done + 1) % 25 == 0:
            print(f"[bottomup-eval] {n_done + 1}/{n_images} images", flush=True)
    summary = evaluator.summarize()
    det = detection_pr(det_images)
    summary["det_ap50"] = det["ap"]
    summary["det_recall50"] = det["recall"]
    return summary
