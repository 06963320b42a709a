"""COCO person-keypoint loading (copy of the host code of
probpose_pytorch_tpu/data/coco.py, which the port cannot import).

Pure-json parsing, no pycocotools: the records have the same schema as the
YOLO parser's, so the rest of the pipeline is format-agnostic. PIL is
imported where an image is read.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from probpose_pytorch_tpu_torch.data.pipeline import _collate

__all__ = [
    "parse_coco_annotations",
    "expand_bbox",
    "COCOPoseDataset",
    "COCO_SIGMAS",
    "COCO_KEYPOINT_NAMES",
    "native_crops",
]

# The 17 COCO person keypoints, protocol order.
COCO_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

# The 17 COCO keypoint sigmas (person category), as published with the
# COCO keypoint evaluation protocol.
COCO_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ],
    np.float32,
)


def native_crops(paths, boxes, size: tuple[int, int]) -> np.ndarray:
    """(n, H, W, 3) uint8 crops of the images at `paths` for xywh `boxes`
    through the native data plane (native/dataplane.cpp), as JAX's loaders
    read with resample="native": the JPEG files decoded and cropped in one
    threaded native call, the others decoded by PIL and cropped by the
    native resampler, so every crop has the device's "bilinear_gather"
    sampling convention."""
    import PIL.Image

    from probpose_pytorch_tpu_torch import native

    if not native.native_available():
        raise RuntimeError(
            "resample='native' requires the C++ data plane (native/dataplane.cpp, "
            f"built at first use with g++): {native.build_report().get('reason')}")
    H, W = size
    out = np.empty((len(paths), H, W, 3), np.uint8)
    jpeg_pos, bufs, jboxes = [], [], []
    for j, (path, box) in enumerate(zip(paths, boxes)):
        path = Path(path)
        if path.suffix.lower() in (".jpg", ".jpeg"):
            jpeg_pos.append(j)
            bufs.append(path.read_bytes())
            jboxes.append(box)
        else:
            with PIL.Image.open(path) as im:
                frame = np.asarray(im.convert("RGB"), np.uint8)
            out[j] = native.crop_resize_batch(frame[None], np.asarray([box], np.float32),
                                              (H, W))[0]
    if jpeg_pos:
        crops, _failed = native.decode_crop_resize_batch(bufs, np.asarray(jboxes, np.float32),
                                                         (H, W))
        out[jpeg_pos] = crops
    return out


def parse_coco_annotations(
    annotation_file: str | Path,
    image_root: str | Path,
    min_keypoints: int = 1,
    include_ignore: bool = False,
) -> Any:
    """Parse a COCO person-keypoints JSON into crop records:
    {image_path, category_id, bbox xywh, keypoints (K, 3), image_id, ann_id,
    area}.

    `iscrowd` and sub-`min_keypoints` annotations are not pose targets but
    ignore-regions of the COCO protocol. With include_ignore=True, returns
    (records, ignore_records); ignore records carry {image_id, bbox, area,
    iscrowd, keypoints}.
    """
    raw = json.loads(Path(annotation_file).read_text())
    images = {im["id"]: im for im in raw["images"]}
    records, ignores = [], []
    for ann in raw["annotations"]:
        kps_flat = ann.get("keypoints")
        if ann.get("iscrowd", 0) or ann.get("num_keypoints", 0) < min_keypoints:
            ignores.append(dict(
                image_id=ann["image_id"],
                bbox=np.asarray(ann["bbox"], np.float32),
                area=float(ann.get("area", ann["bbox"][2] * ann["bbox"][3])),
                iscrowd=bool(ann.get("iscrowd", 0)),
                keypoints=(np.asarray(kps_flat, np.float32).reshape(-1, 3)
                           if kps_flat is not None
                           else np.zeros((len(COCO_SIGMAS), 3), np.float32)),
            ))
            continue
        im = images[ann["image_id"]]
        records.append(dict(
            image_path=str(Path(image_root) / im["file_name"]),
            category_id=ann["category_id"],
            bbox=np.asarray(ann["bbox"], np.float32),
            keypoints=np.asarray(kps_flat, np.float32).reshape(-1, 3),
            image_id=ann["image_id"],
            ann_id=ann["id"],
            area=float(ann.get("area", ann["bbox"][2] * ann["bbox"][3])),
        ))
    if include_ignore:
        return records, ignores
    return records


def expand_bbox(bbox: np.ndarray, scale: float = 1.25,
                aspect: float | None = 192 / 256) -> np.ndarray:
    """Top-down box conditioning: pad to the crop aspect ratio and expand
    by `scale` about the center."""
    x, y, w, h = bbox
    cx, cy = x + w / 2, y + h / 2
    if aspect is not None:
        if w / h > aspect:
            h = w / aspect
        else:
            w = h * aspect
    w, h = w * scale, h * scale
    return np.asarray([cx - w / 2, cy - h / 2, w, h], np.float32)


@dataclass
class COCOPoseDataset:
    """Host-side COCO top-down crop dataset: an image crop of the expanded
    box, crop-space keypoints, and the visibility split that keeps
    occlusion (`keypoints_visible` v >= 1, `keypoints_visibility` v == 2)."""

    annotation_file: str | Path
    image_root: str | Path
    input_size: tuple[int, int]  # (H, W)
    bbox_scale: float = 1.25
    min_keypoints: int = 1
    resample: str = "bilinear"

    def __post_init__(self):
        self.records, ignores = parse_coco_annotations(
            self.annotation_file, self.image_root, self.min_keypoints, include_ignore=True)
        # Ignore-regions (crowds, sub-min-keypoint instances) by image, for
        # the evaluation protocol.
        self.ignores_by_image: dict[int, list[dict]] = {}
        for rec in ignores:
            self.ignores_by_image.setdefault(int(rec["image_id"]), []).append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def _labels(self, rec, box) -> dict[str, np.ndarray]:
        H, W = self.input_size
        x0, y0, bw, bh = box
        kps = rec["keypoints"].copy()
        xy = kps[:, :2]
        xy[:, 0] = (xy[:, 0] - x0) / bw * W
        xy[:, 1] = (xy[:, 1] - y0) / bh * H
        v = kps[:, 2]
        return dict(
            keypoints=xy.astype(np.float32),
            keypoints_visible=(v >= 1).astype(np.float32),
            keypoints_visibility=(v == 2).astype(np.float32),
            bbox=np.asarray(box, np.float32),
            image_id=np.int64(rec["image_id"]),
            area=np.float32(rec["area"]),
            # The annotation in frame space with its raw v, for evaluation.
            keypoints_frame=rec["keypoints"].astype(np.float32),
            bbox_frame=np.asarray(rec["bbox"], np.float32),
        )

    def get_batch(self, indices) -> dict[str, np.ndarray]:
        """The samples of `indices`, read in a thread pool and collated;
        with resample="native", decoded and cropped by the native data plane
        (`native_crops`) in one call."""
        indices = [int(i) for i in indices]
        if self.resample != "native":
            with cf.ThreadPoolExecutor(max_workers=8) as pool:
                return _collate(list(pool.map(self.__getitem__, indices)))
        H, W = self.input_size
        recs = [self.records[i] for i in indices]
        boxes = [expand_bbox(rec["bbox"], self.bbox_scale, W / H) for rec in recs]
        image = native_crops([rec["image_path"] for rec in recs], boxes, (H, W))
        labels = [self._labels(rec, box) for rec, box in zip(recs, boxes)]
        return dict(image=image, **{k: np.stack([lb[k] for lb in labels]) for k in labels[0]})

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        import PIL.Image

        if self.resample == "native":
            return {k: v[0] for k, v in self.get_batch([idx]).items()}
        rec = self.records[idx]
        H, W = self.input_size
        box = expand_bbox(rec["bbox"], self.bbox_scale, W / H)
        x0, y0, bw, bh = box
        with PIL.Image.open(rec["image_path"]) as im:
            im = im.convert("RGB")
            crop = im.crop((x0, y0, x0 + bw, y0 + bh)).resize(
                (W, H),
                PIL.Image.LANCZOS if self.resample == "lanczos" else PIL.Image.BILINEAR,
            )
        return dict(image=np.asarray(crop, np.uint8), **self._labels(rec, box))
