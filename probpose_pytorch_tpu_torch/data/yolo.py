"""YOLO-pose annotation parsing and dataset (copy of the host code of
probpose_pytorch_tpu/data/yolo.py, which the port cannot import).

The reference's visibility quirk is kept: v == 1 is promoted to 2, so
`keypoints_visible` is v == 2 and `keypoints_visibility` is min(v, 1).
PIL is imported where an image is read.
"""

from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import native_unported
from probpose_pytorch_tpu_torch.data.pipeline import _collate

__all__ = ["parse_yolo_annotations", "YOLOPoseDataset"]

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _image_size(path: Path) -> tuple[int, int]:
    """(width, height) from the image header only (no full decode)."""
    import PIL.Image

    with PIL.Image.open(path) as im:
        return im.size


def parse_yolo_annotations(
    split_folder: Path | str,
    target_single_class: int | None = None,
) -> list[dict[str, Any]]:
    """Parse a YOLO-pose split (images/ + labels/ with
    `cls xc yc w h (x y v)*` rows, normalized) into absolute-pixel records:
    {image_path, category_id, bbox xywh, keypoints (K, 3)}."""
    split_folder = Path(split_folder)
    records: list[dict[str, Any]] = []
    image_dir = split_folder / "images"
    label_dir = split_folder / "labels"
    for image_path in sorted(image_dir.iterdir()):
        if image_path.suffix.lower() not in _IMG_EXTS:
            continue
        label_path = label_dir / image_path.with_suffix(".txt").name
        if not label_path.exists():
            continue
        width, height = _image_size(image_path)
        for line in label_path.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            cls = int(parts[0])
            if target_single_class is not None and cls != target_single_class:
                continue
            xc, yc, bw, bh = (float(v) for v in parts[1:5])
            kps = []
            for j in range(5, len(parts), 3):
                v = int(float(parts[j + 2]))
                if v == 1:  # promote "labeled but occluded" to visible
                    v = 2
                kps.append((float(parts[j]) * width, float(parts[j + 1]) * height, v))
            records.append(dict(
                image_path=str(image_path),
                category_id=0,
                bbox=np.array([(xc - bw / 2) * width, (yc - bh / 2) * height,
                               bw * width, bh * height], np.float32),
                keypoints=np.asarray(kps, np.float32),
            ))
    return records


@dataclass
class YOLOPoseDataset:
    """Host-side dataset of crop samples: image (H, W, 3) uint8 crop,
    keypoints (K, 2) in crop space, keypoints_visible / _visibility (K,)."""

    root: Path | str
    split: str
    input_size: tuple[int, int]  # (H, W)
    target_single_class: int | None = None
    resample: str = "lanczos"

    def __post_init__(self):
        if self.resample == "native":
            raise native_unported()
        self.records = parse_yolo_annotations(Path(self.root) / self.split,
                                              self.target_single_class)

    def __len__(self) -> int:
        return len(self.records)

    def _labels(self, rec) -> dict[str, np.ndarray]:
        H, W = self.input_size
        x0, y0, bw, bh = rec["bbox"]
        kps = rec["keypoints"].copy()
        xy = kps[:, :2]
        xy[:, 0] = (xy[:, 0] - x0) / bw * W
        xy[:, 1] = (xy[:, 1] - y0) / bh * H
        v = kps[:, 2]
        return dict(
            keypoints=xy.astype(np.float32),
            keypoints_visible=(v == 2).astype(np.float32),
            keypoints_visibility=np.minimum(v, 1).astype(np.float32),
        )

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        import PIL.Image

        rec = self.records[idx]
        H, W = self.input_size
        x0, y0, bw, bh = rec["bbox"]
        with PIL.Image.open(rec["image_path"]) as im:
            im = im.convert("RGB")
            crop = im.crop((x0, y0, x0 + bw, y0 + bh)).resize(
                (W, H),
                PIL.Image.LANCZOS if self.resample == "lanczos" else PIL.Image.BILINEAR,
            )
        return dict(image=np.asarray(crop, np.uint8), **self._labels(rec))

    def get_batch(self, indices) -> dict[str, np.ndarray]:
        """The samples of `indices`, read in a thread pool and collated."""
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            return _collate(list(pool.map(self.__getitem__, [int(i) for i in indices])))
