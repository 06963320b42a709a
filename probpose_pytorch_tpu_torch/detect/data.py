"""Frame-level detection dataset (port of probpose_pytorch_tpu/detect/data.py):
COCO-format annotations grouped per image.

Every person box is kept, and the crowd and zero-keypoint records become
ignore regions (no negative loss there; detect/loss.py). The host decodes
the frame and pads the box lists to fixed (M, Mi); the resize to the
detector's input happens on the device in the train step.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import parse_coco_annotations

__all__ = ["FrameDetectionDataset"]


def _pad(rows: list, m: int) -> tuple[np.ndarray, np.ndarray]:
    out = np.zeros((m, 4), np.float32)
    msk = np.zeros((m,), np.float32)
    n = min(len(rows), m)
    if n:
        out[:n] = np.stack(rows[:n])
        msk[:n] = 1.0
    return out, msk


@dataclass
class FrameDetectionDataset:
    """One item per image: {frame (H, W, 3) uint8, boxes (M, 4) xywh,
    box_mask (M,), ignore_boxes (Mi, 4), ignore_mask (Mi,), image_id} in
    native frame pixels; with `num_keypoints` K > 0 also `keypoints`
    (M, K, 3) aligned with `boxes`."""

    annotation_file: str | Path
    image_root: str | Path
    max_boxes: int = 16
    max_ignore: int = 8
    num_keypoints: int = 0
    image_ids: list = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        records, ignores = parse_coco_annotations(self.annotation_file, self.image_root,
                                                  include_ignore=True)
        by_image: dict[int, dict] = {}
        for rec in records:
            e = by_image.setdefault(int(rec["image_id"]),
                                    dict(path=rec["image_path"], boxes=[], kpts=[], ignores=[]))
            e["boxes"].append(np.asarray(rec["bbox"], np.float32))
            e["kpts"].append(np.asarray(rec["keypoints"], np.float32))
        # Ignore records carry no image path (their image may hold no
        # positive instance): take it from the image table.
        raw = json.loads(Path(self.annotation_file).read_text())
        paths = {int(im["id"]): str(Path(self.image_root) / im["file_name"])
                 for im in raw["images"]}
        for rec in ignores:
            iid = int(rec["image_id"])
            e = by_image.setdefault(iid, dict(path=paths[iid], boxes=[], kpts=[], ignores=[]))
            e["ignores"].append(np.asarray(rec["bbox"], np.float32))
        if self.image_ids is None:
            self.image_ids = sorted(by_image)
        self._by_image = by_image

    def __len__(self) -> int:
        return len(self.image_ids)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        import PIL.Image

        e = self._by_image[self.image_ids[idx]]
        frame = np.asarray(PIL.Image.open(e["path"]).convert("RGB"), np.uint8)
        boxes, box_mask = _pad(e["boxes"], self.max_boxes)
        ign, ign_mask = _pad(e["ignores"], self.max_ignore)
        item = dict(frame=frame, boxes=boxes, box_mask=box_mask, ignore_boxes=ign,
                    ignore_mask=ign_mask, image_id=np.int64(self.image_ids[idx]))
        if self.num_keypoints > 0:
            K = self.num_keypoints
            kp = np.zeros((self.max_boxes, K, 3), np.float32)
            for j, rows in enumerate(e["kpts"][: self.max_boxes]):
                if rows.shape[0] != K:
                    raise ValueError(f"annotation has {rows.shape[0]} keypoints, "
                                     f"dataset configured for {K}")
                kp[j] = rows
            item["keypoints"] = kp
        return item
