"""Training on several datasets at once (copy of the host code of
probpose_pytorch_tpu/data/mixed.py, which the port cannot import).

`MixedPoseDataset` concatenates datasets of the sample contract (image,
keypoints, keypoints_visible, keypoints_visibility) and weights them by
integer `repeats`: dataset i's samples appear repeats[i] times an epoch, so
`batch_iterator`'s uniform shuffle draws them in proportion. Keypoint
counts must match (batches stack), and a sample keeps only the fields every
member's samples have: COCO's carry their record's ids and boxes beside
the contract, YOLO's do not, and a batch stacks the fields of its first
sample. (The JAX class returns each member's fields as they are, so a
COCO and YOLO mix fails to collate there whenever a batch starts with a
COCO sample; with members of one format the fields are the same.)

Config: `dataset_format: "mixed"` and
    "mixed_datasets": [
        {"root": "./data/coco", "format": "coco", "repeat": 1},
        {"root": "./data/field", "format": "yolo", "repeat": 4}
    ]
Validation uses the first member's val split; training mixes all members.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np

__all__ = ["MixedPoseDataset", "build_mixed_datasets"]


class MixedPoseDataset:
    def __init__(self, datasets: Sequence[Any], repeats: Sequence[int] | None = None):
        if not datasets:
            raise ValueError("no datasets to mix")
        if repeats is None:
            repeats = [1] * len(datasets)
        repeats = [int(r) for r in repeats]
        if len(repeats) != len(datasets):
            raise ValueError(f"{len(repeats)} repeats != {len(datasets)} datasets")
        if any(r < 1 for r in repeats):
            raise ValueError(f"repeats must be >= 1, got {repeats}")
        first = [ds[0] for ds in datasets]
        ks = [np.asarray(f["keypoints"]).shape[0] for f in first]
        if len(set(ks)) > 1:
            raise ValueError(f"keypoint counts differ across mixed datasets: {ks}")
        self.datasets = list(datasets)
        self.repeats = repeats
        keys = set(first[0]).intersection(*first[1:])
        self._keys = None if all(set(f) == keys for f in first) else keys
        # (dataset index, local index), each dataset `repeat` times
        self._index: list[tuple[int, int]] = []
        for di, (ds, r) in enumerate(zip(datasets, repeats)):
            for _ in range(r):
                self._index.extend((di, i) for i in range(len(ds)))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        di, li = self._index[idx]
        sample = self.datasets[di][li]
        return sample if self._keys is None else {
            k: v for k, v in sample.items() if k in self._keys}


def build_mixed_datasets(cfg, split_train: bool = True):
    """The (train, val) pair of `dataset_format: "mixed"`: each
    `cfg.mixed_datasets` entry is {"root", "format" ("coco" | "yolo"),
    "repeat" (optional)}; train is every member's train split weighted by
    its repeat, val the first member's val split."""
    from probpose_pytorch_tpu_torch.data.coco import COCOPoseDataset
    from probpose_pytorch_tpu_torch.data.yolo import YOLOPoseDataset

    if not cfg.mixed_datasets:
        raise ValueError('dataset_format "mixed" needs a non-empty mixed_datasets list')
    members, vals, repeats = [], [], []
    for entry in cfg.mixed_datasets:
        root = Path(entry["root"])
        fmt = entry.get("format", "coco")
        repeats.append(int(entry.get("repeat", 1)))
        kw = dict(resample=cfg.resample) if getattr(cfg, "resample", "") else {}
        if fmt == "coco":
            members.append(COCOPoseDataset(root / "annotations/person_keypoints_train2017.json",
                                           root / "train2017", cfg.model.img_size, **kw))
            vals.append(lambda root=root: COCOPoseDataset(
                root / "annotations/person_keypoints_val2017.json", root / "val2017",
                cfg.model.img_size))
        elif fmt == "yolo":
            members.append(YOLOPoseDataset(str(root), "train", cfg.model.img_size, **kw))
            vals.append(lambda root=root: YOLOPoseDataset(str(root), "valid",
                                                          cfg.model.img_size))
        else:
            raise ValueError(f"mixed_datasets format {fmt!r} (expected 'coco' or 'yolo')")
    return MixedPoseDataset(members, repeats), vals[0]()
