"""Host-side data of the port: loaders, batching and prefetch (copies of the
JAX package's host code, which the port cannot import).

Visibility conventions, as the JAX package pins them (they differ by format
on purpose):

| field                  | YOLO loader (yolo.py)        | COCO loader (coco.py) |
|------------------------|------------------------------|-----------------------|
| raw flag `v`           | promoted: v == 1 -> 2        | kept as annotated     |
| `keypoints_visible`    | v == 2 (labeled, promoted)   | v >= 1 (labeled)      |
| `keypoints_visibility` | min(v, 1) (labeled)          | v == 2 (unoccluded)   |

`keypoints_visible` gates heatmap supervision; `keypoints_visibility` is
the visibility branch's target. Unlabeled (v == 0) keypoints supervise
nothing in either.
"""

from probpose_pytorch_tpu_torch.data.cache import CachedCropDataset, build_crop_cache
from probpose_pytorch_tpu_torch.data.coco import COCOPoseDataset, parse_coco_annotations
from probpose_pytorch_tpu_torch.data.mixed import MixedPoseDataset, build_mixed_datasets
from probpose_pytorch_tpu_torch.data.pipeline import Prefetcher, SyntheticPoseDataset, batch_iterator
from probpose_pytorch_tpu_torch.data.synth_coco import generate_coco_synth
from probpose_pytorch_tpu_torch.data.yolo import YOLOPoseDataset, parse_yolo_annotations

__all__ = [
    "SyntheticPoseDataset",
    "batch_iterator",
    "Prefetcher",
    "COCOPoseDataset",
    "parse_coco_annotations",
    "YOLOPoseDataset",
    "parse_yolo_annotations",
    "CachedCropDataset",
    "build_crop_cache",
    "generate_coco_synth",
    "MixedPoseDataset",
    "build_mixed_datasets",
]
