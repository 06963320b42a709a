"""Dataset-format converter: YOLO-pose <-> COCO person-keypoints (copy of
probpose_pytorch_tpu/data/convert_format.py, which the port cannot import;
it writes the same bytes).

Training takes either format (`TrainConfig.dataset_format`), but COCO AP
evaluation (`eval/run.py`) needs COCO-style annotations: a YOLO split is
converted once and keeps every tool:

    python -m probpose_pytorch_tpu_torch.data.convert_format yolo2coco \
        --root data/ --split val --out annotations/val.json
    python -m probpose_pytorch_tpu_torch.data.convert_format coco2yolo \
        --annotations person_keypoints_val2017.json --images val2017/ \
        --out data/ --split val

Conversion is faithful: raw 0/1/2 visibilities are preserved (the v==1->2
promotion in data/yolo.py is a reference TRAINING quirk, reapplied at load
time, not baked into converted files); coordinates round-trip through the
normalized YOLO form with float precision. coco2yolo links images instead
of copying (one dataset on disk); crowd/zero-keypoint COCO annotations
have no YOLO representation and are dropped with a count (YOLO training
never sees ignore regions — keep the COCO original for eval).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Any

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import COCO_KEYPOINT_NAMES

__all__ = ["yolo_to_coco", "coco_to_yolo", "main"]

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

# COCO person-category skeleton (1-based keypoint indices, protocol order).
COCO_SKELETON = [
    [16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13],
    [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3],
    [2, 4], [3, 5], [4, 6], [5, 7],
]


def yolo_to_coco(
    root: str | Path,
    split: str,
    out_json: str | Path,
    target_single_class: int | None = None,
    category_name: str = "person",
) -> dict[str, Any]:
    """Convert a YOLO-pose split (images/ + labels/ with
    `cls xc yc w h (x y v)*` normalized rows) to a COCO person-keypoints
    dict, written to `out_json`. Image file_names are relative to
    <root>/<split>/images (pass that as --images to eval/run.py).
    Visibilities are copied RAW (no v==1->2 promotion)."""
    import PIL.Image

    split_dir = Path(root) / split
    image_dir, label_dir = split_dir / "images", split_dir / "labels"
    images, annotations = [], []
    ann_id = 1
    n_kpts = 0
    for img_id, image_path in enumerate(sorted(image_dir.iterdir()), 1):
        if image_path.suffix.lower() not in _IMG_EXTS:
            continue
        label_path = label_dir / image_path.with_suffix(".txt").name
        if not label_path.exists():
            continue
        with PIL.Image.open(image_path) as im:
            width, height = im.size
        images.append(dict(
            id=img_id, file_name=image_path.name,
            width=width, height=height,
        ))
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
                x = float(parts[j]) * width
                y = float(parts[j + 1]) * height
                v = int(float(parts[j + 2]))
                kps.extend([x, y, v])
            n_kpts = max(n_kpts, len(kps) // 3)
            bbox = [
                (xc - bw / 2) * width, (yc - bh / 2) * height,
                bw * width, bh * height,
            ]
            annotations.append(dict(
                id=ann_id, image_id=img_id, category_id=1,
                bbox=[round(v, 2) for v in bbox],
                area=round(bbox[2] * bbox[3], 2),
                iscrowd=0,
                keypoints=[
                    round(v, 2) if i % 3 != 2 else int(v)
                    for i, v in enumerate(kps)
                ],
                num_keypoints=int(sum(
                    1 for i in range(2, len(kps), 3) if kps[i] > 0
                )),
            ))
            ann_id += 1
    names = (
        list(COCO_KEYPOINT_NAMES) if n_kpts == len(COCO_KEYPOINT_NAMES)
        else [str(k) for k in range(n_kpts)]
    )
    coco = dict(
        info=dict(description=f"converted from YOLO split {split!r}"),
        images=images,
        annotations=annotations,
        categories=[dict(
            id=1, name=category_name, supercategory=category_name,
            keypoints=names,
            skeleton=COCO_SKELETON if n_kpts == 17 else [],
        )],
    )
    out_json = Path(out_json)
    out_json.parent.mkdir(parents=True, exist_ok=True)
    out_json.write_text(json.dumps(coco))
    return coco


def coco_to_yolo(
    annotations: str | Path,
    images: str | Path,
    out_root: str | Path,
    split: str,
    link: bool = True,
) -> dict[str, int]:
    """Convert COCO person-keypoints JSON to a YOLO-pose split under
    <out_root>/<split>/{images,labels}. Images are symlinked (link=True)
    or copied. Crowd / zero-keypoint annotations have no YOLO form and are
    dropped (returned in the counts). Visibilities are copied RAW."""
    raw = json.loads(Path(annotations).read_text())
    images_dir = Path(images)
    out_images = Path(out_root) / split / "images"
    out_labels = Path(out_root) / split / "labels"
    out_images.mkdir(parents=True, exist_ok=True)
    out_labels.mkdir(parents=True, exist_ok=True)

    by_image: dict[int, list[dict]] = {}
    dropped = 0
    for ann in raw["annotations"]:
        if ann.get("iscrowd", 0) or ann.get("num_keypoints", 0) == 0:
            dropped += 1
            continue
        by_image.setdefault(ann["image_id"], []).append(ann)

    n_images = 0
    for im in raw["images"]:
        anns = by_image.get(im["id"])
        if not anns:
            continue
        src = images_dir / im["file_name"]
        dst = out_images / Path(im["file_name"]).name
        if not dst.exists():
            if link:
                os.symlink(src.resolve(), dst)
            else:
                dst.write_bytes(src.read_bytes())
        w, h = float(im["width"]), float(im["height"])
        lines = []
        for ann in anns:
            x0, y0, bw, bh = (float(v) for v in ann["bbox"])
            row = [
                "0",
                f"{(x0 + bw / 2) / w:.6f}", f"{(y0 + bh / 2) / h:.6f}",
                f"{bw / w:.6f}", f"{bh / h:.6f}",
            ]
            kps = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
            for x, y, v in kps:
                row += [f"{x / w:.6f}", f"{y / h:.6f}", str(int(v))]
            lines.append(" ".join(row))
        (out_labels / Path(im["file_name"]).with_suffix(".txt").name
         ).write_text("\n".join(lines) + "\n")
        n_images += 1
    return dict(
        images=n_images,
        annotations=sum(len(a) for a in by_image.values()),
        dropped_ignores=dropped,
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="YOLO-pose <-> COCO keypoints dataset converter"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("yolo2coco", help="YOLO split -> COCO JSON")
    p1.add_argument("--root", type=Path, required=True,
                    help="YOLO dataset root (contains <split>/images)")
    p1.add_argument("--split", required=True)
    p1.add_argument("--out", type=Path, required=True,
                    help="output COCO JSON path")
    p1.add_argument("--class-id", type=int, default=None,
                    help="keep only this YOLO class id")
    p2 = sub.add_parser("coco2yolo", help="COCO JSON -> YOLO split")
    p2.add_argument("--annotations", type=Path, required=True)
    p2.add_argument("--images", type=Path, required=True)
    p2.add_argument("--out", type=Path, required=True,
                    help="YOLO dataset root to write <split>/ under")
    p2.add_argument("--split", required=True)
    p2.add_argument("--copy", action="store_true",
                    help="copy images instead of symlinking")
    args = parser.parse_args(argv)
    if args.cmd == "yolo2coco":
        coco = yolo_to_coco(
            args.root, args.split, args.out,
            target_single_class=args.class_id,
        )
        print(
            f"wrote {args.out}: {len(coco['images'])} images, "
            f"{len(coco['annotations'])} annotations"
        )
    else:
        counts = coco_to_yolo(
            args.annotations, args.images, args.out, args.split,
            link=not args.copy,
        )
        print(
            f"wrote {args.out}/{args.split}: {counts['images']} images, "
            f"{counts['annotations']} annotations "
            f"({counts['dropped_ignores']} crowd/0-kpt ignores dropped — "
            "keep the COCO original for eval)"
        )


if __name__ == "__main__":
    main()
