"""Deterministic on-disk COCO-format synthetic pose dataset (copy of
probpose_pytorch_tpu/data/synth_coco.py, which the port cannot import).

Writes a COCO directory layout (train2017/ + val2017/ JPEGs and
annotations/person_keypoints_*.json) with multi-person frames, crowd
regions (iscrowd=1) and zero-keypoint instances. Each person is a
17-keypoint COCO-ordered skeleton template, scaled, mirrored, jittered and
placed in the frame; every keypoint index renders as a Gaussian blob in a
fixed colour. v=1 keypoints are annotated but not rendered; v=0 keypoints
are zeroed. Deterministic per (seed, image index): the same JSON and the
same JPEG bytes as the JAX package's generator.
"""

from __future__ import annotations

import colorsys
import json
from pathlib import Path

import numpy as np

__all__ = ["generate_coco_synth", "CANONICAL_SKELETON"]

# Canonical 17-keypoint template in a unit box (x right, y down), COCO order:
# nose, l/r eye, l/r ear, l/r shoulder, l/r elbow, l/r wrist, l/r hip,
# l/r knee, l/r ankle.
CANONICAL_SKELETON = np.array(
    [
        [0.50, 0.08],
        [0.46, 0.05], [0.54, 0.05],
        [0.40, 0.08], [0.60, 0.08],
        [0.32, 0.25], [0.68, 0.25],
        [0.24, 0.42], [0.76, 0.42],
        [0.20, 0.58], [0.80, 0.58],
        [0.38, 0.55], [0.62, 0.55],
        [0.36, 0.75], [0.64, 0.75],
        [0.35, 0.95], [0.65, 0.95],
    ],
    np.float32,
)

_K = 17


def _palette(k: int = _K) -> np.ndarray:
    """Fixed, maximally-spread RGB colors per keypoint index."""
    cols = []
    for i in range(k):
        r, g, b = colorsys.hsv_to_rgb(i / k, 1.0, 1.0)
        cols.append([r * 255, g * 255, b * 255])
    return np.asarray(cols, np.float32)


def _render_person(
    frame: np.ndarray,
    kpts: np.ndarray,
    vis: np.ndarray,
    colors: np.ndarray,
    blob_sigma: float,
) -> None:
    """Additive Gaussian blobs (windowed, vectorized per keypoint)."""
    H, W, _ = frame.shape
    r = int(np.ceil(3 * blob_sigma))
    for k in range(len(kpts)):
        if vis[k] != 2:  # only actually-visible keypoints render
            continue
        x, y = kpts[k]
        x0, x1 = int(max(0, x - r)), int(min(W, x + r + 1))
        y0, y1 = int(max(0, y - r)), int(min(H, y + r + 1))
        if x0 >= x1 or y0 >= y1:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1]
        g = np.exp(
            -((xs - x) ** 2 + (ys - y) ** 2) / (2 * blob_sigma**2)
        ).astype(np.float32)
        frame[y0:y1, x0:x1] += g[..., None] * colors[k][None, None]


def _make_image(
    rng: np.random.Generator,
    frame_hw: tuple[int, int],
    colors: np.ndarray,
    max_people: int,
    p_crowd: float,
    p_unlabeled: float,
):
    """One frame -> (uint8 image, annotation dicts without ids)."""
    H, W = frame_hw
    frame = rng.uniform(0, 40, (H, W, 3)).astype(np.float32)
    anns = []
    n_people = int(rng.integers(1, max_people + 1))
    for _ in range(n_people):
        height = float(rng.uniform(90, 240))
        width = height * float(rng.uniform(0.45, 0.65))
        mirror = rng.random() < 0.5
        tpl = CANONICAL_SKELETON.copy()
        if mirror:
            tpl[:, 0] = 1.0 - tpl[:, 0]
        cx = float(rng.uniform(0.15 * W, 0.85 * W))
        cy = float(rng.uniform(0.15 * H, 0.85 * H))
        kpts = np.empty((_K, 2), np.float32)
        kpts[:, 0] = (tpl[:, 0] - 0.5) * width + cx
        kpts[:, 1] = (tpl[:, 1] - 0.5) * height + cy
        kpts += rng.normal(0, 0.015 * height, kpts.shape)
        # visibility: mostly visible, some labeled-invisible, some unlabeled
        vis = rng.choice([0, 1, 2], _K, p=[0.05, 0.10, 0.85])
        labeled = vis > 0
        if labeled.sum() == 0:
            vis[0] = 2
            labeled[0] = True
        unlabeled_person = rng.random() < p_unlabeled
        _render_person(frame, kpts, vis, colors, blob_sigma=0.03 * height)
        lx = kpts[labeled]
        x0, y0 = lx.min(axis=0) - 0.05 * height
        x1, y1 = lx.max(axis=0) + 0.05 * height
        x0, y0 = max(0.0, float(x0)), max(0.0, float(y0))
        x1, y1 = min(float(W), float(x1)), min(float(H), float(y1))
        flat = np.concatenate([kpts, vis[:, None].astype(np.float32)], axis=1)
        flat[vis == 0] = 0.0
        if unlabeled_person:
            # rendered but unannotated-person region: a 0-keypoint,
            # non-crowd ignore instance (real COCO has these)
            anns.append(
                dict(
                    keypoints=[0.0] * (3 * _K),
                    num_keypoints=0,
                    bbox=[x0, y0, x1 - x0, y1 - y0],
                    area=float((x1 - x0) * (y1 - y0)),
                    iscrowd=0,
                )
            )
        else:
            anns.append(
                dict(
                    keypoints=np.round(flat, 2).reshape(-1).tolist(),
                    num_keypoints=int((vis > 0).sum()),
                    bbox=[x0, y0, x1 - x0, y1 - y0],
                    area=float((x1 - x0) * (y1 - y0)),
                    iscrowd=0,
                )
            )
    if rng.random() < p_crowd:
        # crowd region: textured noise patch with keypoint-colored speckle
        cw, ch = rng.uniform(0.15, 0.35, 2) * [W, H]
        cx0 = float(rng.uniform(0, W - cw))
        cy0 = float(rng.uniform(0, H - ch))
        xs0, xs1 = int(cx0), int(cx0 + cw)
        ys0, ys1 = int(cy0), int(cy0 + ch)
        speck = rng.uniform(0, 1, (ys1 - ys0, xs1 - xs0, 3)) ** 4
        frame[ys0:ys1, xs0:xs1] += speck.astype(np.float32) * 255
        anns.append(
            dict(
                keypoints=[0.0] * (3 * _K),
                num_keypoints=0,
                bbox=[cx0, cy0, float(cw), float(ch)],
                area=float(cw * ch),
                iscrowd=1,
            )
        )
    return np.clip(frame, 0, 255).astype(np.uint8), anns


def generate_coco_synth(
    root: str | Path,
    n_train_images: int = 700,
    n_val_images: int = 160,
    frame_hw: tuple[int, int] = (480, 480),
    max_people: int = 4,
    p_crowd: float = 0.15,
    p_unlabeled: float = 0.08,
    seed: int = 0,
    overwrite: bool = False,
) -> Path:
    """Write the dataset; returns the root. Skips generation if the
    annotation files already exist (unless overwrite)."""
    import PIL.Image

    root = Path(root)
    ann_dir = root / "annotations"
    done = [
        ann_dir / "person_keypoints_train2017.json",
        ann_dir / "person_keypoints_val2017.json",
    ]
    if all(p.exists() for p in done) and not overwrite:
        return root
    ann_dir.mkdir(parents=True, exist_ok=True)
    colors = _palette()
    H, W = frame_hw
    for split, n_images, split_seed in (
        ("train2017", n_train_images, seed),
        ("val2017", n_val_images, seed + 10_000),
    ):
        img_dir = root / split
        img_dir.mkdir(parents=True, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(n_images):
            rng = np.random.default_rng((split_seed, i))
            frame, anns = _make_image(
                rng, frame_hw, colors, max_people, p_crowd, p_unlabeled
            )
            fname = f"{i:012d}.jpg"
            PIL.Image.fromarray(frame).save(img_dir / fname, quality=92)
            images.append(
                dict(id=i, file_name=fname, width=W, height=H)
            )
            for a in anns:
                a = dict(a, id=ann_id, image_id=i, category_id=1)
                ann_id += 1
                annotations.append(a)
        (ann_dir / f"person_keypoints_{split}.json").write_text(
            json.dumps(
                dict(
                    images=images,
                    annotations=annotations,
                    categories=[
                        dict(id=1, name="person", keypoints=[], skeleton=[])
                    ],
                )
            )
        )
    return root
