"""Visualization helpers (a copy of probpose_pytorch_tpu/viz.py): heatmap
overlays and the keypoint drawing of the reference inference script
(inference.py:115-128), plus reliability diagrams. Host-side; PIL, and
matplotlib inside `overlay_heatmaps` only."""

from __future__ import annotations

import numpy as np

__all__ = ["overlay_heatmaps", "draw_keypoints", "reliability_diagram"]


def overlay_heatmaps(
    image: np.ndarray,
    heatmaps: np.ndarray,
    colormap: str = "jet",
    threshold: float = 0.01,
) -> np.ndarray:
    """Overlay (K, H, W) heatmaps on an (H, W, 3) uint8 image.

    Near-zero heatmap pixels stay transparent (viz.py:27-29); channels are
    colored, summed, scaled to [0,255] and added to the image with clipping.
    """
    from matplotlib import colormaps

    cmap = colormaps[colormap]
    combined = np.zeros((*heatmaps.shape[1:], 3), np.float64)
    for k in range(heatmaps.shape[0]):
        colored = cmap(heatmaps[k])[:, :, :3]
        colored[heatmaps[k] < threshold] = 0
        combined += colored
    combined = np.clip((combined * 255), 0, 255).astype(np.uint8)
    return np.clip(
        image.astype(np.int32) + combined.astype(np.int32), 0, 255
    ).astype(np.uint8)


def draw_keypoints(
    image,
    keypoints: np.ndarray,
    probabilities: np.ndarray | None = None,
    prob_threshold: float = 0.9,
    radius: int = 5,
    color: tuple[int, int, int] = (255, 0, 0),
    label: bool = True,
):
    """Draw keypoints (K, 2) on a PIL image, skipping low-probability ones —
    the reference inference script's rendering (inference.py:115-128).
    `color` / `label` support multi-set overlays (e.g. prediction in red vs
    ground truth in green for the eval worst-case dump)."""
    import PIL.ImageDraw

    draw = PIL.ImageDraw.Draw(image)
    w, h = image.size
    for j, kp in enumerate(keypoints):
        prob = 1.0 if probabilities is None else float(probabilities[j])
        if prob < prob_threshold:
            continue
        x, y = int(kp[0]), int(kp[1])
        if 0 <= x < w and 0 <= y < h:
            draw.ellipse(
                (x - radius, y - radius, x + radius, y + radius),
                fill=color,
            )
            if label:
                draw.text(
                    (x + 10, y - 10), f"{j}: {prob:.2f}",
                    fill=(255, 255, 255),
                )
    return image


def reliability_diagram(
    bins: dict,
    title: str = "",
    size: int = 420,
):
    """Render a reliability histogram (eval/calibration.reliability_bins or
    a --calibration-dump `bins` entry) as a PIL image.

    Classic layout: per-bin accuracy bars over confidence on x, the y = x
    perfect-calibration diagonal, the accuracy-vs-confidence gap hatched in
    red, and a sample-count strip along the bottom. PIL-only (no
    matplotlib) so it runs on serving hosts.
    """
    import PIL.Image
    import PIL.ImageDraw

    edges = np.asarray(bins["edges"], np.float64)
    conf = np.asarray(
        [np.nan if c is None else c for c in bins["confidence"]], np.float64
    )
    acc = np.asarray(
        [np.nan if a is None else a for a in bins["accuracy"]], np.float64
    )
    count = np.asarray(bins["count"], np.float64)

    pad, strip = 36, 44  # axis margin; count-strip height
    plot = size - pad - 8
    img = PIL.Image.new("RGB", (size, size + strip), (255, 255, 255))
    draw = PIL.ImageDraw.Draw(img, "RGBA")

    def xy(cx: float, cy: float) -> tuple[float, float]:
        return pad + cx * plot, 8 + (1.0 - cy) * plot

    # frame + gridlines + diagonal
    draw.rectangle([xy(0, 1), xy(1, 0)], outline=(120, 120, 120))
    for g in (0.25, 0.5, 0.75):
        draw.line([xy(g, 0), xy(g, 1)], fill=(230, 230, 230))
        draw.line([xy(0, g), xy(1, g)], fill=(230, 230, 230))
    draw.line([xy(0, 0), xy(1, 1)], fill=(150, 150, 150), width=1)

    for i in range(len(count)):
        if count[i] <= 0 or np.isnan(acc[i]):
            continue
        x0, _ = xy(edges[i], 0)
        x1, _ = xy(edges[i + 1], 0)
        # gap between achieved accuracy and reported confidence, in red
        lo, hi = sorted((acc[i], conf[i]))
        draw.rectangle(
            [x0 + 1, xy(0, hi)[1], x1 - 1, xy(0, lo)[1]],
            fill=(220, 60, 60, 90),
        )
        # accuracy bar
        draw.rectangle(
            [x0 + 1, xy(0, acc[i])[1], x1 - 1, xy(0, 0)[1]],
            fill=(70, 110, 180, 150),
            outline=(70, 110, 180),
        )

    # bottom strip: per-bin sample counts
    top = size + 4
    peak = count.max() if count.max() > 0 else 1.0
    for i in range(len(count)):
        x0, _ = xy(edges[i], 0)
        x1, _ = xy(edges[i + 1], 0)
        h = (strip - 16) * count[i] / peak
        draw.rectangle(
            [x0 + 1, top + (strip - 16) - h, x1 - 1, top + (strip - 16)],
            fill=(120, 120, 120),
        )
    # labels
    draw.text((pad, size + strip - 12), "confidence 0..1 | bar: count",
              fill=(90, 90, 90))
    draw.text((6, 8), "acc", fill=(70, 110, 180))
    if title:
        draw.text((pad + 4, 10), title, fill=(30, 30, 30))
    return img
