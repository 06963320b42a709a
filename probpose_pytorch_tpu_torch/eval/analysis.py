"""Error-analysis triage for eval runs: dump the worst-scoring instances
(a copy of probpose_pytorch_tpu/eval/analysis.py).

Production-debugging surface the reference lacks (SURVEY.md §2.4 absence
list — it has no eval tooling at all): after a COCO eval with
`evaluate_topdown(..., track_instances=True)`, `dump_worst_cases` writes
the N lowest-OKS instances as crop overlays (prediction red, ground truth
green) plus a machine-readable JSON index, so "AP dropped" turns into "look
at THESE crops". Wired to `eval.run --dump-worst N`.

Host-side, PIL-gated; no device work (re-reads crops from the dataset).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Sequence

import numpy as np

__all__ = ["dump_worst_cases"]


def dump_worst_cases(
    dataset: Any,
    instances: Sequence[dict[str, Any]],
    out_dir: str | Path,
    n: int = 20,
    render: bool = True,
) -> list[dict[str, Any]]:
    """Write the `n` lowest-OKS instance records to `out_dir`.

    dataset: the SAME dataset evaluate_topdown ran over (records index into
    it). instances: `summary["instances"]` from
    `evaluate_topdown(..., track_instances=True)`. Writes `worst.json`
    (rank, dataset index, image_id, oks, epe, score, per-keypoint pred +
    probabilities) and, with render=True, one `worst_<rank>_img<id>.png`
    overlay per instance: crop with predicted keypoints in red and labeled
    GT in green. Returns the JSON records.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    worst = sorted(instances, key=lambda r: r["oks"])[: int(n)]
    records = []
    for rank, rec in enumerate(worst):
        row = {
            "rank": rank,
            "index": int(rec["index"]),
            "image_id": int(rec["image_id"]),
            "oks": round(float(rec["oks"]), 4),
            "epe": round(float(rec["epe"]), 2),
            "score": round(float(rec["score"]), 4),
            "pred": np.asarray(rec["pred"]).round(2).tolist(),
            "probs": np.asarray(rec["probs"]).round(4).tolist(),
        }
        if render:
            png = out_dir / f"worst_{rank:03d}_img{row['image_id']}.png"
            _render_overlay(dataset[row["index"]], rec, png)
            row["png"] = png.name
        records.append(row)
    (out_dir / "worst.json").write_text(json.dumps(records, indent=1))
    return records


def _render_overlay(sample: dict, rec: dict, png: Path) -> None:
    import PIL.Image

    from probpose_pytorch_tpu_torch.viz import draw_keypoints

    img = PIL.Image.fromarray(np.asarray(sample["image"], np.uint8))
    # GT (labeled keypoints only) in green, unlabeled skipped via the
    # visibility mask as "probability"; prediction in red with its actual
    # presence probabilities (threshold 0: triage wants every keypoint).
    vis = np.asarray(sample["keypoints_visible"], np.float64).reshape(-1)
    draw_keypoints(
        img, np.asarray(sample["keypoints"]), vis, prob_threshold=0.5,
        color=(0, 200, 0), label=False, radius=3,
    )
    draw_keypoints(
        img, np.asarray(rec["pred"]), np.asarray(rec["probs"]),
        prob_threshold=0.0, color=(255, 0, 0), radius=3,
    )
    img.save(png)
