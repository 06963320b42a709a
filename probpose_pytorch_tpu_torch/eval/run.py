"""Evaluation CLI (port of probpose_pytorch_tpu/eval/run.py): checkpoint ->
COCO keypoint AP.

    python -m probpose_pytorch_tpu_torch.eval.run \
        --checkpoint runs/x/checkpoints [--config runs/x/config.json] \
        --annotations person_keypoints_val2017.json --images val2017/ \
        [--batch-size 64] [--max-samples N] [--ema] [--device cuda]
    # model-free: re-score a COCO keypoint-results file
    python -m probpose_pytorch_tpu_torch.eval.run \
        --score-predictions preds.json --annotations ... --images ...
    # end to end with the person detector's boxes (detect.train's run dir)
    python -m probpose_pytorch_tpu_torch.eval.run --checkpoint ... \
        --detector runs/detector [--detector-threshold 0.3] --annotations ... --images ...
    # the single-stage (bottom-up) pose family
    python -m probpose_pytorch_tpu_torch.eval.run --bottomup runs/bottomup \
        --annotations ... --images ...

Loads a checkpoint of the port's training CLI (train/checkpoint.py), streams
the val set through the top-down predictor (inference.py) and prints the
COCO keypoint summary as one JSON line, with the JAX CLI's keys. It runs on
the card unless `--device cpu` is given. With `--detector` the pose model
gets the person detector's boxes (detect/pipeline.py:
evaluate_detector_topdown); `--bottomup` scores a single-stage model
(evaluate_bottomup). `--bundle` scores an exported serving bundle
(serve/export.py) in place of the checkpoint, its batch size snapped to an
exported bucket; the TTA and temperatures are baked into a bundle at
export. `--data-parallel` and `--model-parallel` (ROADMAP item 13) are not
ported and raise.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

__all__ = ["main"]


def _unported(flag: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{flag} is not ported to PyTorch yet (ROADMAP item {item})")


def _parse_temperatures(spec: str) -> dict[str, float]:
    """--apply-temperature value: a --calibration-dump JSON path (each
    branch's fitted `temperature` is used) or 'presence=T,visibility=T'."""
    path = Path(spec)
    if path.suffix == ".json" or path.exists():
        dumped = json.loads(path.read_text())
        return {branch: float(rep["temperature"]) for branch, rep in dumped.items()}
    out: dict[str, float] = {}
    for part in spec.split(","):
        branch, sep, t = part.partition("=")
        if not sep:
            raise SystemExit(f"--apply-temperature: bad spec {part!r} (want branch=T "
                             "or a calibration-dump JSON path)")
        out[branch.strip()] = float(t)
    return out


def _rounded(summary: dict) -> dict:
    return {k: round(float(v), 4) for k, v in summary.items()}


def main(argv=None) -> dict:
    """Run the CLI on `argv`; returns the summary line it printed."""
    parser = argparse.ArgumentParser(description="ProbPose COCO eval (PyTorch)")
    src = parser.add_mutually_exclusive_group(required=False)
    src.add_argument("--checkpoint", type=Path,
                     help="checkpoint directory of the port's training CLI")
    src.add_argument("--bundle", type=Path,
                     help="serving bundle directory (serve.export) instead of a checkpoint")
    src.add_argument("--score-predictions", type=Path, metavar="RESULTS_JSON",
                     help="model-free: re-score a COCO keypoint-results file "
                     "(--dump-predictions output) against the annotations")
    src.add_argument("--bottomup", type=Path, metavar="RUN_DIR",
                     help="single-stage pose model (detect.train --keypoints run dir): "
                     "COCO AP of its own detections, no boxes needed")
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--annotations", type=Path, required=True)
    parser.add_argument("--images", type=Path, required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--bbox-scale", type=float, default=1.25)
    parser.add_argument("--ema", action="store_true")
    parser.add_argument("--flip-test", action="store_true",
                        help="flip-test TTA (average with the mirrored forward; "
                        "COCO-17 left/right pairs)")
    parser.add_argument("--scale-test", type=str, default="",
                        help="multi-scale TTA: comma-separated box scales "
                        "(e.g. '0.9,1.0,1.1'); decode per scale, average in frame space")
    parser.add_argument("--scale-test-scores", choices=["unit", "mean"], default="unit",
                        help="confidence fields under multi-scale TTA: 'unit' keeps the "
                        "unit-scale forward's; 'mean' averages them")
    parser.add_argument("--calibration", action="store_true",
                        help="report confidence calibration (ECE/MCE/Brier/NLL + fitted "
                        "temperature) of the presence and visibility branches")
    parser.add_argument("--calibration-dump", type=Path, default=None,
                        help="with --calibration: write the per-branch reliability "
                        "histograms and metrics to this JSON file")
    parser.add_argument("--per-joint", action="store_true",
                        help="report per-keypoint EPE / PCK@0.2")
    parser.add_argument("--dump-worst", type=int, default=0, metavar="N",
                        help="write the N lowest-OKS instances as crop overlays")
    parser.add_argument("--dump-worst-dir", type=Path, default=Path("worst_cases"),
                        help="output directory for --dump-worst")
    parser.add_argument("--apply-temperature", type=str, default=None,
                        help="per-branch temperatures to apply before scoring: a "
                        "--calibration-dump JSON or 'presence=1.8,visibility=1.2'")
    parser.add_argument("--detector", type=Path, default=None,
                        help="person-detector run directory (detect.train output): score "
                        "end to end on its boxes instead of the ground-truth boxes")
    parser.add_argument("--detector-threshold", type=float, default=0.3,
                        help="with --detector / --bottomup: detection score threshold")
    parser.add_argument("--data-parallel", action="store_true",
                        help="not ported (ROADMAP item 13)")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="not ported (ROADMAP item 13)")
    parser.add_argument("--dump-predictions", type=Path, default=None, metavar="OUT_JSON",
                        help="write predictions in the COCO keypoint-results format "
                        "(re-score with --score-predictions)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from probpose_pytorch_tpu_torch.data.coco import COCOPoseDataset
    from probpose_pytorch_tpu_torch.eval.pipeline import evaluate_topdown
    from probpose_pytorch_tpu_torch.eval.results import (
        load_results,
        save_results,
        score_results,
    )
    from probpose_pytorch_tpu_torch.inference import load_predictor

    if args.data_parallel or args.model_parallel != 1:
        raise _unported("--data-parallel / --model-parallel", 13)

    if args.score_predictions is not None:
        dataset = COCOPoseDataset(args.annotations, args.images, (256, 192),
                                  bbox_scale=args.bbox_scale)
        line = _rounded(score_results(load_results(args.score_predictions), dataset))
        print(json.dumps(line))
        return line
    if args.bottomup is not None:
        from probpose_pytorch_tpu_torch.detect import evaluate_bottomup, load_bottomup

        predictor = load_bottomup(args.bottomup, score_threshold=args.detector_threshold,
                                  device=args.device)
        line = _rounded(evaluate_bottomup(predictor, args.annotations, args.images,
                                          max_images=args.max_samples, verbose=True))
        print(json.dumps(line))
        return line
    if args.checkpoint is None and args.bundle is None:
        parser.error("one of --checkpoint / --bundle / --score-predictions / --bottomup is "
                     "required")
    if args.bundle and (args.ema or args.flip_test or args.scale_test
                        or args.apply_temperature):
        parser.error("--ema/--flip-test/--scale-test/--apply-temperature are baked into "
                     "bundles at export")
    if args.detector is not None and (args.calibration or args.per_joint or args.dump_worst):
        parser.error("--detector reports the end-to-end AP summary; --calibration/"
                     "--per-joint/--dump-worst need the GT-box crop stream (instance-matched GT)")

    calibration = (_parse_temperatures(args.apply_temperature)
                   if args.apply_temperature else None)
    if args.bundle:
        from probpose_pytorch_tpu_torch.serve.export import ServingBundle

        predictor = ServingBundle.load(args.bundle, device=args.device)
        # the bundle holds its bucket ladder only: snap the batch size
        if args.batch_size not in predictor.buckets:
            snapped = max((b for b in predictor.buckets if b <= args.batch_size),
                          default=predictor.buckets[0])
            print(f"[eval] batch {args.batch_size} -> bucket {snapped}")
            args.batch_size = snapped
    else:
        predictor = load_predictor(
            args.checkpoint,
            args.config,
            ema=args.ema,
            flip_test=args.flip_test,
            scale_test=tuple(float(s) for s in args.scale_test.split(",") if s.strip()),
            scale_test_scores=args.scale_test_scores,
            calibration=calibration,
            device=args.device,
        )
    if args.detector is not None:
        from probpose_pytorch_tpu_torch.detect import evaluate_detector_topdown, load_detector

        det_dir = args.detector
        if (det_dir / "checkpoints").exists():
            det_dir = det_dir / "checkpoints"
        detector = load_detector(det_dir, score_threshold=args.detector_threshold,
                                 device=args.device)
        line = _rounded(evaluate_detector_topdown(
            predictor, detector, args.annotations, args.images, bbox_scale=args.bbox_scale,
            max_images=args.max_samples, verbose=True))
        print(json.dumps(line))
        return line
    dataset = COCOPoseDataset(args.annotations, args.images, predictor.input_size,
                              bbox_scale=args.bbox_scale)
    summary = evaluate_topdown(
        predictor,
        dataset,
        batch_size=args.batch_size,
        max_samples=args.max_samples,
        calibration=args.calibration,
        per_joint=args.per_joint,
        track_instances=args.dump_worst > 0,
        collect_predictions=args.dump_predictions is not None,
    )
    cal = summary.pop("calibration", {})
    joints = summary.pop("per_joint", {})
    instances = summary.pop("instances", [])
    preds = summary.pop("predictions", [])
    if args.dump_predictions is not None:
        args.dump_predictions.parent.mkdir(parents=True, exist_ok=True)
        save_results(preds, args.dump_predictions)
        print(f"[eval] {len(preds)} COCO-format results -> {args.dump_predictions}")
    line = _rounded(summary)
    for branch, rep in cal.items():
        for key in ("ece", "mce", "brier", "nll", "temperature"):
            line[f"{key}_{branch}"] = round(rep[key], 4)
    print(json.dumps(line))
    if joints:
        worst = sorted(joints, key=lambda n: -joints[n]["EPE"])[:3]
        for name, rep in joints.items():
            mark = "  <- worst" if name in worst else ""
            print(f"[eval] {name:>16s}  n={rep['n']:>6d}  EPE={rep['EPE']:7.2f}px  "
                  f"PCK@0.2={rep['PCK@0.2']:.4f}{mark}")
    if args.dump_worst > 0 and instances:
        from probpose_pytorch_tpu_torch.eval.analysis import dump_worst_cases

        rows = dump_worst_cases(dataset, instances, args.dump_worst_dir, n=args.dump_worst)
        print(f"[eval] {len(rows)} worst instances (OKS {rows[0]['oks']:.3f}.."
              f"{rows[-1]['oks']:.3f}) -> {args.dump_worst_dir}/")
    if args.calibration_dump is not None and cal:
        from probpose_pytorch_tpu_torch.viz import reliability_diagram

        args.calibration_dump.parent.mkdir(parents=True, exist_ok=True)
        args.calibration_dump.write_text(json.dumps(cal, indent=1))
        print(f"[eval] calibration report -> {args.calibration_dump}")
        for branch, rep in cal.items():
            png = args.calibration_dump.with_name(f"{args.calibration_dump.stem}_{branch}.png")
            reliability_diagram(
                rep["bins"],
                title=f"{branch}: ECE {rep['ece']:.3f} T {rep['temperature']:.2f}",
            ).save(png)
            print(f"[eval] reliability diagram -> {png}")
    return line


if __name__ == "__main__":
    main()
