"""Video / frame-sequence pose pipeline: boxes -> poses -> tracks -> smooth
(port of probpose_pytorch_tpu/video.py, top-down models).

Per-frame top-down prediction (`TopDownPredictor.predict_frame`: batch
buckets, optional pose OKS-NMS), OKS-greedy track association across frames
(`OksTracker`) and one-euro temporal smoothing per track
(`utils/smoothing.PoseSmoother`); or, in throughput mode, crops of
consecutive frames batched through `predict_stream` (`run_video_stream`).
Standalone, the person detector supplies the boxes (`detector=`, per frame,
or `fused=True`: detector -> crops -> pose with the boxes kept on the card,
and `run_video_fused_stream` over batches of whole frames); the
single-stage family needs no boxes at all (`run_video_bottomup`).

    python -m probpose_pytorch_tpu_torch.video \\
        --checkpoint runs/flagship/checkpoints --frames frames_dir_or.npy \\
        [--boxes boxes.json | --detector runs/detector [--fused]] [--fps 30] \\
        [--nms soft_oks] [--no-smooth] [--render] [--stream-batch 64] \\
        [--device cuda] --out out_dir
    python -m probpose_pytorch_tpu_torch.video --bottomup runs/bottomup \\
        --frames ... --out out_dir

Frames: a directory of image files (sorted by name; any PIL format) or a
`.npy`/`.npz` stack of shape (T, H, W, 3) uint8. Boxes: a JSON list with one
entry per frame, each a list of [x, y, w, h] boxes (frame pixels); without
it, one full-frame box per frame. Output: `poses.jsonl` (one record per
frame: track ids, raw and smoothed keypoints, per-keypoint probabilities,
pose scores) and, with --render, `frame_%06d.png` overlays.

Tracking, smoothing and IO run in NumPy on the host; the model runs on the
predictor's device (the card unless --device cpu). `--bundle` serves an
exported pose bundle (serve/export.py) in place of the checkpoint; in
--stream-batch mode its frame shape and top bucket are the defaults, and
its frame shape is fixed.
"""

from __future__ import annotations

import argparse
import json
from collections import deque
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from probpose_pytorch_tpu_torch.data.coco import COCO_SIGMAS

__all__ = ["iter_frames", "load_boxes", "OksTracker", "detector_boxes", "run_video",
           "run_video_stream", "run_video_fused_stream", "run_video_bottomup", "main"]

_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def iter_frames(path: str | Path) -> Iterator[np.ndarray]:
    """Yield (H, W, 3) uint8 frames from a directory of images (sorted by
    filename) or a .npy/.npz stack of shape (T, H, W, 3)."""
    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES)
        if not files:
            raise ValueError(f"no image files in {path}")
        import PIL.Image

        for f in files:
            yield np.asarray(PIL.Image.open(f).convert("RGB"), np.uint8)
        return
    if path.suffix == ".npy":
        stack = np.load(path)
    elif path.suffix == ".npz":
        with np.load(path) as z:
            stack = z[z.files[0]]
    else:
        raise ValueError(f"{path}: expected a frame directory or a .npy/.npz stack")
    if stack.ndim != 4 or stack.shape[-1] != 3:
        raise ValueError(f"frame stack shape {stack.shape} != (T, H, W, 3)")
    for frame in stack:
        yield np.asarray(frame, np.uint8)


def load_boxes(path: str | Path) -> list[np.ndarray]:
    """Per-frame boxes from JSON: a list with one entry per frame, each a
    list of [x, y, w, h]. Empty per-frame lists are allowed."""
    raw = json.loads(Path(path).read_text())
    if not isinstance(raw, list):
        raise ValueError(f"{path}: expected a per-frame list of box lists")
    return [np.asarray(b, np.float32).reshape(-1, 4) for b in raw]


def _cross_oks(kpts_a: np.ndarray, areas_a: np.ndarray, kpts_b: np.ndarray,
               areas_b: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """(M, N) OKS between two pose sets, the detection-vs-detection form
    (mean of the two instance areas), as in ops/oks_nms.pairwise_oks."""
    var = (2.0 * np.asarray(sigmas, np.float32)) ** 2
    d2 = np.sum((kpts_a[:, None, :, :] - kpts_b[None, :, :, :]) ** 2, axis=-1)  # (M, N, K)
    mean_area = 0.5 * (np.asarray(areas_a, np.float32)[:, None]
                       + np.asarray(areas_b, np.float32)[None, :])
    e = d2 / var[None, None, :] / (mean_area[..., None] + np.spacing(1)) / 2.0
    return np.exp(-e).mean(axis=-1)


def _frame_boxes(boxes, i: int, frame: np.ndarray) -> np.ndarray:
    """Boxes of frame i (a full-frame box when boxes is None); a short boxes
    list raises before poses.jsonl is partly written."""
    if boxes is None:
        return np.array([[0, 0, frame.shape[1], frame.shape[0]]], np.float32)
    if i >= len(boxes):
        raise ValueError(
            f"boxes list has {len(boxes)} entries but the sequence has at least {i + 1} "
            "frames — one [[x,y,w,h], ...] entry per frame")
    return np.asarray(boxes[i], np.float32).reshape(-1, 4)


def _empty_record(i: int, t: float, fb: np.ndarray) -> dict:
    """Record of a frame with no boxes."""
    return {
        "frame": i, "t": t,
        "track_ids": np.zeros((0,), np.int64),
        "keypoints": np.zeros((0, 0, 2), np.float32),
        "smoothed": np.zeros((0, 0, 2), np.float32),
        "probabilities": np.zeros((0, 0), np.float32),
        "scores": np.zeros((0, 0), np.float32),
        "pose_scores": np.zeros((0,), np.float32),
        "boxes": fb,
    }


class OksTracker:
    """Greedy OKS association of per-frame poses to persistent track ids.

    update(keypoints (N, K, 2), areas (N,)) -> (N,) int track ids. Each call
    advances one frame: current poses match the previous poses of live
    tracks greedily by descending OKS (one-to-one, matches below `threshold`
    rejected); unmatched poses open new tracks; tracks unseen for more than
    `max_gap` frames are dropped.
    """

    def __init__(self, threshold: float = 0.3, max_gap: int = 30,
                 sigmas: np.ndarray | None = None):
        self.threshold = float(threshold)
        self.max_gap = int(max_gap)
        # None -> resolved at the first update: COCO sigmas for K = 17, else
        # a uniform sigma at the COCO mean.
        self.sigmas = None if sigmas is None else np.asarray(sigmas, np.float32)
        self._next_id = 0
        self._frame = 0
        # tid -> (keypoints (K, 2), area, last-seen frame index)
        self._tracks: dict[int, tuple[np.ndarray, float, int]] = {}

    def update(self, keypoints: np.ndarray, areas: np.ndarray) -> np.ndarray:
        kpts = np.asarray(keypoints, np.float32)
        ar = np.asarray(areas, np.float32).reshape(-1)
        n = len(kpts)
        if self.sigmas is None and n:
            k = kpts.shape[1]
            self.sigmas = (np.asarray(COCO_SIGMAS, np.float32) if k == len(COCO_SIGMAS)
                           else np.full((k,), float(np.mean(COCO_SIGMAS)), np.float32))
        ids = np.full((n,), -1, np.int64)
        live = [(tid, k, a) for tid, (k, a, seen) in self._tracks.items()
                if self._frame - seen <= self.max_gap]
        if live and n:
            prev_k = np.stack([k for _, k, _ in live])
            prev_a = np.asarray([a for _, _, a in live], np.float32)
            oks = _cross_oks(prev_k, prev_a, kpts, ar, self.sigmas)
            used_t = np.zeros(len(live), bool)
            used_p = np.zeros(n, bool)
            for f in np.argsort(-oks, axis=None):
                ti, pi = divmod(int(f), n)
                if used_t[ti] or used_p[pi]:
                    continue
                if oks[ti, pi] < self.threshold:
                    break  # sorted descending: nothing further matches
                ids[pi] = live[ti][0]
                used_t[ti] = used_p[pi] = True
        for i in range(n):
            if ids[i] < 0:
                ids[i] = self._next_id
                self._next_id += 1
            self._tracks[int(ids[i])] = (kpts[i], float(ar[i]), self._frame)
        for tid in [tid for tid, (_, _, seen) in self._tracks.items()
                    if self._frame - seen > self.max_gap]:
            del self._tracks[tid]
        self._frame += 1
        return ids


def detector_boxes(detector, frame: np.ndarray, input_size: tuple[int, int],
                   bbox_scale: float = 1.25, threshold: float | None = None) -> np.ndarray:
    """The person detector's boxes for one frame, expanded to the pose crop
    (`expand_detections`, the conditioning pose training used), ready for
    `predict_frame`."""
    from probpose_pytorch_tpu_torch.detect.pipeline import expand_detections

    det, _ = detector.detect_frame(frame, threshold)
    return expand_detections(det, input_size, bbox_scale)


def _smoother(smooth: bool):
    from probpose_pytorch_tpu_torch.utils.smoothing import PoseSmoother

    return PoseSmoother() if smooth else None


def run_video(
    predictor,
    frames,
    boxes: Sequence[np.ndarray] | None = None,
    fps: float = 30.0,
    nms: str | None = "soft_oks",
    nms_threshold: float = 0.9,
    smooth: bool = True,
    track_threshold: float = 0.3,
    smoother=None,
    tracker: OksTracker | None = None,
    detector=None,
    detector_threshold: float | None = None,
    bbox_scale: float = 1.25,
    fused: bool = False,
    max_people: int = 8,
) -> Iterator[dict]:
    """Run the sequence pipeline; yields one record dict per frame.

    predictor: a TopDownPredictor. frames: iterable of (H, W, 3) uint8.
    boxes: per-frame (N_i, 4) xywh arrays (None: one full-frame box per
    frame). detector: a DetectorPredictor; the boxes then come from it per
    frame (exclusive with `boxes`). fused=True (needs `detector`): detector
    -> crops -> pose per frame with the boxes kept on the card
    (detect/fused.py), every frame carrying `max_people` pose slots.
    Records carry numpy arrays: frame index, time, track_ids, keypoints
    (raw), smoothed (== raw when smooth=False), probabilities, scores,
    pose_scores, boxes."""
    if detector is not None and boxes is not None:
        raise ValueError("pass either boxes or a detector, not both")
    if fused and detector is None:
        raise ValueError("fused=True needs a detector")
    if tracker is None:
        tracker = OksTracker(threshold=track_threshold)
    if smoother is None:
        smoother = _smoother(smooth)
    fused_pred = None
    if fused:
        from probpose_pytorch_tpu_torch.detect.fused import FusedTwoStagePredictor

        fused_pred = FusedTwoStagePredictor(
            detector=detector, pose=predictor,
            max_people=min(max_people, detector.max_detections), bbox_scale=bbox_scale,
            score_threshold=(detector.score_threshold if detector_threshold is None
                             else detector_threshold))
    for i, frame in enumerate(frames):
        t = i / fps
        if fused_pred is not None:
            out = fused_pred.predict_frame(frame)
            fb = out.pop("boxes")
            out.pop("det_scores")
        else:
            if detector is not None:
                fb = detector_boxes(detector, frame, predictor.input_size, bbox_scale,
                                    detector_threshold)
            else:
                fb = _frame_boxes(boxes, i, frame)
            out = predictor.predict_frame(frame, fb) if len(fb) else None
        if len(fb) == 0:
            yield _empty_record(i, t, fb)
            continue
        yield _postprocess_frame(out, fb, i, t, nms, nms_threshold, tracker, smoother)


def _postprocess_frame(out: dict, fb: np.ndarray, i: int, t: float, nms: str | None,
                       nms_threshold: float, tracker: OksTracker, smoother) -> dict:
    """Per-frame tail: optional pose OKS-NMS (predict_frame's scoring),
    track association, smoothing, the record."""
    kpts = out["keypoints"]
    probs = out["probabilities"][:, 0, :]
    pose_scores = (out["scores"] * probs).mean(axis=1)
    kept_boxes = fb
    if nms is not None and len(kpts):
        from probpose_pytorch_tpu_torch.ops.oks_nms import oks_nms, soft_oks_nms

        areas = fb[:, 2] * fb[:, 3]
        if nms == "oks":
            keep = oks_nms(kpts, pose_scores, areas, threshold=nms_threshold)
            kept_scores = pose_scores[keep]
        elif nms == "soft_oks":
            keep, kept_scores = soft_oks_nms(kpts, pose_scores, areas, threshold=nms_threshold)
        else:
            raise ValueError(f"unknown nms mode {nms!r}")
        out = {k: v[keep] for k, v in out.items()}
        kpts, probs = out["keypoints"], out["probabilities"][:, 0, :]
        pose_scores = np.asarray(kept_scores, np.float32)
        kept_boxes = fb[keep]
    ids = tracker.update(kpts, kept_boxes[:, 2] * kept_boxes[:, 3])
    smoothed = smoother.update(kpts, ids, t) if smoother is not None else kpts
    return {
        "frame": i,
        "t": t,
        "track_ids": ids,
        "keypoints": kpts,
        "smoothed": smoothed,
        "probabilities": probs,
        "scores": out["scores"],
        "pose_scores": np.asarray(pose_scores, np.float32),
        "boxes": kept_boxes,
    }


def run_video_fused_stream(
    fused,
    frames,
    fps: float = 30.0,
    nms: str | None = "soft_oks",
    nms_threshold: float = 0.9,
    smooth: bool = True,
    track_threshold: float = 0.3,
    batch: int = 4,
    frame_shape: tuple[int, int] | None = None,
    depth: int = 2,
    score_threshold: float | None = None,
) -> Iterator[dict]:
    """Standalone throughput mode: batches of `batch` whole frames through
    the fused two-stage predictor (one dispatch each), with up to `depth`
    batches in flight, so the next batch's upload and launch overlap this
    one's compute. frame_shape: (H, W) every frame zero-pads to (default:
    the first frame's). Records are `run_video`'s; tracking and smoothing
    stay sequential, and results lag the input by up to `batch` frames plus
    the batches in flight."""
    tracker = OksTracker(threshold=track_threshold)
    smoother = _smoother(smooth)
    thr = fused.score_threshold if score_threshold is None else score_threshold
    state = {"shape": frame_shape}

    def pad_frame(frame: np.ndarray) -> np.ndarray:
        if state["shape"] is None:
            state["shape"] = tuple(frame.shape[:2])
        H, W = state["shape"]
        h, w = frame.shape[:2]
        if h > H or w > W:
            raise ValueError(f"frame {(h, w)} exceeds the stream shape {(H, W)} — pass "
                             "frame_shape= sized for the largest frame")
        return frame if (h, w) == (H, W) else np.pad(frame, ((0, H - h), (0, W - w), (0, 0)))

    def postprocess(row: dict, i: int) -> dict:
        keep = row["det_scores"] >= thr
        fb = row["boxes"][keep]
        if not keep.any():
            return _empty_record(i, i / fps, fb)
        out = {k: v[keep] for k, v in row.items() if k not in ("boxes", "det_scores")}
        return _postprocess_frame(out, fb, i, i / fps, nms, nms_threshold, tracker, smoother)

    in_flight: deque = deque()  # (device outputs, frame indices)

    def drain_one():
        dev, idxs = in_flight.popleft()
        host = {k: v.float().cpu().numpy() for k, v in dev.items()}
        for j, i in enumerate(idxs):
            yield postprocess({k: v[j] for k, v in host.items()}, i)

    buf, idxs = [], []
    for i, frame in enumerate(frames):
        buf.append(pad_frame(np.asarray(frame, np.uint8)))
        idxs.append(i)
        if len(buf) == batch:
            in_flight.append((fused.dispatch(np.stack(buf)), idxs))
            buf, idxs = [], []
            if len(in_flight) > depth:
                yield from drain_one()
    if buf:  # the short tail: zero frames pad the batch, their rows dropped
        buf += [np.zeros_like(buf[0])] * (batch - len(buf))
        in_flight.append((fused.dispatch(np.stack(buf)), idxs))
    while in_flight:
        yield from drain_one()


def run_video_bottomup(
    predictor,
    frames,
    fps: float = 30.0,
    nms: str | None = "soft_oks",
    nms_threshold: float = 0.9,
    smooth: bool = True,
    track_threshold: float = 0.3,
    score_threshold: float | None = None,
) -> Iterator[dict]:
    """Single-stage mode of `run_video`: every pose from one forward per
    frame (detect.BottomUpPredictor), no boxes and no detector. Records are
    `run_video`'s; `scores` carries the per-joint confidences and
    `probabilities` is all ones (every joint renders)."""
    tracker = OksTracker(threshold=track_threshold)
    smoother = _smoother(smooth)
    for i, frame in enumerate(frames):
        t = i / fps
        out = predictor.predict_frame(np.asarray(frame, np.uint8), score_threshold)
        kpts = np.asarray(out["keypoints"], np.float32)
        fb = np.asarray(out["boxes"], np.float32).reshape(-1, 4)
        if len(kpts) == 0:
            yield _empty_record(i, t, fb)
            continue
        Kj = kpts.shape[1]
        js = out.get("keypoint_scores")
        joint_scores = (np.asarray(js, np.float32) if js is not None
                        else np.tile(np.asarray(out["scores"], np.float32)[:, None], (1, Kj)))
        yield _postprocess_frame(
            {"keypoints": kpts, "scores": joint_scores,
             "probabilities": np.ones((len(kpts), 1, Kj), np.float32)},
            fb, i, t, nms, nms_threshold, tracker, smoother)


def run_video_stream(
    predictor,
    frames,
    boxes: Sequence[np.ndarray] | None = None,
    fps: float = 30.0,
    nms: str | None = "soft_oks",
    nms_threshold: float = 0.9,
    smooth: bool = True,
    track_threshold: float = 0.3,
    batch: int | None = None,
    frame_shape: tuple[int, int] | None = None,
    depth: int = 2,
) -> Iterator[dict]:
    """Throughput mode of `run_video`: crops of consecutive frames are
    flattened into dispatches of `batch` crops (default: the card's
    recorded serving batch) driven through `predictor.predict_stream`, so
    uploads overlap compute. Each unique frame of a batch is passed once
    (indexed; the frame count padded to a power of two).

    frame_shape: (H, W) every frame is zero-padded to (default: the first
    frame's shape rounded up to the predictor's `frame_size_multiple`);
    frames past it raise. Records are those of `run_video`, with NMS,
    tracking and smoothing run on the host per frame in order; they lag the
    input by up to `batch` crops plus `depth` batches in flight."""
    if batch is None:
        from probpose_pytorch_tpu_torch.inference import tuned_serving_batch

        batch = tuned_serving_batch()
    tracker = OksTracker(threshold=track_threshold)
    smoother = _smoother(smooth)
    meta: deque = deque()  # (frame_idx, t, n_boxes, fb) in input order
    state = {"shape": frame_shape}

    def pad_frame(frame: np.ndarray) -> np.ndarray:
        if state["shape"] is None:
            m = getattr(predictor, "frame_size_multiple", None) or 1
            state["shape"] = (-(-frame.shape[0] // m) * m, -(-frame.shape[1] // m) * m)
        Hf, Wf = state["shape"]
        H, W = frame.shape[:2]
        if H > Hf or W > Wf:
            raise ValueError(f"frame {(H, W)} exceeds the stream frame shape {(Hf, Wf)} — "
                             "pass frame_shape= explicitly")
        if (H, W) == (Hf, Wf):
            return frame
        return np.pad(frame, ((0, Hf - H), (0, Wf - W), (0, 0)))

    def assemble(buf_frames, buf_b, buf_ids):
        """Crops padded to `batch`, unique frames to a power-of-two count."""
        pad = batch - len(buf_b)
        if pad:
            buf_b = buf_b + [buf_b[-1]] * pad
            buf_ids = buf_ids + [buf_ids[-1]] * pad
        f = len(buf_frames)
        fcap = min(1 << (f - 1).bit_length() if f > 1 else 1, batch)
        if fcap > f:
            buf_frames = buf_frames + [np.zeros_like(buf_frames[0])] * (fcap - f)
        return (np.stack(buf_frames), np.stack(buf_b).astype(np.float32),
                np.asarray(buf_ids, np.int64))

    def crop_batches():
        buf_frames: list = []
        buf_b: list = []
        buf_ids: list = []
        for i, frame in enumerate(frames):
            fb = _frame_boxes(boxes, i, frame)
            meta.append((i, i / fps, len(fb), fb))
            if len(fb) == 0:
                continue
            padded = pad_frame(np.asarray(frame, np.uint8))
            remaining = list(fb)
            while remaining:
                take = remaining[:batch - len(buf_b)]
                remaining = remaining[len(take):]
                buf_frames.append(padded)
                buf_ids.extend([len(buf_frames) - 1] * len(take))
                buf_b.extend(take)
                if len(buf_b) == batch:
                    yield assemble(buf_frames, buf_b, buf_ids)
                    buf_frames, buf_b, buf_ids = [], [], []
        if buf_b:
            yield assemble(buf_frames, buf_b, buf_ids)

    rows: dict[str, np.ndarray] = {}
    filled = 0

    def pop_frames():
        nonlocal filled, rows
        while meta and meta[0][2] <= filled:
            i, t, n, fb = meta.popleft()
            if n == 0:
                yield _empty_record(i, t, fb)
                continue
            out = {k: v[:n] for k, v in rows.items()}
            rows = {k: v[n:] for k, v in rows.items()}
            filled -= n
            yield _postprocess_frame(out, fb, i, t, nms, nms_threshold, tracker, smoother)

    for got in predictor.predict_stream(crop_batches(), depth=depth):
        pending = sum(m[2] for m in meta) - filled
        valid = min(batch, pending)  # the tail batch carries padding rows
        for k, v in got.items():
            v = v[:valid]
            rows[k] = np.concatenate([rows[k], v]) if k in rows else v.copy()
        filled += valid
        yield from pop_frames()
    yield from pop_frames()


def main(argv: Sequence[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="ProbPose video / frame-sequence inference "
                                     "(PyTorch)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", type=Path,
                     help="checkpoint directory of the port's training CLI")
    src.add_argument("--bundle", type=Path,
                     help="serving bundle directory (serve.export) instead of a checkpoint")
    src.add_argument("--bottomup", type=Path,
                     help="single-stage pose model (detect.train --keypoints run dir): "
                     "every person's pose in one forward per frame, no --boxes or --detector")
    parser.add_argument("--config", type=Path, default=None,
                        help="TrainConfig JSON (default: beside checkpoint)")
    parser.add_argument("--frames", type=Path, required=True,
                        help="frame directory or (T, H, W, 3) .npy/.npz")
    parser.add_argument("--detector", type=Path, default=None,
                        help="person-detector checkpoint directory (detect.train's "
                        "<out>/checkpoints): the boxes come from the port's own detector, "
                        "no --boxes file needed")
    parser.add_argument("--detector-threshold", type=float, default=None,
                        help="detection (or --bottomup) score threshold override")
    parser.add_argument("--fused", action="store_true",
                        help="with --detector: detector -> crops -> pose with the boxes kept "
                        "on the card (--max-people pose slots a frame)")
    parser.add_argument("--max-people", type=int, default=8,
                        help="pose slots per frame in --fused mode")
    parser.add_argument("--boxes", type=Path, default=None,
                        help="per-frame [[x,y,w,h], ...] JSON (default: full-frame box)")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--nms", choices=("oks", "soft_oks", "none"), default="soft_oks")
    parser.add_argument("--nms-threshold", type=float, default=0.9)
    parser.add_argument("--track-threshold", type=float, default=0.3)
    parser.add_argument("--no-smooth", action="store_true")
    parser.add_argument("--render", action="store_true",
                        help="write frame_%%06d.png overlays")
    parser.add_argument("--prob-threshold", type=float, default=0.9)
    parser.add_argument("--ema", action="store_true", help="use EMA params")
    parser.add_argument("--flip-test", action="store_true")
    parser.add_argument("--stream-batch", type=int, default=None,
                        help="throughput mode: flatten crops across frames into batches "
                        "of this size driven through predict_stream (0 = the card's "
                        "recorded batch); incompatible with --render")
    parser.add_argument("--stream-frame-shape", type=str, default=None, metavar="H,W",
                        help="pad every frame to this shape in stream mode (default: the "
                        "first frame's shape rounded up to the predictor's size multiple)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.stream_batch is not None and args.render:
        parser.error("--stream-batch is incompatible with --render")
    if args.bottomup is not None:
        for flag, bad in (("--boxes", args.boxes), ("--detector", args.detector),
                          ("--stream-batch", args.stream_batch)):
            if bad is not None:
                parser.error(f"--bottomup is incompatible with {flag} (the model finds "
                             "people itself, per frame)")
        if args.ema or args.flip_test:
            parser.error("--ema/--flip-test are top-down options")
    if args.detector is not None:
        if args.boxes is not None:
            parser.error("--detector and --boxes are mutually exclusive")
        if args.stream_batch is not None and not args.fused:
            parser.error("--detector runs per frame; in --stream-batch throughput mode add "
                         "--fused (batched whole-frame dispatches) or pre-compute boxes")
    if args.fused and args.detector is None:
        parser.error("--fused needs --detector")
    if args.bundle is not None:
        if args.ema or args.flip_test:
            parser.error("--ema/--flip-test are baked in at bundle export time")
        if args.stream_batch is not None and args.stream_frame_shape is not None:
            parser.error("--stream-frame-shape is fixed at bundle export time")

    from probpose_pytorch_tpu_torch.detect import (
        FusedTwoStagePredictor,
        load_bottomup,
        load_detector,
    )
    from probpose_pytorch_tpu_torch.inference import load_predictor

    stream_batch = None
    if args.bottomup is not None:
        predictor = load_bottomup(args.bottomup, device=args.device)
    elif args.bundle is not None:
        from probpose_pytorch_tpu_torch.serve.export import ServingBundle

        predictor = ServingBundle.load(args.bundle, device=args.device)
        stream_batch = predictor.buckets[-1]
    else:
        predictor = load_predictor(args.checkpoint, args.config, ema=args.ema,
                                   flip_test=args.flip_test, device=args.device)
    boxes = load_boxes(args.boxes) if args.boxes else None
    detector = None
    if args.detector is not None:
        detector = load_detector(args.detector, device=args.device)
    args.out.mkdir(parents=True, exist_ok=True)

    frames = iter_frames(args.frames)
    last: dict = {}
    if args.render:
        # run_video pulls each frame before yielding its record, so `last`
        # holds the record's frame when the record arrives.
        def _remember(it):
            for f in it:
                last["frame"] = f
                yield f

        frames = _remember(frames)

    common = dict(boxes=boxes, fps=args.fps, nms=None if args.nms == "none" else args.nms,
                  nms_threshold=args.nms_threshold, smooth=not args.no_smooth,
                  track_threshold=args.track_threshold)
    frame_shape = getattr(predictor, "frame_shape", None)
    if args.stream_frame_shape is not None:
        frame_shape = tuple(int(v) for v in args.stream_frame_shape.split(","))
        if len(frame_shape) != 2:
            parser.error("--stream-frame-shape expects H,W")
    if args.bottomup is not None:
        del common["boxes"]  # whole frames in
        records = run_video_bottomup(predictor, frames,
                                     score_threshold=args.detector_threshold, **common)
    elif args.stream_batch is not None and args.fused:
        del common["boxes"]
        fused = FusedTwoStagePredictor(
            detector=detector, pose=predictor,
            max_people=min(args.max_people, detector.max_detections),
            score_threshold=(detector.score_threshold if args.detector_threshold is None
                             else args.detector_threshold))
        records = run_video_fused_stream(fused, frames, batch=args.stream_batch or 4,
                                         frame_shape=frame_shape, **common)
    elif args.stream_batch is not None:
        records = run_video_stream(predictor, frames, batch=args.stream_batch or stream_batch,
                                   frame_shape=frame_shape, **common)
    else:
        records = run_video(predictor, frames, detector=detector,
                            detector_threshold=args.detector_threshold, fused=args.fused,
                            max_people=args.max_people, **common)

    n = 0
    with (args.out / "poses.jsonl").open("w") as sink:
        for rec in records:
            sink.write(json.dumps({k: v.tolist() if isinstance(v, np.ndarray) else v
                                   for k, v in rec.items()}) + "\n")
            if args.render:
                import PIL.Image

                from probpose_pytorch_tpu_torch.viz import draw_keypoints

                img = PIL.Image.fromarray(last["frame"])
                for p in range(len(rec["smoothed"])):
                    draw_keypoints(img, rec["smoothed"][p], rec["probabilities"][p],
                                   prob_threshold=args.prob_threshold)
                img.save(args.out / f"frame_{rec['frame']:06d}.png")
            n += 1
    print(f"wrote {args.out}/poses.jsonl ({n} frames)")


if __name__ == "__main__":
    main()
