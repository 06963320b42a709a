"""Batched top-down predictor and the single-image CLI (port of
probpose_pytorch_tpu/inference.py: TopDownPredictor with predict_stream and
predict_frame, the bucket ladder, load_predictor and main).

    python -m probpose_pytorch_tpu_torch.inference \
        --checkpoint runs/x/checkpoints --image img.jpg --output out/ \
        [--config runs/x/config.json] [--input-size 256,192] [--normalize] \
        [--device cuda]

frames + person boxes -> crop_resize ("bilinear_matmul", or any method of
JAX's `Method`) -> ProbPoseModel (ViT trunk with kernel K1, ProbMap head
with kernel K2, or the SimCC head) -> Codec.decode (SimCCCodec.decode) ->
keypoints mapped back to frame space. With `quantize="int8"` (or
"int8_wo", weight-only) the trunk is models/vit_int8.py's QuantizedViT,
its weights quantized once, before the same head. Returns the JAX
predictor's dict of numpy arrays: keypoints (B, K,
2), scores (B, K), and probabilities, visibilities, oks, errors (B, 1, K),
plus heatmaps (B, K, H, W) with `return_heatmaps` (for SimCC the outer
product of the two axes' softmaxes, (B, K, Hb, Wb)). Flip-test and
multi-scale TTA and per-branch temperature calibration run on the model's
device, as the JAX predictor runs them inside its jitted program.

`predict_frame` pads a variable box list to a batch bucket (the card's
record in configs/autotune_serving.json, keyed by
`torch.cuda.get_device_name()`, else powers of two), zero-pads the frame to
`frame_size_multiple` and can run pose OKS-NMS over the results.

With `detector=` (detect/pipeline.py:DetectorPredictor), `predict_frame`
without boxes runs standalone: the person detector finds the boxes.

With `mesh=` (parallel/mesh.py) it is JAX's mesh predictor on one rank of
the world: every rank calls it with the same batch and gets the whole
result. The rank crops its rows of the batch (the batch must divide the
data axis), the model runs them (on a model axis, "fused" weights are
converted to head-major and their heads split, as JAX's predictor does;
parallel/sharding.py), and the head's outputs are gathered over the ranks
before the one decode. Indexed frames stay single-device, as in JAX.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from probpose_pytorch_tpu_torch.codec import Codec
from probpose_pytorch_tpu_torch.codec_simcc import SimCCCodec
from probpose_pytorch_tpu_torch.eval.calibration import P_HI, P_LO
from probpose_pytorch_tpu_torch.models.model import ProbPoseModel
from probpose_pytorch_tpu_torch.models.vit_int8 import QuantizedViT
from probpose_pytorch_tpu_torch.ops.augment import average_flip_pred, average_flip_pred_simcc
from probpose_pytorch_tpu_torch.parallel.collectives import all_gather_cat
from probpose_pytorch_tpu_torch.parallel.sharding import shard_batch
from probpose_pytorch_tpu_torch.ops.preprocess import (
    crop_resize,
    untransform_keypoints,
)
from probpose_pytorch_tpu_torch.train.config import COCO_FLIP_PAIRS

__all__ = ["TopDownPredictor", "derive_bucket_ladder", "load_predictor", "main",
           "tuned_bucket_ladder", "tuned_serving_batch"]


def _mesh_model(model: ProbPoseModel, mesh: Any) -> ProbPoseModel:
    """A copy of a single-device model on `mesh`, as JAX's predictor
    re-clones its model (inference.py:247-296 there): on a model axis > 1,
    "fused" weights convert to head-major and run "fused_tp" with their
    heads split where the heads divide the axis; any fused attention that
    cannot split runs "einsum" (qkv-major) whole. On a pipe axis > 1 the
    trunk is stacked (compat/layouts.py:stack_state_dict) and served as a
    pipeline, each rank its stage. The weights are then laid on the mesh
    (parallel/sharding.py:shard_params)."""
    from probpose_pytorch_tpu_torch.compat.layouts import (
        qkv_to_head_major,
        qkv_to_qkv_major,
        stack_state_dict,
    )
    from probpose_pytorch_tpu_torch.models.vit import ViTBackbone, _StackedBlockParams
    from probpose_pytorch_tpu_torch.parallel.mesh import mesh_device, mesh_shape
    from probpose_pytorch_tpu_torch.parallel.sharding import shard_params

    model = copy.deepcopy(model)
    backbone = model.backbone
    shape = mesh_shape(mesh)
    model_size, pipe = shape.get("model", 1), shape.get("pipe", 1)
    if isinstance(backbone, ViTBackbone) and (model_size > 1 or pipe > 1):
        stacked = backbone.stacked or pipe > 1
        impl = backbone.attn_impl if backbone.stacked else backbone.blocks[0].attn.impl
        heads = backbone.num_heads
        sd = model.state_dict()
        impl_new = impl
        if model_size > 1:
            if impl in ("fused", "fused_tp") and heads % model_size == 0:
                impl_new = "fused_tp"
                if impl == "fused":
                    sd = qkv_to_head_major(sd, heads)
            elif impl in ("fused", "fused_tp", "pallas"):
                if stacked:
                    raise ValueError(
                        "tensor parallelism inside a pipeline stage requires "
                        "attn_impl='fused'/'fused_tp' with heads divisible by model_parallel "
                        f"(got attn_impl={impl!r}, model axis {model_size})")
                impl_new = "einsum"
                if impl == "fused_tp":
                    sd = qkv_to_qkv_major(sd, heads)
        if stacked and not backbone.stacked:
            depth = len(backbone.blocks)
            backbone.blocks = _StackedBlockParams(depth, backbone.embed_dim,
                                                  int(backbone.embed_dim * backbone.mlp_ratio))
            backbone.pp_stages = pipe
            sd = stack_state_dict(sd)
        model.load_state_dict(sd)
        backbone.attn_impl = impl_new
        if not backbone.stacked:
            for block in backbone.blocks:
                block.attn.impl = impl_new
    model.mesh = mesh
    shard_params(model, mesh)
    return model.to(mesh_device(mesh, next(model.parameters()).device))


def _check_quantize(quantize: str | None, mesh: Any) -> None:
    """JAX's refusals of a quantize mode (inference.py:217-220 there)."""
    if quantize is None:
        return
    if quantize not in ("int8", "int8_wo"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if mesh is not None:
        raise ValueError(f"quantize={quantize!r} is single-device only")


def _load_autotune_entry() -> dict:
    """This card's entry of the port's serving record
    (configs/autotune_serving.json, package data), keyed by
    `torch.cuda.get_device_name()`; {} on a host without CUDA or a card
    with no entry."""
    if not torch.cuda.is_available():
        return {}
    try:
        from importlib.resources import files

        text = (files("probpose_pytorch_tpu_torch")
                .joinpath("configs/autotune_serving.json").read_text())
        return json.loads(text)[torch.cuda.get_device_name()]
    except (KeyError, ValueError, RuntimeError, OSError):
        return {}


def tuned_serving_batch(default: int = 64) -> int:
    """Best serving batch recorded for this card; `default` without one."""
    try:
        return int(_load_autotune_entry()["batch"])
    except (KeyError, ValueError):
        return default


def derive_bucket_ladder(sweep: Sequence[dict], margin: float = 0.10) -> tuple[int, ...]:
    """Prune a measured per-batch latency sweep into a padding-bucket ladder.

    `predict_frame` pads a variable box count up to the next bucket, so a
    rung is worth keeping only when it is measurably faster than padding up
    to the next one. Walking from the largest batch down, a smaller batch
    stays on the ladder iff its latency beats the next kept rung by at least
    `margin`.

    sweep rows: {"batch": int, "ms_per_batch": float} (extra keys ignored).
    Returns ascending batch sizes ending at the largest swept batch.
    """
    rows = sorted(({"batch": int(r["batch"]), "ms": float(r["ms_per_batch"])} for r in sweep),
                  key=lambda r: r["batch"])
    if not rows:
        raise ValueError("empty sweep")
    bad = [r for r in rows if r["ms"] <= 0]
    if bad:
        raise ValueError(
            f"non-positive latency for batches {[r['batch'] for r in bad]} — "
            "below the measurement noise floor; re-sweep with more repeats")
    ladder = [rows[-1]]
    for row in reversed(rows[:-1]):
        if row["ms"] < ladder[-1]["ms"] * (1.0 - margin):
            ladder.append(row)
    return tuple(r["batch"] for r in reversed(ladder))


def tuned_bucket_ladder() -> tuple[int, ...] | None:
    """The `predict_frame` bucket ladder recorded for this card, or None."""
    ladder = _load_autotune_entry().get("bucket_ladder")
    if ladder:
        return tuple(int(b) for b in ladder)
    return None


def _scale_boxes(boxes: torch.Tensor, s: float) -> torch.Tensor:
    """Rescale xywh boxes about their centers by factor `s` (multi-scale
    TTA geometry: the crop sees s x more context at s > 1)."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack(
        [x + w * (1.0 - s) / 2.0, y + h * (1.0 - s) / 2.0, w * s, h * s], dim=-1)


def _rescale(p: torch.Tensor, t: float) -> torch.Tensor:
    """Temperature scaling of sigmoid probabilities in f32: clip to
    [P_LO, P_HI] (the host metrics' clip, which keeps the logit finite),
    logit, divide by T, sigmoid."""
    p = p.float().clamp(P_LO, P_HI)
    return torch.sigmoid((torch.log(p) - torch.log1p(-p)) / float(t))


@dataclasses.dataclass
class TopDownPredictor:
    model: ProbPoseModel
    codec: Codec | SimCCCodec
    input_size: tuple[int, int]  # (H, W)
    preprocess_method: str = "bilinear_matmul"
    return_heatmaps: bool = False
    # Flip-test TTA: a second forward on the W-mirrored crops, averaged with
    # the first (ops/augment.py:average_flip_pred). flip_pairs defaults to
    # the COCO-17 skeleton.
    flip_test: bool = False
    flip_pairs: tuple | None = None
    # Multi-scale TTA: each box re-cropped at these scales about its center,
    # decoded in its own crop geometry and averaged in frame space; () off.
    scale_test: tuple[float, ...] = ()
    # Under multi-scale, "unit" keeps the unit-scale (or first-scale)
    # forward's confidence fields; "mean" averages them too.
    scale_test_scores: str = "unit"
    # Per-branch temperatures {"presence": T, "visibility": T}, applied to
    # `probabilities` / `visibilities` in logit space on the device.
    calibration: dict | None = None
    # "int8": the trunk's qkv, proj, fc1 and fc2 as int8 x int8 -> int32
    # products with dynamic per-row activation scales; "int8_wo": int8
    # weights dequantized into bf16 products (models/vit_int8.py). Plain ViT
    # trunks only (no prefix tokens, no adapters), single device.
    quantize: str | None = None
    mesh: Any = None
    # `predict_frame` zero-pads the frame's (H, W) up to this multiple, so
    # slightly different camera sizes share one padded shape; crop_resize
    # samples black outside the frame either way. None keeps exact shapes.
    frame_size_multiple: int | None = 64
    detector: Any = None

    def __post_init__(self):
        self.scale_test = tuple(float(s) for s in (self.scale_test or ()))
        if any(s <= 0 for s in self.scale_test):
            raise ValueError(f"scale_test must be positive: {self.scale_test}")
        if self.scale_test_scores not in ("unit", "mean"):
            raise ValueError(
                f"scale_test_scores must be 'unit' or 'mean': {self.scale_test_scores!r}")
        if self.calibration:
            bad = set(self.calibration) - {"presence", "visibility"}
            if bad:
                raise ValueError(f"unknown calibration branches {sorted(bad)}; expected "
                                 "'presence' and/or 'visibility'")
            for k, t in self.calibration.items():
                t = float(t)
                if not (0.0 < t < float("inf")):
                    raise ValueError(f"calibration temperature {k}={t!r} must be a "
                                     "positive finite float")
        _check_quantize(self.quantize, self.mesh)
        if self.mesh is not None and getattr(self.model, "mesh", None) is not self.mesh:
            self.model = _mesh_model(self.model, self.mesh)
        if self.quantize is not None:
            weight_only = self.quantize == "int8_wo"
            bb = self.model.backbone
            if not (isinstance(bb, QuantizedViT) and bb.weight_only == weight_only):
                # not a copy of a quantized predictor (dataclasses.replace):
                # the float trunk's weights are quantized once (QuantizedViT
                # refuses any other trunk); the head is shared with the
                # float model
                self.model = ProbPoseModel(QuantizedViT(bb, weight_only), self.model.head)
        self.model.eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _forward(self, crops: torch.Tensor):
        """The model's outputs of the batch: on a mesh, of this rank's
        crops gathered over the ranks whose head rows make the batch."""
        pred = self.model(crops)
        if self.mesh is None:
            return pred
        group = self.model.head_group(crops.shape[0])
        gather = lambda t: all_gather_cat(t, group)
        return tuple([gather(t) for t in x] if isinstance(x, (tuple, list)) else gather(x)
                     for x in pred)

    def _predict_boxes(self, frames: torch.Tensor, boxes: torch.Tensor):
        """One forward (two with flip test) and decode at one box geometry,
        keypoints un-mapped to frame space; returns (fields, head output)."""
        if self.mesh is None:
            crops = crop_resize(frames, boxes, self.input_size, self.preprocess_method)
        else:  # this rank's rows
            crops = crop_resize(shard_batch(frames, self.mesh), shard_batch(boxes, self.mesh),
                                self.input_size, self.preprocess_method)
        pred = self._forward(crops)
        if self.flip_test:
            pairs = self.flip_pairs if self.flip_pairs is not None else COCO_FLIP_PAIRS
            # crops are (B, H, W, C): W is axis 2
            pred_f = self._forward(crops.flip(2))
            if isinstance(pred[0], (tuple, list)):
                pred = average_flip_pred_simcc(pred, pred_f, pairs, self.codec.label.split_ratio)
            else:
                pred = average_flip_pred(pred, pred_f, pairs)
        (kpts, scores), probs, vis, oks, errs = self.codec.decode(pred)
        kpts = untransform_keypoints(kpts, boxes, self.input_size)
        return (kpts, scores, probs, vis, oks, errs), pred

    @torch.inference_mode()
    def predict(self, frames: torch.Tensor, boxes: torch.Tensor,
                frame_ids: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """The serving path on tensors already on the model's device; the
        outputs stay there (no host copy, no synchronisation)."""
        if frame_ids is not None:
            if self.mesh is not None:
                raise ValueError("indexed frames are single-device; mesh serving takes "
                                 "per-crop frames")
            # indexed serving: frames holds each unique frame once.
            frames = frames.index_select(0, frame_ids)
        scales = self.scale_test or (1.0,)
        results = []
        pred_unit = unit_fields = None
        for s in scales:
            boxes_s = boxes if s == 1.0 else _scale_boxes(boxes, s)
            fields, pred = self._predict_boxes(frames, boxes_s)
            results.append(fields)
            if pred_unit is None or s == 1.0:
                pred_unit, unit_fields = pred, fields
        if len(results) == 1:
            kpts, scores, probs, vis, oks, errs = results[0]
        else:
            kpts, scores, probs, vis, oks, errs = (
                sum(field) / len(scales) for field in zip(*results))
            if self.scale_test_scores == "unit":
                _, scores, probs, vis, oks, errs = unit_fields
        if self.calibration:
            if "presence" in self.calibration:
                probs = _rescale(probs, self.calibration["presence"])
            if "visibility" in self.calibration:
                vis = _rescale(vis, self.calibration["visibility"])
        out = dict(keypoints=kpts, scores=scores, probabilities=probs,
                   visibilities=vis, oks=oks, errors=errs)
        if self.return_heatmaps:
            # Maps of different box geometries share no grid: the unit-scale
            # (or first-scale) ones. SimCC renders the outer product of its
            # two axes' distributions, which the CLI's PNG dump takes as is.
            loc = pred_unit[0]
            if isinstance(loc, (tuple, list)):
                px, py = (torch.softmax(t.float(), dim=-1) for t in loc)
                loc = py[..., :, None] * px[..., None, :]
            out["heatmaps"] = loc
        return out

    def _dispatch(self, frames: np.ndarray, boxes: np.ndarray,
                  frame_ids: np.ndarray | None = None) -> dict[str, torch.Tensor]:
        """Upload one batch and launch its work; returns the outputs on the
        device, still being computed there."""
        dev = self.device
        f = torch.as_tensor(np.asarray(frames)).to(dev)
        b = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
        ids = None
        if frame_ids is not None:
            ids = torch.as_tensor(np.asarray(frame_ids, np.int64)).to(dev)
        return self.predict(f, b, ids)

    @staticmethod
    def _download(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def __call__(self, frames: np.ndarray, boxes: np.ndarray,
                 frame_ids: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """frames (B, Hs, Ws, 3) uint8, boxes (B, 4) xywh -> dict of numpy
        arrays with frame-space keypoints. With frame_ids (B,), frames holds
        each unique frame once and crop i reads frames[frame_ids[i]]."""
        return self._download(self._dispatch(frames, boxes, frame_ids))

    def predict_stream(self, batches, depth: int = 2):
        """Stream serving: iterate (frames, boxes) or (frames, boxes,
        frame_ids) batches and yield their output dicts in order, with up
        to `depth` batches in flight. Uploads and launches run on one
        worker thread while this thread downloads, so batch i+1's upload
        overlaps batch i's compute and readback."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        in_flight: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as pool:
            for item in batches:
                in_flight.append(pool.submit(self._dispatch, *item))
                if len(in_flight) > depth:
                    yield self._download(in_flight.popleft().result())
            while in_flight:
                yield self._download(in_flight.popleft().result())

    def predict_frame(
        self,
        frame: np.ndarray,
        boxes: np.ndarray | None = None,
        buckets: tuple[int, ...] | None = None,
        nms: str | None = None,
        nms_threshold: float = 0.9,
        nms_sigmas: np.ndarray | None = None,
        detector_threshold: float | None = None,
    ) -> dict:
        """Variable-count person boxes (N, 4) xywh on one (H, W, 3) uint8
        frame: the box list pads to the next bucket (unless given: the card's
        recorded ladder, else powers of two up to `tuned_serving_batch()`;
        a list past the top bucket runs in top-bucket parts),
        the frame zero-pads to `frame_size_multiple` and crosses to the
        device once (indexed, frame_ids all 0), and the padding rows are
        stripped from the outputs; {} for no boxes.

        nms: None, "oks" or "soft_oks": pose-level OKS-NMS over the results
        (ops/oks_nms.py), pose score = mean over keypoints of score x
        probability, OKS area = box w*h. Adds "pose_scores" (decayed ones
        under "soft_oks") and "keep", the input-box indices of the kept
        poses.

        boxes=None (standalone mode, needs `detector=`): the detector's
        boxes above `detector_threshold` (default: the detector's own),
        expanded to the crop aspect (`expand_detections`), are used and
        returned under "boxes"."""
        if boxes is None:
            if self.detector is None:
                raise ValueError("predict_frame needs boxes, or construct the predictor "
                                 "with detector= for standalone mode")
            from probpose_pytorch_tpu_torch.detect.pipeline import expand_detections

            det, _ = self.detector.detect_frame(frame, detector_threshold)
            boxes = expand_detections(det, self.input_size)
            out = self.predict_frame(frame, boxes, buckets, nms, nms_threshold, nms_sigmas)
            if out:
                kept = out.get("keep")
                out["boxes"] = boxes if kept is None else boxes[kept]
            else:
                out = {"boxes": boxes}
            return out
        if nms is not None:
            raw = self.predict_frame(frame, boxes, buckets)
            if not raw:
                return raw
            from probpose_pytorch_tpu_torch.ops.oks_nms import oks_nms, soft_oks_nms

            pose_scores = (raw["scores"] * raw["probabilities"][:, 0, :]).mean(axis=1)
            boxes = np.asarray(boxes, np.float32)
            areas = boxes[:, 2] * boxes[:, 3]
            if nms == "oks":
                keep = oks_nms(raw["keypoints"], pose_scores, areas,
                               threshold=nms_threshold, sigmas=nms_sigmas)
                kept_scores = pose_scores[keep]
            elif nms == "soft_oks":
                keep, kept_scores = soft_oks_nms(raw["keypoints"], pose_scores, areas,
                                                 threshold=nms_threshold, sigmas=nms_sigmas)
            else:
                raise ValueError(f"unknown nms mode {nms!r}")
            out = {k: v[keep] for k, v in raw.items()}
            out["pose_scores"] = np.asarray(kept_scores, np.float32)
            out["keep"] = np.asarray(keep, np.int64)
            return out
        if buckets is None:
            buckets = tuned_bucket_ladder()
        if buckets is None:
            top = tuned_serving_batch()
            buckets = tuple(b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                            if b < top) + (top,)
        n = len(boxes)
        if n == 0:
            return {}
        bucket = next((b for b in buckets if b >= n), None)
        if bucket is None:
            parts = [self.predict_frame(frame, boxes[i:i + buckets[-1]], buckets)
                     for i in range(0, n, buckets[-1])]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        m = self.frame_size_multiple
        if m:
            pad_h, pad_w = -frame.shape[0] % m, -frame.shape[1] % m
            if pad_h or pad_w:
                frame = np.pad(frame, ((0, pad_h), (0, pad_w), (0, 0)))
        padded = np.concatenate([boxes, np.tile(boxes[-1:], (bucket - n, 1))],
                                axis=0).astype(np.float32)
        if self.mesh is None:
            # indexed: the frame crosses the host->device link once
            out = self(frame[None], padded, np.zeros((bucket,), np.int64))
        else:
            out = self(np.broadcast_to(frame, (bucket, *frame.shape)), padded)
        return {k: v[:n] for k, v in out.items()}


def load_predictor(
    checkpoint_dir: str | Path,
    config_path: str | Path | None = None,
    ema: bool = False,
    quantize: str | None = None,
    mesh: Any = None,
    flip_test: bool = False,
    scale_test: tuple[float, ...] = (),
    scale_test_scores: str = "unit",
    calibration: dict | None = None,
    device: torch.device | str = "cuda",
) -> TopDownPredictor:
    """A predictor from a checkpoint directory of the port's training
    (train/checkpoint.py: the latest `<checkpoint_dir>/<step>`) and its
    config JSON, which defaults to `<checkpoint_dir>/../config.json`, then
    to the flagship defaults. With `ema`, the EMA parameters. The
    parameters sit in the JAX function's places; `quantize` quantizes the
    trunk (TopDownPredictor's). On a `mesh` the trainer of the config is
    laid on it ("fused" becomes "fused_tp" on a model axis) and the
    checkpoint's qkv layout converted to its (restore_state_with_layout).
    Runs on the card unless `device` asks for the CPU."""
    from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.loop import restore_state_with_layout

    _check_quantize(quantize, mesh)
    checkpoint_dir = Path(checkpoint_dir)
    if config_path is None:
        candidate = checkpoint_dir.parent / "config.json"
        config_path = candidate if candidate.exists() else None
    cfg = TrainConfig.load(config_path) if config_path else TrainConfig()
    ckpt = CheckpointManager(checkpoint_dir)
    trainer = Trainer.create(cfg, steps_per_epoch=1, mesh=mesh, device=device)
    state = restore_state_with_layout(ckpt, trainer.state, trainer.cfg)
    if ema and state.ema_params is not None:
        with torch.no_grad():
            torch._foreach_copy_(state.params, state.ema_params)
    return TopDownPredictor(
        model=trainer.model,
        codec=trainer.encode_codec,
        input_size=cfg.model.img_size,
        mesh=mesh,
        flip_test=flip_test,
        scale_test=scale_test,
        scale_test_scores=scale_test_scores,
        calibration=calibration,
        quantize=quantize,
    )


def main(argv: Sequence[str] | None = None) -> None:
    """The single-image CLI: the whole image as one box through the
    predictor, writing heatmap_{i}.png, output_image.png and
    predictions.json to --output. Runs on the card unless --device cpu."""
    parser = argparse.ArgumentParser(description="ProbPose inference (PyTorch)")
    parser.add_argument("--checkpoint", type=Path, required=True,
                        help="checkpoint directory of the port's training CLI")
    parser.add_argument("--config", type=Path, default=None,
                        help="TrainConfig JSON (default: beside checkpoint)")
    parser.add_argument("--image", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--input-size", type=str, default=None, help="H,W override")
    parser.add_argument("--normalize", action="store_true",
                        help="normalize heatmap PNGs to their max")
    parser.add_argument("--prob-threshold", type=float, default=0.9)
    parser.add_argument("--ema", action="store_true", help="use EMA params")
    parser.add_argument("--int8", action="store_true",
                        help="post-training int8-quantized backbone products "
                        "(models/vit_int8.py)")
    parser.add_argument("--int8-weight-only", action="store_true",
                        help="weight-only int8 backbone products (bf16 activations)")
    parser.add_argument("--flip-test", action="store_true",
                        help="flip-test TTA: average predictions with the horizontally "
                        "mirrored forward (COCO-17 left/right pairs)")
    parser.add_argument("--scale-test", type=str, default="",
                        help="multi-scale TTA: comma-separated box scales (e.g. "
                        "'0.9,1.0,1.1'); predictions decode per scale and average in "
                        "frame space")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import PIL.Image

    from probpose_pytorch_tpu_torch.viz import draw_keypoints, inferno_rgba

    predictor = load_predictor(
        args.checkpoint, args.config, ema=args.ema,
        quantize="int8_wo" if args.int8_weight_only else "int8" if args.int8 else None,
        flip_test=args.flip_test,
        scale_test=tuple(float(s) for s in args.scale_test.split(",") if s.strip()),
        device=args.device,
    )
    predictor.return_heatmaps = True  # one forward serves decode and PNGs
    if args.input_size:
        h, w = (int(v) for v in args.input_size.split(","))
        predictor.input_size = (h, w)

    image = PIL.Image.open(args.image).convert("RGB")
    frame = np.asarray(image, np.uint8)[None]
    # the whole image as the box, as the JAX CLI does
    box = np.array([[0, 0, frame.shape[2], frame.shape[1]]], np.float32)
    out = predictor(frame, box)

    args.output.mkdir(parents=True, exist_ok=True)
    hm = out.pop("heatmaps")[0].astype(np.float32)
    for i in range(hm.shape[0]):
        h = hm[i] / hm[i].max() if args.normalize and hm[i].max() > 0 else hm[i]
        PIL.Image.fromarray(inferno_rgba(h)).save(args.output / f"heatmap_{i}.png")

    rendered = draw_keypoints(image, out["keypoints"][0], out["probabilities"][0, 0],
                              prob_threshold=args.prob_threshold)
    rendered.save(args.output / "output_image.png")
    (args.output / "predictions.json").write_text(
        json.dumps({k: v.tolist() for k, v in out.items()}, indent=2))
    print(f"wrote {args.output}/output_image.png, heatmap_*.png, predictions.json")


if __name__ == "__main__":
    main()
