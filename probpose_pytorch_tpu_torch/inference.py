"""Batched top-down predictor (port of the serving path of
probpose_pytorch_tpu/inference.py: TopDownPredictor, predict_stream and
load_predictor).

frames + person boxes -> crop_resize ("bilinear_matmul") -> ProbPoseModel
(ViT trunk with kernel K1, ProbMap head with kernel K2) -> Codec.decode ->
keypoints mapped back to frame space. Returns the JAX predictor's dict of
numpy arrays: keypoints (B, K, 2), scores (B, K), and probabilities,
visibilities, oks, errors (B, 1, K), plus heatmaps (B, K, H, W) with
`return_heatmaps`. Flip-test and multi-scale TTA and per-branch temperature
calibration run on the model's device, as the JAX predictor runs them
inside its jitted program.

Not ported yet: quantisation (ROADMAP item 12), mesh serving (item 13), and
`predict_frame` with its buckets, NMS and detector mode (item 8).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from probpose_pytorch_tpu_torch.codec import Codec
from probpose_pytorch_tpu_torch.eval.calibration import P_HI, P_LO
from probpose_pytorch_tpu_torch.models.model import ProbPoseModel
from probpose_pytorch_tpu_torch.ops.augment import average_flip_pred
from probpose_pytorch_tpu_torch.ops.preprocess import (
    crop_resize,
    untransform_keypoints,
)
from probpose_pytorch_tpu_torch.train.config import COCO_FLIP_PAIRS

__all__ = ["TopDownPredictor", "load_predictor"]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP item {item})"
    )


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
    codec: Codec
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
    quantize: str | None = None
    mesh: Any = None

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
        if self.quantize is not None:
            raise _unported(f"TopDownPredictor(quantize={self.quantize!r})", 12)
        if self.mesh is not None:
            raise _unported("TopDownPredictor(mesh=...)", 13)
        self.model.eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _predict_boxes(self, frames: torch.Tensor, boxes: torch.Tensor):
        """One forward (two with flip test) and decode at one box geometry,
        keypoints un-mapped to frame space; returns (fields, head output)."""
        crops = crop_resize(frames, boxes, self.input_size, self.preprocess_method)
        pred = self.model(crops)
        if self.flip_test:
            pairs = self.flip_pairs if self.flip_pairs is not None else COCO_FLIP_PAIRS
            # crops are (B, H, W, C): W is axis 2
            pred = average_flip_pred(pred, self.model(crops.flip(2)), pairs)
        (kpts, scores), probs, vis, oks, errs = self.codec.decode(pred)
        kpts = untransform_keypoints(kpts, boxes, self.input_size)
        return (kpts, scores, probs, vis, oks, errs), pred

    @torch.inference_mode()
    def predict(self, frames: torch.Tensor, boxes: torch.Tensor,
                frame_ids: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """The serving path on tensors already on the model's device; the
        outputs stay there (no host copy, no synchronisation)."""
        if frame_ids is not None:
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
            # (or first-scale) ones.
            out["heatmaps"] = pred_unit[0]
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
    parameters sit in the JAX function's places; `quantize` and `mesh`
    take only their defaults here. Runs on the card unless `device` asks
    for the CPU."""
    from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

    if quantize is not None:
        raise _unported(f"load_predictor(quantize={quantize!r})", 12)
    if mesh is not None:
        raise _unported("load_predictor(mesh=...)", 13)
    checkpoint_dir = Path(checkpoint_dir)
    if config_path is None:
        candidate = checkpoint_dir.parent / "config.json"
        config_path = candidate if candidate.exists() else None
    cfg = TrainConfig.load(config_path) if config_path else TrainConfig()
    ckpt = CheckpointManager(checkpoint_dir)
    if (cfg.model.attn_impl == "fused_tp"
            or ckpt.read_metadata().get("qkv_layout") == "head_major"):
        raise _unported("a head-major qkv layout (attn_impl='fused_tp')", 13)
    trainer = Trainer.create(cfg, steps_per_epoch=1, device=device)
    state = ckpt.restore(trainer.state)
    if ema and state.ema_params is not None:
        with torch.no_grad():
            torch._foreach_copy_(state.params, state.ema_params)
    return TopDownPredictor(
        model=trainer.model,
        codec=trainer.encode_codec,
        input_size=cfg.model.img_size,
        flip_test=flip_test,
        scale_test=scale_test,
        scale_test_scores=scale_test_scores,
        calibration=calibration,
    )
