"""The training loop (port of probpose_pytorch_tpu/train/loop.py): one train
step (encode -> forward -> loss -> backward -> update), an eval step with
accuracies, and `Trainer` with `create` and `fit`.

The step runs eagerly on the model's device. Targets are encoded on the
device from the batch's keypoints, the ViT trunk runs kernel K1 forward
and backward in every block and the head runs kernel K2, and the update is
the functional AdamW of train/state.py applied in place. Nothing in the
step reads a value back to the host.

What the JAX loop does and this one does not yet raises
`NotImplementedError` naming its ROADMAP item: augmentation and
distillation (item 11), best-checkpoint tracking, asynchronous
checkpoints, resume and non-finite recovery in `fit` (which writes no
checkpoints yet), frozen-parameter masks (item 6), meshes and pipelines
(item 13).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from probpose_pytorch_tpu_torch.codec import ArgMaxProbMap, Codec, ProbMap
from probpose_pytorch_tpu_torch.losses import ProbPoseLoss
from probpose_pytorch_tpu_torch.models.model import build_model, resolve_device
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize, transform_keypoints
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.state import AdamW, TrainState, global_norm, make_optimizer

__all__ = ["build_codecs", "make_train_step", "make_eval_step", "Trainer"]

# A callable the train step calls after each of its stages with the stage's
# name ("encode", "forward", "loss", "backward", "optimizer"); chip_smoke.py
# records a CUDA event there.
StageMark = Callable[[str], None]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


def build_codecs(cfg: TrainConfig) -> tuple[Codec, Codec]:
    """(encode codec, loss-decode codec): a ProbMap with the fixed spread
    `cfg.sigma` encodes the targets, an ArgMaxProbMap with `decode_sigma`
    decodes both heatmaps inside the loss."""
    if cfg.model.head_type == "simcc":
        raise _unported("head_type='simcc'", 9)
    sigmas = np.full(cfg.model.num_keypoints, cfg.kpt_sigma_value, np.float32)
    img_wh = (cfg.model.img_size[1], cfg.model.img_size[0])
    W, H = cfg.model.heatmap_size
    encode_codec = Codec(ProbMap(img_wh, (W, H), sigmas=sigmas, sigma=cfg.sigma))
    fast_codec = Codec(ArgMaxProbMap(img_wh, (W, H), sigmas=sigmas, sigma=cfg.decode_sigma))
    return encode_codec, fast_codec


def _prepare_images(images: torch.Tensor) -> torch.Tensor:
    return images.float() / 255.0 if images.dtype == torch.uint8 else images


def _encode_targets(codec: Codec, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    enc = codec.encode(batch["keypoints"], batch["keypoints_visible"],
                       keypoints_visibility=batch["keypoints_visibility"])
    return dict(
        in_image=enc["in_image"],
        keypoints_visible=batch["keypoints_visible"],
        keypoints_visibility=batch["keypoints_visibility"],
        keypoint_weights=enc["keypoint_weights"],
        heatmaps=enc["heatmaps"],
    )


def _augment_encode(cfg: TrainConfig, encode_codec: Codec,
                    batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """(images, gt) of a batch without augmentation. Crop mode: `image`
    (B, H, W, 3) uint8 or float crops with crop-space keypoints. Frame mode:
    `frame` (B, Hs, Ws, 3) and `box` (B, 4) xywh with frame-space
    keypoints, cropped here with the port's crop_resize."""
    if "frame" in batch:
        H, W = cfg.model.img_size
        boxes = batch["box"].float()
        images = crop_resize(batch["frame"], boxes, (H, W), cfg.preprocess_method)
        batch = dict(batch, keypoints=transform_keypoints(
            batch["keypoints"].float(), boxes, (H, W)))
    else:
        images = _prepare_images(batch["image"])
    return images, _encode_targets(encode_codec, batch)


def _total(losses: dict[str, torch.Tensor], weights: dict[str, float]) -> torch.Tensor:
    return sum(losses[k] * w for k, w in weights.items())


def make_train_step(model: torch.nn.Module, encode_codec: Codec, loss_fn: ProbPoseLoss,
                    tx: AdamW, cfg: TrainConfig) -> Callable:
    """The train step: (state, batch[, mark]) -> (state, metrics), batch a
    dict of tensors on the model's device. The state is updated in place
    and returned. Metrics stay on the device: `loss`, `loss/<term>` and
    `grad_norm`, the global norm of the gradients before clipping."""
    aug = cfg.augment
    if aug is not None and (aug.enabled or aug.half_body_prob > 0):
        raise _unported("augmentation (TrainConfig.augment; set it to null)", 11)
    weights = cfg.loss_weights.as_dict()

    def step(state: TrainState, batch: dict[str, torch.Tensor],
             mark: StageMark | None = None):
        mark = mark or (lambda name: None)
        images, gt = _augment_encode(cfg, encode_codec, batch)
        mark("encode")
        model.train()
        pred = model(images)
        mark("forward")
        losses = loss_fn(gt, pred, learn_heatmaps_from_zeros=cfg.learn_heatmaps_from_zeros)
        total = _total(losses, weights)
        mark("loss")
        grads = torch.autograd.grad(total, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, state.params)]
        mark("backward")
        grad_norm = global_norm(grads)
        state.apply_gradients(grads, tx, ema_decay=cfg.optim.ema_decay)
        mark("optimizer")
        metrics = {"loss": total.detach(),
                   **{f"loss/{k}": v.detach() for k, v in losses.items()},
                   "grad_norm": grad_norm}
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, encode_codec: Codec, loss_fn: ProbPoseLoss,
                   cfg: TrainConfig) -> Callable:
    """(state, batch) -> metrics: losses, accuracies (`acc/<term>`),
    `max_heatmap` and `mean_prob`, with the model in eval mode and the
    BatchNorm running statistics."""
    weights = cfg.loss_weights.as_dict()

    @torch.no_grad()
    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        images, gt = _augment_encode(cfg, encode_codec, batch)
        model.eval()
        pred = model(images)
        losses, acc = loss_fn(gt, pred, compute_acc=True)
        return {
            "loss": _total(losses, weights),
            **{f"loss/{k}": v for k, v in losses.items()},
            **{f"acc/{k}": v for k, v in acc.items()},
            "max_heatmap": pred[0].max(),
            "mean_prob": pred[1].mean(),
        }

    return step


@dataclass
class Trainer:
    """Model, codecs, loss, optimizer, state and steps of one run.

        trainer = Trainer.create(cfg, steps_per_epoch, device="cuda")
        trainer.fit(lambda: batch_iterator(dataset, cfg.train_batch_size))
    """

    cfg: TrainConfig
    model: torch.nn.Module
    encode_codec: Codec
    fast_codec: Codec
    loss_fn: ProbPoseLoss
    tx: AdamW
    state: TrainState
    train_step: Callable
    eval_step: Callable
    device: torch.device
    # (prefix, step, metrics) of every line `fit` and `validate` logged.
    history: list[tuple[str, int, dict[str, float]]] = field(default_factory=list)

    @classmethod
    def create(cls, cfg: TrainConfig, steps_per_epoch: int,
               device: torch.device | str = "cuda") -> "Trainer":
        """Weights drawn from `cfg.seed` (compat/from_jax.py loads a JAX
        run's state instead); the schedule spans steps_per_epoch * epochs.
        Runs on the card unless `device` asks for the CPU."""
        device = resolve_device(device, "Trainer.create")
        if cfg.model_parallel > 1 or cfg.pipeline_parallel > 1 or cfg.shard_opt_state:
            raise _unported("model_parallel, pipeline_parallel and shard_opt_state", 13)
        if cfg.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule {cfg.pipeline_schedule!r}")
        if cfg.distill is not None and cfg.distill.teacher_checkpoint:
            raise _unported("distillation (TrainConfig.distill)", 11)
        if cfg.model.frozen_backbone or cfg.train_lora_only:
            raise _unported("frozen-parameter masks (frozen_backbone, train_lora_only)", 6)
        model = build_model(cfg.model, device, seed=cfg.seed)
        encode_codec, fast_codec = build_codecs(cfg)
        loss_fn = ProbPoseLoss(fast_codec, freeze_error=cfg.freeze_error,
                               freeze_oks=cfg.freeze_oks)
        tx = make_optimizer(cfg.optim, steps_per_epoch * cfg.epochs)
        state = TrainState(model, tx, ema=cfg.optim.ema_decay is not None)
        return cls(
            cfg=cfg, model=model, encode_codec=encode_codec, fast_codec=fast_codec,
            loss_fn=loss_fn, tx=tx, state=state,
            train_step=make_train_step(model, encode_codec, loss_fn, tx, cfg),
            eval_step=make_eval_step(model, encode_codec, loss_fn, cfg),
            device=device,
        )

    def device_batch(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """A host batch (numpy arrays) as tensors on the model's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def fit(self, train_batches: Callable[[], Iterable[dict[str, Any]]],
            val_batches: Callable[[], Iterable[dict[str, Any]]] | None = None,
            max_steps: int | None = None) -> TrainState:
        """Run `cfg.epochs` epochs of `train_batches()` (or `max_steps`
        steps), printing the metrics every `log_every` steps and the
        averaged eval metrics every `val_every`; each logged line is kept in
        `self.history`. It writes no checkpoints (ROADMAP item 6), so
        `checkpoint_every_epochs` has no effect here; what only
        checkpointing serves (`track_best_metric`, `async_checkpoint`,
        resume from `out_dir/checkpoints`) and recovery from non-finite
        losses raise."""
        cfg = self.cfg
        if cfg.track_best_metric or cfg.async_checkpoint:
            raise _unported("checkpoints in Trainer.fit (track_best_metric, async_checkpoint)", 6)
        ckpt_dir = Path(cfg.out_dir) / "checkpoints"
        if cfg.resume and ckpt_dir.is_dir() and any(ckpt_dir.iterdir()):
            raise _unported(f"resume from {ckpt_dir}", 6)
        step_idx = start = int(self.state.step)
        t0, last_log, strikes = time.perf_counter(), None, 0
        for _ in range(cfg.epochs):
            for batch in train_batches():
                _, metrics = self.train_step(self.state, self.device_batch(batch))
                if step_idx % cfg.log_every == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    host["steps_per_sec"] = ((step_idx - last_log) / dt
                                             if last_log is not None and dt > 0 else 0.0)
                    last_log, t0 = step_idx, time.perf_counter()
                    self._log("training", step_idx, host)
                    if cfg.recover_on_nonfinite and not math.isfinite(host["loss"]):
                        strikes += 1
                        if strikes >= 2:
                            raise _unported(
                                f"recovery from the non-finite loss at step {step_idx}", 6)
                    else:
                        strikes = 0
                if val_batches is not None and step_idx % cfg.val_every == 0:
                    tv = time.perf_counter()
                    self.validate(val_batches, step_idx)
                    t0 += time.perf_counter() - tv
                step_idx += 1
                if max_steps is not None and step_idx - start >= max_steps:
                    return self.state
        return self.state

    def validate(self, val_batches: Callable[[], Iterable[dict[str, Any]]],
                 step_idx: int) -> dict[str, float] | None:
        """Eval metrics averaged over `val_batches()`, summed on the device
        and read back once."""
        total, n = None, 0
        for batch in val_batches():
            m = self.eval_step(self.state, self.device_batch(batch))
            total = m if total is None else {k: total[k] + m[k] for k in m}
            n += 1
        if total is None:
            return None
        averaged = {k: float(v) / n for k, v in total.items()}
        self._log("validation", step_idx, averaged)
        return averaged

    def _log(self, prefix: str, step_idx: int, metrics: dict[str, float]) -> None:
        self.history.append((prefix, step_idx, metrics))
        print(f"[{prefix}] step {step_idx} "
              + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()), flush=True)
