"""The training loop (port of probpose_pytorch_tpu/train/loop.py): one train
step (augment -> encode -> forward -> loss -> backward -> update), an eval
step with accuracies, and `Trainer` with `create` and `fit`.

The step runs eagerly on the model's device. Augmentation (ROADMAP item 6,
ops/augment.py) draws from generators seeded by (seed, domain, step) on the
host, targets are encoded on the device from the batch's keypoints, the
ViT trunk runs kernel K1 forward and backward in every block and the head
runs kernel K2 (the SimCC head runs no kernel; its targets are 1-D bin
labels and its loss is losses_simcc.py's), and the update is the
functional optimizer of train/state.py (AdamW, Lion or Adafactor, in
optax's MultiSteps with accum_steps > 1) applied in place. Nothing in the
step reads a value back to the host.

`fit` logs to `<out_dir>/metrics.jsonl`, checkpoints into
`<out_dir>/checkpoints` (train/checkpoint.py), resumes from the latest,
restores it after persistent non-finite losses, tracks a best validation
metric and checkpoints on SIGTERM, as the JAX `fit` does.

`frozen_backbone` and `train_lora_only` mask the optimizer as the JAX
`Trainer.create` does (train/state.py). With `TrainConfig.distill`, a
frozen teacher loaded from a port checkpoint runs in eval mode on the
step's augmented crops and the student also learns the MSE toward its
heatmaps (or SimCC logits) and scalar branches. What the JAX loop does and
this one does not yet raises `NotImplementedError` naming its ROADMAP
item: meshes and pipelines (item 13).
"""

from __future__ import annotations

import math
import signal
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from probpose_pytorch_tpu_torch.codec import ArgMaxProbMap, Codec, ProbMap
from probpose_pytorch_tpu_torch.codec_simcc import SimCCCodec, SimCCLabel
from probpose_pytorch_tpu_torch.data.pipeline import Prefetcher
from probpose_pytorch_tpu_torch.losses import ProbPoseLoss
from probpose_pytorch_tpu_torch.losses_simcc import SimCCLoss
from probpose_pytorch_tpu_torch.models.lora import lora_frozen_labels
from probpose_pytorch_tpu_torch.models.model import build_model, resolve_device
from probpose_pytorch_tpu_torch.ops.augment import (
    AugmentDraws,
    augment_boxes,
    color_jitter,
    draw_augment,
    flip_crops_and_keypoints,
    half_body_boxes,
    rotate_crops,
)
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize, transform_keypoints
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager, state_is_finite
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.state import (
    MultiSteps,
    Optimizer,
    TrainState,
    global_norm,
    make_optimizer,
    param_layouts,
)
from probpose_pytorch_tpu_torch.utils.logging import MetricsLogger

__all__ = ["build_codecs", "augment_batch", "load_teacher", "frozen_labels", "make_train_step",
           "make_eval_step", "Trainer"]

# A callable the train step calls after each of its stages with the stage's
# name ("encode", "forward", "loss", "backward", "optimizer"); chip_smoke.py
# records a CUDA event there.
StageMark = Callable[[str], None]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


def build_codecs(cfg: TrainConfig) -> tuple[Codec, Codec] | tuple[SimCCCodec, SimCCCodec]:
    """(encode codec, loss-decode codec): a ProbMap with the fixed spread
    `cfg.sigma` encodes the targets, an ArgMaxProbMap with `decode_sigma`
    decodes both heatmaps inside the loss. The SimCC family uses one codec
    in both roles: its argmax and parabola are the fast decode."""
    sigmas = np.full(cfg.model.num_keypoints, cfg.kpt_sigma_value, np.float32)
    img_wh = (cfg.model.img_size[1], cfg.model.img_size[0])
    if cfg.model.head_type == "simcc":
        codec = SimCCCodec(SimCCLabel(img_wh, split_ratio=cfg.model.simcc_split_ratio,
                                      sigma=cfg.model.simcc_sigma, sigmas=sigmas))
        return codec, codec
    W, H = cfg.model.heatmap_size
    encode_codec = Codec(ProbMap(img_wh, (W, H), sigmas=sigmas, sigma=cfg.sigma))
    fast_codec = Codec(ArgMaxProbMap(img_wh, (W, H), sigmas=sigmas, sigma=cfg.decode_sigma))
    return encode_codec, fast_codec


def _prepare_images(images: torch.Tensor) -> torch.Tensor:
    return images.float() / 255.0 if images.dtype == torch.uint8 else images


def _encode_targets(codec: Codec | SimCCCodec,
                    batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The loss's targets: heatmaps, or the SimCC family's x and y labels."""
    enc = codec.encode(batch["keypoints"], batch["keypoints_visible"],
                       keypoints_visibility=batch["keypoints_visibility"])
    targets = ("heatmaps",) if "heatmaps" in enc else ("x_labels", "y_labels")
    return dict(
        in_image=enc["in_image"],
        keypoints_visible=batch["keypoints_visible"],
        keypoints_visibility=batch["keypoints_visibility"],
        keypoint_weights=enc["keypoint_weights"],
        **{k: enc[k] for k in targets},
    )


def augment_batch(cfg: TrainConfig, batch: dict[str, torch.Tensor],
                  draws: AugmentDraws | None = None) -> tuple[torch.Tensor, dict]:
    """(crops, batch with crop-space keypoints and visibilities) of a batch,
    augmented with `draws` (None: not augmented, as the eval step), in the
    JAX order. Crop mode: `image` (B, H, W, 3) uint8 or float crops with
    crop-space keypoints. Frame mode: `frame` (B, Hs, Ws, 3) and `box`
    (B, 4) xywh with frame-space keypoints: the boxes take half-body, then
    scale and shift jitter, before crop_resize. Both modes: flip,
    rotation, then brightness and contrast on the crops."""
    aug = cfg.augment if draws is not None else None
    H, W = cfg.model.img_size
    if "frame" in batch:
        boxes = batch["box"].float()
        if aug is not None and aug.half_body_prob > 0:
            boxes = half_body_boxes(boxes, batch["keypoints"].float(),
                                    batch["keypoints_visibility"], draws.half_coin,
                                    draws.half_u, aug, aspect=W / H)
        if aug is not None and (aug.scale_jitter or aug.shift_jitter):
            boxes = augment_boxes(boxes, draws.scale, draws.shift)
        images = crop_resize(batch["frame"], boxes, (H, W), cfg.preprocess_method)
        batch = dict(batch, keypoints=transform_keypoints(
            batch["keypoints"].float(), boxes, (H, W)))
    else:
        images = _prepare_images(batch["image"])
    if aug is not None and aug.enabled:
        images, kpts, vis, visibility = flip_crops_and_keypoints(
            draws.flip, images, batch["keypoints"], batch["keypoints_visible"],
            batch["keypoints_visibility"], aug)
        if aug.rotation_deg > 0:
            images, kpts = rotate_crops(images, kpts, draws.theta)
        images = color_jitter(images, draws.brightness, draws.contrast)
        batch = dict(batch, keypoints=kpts, keypoints_visible=vis,
                     keypoints_visibility=visibility)
    return images, batch


def _augment_encode(cfg: TrainConfig, encode_codec: Codec, batch: dict[str, torch.Tensor],
                    draws: AugmentDraws | None = None) -> tuple[torch.Tensor, dict]:
    """(images, gt): `augment_batch`, then the targets encoded on the
    batch's device."""
    images, batch = augment_batch(cfg, batch, draws)
    return images, _encode_targets(encode_codec, batch)


def _total(losses: dict[str, torch.Tensor], weights: dict[str, float]) -> torch.Tensor:
    return sum(losses[k] * w for k, w in weights.items())


def load_teacher(cfg: TrainConfig, device: torch.device | str) -> torch.nn.Module:
    """The frozen distillation teacher of `cfg.distill`, in eval mode with
    no gradients, on `device`: the model of its config (`teacher_config`,
    default `<teacher_checkpoint>/../config.json`) with the parameters, or
    the EMA with `ema_teacher` when the checkpoint has one, and the BN
    statistics of the latest port checkpoint under `teacher_checkpoint`.
    Any architecture teaches whose head family, crop size and keypoint
    count match the student's (the MSE targets must share shapes)."""
    d = cfg.distill
    ckpt_dir = Path(d.teacher_checkpoint)
    config_path = Path(d.teacher_config) if d.teacher_config else ckpt_dir.parent / "config.json"
    tcfg = TrainConfig.load(config_path)
    if tcfg.model.head_type != cfg.model.head_type:
        raise ValueError(
            "distillation teacher/student head families must match: teacher "
            f"{tcfg.model.head_type!r} vs student {cfg.model.head_type!r}")
    if (tcfg.model.img_size != cfg.model.img_size
            or tcfg.model.num_keypoints != cfg.model.num_keypoints):
        raise ValueError(
            "distillation teacher geometry mismatch: teacher "
            f"img_size={tcfg.model.img_size} K={tcfg.model.num_keypoints} "
            f"vs student img_size={cfg.model.img_size} K={cfg.model.num_keypoints}")
    teacher = build_model(tcfg.model, device=device, seed=tcfg.seed)
    payload = CheckpointManager(ckpt_dir).read(mmap=True)
    params = payload["ema"] if d.ema_teacher and payload["ema"] is not None else payload["params"]
    teacher.load_state_dict({**params, **payload["buffers"]}, strict=True)
    return teacher.eval().requires_grad_(False)


def frozen_labels(cfg: TrainConfig, names: list[str]) -> list[str] | None:
    """The optimizer's mask of `cfg` over the parameter `names`, as the JAX
    `Trainer.create` labels its tree: `frozen_backbone` freezes
    `backbone.*` but the adapters; `train_lora_only` trains the LoRA deltas
    and the head alone, and wins when both are set. None: nothing frozen."""
    labels = None
    if cfg.model.frozen_backbone:
        labels = ["frozen" if n.startswith("backbone.") and "adapter" not in n else "trainable"
                  for n in names]
    if cfg.train_lora_only:
        if cfg.model.lora_rank <= 0:
            raise ValueError("train_lora_only requires model.lora_rank > 0")
        labels = lora_frozen_labels(names)
    return labels


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.float() - b.float()) ** 2).mean()


def _is_pair(loc: Any) -> bool:
    """pred[0] of the SimCC family: the (x_logits, y_logits) pair."""
    return isinstance(loc, (tuple, list))


def make_train_step(model: torch.nn.Module, encode_codec: Codec | SimCCCodec,
                    loss_fn: ProbPoseLoss | SimCCLoss, tx: Optimizer | MultiSteps,
                    cfg: TrainConfig,
                    teacher: torch.nn.Module | None = None) -> Callable:
    """The train step: (state, batch[, mark]) -> (state, metrics), batch a
    dict of tensors on the model's device. The state is updated in place
    and returned. Augmentation draws are seeded by `state.host_step`, the
    host's copy of the step. Metrics stay on the device: `loss`,
    `loss/<term>` and `grad_norm`, the global norm of all the gradients
    (frozen leaves' included) before clipping. With a `teacher` (eval
    mode, no gradients), the total gains weight * (heatmap_weight * d_hm +
    scalar_weight * d_sc): d_hm the f32 MSE of the heatmaps against the
    teacher's on the same crops (the mean of the two axes' MSEs for SimCC
    logits), d_sc the mean of the MSEs of the
    probability, visibility and oks maps, logged as
    `loss/distill_heatmap` and `loss/distill_scalar`."""
    weights = cfg.loss_weights.as_dict()
    aug = cfg.augment
    augment = aug is not None and (aug.enabled or aug.half_body_prob > 0)

    def step(state: TrainState, batch: dict[str, torch.Tensor],
             mark: StageMark | None = None):
        mark = mark or (lambda name: None)
        draws = None
        if augment:
            kpts = batch["keypoints"]
            draws = draw_augment(cfg.seed, state.host_step, kpts.shape[0], aug, kpts.device)
        images, gt = _augment_encode(cfg, encode_codec, batch, draws)
        mark("encode")
        model.train()
        pred = model(images)
        mark("forward")
        losses = loss_fn(gt, pred, learn_heatmaps_from_zeros=cfg.learn_heatmaps_from_zeros)
        total = _total(losses, weights)
        if teacher is not None:
            d = cfg.distill
            with torch.no_grad():
                tpred = teacher(images)
            if _is_pair(pred[0]):
                d_hm = sum(_mse(a, b) for a, b in zip(pred[0], tpred[0])) / len(pred[0])
            else:
                d_hm = _mse(pred[0], tpred[0])
            d_sc = (_mse(pred[1], tpred[1]) + _mse(pred[2], tpred[2])
                    + _mse(pred[3], tpred[3])) / 3.0
            losses = dict(losses, distill_heatmap=d_hm, distill_scalar=d_sc)
            total = total + d.weight * (d.heatmap_weight * d_hm + d.scalar_weight * d_sc)
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


def make_eval_step(model: torch.nn.Module, encode_codec: Codec | SimCCCodec,
                   loss_fn: ProbPoseLoss | SimCCLoss, cfg: TrainConfig) -> Callable:
    """(state, batch) -> metrics: losses, accuracies (`acc/<term>`),
    `max_heatmap` (of the x logits for SimCC, as JAX) and `mean_prob`, with
    the model in eval mode and the BatchNorm running statistics."""
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
            "max_heatmap": pred[0][0].max() if _is_pair(pred[0]) else pred[0].max(),
            "mean_prob": pred[1].mean(),
        }

    return step


@dataclass
class Trainer:
    """Model, codecs, loss, optimizer, state and steps of one run.

        trainer = Trainer.create(cfg, steps_per_epoch, device="cuda")
        trainer.fit(lambda: batch_iterator(dataset, cfg.train_batch_size))

    train/cli.py builds the datasets of a config and runs this.
    """

    cfg: TrainConfig
    model: torch.nn.Module
    encode_codec: Codec | SimCCCodec
    fast_codec: Codec | SimCCCodec
    loss_fn: ProbPoseLoss | SimCCLoss
    tx: Optimizer | MultiSteps
    state: TrainState
    train_step: Callable
    eval_step: Callable
    device: torch.device
    # The distillation teacher (eval mode, no gradients), outside the state.
    teacher: torch.nn.Module | None = None
    # (prefix, step, metrics) of every line `fit` and `validate` logged.
    history: list[tuple[str, int, dict[str, float]]] = field(default_factory=list)

    @classmethod
    def create(cls, cfg: TrainConfig, steps_per_epoch: int, mesh: Any = None, *,
               device: torch.device | str = "cuda") -> "Trainer":
        """Weights drawn from `cfg.seed` (compat/from_jax.py loads a JAX
        run's state instead); the schedule spans steps_per_epoch * epochs;
        the optimizer is masked by `frozen_labels` and the teacher loaded
        by `load_teacher`. Runs on the card unless `device` asks for the
        CPU. `mesh` sits in JAX's place; a mesh is not ported."""
        if mesh is not None:
            raise _unported("Trainer.create(mesh=...)", 13)
        device = resolve_device(device, "Trainer.create")
        if cfg.model_parallel > 1 or cfg.pipeline_parallel > 1 or cfg.shard_opt_state:
            raise _unported("model_parallel, pipeline_parallel and shard_opt_state", 13)
        if cfg.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule {cfg.pipeline_schedule!r}")
        model = build_model(cfg.model, device=device, seed=cfg.seed)
        encode_codec, fast_codec = build_codecs(cfg)
        loss_cls = SimCCLoss if cfg.model.head_type == "simcc" else ProbPoseLoss
        loss_fn = loss_cls(fast_codec, freeze_error=cfg.freeze_error, freeze_oks=cfg.freeze_oks)
        labels = frozen_labels(cfg, [n for n, _ in model.named_parameters()])
        tx = make_optimizer(cfg.optim, steps_per_epoch * cfg.epochs, labels,
                            param_layouts(model))
        state = TrainState(model, tx, ema=cfg.optim.ema_decay is not None)
        teacher = None
        if cfg.distill is not None and cfg.distill.teacher_checkpoint:
            teacher = load_teacher(cfg, device)
        return cls(
            cfg=cfg, model=model, encode_codec=encode_codec, fast_codec=fast_codec,
            loss_fn=loss_fn, tx=tx, state=state,
            train_step=make_train_step(model, encode_codec, loss_fn, tx, cfg, teacher),
            eval_step=make_eval_step(model, encode_codec, loss_fn, cfg),
            device=device, teacher=teacher,
        )

    def device_batch(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """A host batch (numpy arrays) as tensors on the model's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def _prefetched(self, batches: Iterable[dict[str, Any]]) -> Iterator[dict[str, torch.Tensor]]:
        """`batches` on the device with `device_prefetch` host batches made
        ahead by a Prefetcher thread. On the card each batch is copied from
        pinned memory without blocking on a side stream while the previous
        step runs, and the step's stream waits for that copy; on the CPU
        the copy is plain. 1 or less: made and copied in turn."""
        depth = self.cfg.device_prefetch
        if depth <= 1:
            for batch in batches:
                yield self.device_batch(batch)
            return
        host = Prefetcher(iter(batches), depth)
        try:
            if self.device.type != "cuda":
                for batch in host:
                    yield self.device_batch(batch)
                return
            side = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)

            def upload(batch):
                with torch.cuda.stream(side):
                    return {k: torch.as_tensor(np.asarray(v)).pin_memory().to(
                        self.device, non_blocking=True) for k, v in batch.items()}

            def ready(batch):
                # The step's stream waits for the copies queued so far, and
                # their memory is not reused before that stream is done.
                main.wait_stream(side)
                for t in batch.values():
                    t.record_stream(main)
                return batch

            pending = None
            for batch in host:
                if pending is not None:
                    done = ready(pending)
                    pending = upload(batch)
                    yield done
                else:
                    pending = upload(batch)
            if pending is not None:
                yield ready(pending)
        finally:
            host.close()

    def fit(self, train_batches: Callable[[], Iterable[dict[str, Any]]],
            val_batches: Callable[[], Iterable[dict[str, Any]]] | None = None,
            max_steps: int | None = None) -> TrainState:
        """Run `cfg.epochs` epochs of `train_batches()` (or `max_steps`
        steps from where it starts), logging every `log_every` steps and
        the averaged eval metrics every `val_every` to
        `<out_dir>/metrics.jsonl` and `self.history`, as the JAX `fit`:

        - resume (`cfg.resume`) from the latest `<out_dir>/checkpoints`;
        - a checkpoint at the end of every `checkpoint_every_epochs`-th
          epoch and at the end, labelled by `state.step`, never of a
          state with non-finite leaves;
        - after two non-finite losses in a row at log points, restore the
          latest checkpoint and rewind the step counter, up to
          `max_recoveries` times (with none yet, log and go on);
        - `track_best_metric` into `<out_dir>/checkpoints_best`;
        - on SIGTERM (`handle_preemption`), finish the step, save, return.
        """
        cfg = self.cfg
        logger = MetricsLogger(cfg.out_dir)
        ckpt = CheckpointManager(f"{cfg.out_dir}/checkpoints", keep=cfg.keep_checkpoints,
                                 async_save=cfg.async_checkpoint)
        start_step = 0
        if cfg.resume and ckpt.latest_step() is not None:
            ckpt.restore(self.state)
            start_step = self.state.host_step
            print(f"[trainer] resumed from step {start_step}", flush=True)

        best = None
        if cfg.track_best_metric:
            mode = cfg.track_best_mode
            if mode == "auto":
                mode = "min" if "loss" in cfg.track_best_metric else "max"
            if mode not in ("min", "max"):
                raise ValueError(f"track_best_mode {cfg.track_best_mode!r}")
            best = _Best(CheckpointManager(f"{cfg.out_dir}/checkpoints_best", keep=1),
                         1.0 if mode == "min" else -1.0)
            prior = best.ckpt.read_metadata()
            if prior.get("best_value") is not None:
                best.value = float(prior["best_value"])

        # Preemption: eviction arrives as SIGTERM with a grace window. Finish
        # the step in flight, save, and return so that a resume continues.
        preempted = threading.Event()
        prev_sigterm = None
        if cfg.handle_preemption:
            def on_sigterm(signum, frame):
                if not preempted.is_set():
                    preempted.set()
                    print("[trainer] SIGTERM: checkpointing at the next step boundary, "
                          "then exiting cleanly", flush=True)

            try:
                prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
            except ValueError:  # fit() running off the main thread
                prev_sigterm = None
        try:
            self._fit_loop(train_batches, val_batches, max_steps, logger, ckpt, best,
                           start_step, preempted)
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            ckpt.close()
            if best is not None:
                best.ckpt.close()
            logger.close()
        return self.state

    def _save(self, ckpt: CheckpointManager, what: str, metadata: dict | None = None) -> bool:
        """Save the state at its step unless a leaf is non-finite."""
        step = self.state.host_step
        if not state_is_finite(self.state):
            print(f"[trainer] NOT saving {what} at step {step}: the state has non-finite "
                  f"leaves (latest clean checkpoint: step {ckpt.latest_step()})", flush=True)
            return False
        ckpt.save(step, self.state, metadata=metadata)
        return True

    def _fit_loop(self, train_batches, val_batches, max_steps, logger, ckpt, best,
                  start_step, preempted) -> None:
        cfg = self.cfg
        step_idx = start_step
        t0, last_log, done = time.perf_counter(), None, False
        strikes = recoveries = 0  # consecutive non-finite losses at log points
        for epoch in range(cfg.epochs):
            if done:
                break
            for batch in self._prefetched(train_batches()):
                _, metrics = self.train_step(self.state, batch)
                if step_idx % cfg.log_every == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    host["steps_per_sec"] = ((step_idx - last_log) / dt
                                             if last_log is not None and dt > 0 else 0.0)
                    last_log, t0 = step_idx, time.perf_counter()
                    self._log(logger, "training", step_idx, host)
                    if cfg.recover_on_nonfinite and not math.isfinite(host["loss"]):
                        strikes += 1
                        if strikes >= 2:
                            if recoveries >= cfg.max_recoveries:
                                raise RuntimeError(
                                    f"loss non-finite at step {step_idx} after {recoveries} "
                                    "checkpoint recoveries; aborting")
                            strikes, recoveries = 0, recoveries + 1
                            restore_step = ckpt.latest_step()
                            if restore_step is not None:
                                ckpt.restore(self.state)
                                print(f"[trainer] non-finite loss at step {step_idx}; restored "
                                      f"checkpoint step {restore_step} (recovery {recoveries}/"
                                      f"{cfg.max_recoveries})", flush=True)
                                # Rewind with the state: checkpoint labels must
                                # keep following state.step.
                                step_idx, last_log = self.state.host_step, None
                            else:
                                print("[trainer] non-finite loss with no checkpoint yet; "
                                      "relying on the optimizer's non-finite skip guard",
                                      flush=True)
                    else:
                        strikes = 0
                if val_batches is not None and step_idx % cfg.val_every == 0:
                    tv = time.perf_counter()
                    val = self.validate(val_batches, step_idx, logger)
                    t0 += time.perf_counter() - tv  # steps_per_sec counts training only
                    if best is not None and val is not None:
                        best.offer(self, cfg, val, step_idx)
                step_idx += 1
                if preempted.is_set() or (max_steps is not None
                                          and step_idx - start_step >= max_steps):
                    done = True
                    break
            if ((epoch % cfg.checkpoint_every_epochs == 0 or done)
                    and ckpt.latest_step() != self.state.host_step):
                self._save(ckpt, "a checkpoint")
        ckpt.wait()
        if ckpt.latest_step() != self.state.host_step:
            self._save(ckpt, "the final checkpoint")
        if preempted.is_set():
            print(f"[trainer] preempted: latest checkpoint at step {ckpt.latest_step()}; "
                  "resume will continue from there", flush=True)

    def validate(self, val_batches: Callable[[], Iterable[dict[str, Any]]],
                 step_idx: int, logger: MetricsLogger | None = None) -> dict[str, float] | None:
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
        self._log(logger, "validation", step_idx, averaged)
        return averaged

    def _log(self, logger: MetricsLogger | None, prefix: str, step_idx: int,
             metrics: dict[str, float]) -> None:
        self.history.append((prefix, step_idx, metrics))
        if logger is not None:
            logger.log(step_idx, metrics, prefix=prefix)
        print(f"[{prefix}] step {step_idx} "
              + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()), flush=True)


@dataclass
class _Best:
    """The best-metric checkpoint of a `fit` run: its manager, the sign that
    makes lower better, and the best value so far."""

    ckpt: CheckpointManager
    sign: float
    value: float | None = None

    def offer(self, trainer: Trainer, cfg: TrainConfig, val: dict[str, float],
              step_idx: int) -> None:
        if cfg.track_best_metric not in val:
            raise ValueError(f"track_best_metric {cfg.track_best_metric!r} not among "
                             f"validation metrics {sorted(val)}")
        v = float(val[cfg.track_best_metric])
        if not math.isfinite(v) or (self.value is not None
                                    and self.sign * v >= self.sign * self.value):
            return
        if trainer._save(self.ckpt, "the best checkpoint",
                         metadata=dict(best_value=v, best_metric=cfg.track_best_metric)):
            self.value = v
            print(f"[trainer] new best {cfg.track_best_metric}={v:.5g} at step {step_idx} "
                  "-> checkpoints_best", flush=True)
