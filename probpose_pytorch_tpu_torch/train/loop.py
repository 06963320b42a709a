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
heatmaps (or SimCC logits) and scalar branches.

On a mesh (parallel/mesh.py) every rank runs the step on its rows of the
global batch, as JAX's one program over the global batch computes: the
augmentation draws are the global batch's, the model runs the rank's rows
(and its slices of a split trunk), the head outputs and the targets are
gathered over the ranks whose head rows make the batch, so every rank
computes the one global loss and metrics (each mean, each weighted mean
with its count, each accuracy's max(count, 1) is the global batch's), and
the gradients are summed over the data axis, the head's also over the
model and pipe axes where their ranks share the head's rows.

On a mesh with a pipe axis the trunk is stacked and staged
(parallel/pipeline.py). `pipeline_schedule="gpipe"` runs the step above
through the pipelined forward, whose backward is autograd through the
ticks; the patch embedding's gradients, which stage 0 alone computes, are
summed over the pipe axis. "1f1b" runs `make_train_step_1f1b`: the embed
segment, then `pipeline_1f1b` with the final norm, the head and the loss as
its last stage's loss, JAX's two semantic changes included (BatchNorm on
each microbatch's statistics, masked means per microbatch).
"""

from __future__ import annotations

import dataclasses
import math
import signal
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

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
from probpose_pytorch_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_,
    gather_rows,
)
from probpose_pytorch_tpu_torch.parallel.mesh import mesh_coords, mesh_device, mesh_shape
from probpose_pytorch_tpu_torch.parallel.sharding import local_slice, shard_opt_state
from probpose_pytorch_tpu_torch.train.checkpoint import (
    CheckpointManager,
    _load_payload,
    state_is_finite,
)
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.state import (
    MultiSteps,
    Optimizer,
    ShardPlan,
    TrainState,
    global_norm,
    make_optimizer,
    param_layouts,
)
from probpose_pytorch_tpu_torch.utils.logging import MetricsLogger

__all__ = ["build_codecs", "augment_batch", "load_teacher", "frozen_labels", "make_train_step",
           "make_train_step_1f1b", "make_eval_step", "Trainer", "qkv_layout_of",
           "trunk_layout_of", "layout_metadata",
           "restore_state_with_layout"]

# A callable the train step calls after each of its stages with the stage's
# name ("encode", "forward", "loss", "backward", "optimizer"); chip_smoke.py
# records a CUDA event there.
StageMark = Callable[[str], None]


def qkv_layout_of(model_cfg) -> str:
    """The layout of the attention's qkv columns: head-major under
    "fused_tp" (compat/layouts.py), qkv-major under every other attn_impl."""
    return "head_major" if model_cfg.attn_impl == "fused_tp" else "qkv_major"


def trunk_layout_of(model_cfg) -> str:
    """"stacked" for a pipeline-parallel trunk (pp_stages > 1), else
    "per_block"."""
    return "stacked" if model_cfg.pp_stages > 1 else "per_block"


def layout_metadata(cfg: TrainConfig) -> dict:
    """A checkpoint's sidecar metadata naming its qkv and trunk layouts,
    so a restore onto another layout converts (`restore_state_with_layout`)."""
    from probpose_pytorch_tpu_torch.models.vit import ViTConfig

    heads = ViTConfig.PRESETS.get(cfg.model.backbone, {}).get("num_heads", 0)
    return {"qkv_layout": qkv_layout_of(cfg.model), "trunk_layout": trunk_layout_of(cfg.model),
            "num_heads": heads, "backbone": cfg.model.backbone}


def _qkv_moment(t: torch.Tensor, three_c: int, perm: np.ndarray) -> torch.Tensor:
    """A moment of a qkv leaf with its axis of the 3C columns permuted
    (Adafactor's reduced moments may have none)."""
    for axis, n in enumerate(t.shape):
        if n == three_c:
            return t.index_select(axis, torch.as_tensor(perm))
    return t


def _convert_payload(payload: dict, names: list[str], trainable: list[str], heads: int,
                     src: str, dst: str) -> dict:
    """A checkpoint payload's parameters, EMA and optimizer moments from
    qkv layout `src` to `dst`."""
    from probpose_pytorch_tpu_torch.compat.layouts import (
        _qkv_axis,
        convert_qkv_layout,
        qkv_head_major_permutation,
    )

    params = payload["params"]
    perms = {}
    for n, p in params.items():
        axis = _qkv_axis(n.split("."), p.dim())
        if axis is not None:
            perm = qkv_head_major_permutation(p.shape[axis] // 3, heads)
            perms[n] = (p.shape[axis], perm if dst == "head_major" else np.argsort(perm))

    def moments(node):
        if isinstance(node, dict):
            return {k: moments(v) for k, v in node.items()}
        if isinstance(node, list):
            order = trainable if len(node) == len(trainable) else names
            return [_qkv_moment(t, *perms[n]) if n in perms else t
                    for n, t in zip(order, node)]
        return node

    out = dict(payload, params=convert_qkv_layout(params, heads, src, dst),
               opt_state=moments(payload["opt_state"]))
    if payload["ema"] is not None:
        out["ema"] = convert_qkv_layout(payload["ema"], heads, src, dst)
    return out


def _convert_trunk(payload: dict, names: list[str], trainable: list[str],
                   own_names: list[str], own_trainable: list[str], src: str, dst: str) -> dict:
    """A checkpoint payload's parameters, EMA and optimizer moments from
    trunk layout `src` to `dst` (compat/layouts.py:stack_state_dict;
    Adafactor's reduced moments stacked along the depth axis), the moments
    re-ordered to the target's parameters."""
    from probpose_pytorch_tpu_torch.compat.layouts import stack_state_dict, unstack_state_dict

    convert = stack_state_dict if dst == "stacked" else unstack_state_dict
    params = payload["params"]
    shapes = {n: tuple(t.shape) for n, t in params.items()}

    def moments(node):
        if isinstance(node, dict):
            return {k: moments(v) for k, v in node.items()}
        if isinstance(node, list):
            order, own = ((trainable, own_trainable) if len(node) == len(trainable)
                          else (names, own_names))
            moved = convert(dict(zip(order, node)), shapes=shapes)
            return [moved[n] for n in own]
        return node

    out = dict(payload, params=convert(params), opt_state=moments(payload["opt_state"]))
    if payload["ema"] is not None:
        out["ema"] = convert(payload["ema"])
    return out


def restore_state_with_layout(ckpt: CheckpointManager, target_state: TrainState,
                              cfg: TrainConfig, step: int | None = None) -> TrainState:
    """`ckpt.restore` with the qkv and trunk layouts converted where the
    checkpoint's metadata (none: qkv-major, per-block) differs from `cfg`'s:
    the parameters, the EMA and the optimizer's moments alike, before a
    mesh takes its slices, so the resume is exact."""
    meta = ckpt.read_metadata(step)
    own_qkv, stored_qkv = qkv_layout_of(cfg.model), meta.get("qkv_layout", "qkv_major")
    own_trunk, stored_trunk = trunk_layout_of(cfg.model), meta.get("trunk_layout", "per_block")
    heads = meta.get("num_heads") or layout_metadata(cfg)["num_heads"]
    qkv = stored_qkv != own_qkv and heads
    if not qkv and stored_trunk == own_trunk:
        return ckpt.restore(target_state, step=step)
    payload = ckpt.read(step)
    names = list(payload["params"])
    labels = frozen_labels(cfg, names)
    trainable = names if labels is None else [n for n, k in zip(names, labels)
                                              if k == "trainable"]
    if qkv:
        payload = _convert_payload(payload, names, trainable, heads, stored_qkv, own_qkv)
        print(f"[checkpoint] converted qkv layout: {stored_qkv} -> {own_qkv}")
    if stored_trunk != own_trunk:
        inner = getattr(target_state.tx, "inner", target_state.tx)
        own_trainable = (target_state.names if inner.trainable is None
                         else [target_state.names[i] for i in inner.trainable])
        payload = _convert_trunk(payload, names, trainable, target_state.names, own_trainable,
                                 stored_trunk, own_trunk)
        print(f"[checkpoint] converted trunk layout: {stored_trunk} -> {own_trunk}")
    _load_payload(target_state, payload)
    return target_state


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


def _draw_rows(cfg: TrainConfig, step: int, rows: int, mesh: Any,
               device: torch.device) -> AugmentDraws:
    """The draws of this rank's `rows` of the step's global batch."""
    data = mesh_shape(mesh).get("data", 1)
    draws = draw_augment(cfg.seed, step, rows * data, cfg.augment, device)
    if data == 1:
        return draws
    index = mesh_coords(mesh)["data"]
    return AugmentDraws(**{f.name: local_slice(getattr(draws, f.name), 0, index, data)
                           for f in dataclasses.fields(draws)})


def _gather_global(model: torch.nn.Module, rows: int, pred: Any, gt: dict) -> tuple[Any, dict]:
    """(pred, gt) of the global batch from this rank's `rows`: the head's
    outputs (its head rows) and the targets, gathered over the ranks whose
    head rows make the batch (ProbPoseModel.head_group)."""
    group = model.head_group(rows)
    if model.head_split(rows):  # the targets of this rank's share of the rows
        gt = {k: model.head_share(v) for k, v in gt.items()}
    gather = lambda x: ([gather_rows(t, group) for t in x] if isinstance(x, (tuple, list))
                        else gather_rows(x, group))
    return [gather(x) for x in pred], {k: all_gather_cat(v, group) for k, v in gt.items()}


# The parameters before a stacked trunk, which stage 0 alone differentiates.
_EMBED = ("backbone.patch_embed.", "backbone.pos_embed", "backbone.prefix_tokens")


def _sum_over(grads: list[torch.Tensor], group) -> None:
    """Sum `grads` over `group`, in place (one flat buffer)."""
    if not grads:
        return
    flat = all_reduce_(torch._utils._flatten_dense_tensors(grads), group)
    for g, t in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(t)


def _reduce_grads(model: torch.nn.Module, names: list[str], grads: list[torch.Tensor],
                  rows: int) -> None:
    """Sum the gradients over the data axis, in place, then over the model
    and pipe axes those that are partial there: the head's where those
    ranks share the head's rows, the LoRA deltas beside a split projection
    over the model axis, the embedding's before a stacked trunk over the
    pipe axis."""
    mesh = model.mesh
    _sum_over(grads, mesh.get_group("data"))
    split, shape = model.head_split(rows), mesh_shape(mesh)
    stacked = getattr(model.backbone, "stacked", False)
    partial = getattr(model, "tp_partial", set())
    for ax in ("model", "pipe"):
        if shape.get(ax, 1) == 1:
            continue
        _sum_over([g for g, n in zip(grads, names)
                   if (split and n.startswith("head."))
                   or (ax == "model" and n in partial)
                   or (ax == "pipe" and stacked and n.startswith(_EMBED))],
                  mesh.get_group(ax))


def _grad_norm(grads: list[torch.Tensor], plan: ShardPlan | None) -> torch.Tensor:
    """The global norm of every gradient, split leaves counted once."""
    if plan is None:
        return global_norm(grads)
    return global_norm(grads, plan.tp_dims, plan.tp_group, plan.pp_dims, plan.pp_group)


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
    `loss/distill_heatmap` and `loss/distill_scalar`. On the model's mesh,
    the batch is this rank's rows (see the module's docstring)."""
    weights = cfg.loss_weights.as_dict()
    aug = cfg.augment
    augment = aug is not None and (aug.enabled or aug.half_body_prob > 0)
    mesh = getattr(model, "mesh", None)

    def step(state: TrainState, batch: dict[str, torch.Tensor],
             mark: StageMark | None = None):
        mark = mark or (lambda name: None)
        draws = None
        rows = batch["keypoints"].shape[0]
        if augment:
            draws = _draw_rows(cfg, state.host_step, rows, mesh, batch["keypoints"].device)
        images, gt = _augment_encode(cfg, encode_codec, batch, draws)
        mark("encode")
        model.train()
        pred = model(images)
        if mesh is not None:
            pred, gt = _gather_global(model, rows, pred, gt)
        mark("forward")
        losses = loss_fn(gt, pred, learn_heatmaps_from_zeros=cfg.learn_heatmaps_from_zeros)
        total = _total(losses, weights)
        if teacher is not None:
            d = cfg.distill
            with torch.no_grad():
                tpred = teacher(images)
                if mesh is not None:  # the teacher is whole on every rank
                    group = mesh.get_group("data")
                    tpred = [[all_gather_cat(t, group) for t in x] if _is_pair(x)
                             else all_gather_cat(x, group) for x in tpred]
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
        plan = tx.plan
        if mesh is not None:
            _reduce_grads(model, state.names, grads, rows)
        mark("backward")
        grad_norm = _grad_norm(grads, plan)
        state.apply_gradients(grads, tx, ema_decay=cfg.optim.ema_decay)
        mark("optimizer")
        metrics = {"loss": total.detach(),
                   **{f"loss/{k}": v.detach() for k, v in losses.items()},
                   "grad_norm": grad_norm}
        return state, metrics

    return step


def make_train_step_1f1b(model: torch.nn.Module, encode_codec: Codec | SimCCCodec,
                         loss_fn: ProbPoseLoss | SimCCLoss, tx: Optimizer | MultiSteps,
                         cfg: TrainConfig, mesh: Any) -> Callable:
    """JAX's 1F1B train step (`pipeline_schedule="1f1b"` on a mesh with a
    pipe axis > 1): the augmented, encoded batch; the embed segment under
    autograd; the trunk, final norm, head and loss through
    `pipeline_1f1b`, whose last stage runs `backbone.post_trunk` and the
    head on each microbatch as its loss; the engine's dx into the embed's
    gradients (summed over the data axis, as GSPMD sums them); the update.
    As in JAX, the head's BatchNorm normalises each microbatch by its own
    statistics and its running statistics take the microbatches' mean
    update, and masked loss means are taken per microbatch, then averaged.
    Same call and metrics as `make_train_step`."""
    from probpose_pytorch_tpu_torch.parallel.pipeline import pipeline_1f1b

    weights = cfg.loss_weights.as_dict()
    aug = cfg.augment
    augment = aug is not None and (aug.enabled or aug.half_body_prob > 0)
    backbone, head = model.backbone, model.head
    params = dict(model.named_parameters())
    names = list(params)
    embed = [n for n in names if n.startswith(_EMBED)]
    post = [n for n in names if not n.startswith(_EMBED)
            and not n.startswith("backbone.blocks.")]
    bns = [m for m in head.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    model_axis = "model" if mesh_shape(mesh).get("model", 1) > 1 else None

    def step(state: TrainState, batch: dict[str, torch.Tensor],
             mark: StageMark | None = None):
        mark = mark or (lambda name: None)
        draws = None
        rows = batch["keypoints"].shape[0]
        if augment:
            draws = _draw_rows(cfg, state.host_step, rows, mesh, batch["keypoints"].device)
        images, gt = _augment_encode(cfg, encode_codec, batch, draws)
        mark("encode")
        model.train()
        tokens = backbone(images, segment="embed")
        start = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]

        def pp_loss(lp, h, t_mb):
            with torch.no_grad():  # every microbatch from the step's running statistics
                for bn, (mean, var) in zip(bns, start):
                    bn.running_mean.copy_(mean)
                    bn.running_var.copy_(var)
            pred = head(backbone(h, segment="post_trunk"))
            losses = loss_fn(t_mb, pred, learn_heatmaps_from_zeros=cfg.learn_heatmaps_from_zeros)
            stats = [t.clone() for bn in bns for t in (bn.running_mean, bn.running_var)]
            return _total(losses, weights), (losses, stats)

        block_fn, seq_block_fn, specs = backbone.block_fns()
        loss, d_trunk, d_post, dx, (losses, stats) = pipeline_1f1b(
            block_fn, backbone.blocks.flat(), pp_loss, [params[n] for n in post],
            tokens.detach(), gt, mesh, model_axis=model_axis,
            microbatches=cfg.model.pp_microbatches, param_specs=specs,
            seq_block_fn=seq_block_fn, loss_has_aux=True)
        mark("loss")
        d_embed = torch.autograd.grad(tokens, [params[n] for n in embed], dx, allow_unused=True)
        d_embed = [torch.zeros_like(params[n]) if g is None else g
                   for n, g in zip(embed, d_embed)]
        _sum_over(d_embed, mesh.get_group("data"))
        with torch.no_grad():
            for i, bn in enumerate(bns):
                bn.running_mean.copy_(stats[2 * i])
                bn.running_var.copy_(stats[2 * i + 1])
        by_name = {**dict(zip(embed, d_embed)), **dict(zip(post, d_post)),
                   **{f"backbone.blocks.{k}": v for k, v in d_trunk.items()}}
        grads = [by_name[n].to(params[n].dtype) for n in names]
        mark("backward")
        grad_norm = _grad_norm(grads, tx.plan)
        state.apply_gradients(grads, tx, ema_decay=cfg.optim.ema_decay)
        mark("optimizer")
        metrics = {"loss": loss, **{f"loss/{k}": v for k, v in losses.items()},
                   "grad_norm": grad_norm}
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, encode_codec: Codec | SimCCCodec,
                   loss_fn: ProbPoseLoss | SimCCLoss, cfg: TrainConfig) -> Callable:
    """(state, batch) -> metrics: losses, accuracies (`acc/<term>`),
    `max_heatmap` (of the x logits for SimCC, as JAX) and `mean_prob`, with
    the model in eval mode and the BatchNorm running statistics; on the
    model's mesh, of the global batch from this rank's rows."""
    weights = cfg.loss_weights.as_dict()
    mesh = getattr(model, "mesh", None)

    @torch.no_grad()
    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        images, gt = _augment_encode(cfg, encode_codec, batch)
        model.eval()
        pred = model(images)
        if mesh is not None:
            pred, gt = _gather_global(model, images.shape[0], pred, gt)
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
    mesh: Any = None
    # On a mesh: whether each batch given to the trainer is already this
    # rank's data slice (JAX's several-process feeding, batch_iterator with
    # process_index / process_count of the data axis), else the global
    # batch, of which the trainer takes the rank's rows.
    local_batches: bool = False
    # (prefix, step, metrics) of every line `fit` and `validate` logged.
    history: list[tuple[str, int, dict[str, float]]] = field(default_factory=list)

    @classmethod
    def create(cls, cfg: TrainConfig, steps_per_epoch: int, mesh: Any = None, *,
               device: torch.device | str = "cuda") -> "Trainer":
        """Weights drawn from `cfg.seed` (compat/from_jax.py loads a JAX
        run's state instead); the schedule spans steps_per_epoch * epochs;
        the optimizer is masked by `frozen_labels` and the teacher loaded
        by `load_teacher`. Runs on the card unless `device` asks for the
        CPU. On a `mesh` (JAX's `Trainer.create` mesh logic): "fused"
        becomes "fused_tp" where the heads divide a model axis > 1, and any
        fused attention "einsum" where they do not; the weights, the
        optimizer's plan and, with `shard_opt_state` (data-parallel meshes
        only), the ZeRO-1 moments are laid on the mesh. A pipe axis > 1
        stages the stacked trunk over it (`pp_stages` set from the mesh, as
        JAX's) and `pipeline_schedule` picks the GPipe or the 1F1B step."""
        device = mesh_device(mesh, resolve_device(device, "Trainer.create"))
        if cfg.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule {cfg.pipeline_schedule!r} "
                             "(expected gpipe | 1f1b)")
        model_size = mesh_shape(mesh).get("model", 1)
        pipe_size = mesh_shape(mesh).get("pipe", 1)
        if model_size > 1 and cfg.model.attn_impl in ("fused", "fused_tp"):
            from probpose_pytorch_tpu_torch.models.vit import ViTConfig

            heads = ViTConfig.PRESETS.get(cfg.model.backbone, {}).get("num_heads", 0)
            if heads and heads % model_size == 0:
                if cfg.model.attn_impl == "fused":
                    print("[trainer] tensor-parallel mesh: using attn_impl='fused_tp' "
                          "(head-major qkv layout; convert qkv-major checkpoints with "
                          "compat.qkv_to_head_major)")
                    cfg = dataclasses.replace(
                        cfg, model=dataclasses.replace(cfg.model, attn_impl="fused_tp"))
            else:
                print(f"[trainer] attn heads ({heads}) don't divide the model axis "
                      f"({model_size}); using 'einsum' on this mesh")
                cfg = dataclasses.replace(
                    cfg, model=dataclasses.replace(cfg.model, attn_impl="einsum"))
        if pipe_size > 1:
            from probpose_pytorch_tpu_torch.models.vit import ViTConfig

            if model_size > 1 and cfg.model.attn_impl != "fused_tp":
                raise ValueError(
                    "tensor parallelism inside a pipeline stage requires "
                    "attn_impl='fused'/'fused_tp' with heads divisible by model_parallel "
                    f"(got attn_impl={cfg.model.attn_impl!r}, model axis {model_size})")
            depth = ViTConfig.PRESETS.get(cfg.model.backbone, {}).get("depth", 0)
            if cfg.model.backbone.startswith("conv") or depth % pipe_size:
                raise ValueError(
                    "pipeline parallelism needs a ViT backbone whose depth divides the pipe "
                    f"axis (backbone={cfg.model.backbone}, pipe={pipe_size})")
            if cfg.model.pp_stages != pipe_size:
                cfg = dataclasses.replace(
                    cfg, model=dataclasses.replace(cfg.model, pp_stages=pipe_size))
        if mesh is not None and cfg.shard_opt_state and (model_size > 1 or pipe_size > 1):
            raise ValueError(
                "shard_opt_state (ZeRO-1 over the data axis) is supported on dp-only meshes; "
                "with tensor/pipeline parallelism the moments inherit the param layouts")
        model = build_model(cfg.model, mesh, device=device, seed=cfg.seed)
        encode_codec, fast_codec = build_codecs(cfg)
        loss_cls = SimCCLoss if cfg.model.head_type == "simcc" else ProbPoseLoss
        loss_fn = loss_cls(fast_codec, freeze_error=cfg.freeze_error, freeze_oks=cfg.freeze_oks)
        labels = frozen_labels(cfg, [n for n, _ in model.named_parameters()])
        tx = make_optimizer(cfg.optim, steps_per_epoch * cfg.epochs, labels,
                            param_layouts(model))
        names = [n for n, _ in model.named_parameters()]
        if mesh is not None:
            tx.plan = ShardPlan(
                tp_group=mesh.get_group("model") if model_size > 1 else None,
                tp_dims=[model.tp_splits.get(n) for n in names],
                dp_group=mesh.get_group("data"),
                pp_group=mesh.get_group("pipe") if pipe_size > 1 else None,
                pp_dims=[model.pp_splits.get(n) for n in names])
        state = TrainState(model, tx, ema=cfg.optim.ema_decay is not None)
        if mesh is not None and cfg.shard_opt_state:
            inner = getattr(tx, "inner", tx)
            layouts = None if inner.layouts is None else inner._masked(inner.layouts)
            state.opt_state, tx.plan.zero_dims = shard_opt_state(state.opt_state, mesh,
                                                                 layouts=layouts)
        teacher = None
        if cfg.distill is not None and cfg.distill.teacher_checkpoint:
            teacher = load_teacher(cfg, device)
        if pipe_size > 1 and cfg.pipeline_schedule == "1f1b":
            if teacher is not None:
                raise ValueError(
                    "distillation does not compose with pipeline_schedule='1f1b' (the frozen "
                    "teacher would have to run on every pipeline stage); use 'gpipe'")
            train_step = make_train_step_1f1b(model, encode_codec, loss_fn, tx, cfg, mesh)
        else:
            train_step = make_train_step(model, encode_codec, loss_fn, tx, cfg, teacher)
        return cls(
            cfg=cfg, model=model, encode_codec=encode_codec, fast_codec=fast_codec,
            loss_fn=loss_fn, tx=tx, state=state,
            train_step=train_step,
            eval_step=make_eval_step(model, encode_codec, loss_fn, cfg),
            device=device, teacher=teacher, mesh=mesh,
        )

    def _rows(self, batch: dict[str, Any]) -> dict[str, Any]:
        """On a mesh, this rank's rows of a global batch (a batch that is
        already the rank's slice, `local_batches`, as it is)."""
        if self.mesh is None or self.local_batches:
            return batch
        return {k: local_slice(np.asarray(v), 0, mesh_coords(self.mesh)["data"],
                               mesh_shape(self.mesh)["data"]) for k, v in batch.items()}

    def device_batch(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """A host batch (numpy arrays) as tensors on the model's device (on
        a mesh, the rank's rows)."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in self._rows(batch).items()}

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
                    return {k: torch.as_tensor(np.ascontiguousarray(v)).pin_memory().to(
                        self.device, non_blocking=True) for k, v in self._rows(batch).items()}

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

        On a mesh every rank runs the loop (the saves gather over the mesh)
        and rank 0 alone logs.
        """
        cfg = self.cfg
        main = not dist.is_initialized() or dist.get_rank() == 0
        logger = MetricsLogger(cfg.out_dir) if main else None
        ckpt = CheckpointManager(f"{cfg.out_dir}/checkpoints", keep=cfg.keep_checkpoints,
                                 async_save=cfg.async_checkpoint)
        start_step = 0
        if cfg.resume and ckpt.latest_step() is not None:
            restore_state_with_layout(ckpt, self.state, cfg)
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
            if logger is not None:
                logger.close()
        return self.state

    def _save(self, ckpt: CheckpointManager, what: str, metadata: dict | None = None) -> bool:
        """Save the state at its step unless a leaf is non-finite, with the
        layouts' metadata (`layout_metadata`) and `metadata`."""
        step = self.state.host_step
        if not state_is_finite(self.state):
            print(f"[trainer] NOT saving {what} at step {step}: the state has non-finite "
                  f"leaves (latest clean checkpoint: step {ckpt.latest_step()})", flush=True)
            return False
        ckpt.save(step, self.state, metadata={**layout_metadata(self.cfg), **(metadata or {})})
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
        if dist.is_initialized() and dist.get_rank() != 0:
            return
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
