"""Person detector training (port of probpose_pytorch_tpu/detect/train.py).

    python -m probpose_pytorch_tpu_torch.detect.train \\
        --data-root synth_coco/ --out runs/detector \\
        [--steps 1500] [--batch-size 16] [--img-size 512] [--preset conv-t] \\
        [--keypoints 17 [--kpt-heatmaps]] [--device cuda]

One step: the full-frame resize on the device (ops/preprocess.py's
`crop_resize`, "bilinear_matmul"), the targets encoded on the device
(detect/codec.py), forward, focal + L1 loss, backward, and JAX's optimizer:

    optax.chain(clip_by_global_norm(1.0),
                adamw(warmup_cosine_decay_schedule(lr / 25, lr,
                      max(total // 20, 1), max(total, warmup + 1)),
                      weight_decay=1e-4))

(train/state.py's AdamW, whose weight decay reaches every leaf, BatchNorm
scales and biases included; no EMA). The CLI writes `detector.json` beside
`checkpoints/<step>` (train/checkpoint.py), the layout `load_detector`
and `load_bottomup` read. Everything runs on the card unless the caller
asks for the CPU (`device=`, `--device cpu`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from probpose_pytorch_tpu_torch.detect.codec import encode_boxes
from probpose_pytorch_tpu_torch.detect.loss import detection_loss
from probpose_pytorch_tpu_torch.detect.model import PersonDetector, init_detector_weights
from probpose_pytorch_tpu_torch.detect.pipeline import full_frame_boxes, scale_xy
from probpose_pytorch_tpu_torch.models.model import resolve_device
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize
from probpose_pytorch_tpu_torch.train.config import OptimConfig
from probpose_pytorch_tpu_torch.train.state import AdamW, TrainState, warmup_cosine_decay_schedule

__all__ = ["DetectorTrainer", "detector_optimizer", "load_detector", "load_bottomup", "main"]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


def detector_optimizer(lr: float, total_steps: int, weight_decay: float = 1e-4) -> AdamW:
    """The detector's optax chain: global-norm clip at 1, then AdamW (b1 0.9,
    b2 0.999, eps 1e-8) on a warm-up cosine from lr / 25 over exactly
    max(total_steps // 20, 1) warm-up steps to 0."""
    warmup = max(total_steps // 20, 1)
    cfg = OptimConfig(peak_lr=lr, weight_decay=weight_decay, clip_grad_norm=1.0)
    return AdamW(cfg, warmup_cosine_decay_schedule(lr / 25, lr, warmup,
                                                   max(total_steps, warmup + 1)))


@dataclasses.dataclass
class DetectorTrainer:
    """The detector, its train state and optimizer on one device."""

    model: PersonDetector
    state: TrainState
    tx: AdamW

    @property
    def device(self) -> torch.device:
        return self.state.params[0].device

    @classmethod
    def create(
        cls,
        img_size: tuple[int, int] = (512, 512),
        preset: str = "conv-t",
        lr: float = 2.5e-4,
        total_steps: int = 1500,
        weight_decay: float = 1e-4,
        seed: int = 0,
        num_keypoints: int = 0,
        kpt_heatmaps: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
    ) -> "DetectorTrainer":
        """Weights drawn as flax's initializers draw them, from a
        `torch.Generator` seeded with `seed` (compat/from_jax.py carries a
        JAX state instead). `dtype` is the convs' compute dtype. Runs on the
        card unless `device` asks for the CPU."""
        device = resolve_device(device, "DetectorTrainer.create")
        model = PersonDetector(img_size=tuple(img_size), preset=preset, dtype=dtype,
                               num_keypoints=num_keypoints,
                               kpt_heatmaps=kpt_heatmaps and num_keypoints > 0)
        init_detector_weights(model, torch.Generator().manual_seed(seed))
        model.to(device)
        tx = detector_optimizer(lr, total_steps, weight_decay)
        return cls(model=model, state=TrainState(model, tx, ema=False), tx=tx)

    def inputs(self, batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """A batch of one native frame size -> (detector inputs (B, Hd, Wd,
        3), encode_boxes' targets), on the model's device."""
        dev = self.device
        t = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()
             if k != "image_id"}
        frames = t["frame"]
        _, Hf, Wf, _ = frames.shape
        Hd, Wd = self.model.img_size
        imgs = crop_resize(frames, full_frame_boxes(frames), (Hd, Wd), "bilinear_matmul")
        sx, sy = Wd / Wf, Hd / Hf
        kpts = None
        if self.model.num_keypoints > 0:
            kp = t["keypoints"].float()
            kpts = torch.cat([scale_xy(kp[..., :2], sx, sy), kp[..., 2:]], -1)
        targets = encode_boxes(
            scale_xy(t["boxes"].float(), sx, sy), t["box_mask"], self.model.feat_hw,
            self.model.out_stride, ignore_boxes=scale_xy(t["ignore_boxes"].float(), sx, sy),
            ignore_mask=t["ignore_mask"], keypoints=kpts, kpt_heatmaps=self.model.kpt_heatmaps)
        return imgs, targets

    def train_step(self, batch: dict) -> dict[str, torch.Tensor]:
        """One step on a host batch (FrameDetectionDataset's collated
        fields); returns the loss terms on the device, unread. The
        BatchNorm statistics move in the forward, as flax's mutable
        batch_stats do."""
        imgs, targets = self.inputs(batch)
        self.model.train()
        total, terms = detection_loss(self.model(imgs), targets)
        grads = torch.autograd.grad(total, self.state.params)
        self.state.apply_gradients(list(grads), self.tx)
        return {k: v.detach() for k, v in terms.items()}


def _bundle_kind(checkpoint_dir: Path) -> str | None:
    manifest = checkpoint_dir / "manifest.json"
    return json.loads(manifest.read_text()).get("kind") if manifest.exists() else None


def _bundle_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("mesh serving needs a live checkpoint; exported bundles are "
                         "single-device programs")


def _restored(checkpoint_dir: Path, device, num_keypoints: int | None = None,
              kpt_heatmaps: bool = False) -> DetectorTrainer:
    """A trainer of `detector.json` (beside `checkpoint_dir`) with the
    latest checkpoint under `checkpoint_dir` restored."""
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

    cfg_path = checkpoint_dir.parent / "detector.json"
    cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    trainer = DetectorTrainer.create(
        img_size=tuple(cfg.get("img_size", (512, 512))),
        preset=cfg.get("preset", "conv-t"),
        num_keypoints=int(cfg.get("num_keypoints", 0)) if num_keypoints is None else num_keypoints,
        kpt_heatmaps=kpt_heatmaps,
        device=device,
    )
    CheckpointManager(checkpoint_dir).restore(trainer.state)
    trainer.model.eval()
    return trainer


def load_detector(checkpoint_dir: str | Path, score_threshold: float = 0.3,
                  max_detections: int = 64, mesh=None, device: torch.device | str = "cuda"):
    """A DetectorPredictor from a detector checkpoint directory (the CLI's
    `<out>/checkpoints`; its `detector.json` is read from the parent). Runs
    on the card unless `device` asks for the CPU. A directory holding an
    exported detector bundle (serve/export.py) loads as a DetectorBundle,
    with the same detect_frame contract. `mesh` (item 13) is not ported."""
    from probpose_pytorch_tpu_torch.detect.pipeline import DetectorPredictor

    checkpoint_dir = Path(checkpoint_dir)
    if _bundle_kind(checkpoint_dir) == "detector":
        from probpose_pytorch_tpu_torch.serve.export import DetectorBundle

        _bundle_mesh(mesh)
        return DetectorBundle.load(checkpoint_dir, device=device)
    if mesh is not None:
        raise _unported("load_detector(mesh=...)", 13)
    trainer = _restored(checkpoint_dir, device)
    return DetectorPredictor(model=trainer.model, score_threshold=score_threshold,
                             max_detections=max_detections)


def load_bottomup(checkpoint_dir: str | Path, score_threshold: float = 0.3,
                  max_detections: int = 32, mesh=None, device: torch.device | str = "cuda"):
    """A BottomUpPredictor from a checkpoint trained with --keypoints K > 0:
    the run directory or its `checkpoints/`. Runs on the card unless
    `device` asks for the CPU. A directory holding an exported bottom-up
    bundle (serve/export.py) loads as a BottomUpBundle, with the same
    predict_frame contract. `mesh` (item 13) is not ported."""
    from probpose_pytorch_tpu_torch.detect.pipeline import BottomUpPredictor

    checkpoint_dir = Path(checkpoint_dir)
    if _bundle_kind(checkpoint_dir) == "bottomup":
        from probpose_pytorch_tpu_torch.serve.export import BottomUpBundle

        _bundle_mesh(mesh)
        return BottomUpBundle.load(checkpoint_dir, device=device)
    if mesh is not None:
        raise _unported("load_bottomup(mesh=...)", 13)
    if (checkpoint_dir / "checkpoints").exists():
        checkpoint_dir = checkpoint_dir / "checkpoints"
    cfg_path = checkpoint_dir.parent / "detector.json"
    cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    num_keypoints = int(cfg.get("num_keypoints", 0))
    if num_keypoints <= 0:
        raise ValueError(f"{cfg_path}: not a single-stage pose checkpoint "
                         "(num_keypoints == 0; train with detect.train --keypoints K)")
    trainer = _restored(checkpoint_dir, device, num_keypoints,
                        bool(cfg.get("kpt_heatmaps", False)))
    return BottomUpPredictor(model=trainer.model, score_threshold=score_threshold,
                             max_detections=max_detections)


def main(argv: Sequence[str] | None = None) -> list[dict[str, float]]:
    """Run the CLI on `argv`; returns the loss terms of the logged steps."""
    parser = argparse.ArgumentParser(description="Person detector training (PyTorch)")
    parser.add_argument("--data-root", type=Path, required=True,
                        help="COCO layout root (annotations/ + train2017/)")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--img-size", type=int, default=512, help="square detector input size")
    parser.add_argument("--preset", type=str, default="conv-t", choices=("conv-t", "conv-s"))
    parser.add_argument("--keypoints", type=int, default=0,
                        help=">0: train the single-stage pose family (a joint-offset head on "
                        "the same trunk); load with load_bottomup, score with eval.run "
                        "--bottomup")
    parser.add_argument("--kpt-heatmaps", action="store_true",
                        help="with --keypoints: add per-joint heat and sub-cell offset heads and "
                        "snap-refine the regressed joints at decode")
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--max-boxes", type=int, default=16)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from probpose_pytorch_tpu_torch.data.pipeline import Prefetcher, batch_iterator
    from probpose_pytorch_tpu_torch.detect.data import FrameDetectionDataset
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

    trainer = DetectorTrainer.create(
        img_size=(args.img_size, args.img_size), preset=args.preset, lr=args.lr,
        total_steps=args.steps, seed=args.seed, num_keypoints=args.keypoints,
        kpt_heatmaps=args.kpt_heatmaps, device=args.device)
    ds = FrameDetectionDataset(
        args.data_root / "annotations" / "person_keypoints_train2017.json",
        args.data_root / "train2017", max_boxes=args.max_boxes, num_keypoints=args.keypoints)
    print(f"[detect] {len(ds)} training frames", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "detector.json").write_text(json.dumps(dict(
        img_size=[args.img_size, args.img_size], preset=args.preset,
        num_keypoints=args.keypoints, kpt_heatmaps=bool(args.kpt_heatmaps and args.keypoints > 0))))
    ckpt = CheckpointManager(args.out / "checkpoints")

    logged = []
    step = epoch = 0
    t0 = time.perf_counter()
    while step < args.steps:
        batches = Prefetcher(batch_iterator(ds, args.batch_size, shuffle=True, seed=args.seed,
                                            epoch=epoch, num_workers=args.num_workers), depth=2)
        before = step
        try:
            for batch in batches:
                terms = trainer.train_step(batch)
                step += 1
                if step % args.log_every == 0 or step == args.steps:
                    vals = {k: float(v) for k, v in terms.items()}
                    logged.append(vals)
                    rate = step * args.batch_size / (time.perf_counter() - t0)
                    kpt_part = f" kpts {vals['kpts']:.4f}" if "kpts" in vals else ""
                    if "kpt_heat" in vals:
                        kpt_part += (f" kpt_heat {vals['kpt_heat']:.4f}"
                                     f" kpt_off {vals['kpt_offset']:.4f}")
                    print(f"[detect] step {step}/{args.steps} loss {vals['total']:.4f} "
                          f"(center {vals['center']:.4f} size {vals['size']:.4f} "
                          f"offset {vals['offset']:.4f}{kpt_part}) {rate:.0f} frames/s",
                          flush=True)
                if step >= args.steps:
                    break
        finally:
            batches.close()
        if step == before:
            raise ValueError(f"{len(ds)} training frames make no batch of {args.batch_size}")
        epoch += 1
    ckpt.save(step, trainer.state)
    print(f"[detect] saved checkpoint at step {step} -> {args.out / 'checkpoints'}", flush=True)
    return logged


if __name__ == "__main__":
    main()
