"""Training configuration (port of probpose_pytorch_tpu/train/config.py).

The dataclasses take every key of the JAX ones, so every configs/*.json
loads with the same field values as the JAX `TrainConfig.load`, and every
option of the JAX config runs. A value that is no option raises
`ValueError` where it would take effect (`ModelConfig.check_ported` in
models/model.py, train/loop.py, train/cli.py, data/mixed.py), as JAX's does.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from probpose_pytorch_tpu_torch.models.model import ModelConfig

__all__ = ["OptimConfig", "LossWeights", "AugmentConfig", "DistillConfig", "TrainConfig"]

COCO_FLIP_PAIRS = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
)


@dataclass(frozen=True)
class OptimConfig:
    """AdamW (or Lion, or Adafactor) + one-cycle cosine schedule (or
    warm-up cosine, or constant) + global-norm clipping, optional EMA,
    non-finite skipping and gradient accumulation over `accum_steps`
    micro-steps."""

    peak_lr: float = 5e-4
    weight_decay: float = 0.1
    optimizer: str = "adamw"  # or "lion", "adafactor"
    schedule: str = "onecycle"  # or "cosine", "constant"
    pct_start: float = 0.1
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    clip_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    ema_decay: float | None = None
    accum_steps: int = 1
    # Skip updates whose gradients are non-finite, up to this many in a
    # row (optax.apply_if_finite); 0 disables the guard.
    max_nonfinite_skips: int = 0


@dataclass(frozen=True)
class LossWeights:
    kpt: float = 1.0
    probability: float = 1.0
    visibility: float = 0.0
    oks: float = 1.0
    error: float = 1.0

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class AugmentConfig:
    """The JAX `ops.augment.AugmentConfig` fields (ROADMAP item 6): flip
    with left/right swaps, box scale and shift jitter, rotation, brightness
    and contrast, and half-body boxes in frame mode (ops/augment.py)."""

    flip_prob: float = 0.5
    scale_jitter: float = 0.15
    shift_jitter: float = 0.05
    rotation_deg: float = 0.0
    brightness: float = 0.2
    contrast: float = 0.2
    flip_pairs: tuple[tuple[int, int], ...] = COCO_FLIP_PAIRS
    half_body_prob: float = 0.0
    half_body_min_total: int = 8
    half_body_min_half: int = 2
    half_body_padding: float = 1.5
    upper_body_ids: tuple[int, ...] = tuple(range(11))

    @property
    def enabled(self) -> bool:
        return (self.flip_prob > 0 or self.scale_jitter > 0 or self.shift_jitter > 0
                or self.rotation_deg > 0 or self.brightness > 0 or self.contrast > 0)


@dataclass(frozen=True)
class DistillConfig:
    """Distillation from a frozen teacher, a port checkpoint with its
    config (train/loop.py:load_teacher); `ema_teacher` takes its EMA."""

    teacher_checkpoint: str = ""
    teacher_config: str = ""
    ema_teacher: bool = True
    weight: float = 1.0
    heatmap_weight: float = 1.0
    scalar_weight: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss_weights: LossWeights = field(default_factory=LossWeights)
    augment: AugmentConfig | None = None
    distill: DistillConfig | None = None
    epochs: int = 200
    train_batch_size: int = 32
    val_batch_size: int = 32
    val_every: int = 50
    log_every: int = 10
    checkpoint_every_epochs: int = 10
    keep_checkpoints: int = 3
    async_checkpoint: bool = False
    handle_preemption: bool = True
    seed: int = 0
    sigma: float = 2.0  # fixed encode spread (ProbMap)
    decode_sigma: float = -1.0  # loss decoder spread (ArgMaxProbMap)
    kpt_sigma_value: float = 0.05
    freeze_error: bool = True
    freeze_oks: bool = False
    learn_heatmaps_from_zeros: bool = False
    data_root: str = "./data/field-synth-2"
    dataset_format: str = "yolo"
    resample: str = ""
    mixed_datasets: tuple = ()
    preprocess_method: str = "bilinear_matmul"
    cache_dir: str = ""
    num_workers: int = 4
    recover_on_nonfinite: bool = True
    max_recoveries: int = 3
    out_dir: str = "./runs/default"
    resume: bool = True
    model_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_schedule: str = "gpipe"
    shard_opt_state: bool = False
    device_prefetch: int = 2
    train_lora_only: bool = False
    track_best_metric: str = ""
    track_best_mode: str = "auto"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "TrainConfig":
        nested = {"model": ModelConfig, "optim": OptimConfig,
                  "loss_weights": LossWeights, "augment": AugmentConfig,
                  "distill": DistillConfig}

        def build(dc_cls, data):
            names = {f.name for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in data.items():
                if k.startswith("_"):  # "_comment" keys
                    continue
                if k not in names:
                    raise ValueError(f"unknown config key {k!r} for {dc_cls.__name__}")
                if k in nested:
                    kwargs[k] = None if v is None else build(nested[k], v)
                elif isinstance(v, list):
                    kwargs[k] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
                else:
                    kwargs[k] = v
            return dc_cls(**kwargs)

        return build(cls, raw)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "TrainConfig":
        return cls.from_json(Path(path).read_text())
