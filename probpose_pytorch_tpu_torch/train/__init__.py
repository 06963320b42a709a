"""Training of the port: config, optimizer and state, checkpoints, and the
train loop."""

from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.config import LossWeights, OptimConfig, TrainConfig
from probpose_pytorch_tpu_torch.train.loop import (
    Trainer,
    build_codecs,
    layout_metadata,
    make_eval_step,
    make_train_step,
    qkv_layout_of,
    restore_state_with_layout,
)
from probpose_pytorch_tpu_torch.train.state import TrainState, make_optimizer

__all__ = ["CheckpointManager", "LossWeights", "OptimConfig", "TrainConfig", "TrainState",
           "Trainer", "build_codecs", "make_eval_step", "make_optimizer", "make_train_step",
           "layout_metadata", "qkv_layout_of", "restore_state_with_layout"]
