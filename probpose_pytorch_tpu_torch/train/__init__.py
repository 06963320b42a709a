"""Training of the port: config, optimizer and state, and the train loop."""

from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer

__all__ = ["TrainConfig", "Trainer"]
