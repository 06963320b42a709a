"""Host utilities of the port."""

from probpose_pytorch_tpu_torch.utils.logging import MetricsLogger

__all__ = ["MetricsLogger"]
