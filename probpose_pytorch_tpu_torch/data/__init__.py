"""Host-side data of the port: synthetic poses and numpy batching."""

from probpose_pytorch_tpu_torch.data.pipeline import SyntheticPoseDataset, batch_iterator

__all__ = ["SyntheticPoseDataset", "batch_iterator"]
