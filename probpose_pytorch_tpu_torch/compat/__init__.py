"""Weight interchange with the JAX package (numpy in, no jax imported) and
with reference PyTorch checkpoints."""

from probpose_pytorch_tpu_torch.compat.torch_import import state_dict_from_checkpoint

__all__ = ["state_dict_from_checkpoint"]
