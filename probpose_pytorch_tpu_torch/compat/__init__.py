"""Weight interchange with the JAX package (numpy in, no jax imported) and
with reference PyTorch checkpoints."""

from probpose_pytorch_tpu_torch.compat.layouts import (
    convert_qkv_layout,
    convert_trunk_layout,
    qkv_head_major_permutation,
    qkv_to_head_major,
    qkv_to_qkv_major,
    stack_vit_blocks,
    unstack_vit_blocks,
)
from probpose_pytorch_tpu_torch.compat.torch_import import state_dict_from_checkpoint

__all__ = ["state_dict_from_checkpoint", "convert_qkv_layout", "convert_trunk_layout",
           "qkv_head_major_permutation", "qkv_to_head_major", "qkv_to_qkv_major",
           "stack_vit_blocks", "unstack_vit_blocks"]
