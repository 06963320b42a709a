"""Models of the port: ViT and conv backbones, ProbMap and SimCC heads,
their composition, and the int8 serving trunk."""

from probpose_pytorch_tpu_torch.models.head import ProbMapHead
from probpose_pytorch_tpu_torch.models.lora import LoRADelta, lora_frozen_labels
from probpose_pytorch_tpu_torch.models.model import ModelConfig, ProbPoseModel, build_model
from probpose_pytorch_tpu_torch.models.vit import ViTBackbone, ViTConfig

__all__ = ["LoRADelta", "ModelConfig", "ProbMapHead", "ProbPoseModel", "ViTBackbone",
           "ViTConfig", "build_model", "lora_frozen_labels"]
