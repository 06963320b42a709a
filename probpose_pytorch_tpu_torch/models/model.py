"""Backbone + head composition and the config-driven builder (port of
probpose_pytorch_tpu/models/model.py).

`ModelConfig` takes every key of the JAX `ModelConfig`, so the `model`
block of any configs/*.json loads as `ModelConfig(**block)`. The trunk is
a ViT, or with `backbone="conv-s"` / `"conv-t"` the residual conv family
(models/convnet.py). The head is `head_type`'s: the ProbMap heatmap head
or the SimCC coordinate classifier (models/simcc.py). `build_model`
raises `NotImplementedError` for the values this port does not run yet,
naming the ROADMAP item that ports each (`ModelConfig.check_ported`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any

import torch
from torch import nn

from probpose_pytorch_tpu_torch.models.convnet import (
    CONV_PRESETS,
    ConvBackbone,
    init_conv_weights,
)
from probpose_pytorch_tpu_torch.models.head import ProbMapHead
from probpose_pytorch_tpu_torch.models.simcc import SimCCHead
from probpose_pytorch_tpu_torch.models.vit import ViTBackbone, ViTConfig

__all__ = ["ModelConfig", "ProbPoseModel", "build_model", "init_weights", "resolve_device"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tuples(v: Any) -> Any:
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


@dataclass(frozen=True)
class ModelConfig:
    img_size: tuple[int, int] = (256, 192)  # (H, W)
    patch_size: int = 16
    num_keypoints: int = 17
    backbone: str = "vit-s"
    head_type: str = "probmap"
    simcc_split_ratio: float = 2.0
    simcc_sigma: float = 6.0
    frozen_backbone: bool = False
    adapter_hidden: tuple[int, ...] = ()
    deconv_out_channels: tuple[int, ...] = (256, 256)
    deconv_kernel_sizes: tuple[int, ...] = (4, 4)
    conv_out_channels: tuple[int, ...] = ()
    conv_kernel_sizes: tuple[int, ...] = ()
    final_layer_kernel_size: int | None = 1
    pool_sizes: tuple[tuple[int, int], ...] = ((4, 3), (2, 2), (2, 2))
    normalize: float | None = 1.0
    compute_dtype: str = "bfloat16"
    softmax_dtype: str = "float32"
    # "fused" and "einsum" both run kernel K1 (f32 softmax); "pallas" runs
    # kernel K6, forward only.
    attn_impl: str = "einsum"
    mlp_impl: str = "dense"  # "fused": kernel K5
    # "fused" and "fastvjp" were XLA rewrites, pinned numerically equal to
    # the defaults by the JAX tests; the port accepts them and runs its one
    # implementation.
    scalar_impl: str = "separate"
    deconv_impl: str = "lax"
    remat: bool = False  # per-block recompute in training
    num_prefix_tokens: int = 0
    exact_gelu: bool = False
    pp_stages: int = 1
    pp_microbatches: int = 0
    lora_rank: int = 0
    lora_alpha: float = 16.0

    def __post_init__(self):
        for f in fields(self):
            object.__setattr__(self, f.name, _tuples(getattr(self, f.name)))

    def check_ported(self) -> None:
        """Raise for values the port cannot build yet, naming the ROADMAP
        item that ports each; ValueError for values that are no option."""
        unported = [
            (self.pp_stages > 1, "pp_stages > 1", 13),
            (self.attn_impl == "fused_tp", "attn_impl='fused_tp'", 13),
            (any(k != 4 for k in self.deconv_kernel_sizes),
             f"deconv_kernel_sizes={self.deconv_kernel_sizes}", 4),
            (self.attn_impl == "einsum" and self.softmax_dtype != "float32",
             f"attn_impl='einsum' with softmax_dtype={self.softmax_dtype!r}", 4),
        ]
        if self.lora_rank > 0 and self.backbone.startswith("conv"):
            raise ValueError("lora_rank applies to ViT backbones only")
        if self.lora_rank > 0 and self.mlp_impl == "fused":
            raise ValueError(
                "lora_rank > 0 does not compose with mlp_impl='fused' (the fused "
                "LN+MLP kernel bypasses the Dense modules)"
            )
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported to PyTorch yet (ROADMAP item {item})"
                )
        if self.head_type not in ("probmap", "simcc"):
            raise ValueError(
                f"unknown head_type {self.head_type!r} (expected probmap | simcc)")
        if self.attn_impl not in ("fused", "einsum", "pallas"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.mlp_impl not in ("dense", "fused"):
            raise ValueError(f"unknown mlp_impl {self.mlp_impl!r}")
        if self.scalar_impl not in ("separate", "fused"):
            raise ValueError(f"unknown scalar_impl {self.scalar_impl!r}")
        if self.deconv_impl not in ("lax", "fastvjp"):
            raise ValueError(f"unknown deconv_impl {self.deconv_impl!r}")
        for name in ("compute_dtype", "softmax_dtype"):
            if getattr(self, name) not in _DTYPES:
                raise ValueError(f"{name} must be one of {sorted(_DTYPES)}")

    @property
    def heatmap_size(self) -> tuple[int, int]:
        """(W, H): feature grid upsampled 2x per deconv stage."""
        up = 2 ** len(self.deconv_out_channels)
        return (self.img_size[1] // self.patch_size * up,
                self.img_size[0] // self.patch_size * up)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


class ProbPoseModel(nn.Module):
    """forward = head(backbone(x)): (B, H, W, 3) image in [0, 1] -> the
    5-tuple (heatmaps, probability, visibility, oks, error); with the SimCC
    head the first entry is the pair (x_logits, y_logits)."""

    def __init__(self, backbone: ViTBackbone | ConvBackbone, head: ProbMapHead | SimCCHead):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.head(self.backbone(x))


def _trunc_normal(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal truncated at +-2 std (flax `truncated_normal` /
    `lecun_normal`'s shape), drawn on the CPU from `g`."""
    v = torch.empty(t.shape).normal_(generator=g)
    while True:
        bad = v.abs() > 2.0
        if not bad.any():
            break
        v[bad] = torch.empty(int(bad.sum())).normal_(generator=g)
    with torch.no_grad():
        t.copy_(v * std)


def init_weights(model: ProbPoseModel, generator: torch.Generator) -> None:
    """Draw the weights as the flax initializers do (lecun-normal trunk
    kernels, truncated-normal 0.02 position embedding, normal(0.001) head
    convs, zero biases, unit BN scales and variances, LoRA `a` normal(0.02)
    and `b` zero; the SimCC head's 1x1 conv and Linears lecun-normal, as
    flax's defaults draw them), from `generator`. The LoRA factors are
    drawn last, so a LoRA model's base weights are those of the same model
    without LoRA. A conv trunk draws as `init_conv_weights` does."""
    # lecun_normal divides by 0.8796, the std of a unit normal truncated at
    # +-2; truncated_normal(0.02) scales the truncated draw as it is.
    lecun = lambda fan_in: 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    if isinstance(model.backbone, ConvBackbone):
        init_conv_weights(model.backbone, generator)
        trunk = []
    else:
        trunk = model.backbone.named_parameters()
    with torch.no_grad():
        lora = []
        for name, p in trunk:
            if "_lora." in name:
                lora.append((name, p))
                continue
            if "norm" in name:
                continue  # LayerNorm keeps its ones / zeros
            if name.endswith("bias"):
                p.zero_()
                continue
            if name in ("pos_embed", "prefix_tokens"):
                _trunc_normal(p, 0.02, generator)
            else:
                fan_in = p[0].numel() if p.dim() > 2 else p.shape[1]
                _trunc_normal(p, lecun(fan_in), generator)
        simcc = isinstance(model.head, SimCCHead)
        for m in model.head.modules():
            if simcc and m in (model.head.final, model.head.mlp_x, model.head.mlp_y):
                w = m.weight
                _trunc_normal(w, lecun(w[0].numel()), generator)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.copy_(torch.empty(m.weight.shape).normal_(
                    0.0, 0.001, generator=generator))
                if m.bias is not None:
                    m.bias.zero_()
        for name, p in lora:
            if name.endswith(".a"):
                p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=generator))
            else:
                p.zero_()


def resolve_device(device: torch.device | str, what: str) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises, so an
    entry point never falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {str(device)!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def _vit_backbone(cfg: ModelConfig) -> tuple[ViTBackbone, int]:
    """The ViT trunk of `cfg` and the width of its feature grid."""
    vit = ViTConfig.PRESETS[cfg.backbone]
    backbone = ViTBackbone(
        img_size=cfg.img_size,
        patch_size=cfg.patch_size,
        embed_dim=vit["embed_dim"],
        depth=vit["depth"],
        num_heads=vit["num_heads"],
        mlp_ratio=vit["mlp_ratio"],
        dtype=cfg.dtype,
        frozen=cfg.frozen_backbone,
        adapter_hidden=cfg.adapter_hidden,
        num_prefix_tokens=cfg.num_prefix_tokens,
        exact_gelu=cfg.exact_gelu,
        remat=cfg.remat,
        attn_impl=cfg.attn_impl,
        mlp_impl=cfg.mlp_impl,
        lora_rank=cfg.lora_rank,
        lora_alpha=cfg.lora_alpha,
    )
    return backbone, cfg.adapter_hidden[-1] if cfg.adapter_hidden else vit["embed_dim"]


def build_model(cfg: ModelConfig, device: torch.device | str = "cuda",
                seed: int = 0) -> ProbPoseModel:
    """The model of `cfg` on `device` (the card unless the caller asks for
    the CPU), in eval mode, with weights drawn from a `torch.Generator`
    seeded with `seed`."""
    device = resolve_device(device, "build_model")
    cfg.check_ported()
    if cfg.backbone.startswith("conv"):
        channels, blocks = CONV_PRESETS[cfg.backbone]
        backbone = ConvBackbone(channels, blocks, dtype=cfg.dtype, frozen=cfg.frozen_backbone)
        feat_ch = backbone.out_channels
    else:
        backbone, feat_ch = _vit_backbone(cfg)
    if cfg.head_type == "simcc":
        H, W = cfg.img_size
        head = SimCCHead(
            in_channels=feat_ch,
            out_channels=cfg.num_keypoints,
            input_size=cfg.img_size,
            grid=(H // cfg.patch_size, W // cfg.patch_size),
            split_ratio=cfg.simcc_split_ratio,
            pool_sizes=cfg.pool_sizes,
            dtype=cfg.dtype,
        )
    else:
        head = ProbMapHead(
            in_channels=feat_ch,
            out_channels=cfg.num_keypoints,
            pool_sizes=cfg.pool_sizes,
            deconv_out_channels=cfg.deconv_out_channels,
            deconv_kernel_sizes=cfg.deconv_kernel_sizes,
            conv_out_channels=cfg.conv_out_channels,
            conv_kernel_sizes=cfg.conv_kernel_sizes,
            final_layer_kernel_size=cfg.final_layer_kernel_size,
            normalize=cfg.normalize,
            dtype=cfg.dtype,
        )
    model = ProbPoseModel(backbone, head)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
