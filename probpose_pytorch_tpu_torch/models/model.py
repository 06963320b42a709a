"""Backbone + head composition and the config-driven builder (port of
probpose_pytorch_tpu/models/model.py).

`ModelConfig` takes every key of the JAX `ModelConfig`, so the `model`
block of any configs/*.json loads as `ModelConfig(**block)`. The trunk is
a ViT, or with `backbone="conv-s"` / `"conv-t"` the residual conv family
(models/convnet.py). The head is `head_type`'s: the ProbMap heatmap head
or the SimCC coordinate classifier (models/simcc.py). Every option of
the JAX config runs; `build_model` raises `ValueError` for a value that is
no option or a combination JAX refuses too (`ModelConfig.check_ported`).
`pp_stages > 1` stacks the ViT's blocks for pipeline parallelism
(models/vit.py); its weights are drawn as the per-block trunk's.

On a mesh (parallel/mesh.py) every rank builds the same weights from the
seed and keeps its slices (parallel/sharding.py:shard_params): its
Megatron slices on a model axis, its pipeline stage of a stacked trunk on
a pipe axis. The model takes the rank's rows of the batch; its head
follows JAX's `head_batch_spec`: where the rows divide the model and pipe
axes too, each rank runs the head on its share of them (`scatter_rows`
over each axis in turn), else on all of them. Train-mode BatchNorm takes
the statistics of the global batch: the head's over the ranks whose rows
it runs (`head_group`), a conv trunk's over the data axis.
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
from probpose_pytorch_tpu_torch.models.head import ProbMapHead, bn_sync
from probpose_pytorch_tpu_torch.models.simcc import SimCCHead
from probpose_pytorch_tpu_torch.models.vit import ViTBackbone, ViTConfig
from probpose_pytorch_tpu_torch.parallel.collectives import scatter_rows
from probpose_pytorch_tpu_torch.parallel.mesh import mesh_coords, mesh_shape
from probpose_pytorch_tpu_torch.parallel.sharding import head_batch_spec, local_slice, shard_params

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
    # "fused" and "einsum" both run kernel K1 (f32 softmax); "einsum" with a
    # bf16 softmax_dtype runs JAX's einsum attention in plain PyTorch;
    # "pallas" runs kernel K6, forward only; "fused_tp" runs K1 on head-major
    # qkv weights (compat/layouts.py), split by heads on a model axis.
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
        """ValueError for values that are no option (every option of the
        JAX config is ported)."""
        if self.lora_rank > 0 and self.backbone.startswith("conv"):
            raise ValueError("lora_rank applies to ViT backbones only")
        if self.lora_rank > 0 and self.mlp_impl == "fused":
            raise ValueError(
                "lora_rank > 0 does not compose with mlp_impl='fused' (the fused "
                "LN+MLP kernel bypasses the Dense modules)"
            )
        if self.lora_rank > 0 and self.pp_stages > 1:
            raise ValueError("lora_rank > 0 does not compose with the stacked pipeline-parallel "
                             "trunk layout (pp_stages > 1)")
        if self.head_type not in ("probmap", "simcc"):
            raise ValueError(
                f"unknown head_type {self.head_type!r} (expected probmap | simcc)")
        if self.attn_impl not in ("fused", "fused_tp", "einsum", "pallas"):
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

    def __init__(self, backbone: ViTBackbone | ConvBackbone, head: ProbMapHead | SimCCHead,
                 mesh: Any = None):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.mesh = mesh

    def head_split(self, rows: int) -> bool:
        """Whether the model ranks share the head's `rows` (this rank's
        rows of the batch): JAX's head_batch_spec of the global batch."""
        shape = mesh_shape(self.mesh)
        return head_batch_spec(self.mesh, rows * shape.get("data", 1)) is not None

    def head_group(self, rows: int):
        """The ranks whose head rows make the batch: the world where the
        head is split, else the data axis; None off a mesh."""
        if self.mesh is None:
            return None
        if self.head_split(rows):
            return torch.distributed.group.WORLD
        return self.mesh.get_group("data")

    def head_axes(self) -> list[str]:
        """The axes beyond "data" that a split head's rows are shared over,
        outermost first."""
        shape = mesh_shape(self.mesh)
        return [ax for ax in ("model", "pipe") if shape.get(ax, 1) > 1]

    def head_share(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's head rows of a tensor of its data rows (the rows a
        split head runs here)."""
        shape, coords = mesh_shape(self.mesh), mesh_coords(self.mesh)
        for ax in self.head_axes():
            t = local_slice(t, 0, coords[ax], shape[ax])
        return t

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """On a mesh: x is this rank's rows; the outputs are its head rows
        (`head_group`)."""
        if self.mesh is None:
            return self.head(self.backbone(x))
        with bn_sync(self.mesh.get_group("data")):
            feats = self.backbone(x)
        if self.head_split(x.shape[0]):
            for ax in self.head_axes():
                feats = scatter_rows(feats, self.mesh.get_group(ax))
        with bn_sync(self.head_group(x.shape[0])):
            return self.head(feats)


def _trunc_normal(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal truncated at +-2 std (flax `truncated_normal` /
    `lecun_normal`'s shape), drawn on the CPU from `g`: the draws outside
    +-2 drawn again, in index order, until none is left (only the redrawn
    elements are checked again)."""
    v = torch.empty(t.shape).normal_(generator=g)
    flat = v.view(-1)
    idx = (flat.abs() > 2.0).nonzero().squeeze(1)
    while idx.numel():
        draw = torch.empty(idx.numel()).normal_(generator=g)
        flat[idx] = draw
        idx = idx[draw.abs() > 2.0]
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
        stacked = getattr(model.backbone, "stacked", False)
        for name, p in trunk:
            if stacked and name.startswith("blocks."):
                if name == "blocks.norm1_scale":
                    _init_stacked(model.backbone.blocks, generator, lecun)
                continue
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


def _init_stacked(blocks: nn.Module, generator: torch.Generator, lecun) -> None:
    """The stacked trunk's kernels drawn as the per-block trunk's: per block,
    qkv, proj, fc1 and fc2 in (out, in), then stored (in, out)."""
    for i in range(blocks.qkv_kernel.shape[0]):
        for name in ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel"):
            leaf = getattr(blocks, name)
            v = torch.empty(leaf.shape[2], leaf.shape[1])
            _trunc_normal(v, lecun(leaf.shape[1]), generator)
            leaf[i].copy_(v.t())


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
        softmax_dtype=_DTYPES[cfg.softmax_dtype],
        pp_stages=cfg.pp_stages,
        pp_microbatches=cfg.pp_microbatches,
    )
    return backbone, cfg.adapter_hidden[-1] if cfg.adapter_hidden else vit["embed_dim"]


def build_model(cfg: ModelConfig, mesh: Any = None, *, device: torch.device | str = "cuda",
                seed: int = 0) -> ProbPoseModel:
    """The model of `cfg` on `device` (the card unless the caller asks for
    the CPU), in eval mode, with weights drawn from a `torch.Generator`
    seeded with `seed`. On a `mesh` each rank keeps its slices of the
    weights (on the rank's card when `device` is a card): on a pipe axis,
    its stage of a stacked trunk."""
    from probpose_pytorch_tpu_torch.parallel.mesh import mesh_device

    device = mesh_device(mesh, resolve_device(device, "build_model"))
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
    model = ProbPoseModel(backbone, head, mesh)
    init_weights(model, torch.Generator().manual_seed(seed))
    if mesh is not None:
        shard_params(model, mesh)
    return model.to(device).eval()
