"""Vision Transformer backbone (port of probpose_pytorch_tpu/models/vit.py).

NHWC image in [0, 1] -> NHWC feature grid, no class token, no pooling; the
input is not mean/std normalised. Numerics follow the flax modules:
parameters stay float32 and each Linear/Conv runs in the compute dtype
(weights, input and bias cast to it), LayerNorms run in float32 with
eps 1e-6, GELU is the tanh approximation unless `exact_gelu`, and the
positional embedding is added in the compute dtype.

Attention reads the (B, N, 3C) qkv projection in qkv-major order, exactly
the input of kernel K1, and hands it to
`ops.kernels.attention.packed_attention` unchanged. K1's softmax is f32, so
it computes both the JAX "fused" attention and the JAX "einsum" attention
at its default float32 `softmax_dtype`. `attn_impl="einsum"` with another
`softmax_dtype` runs JAX's einsum attention as it is, in plain PyTorch:
the scores in the compute dtype, scaled in float32 (JAX's NumPy-scalar
scale promotes them), the softmax in `softmax_dtype`, then the compute
dtype.
`attn_impl="pallas"` hands the q, k, v views of the same projection to
kernel K6 (`fused_attention`), forward only, as JAX does.
`attn_impl="fused_tp"` reads the projection head-major (compat/layouts.py;
JAX's `_qkv_offsets`) and runs K1 with `layout="head_major"`; on the CPU
that is the plain head-major attention, JAX's einsum fallback there
(models/vit.py:174-177 of the JAX package).

On a model-parallel mesh (parallel/sharding.py:shard_params) a block is
JAX's Megatron block (`tp_block_apply`): the head-major qkv and fc1 keep
this rank's output columns, proj and fc2 its input columns, the input of
each enters through `tp_enter` and the two row-parallel products are summed
over the model group by `tp_leave` before their whole bias is added. The
attention runs K1 head-major on the rank's own heads, with no collective
(JAX's `sharded_packed_attention`). An attention or MLP that stays whole
(qkv-major weights, the fused MLP) runs as on one device.

`mlp_impl="fused"` runs the block's second half, LayerNorm -> fc1 -> GELU
-> fc2 -> +residual, as kernel K5 (`ops.kernels.mlp.fused_ln_mlp`) on the
(B * N, C) residual stream, with the f32 LayerNorm parameters, the fc
weights cast to the compute dtype and the fc biases in f32, as the JAX
branch does (models/vit.py:271-292 of the JAX package). Its parameters
keep the dense path's names (`norm2`, `mlp.fc1`, `mlp.fc2`).

`lora_rank > 0` adds a LoRA delta (models/lora.py) beside qkv, proj, fc1
and fc2, where JAX places them: each is added to its projection's output,
both in the compute dtype; qkv's before attention, so K1 (or K6) reads the
summed projection, and fc2's reads the hidden state after the GELU.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from probpose_pytorch_tpu_torch.models.lora import LoRADelta
from probpose_pytorch_tpu_torch.ops.kernels.attention import fused_attention, packed_attention
from probpose_pytorch_tpu_torch.ops.kernels.mlp import fused_ln_mlp
from probpose_pytorch_tpu_torch.parallel.pipeline import tp_enter, tp_leave

__all__ = ["ViTConfig", "Attention", "MlpBlock", "Block", "ViTBackbone"]

LN_EPS = 1e-6


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: input, kernel and bias in `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=float32)`: float32 in and out."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class ViTConfig:
    """Static geometry presets (ViTPose-style sizes), as in the JAX package."""

    PRESETS = {
        "vit-s": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0),
        "vit-b": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0),
        "vit-l": dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0),
        "vit-h": dict(embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4.0),
        "vit-s-timm": dict(embed_dim=384, depth=12, num_heads=12, mlp_ratio=4.0),
        "vit-nano": dict(embed_dim=64, depth=2, num_heads=2, mlp_ratio=2.0),
    }


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 exact_gelu: bool = False, lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.dtype = dtype
        self.approximate = "none" if exact_gelu else "tanh"
        lora = lambda i, o: LoRADelta(i, o, lora_rank, lora_alpha, dtype) if lora_rank else None
        self.fc1_lora, self.fc2_lora = lora(dim, hidden_dim), lora(hidden_dim, dim)
        self.tp_group = None  # the model group when fc1 and fc2 hold this rank's columns

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            h = F.gelu(linear(tp_enter(x, self.tp_group), self.fc1, self.dtype),
                       approximate=self.approximate)
            out = F.linear(h, self.fc2.weight.to(self.dtype))
            return tp_leave(out, self.tp_group) + self.fc2.bias.to(self.dtype)
        h = linear(x, self.fc1, self.dtype)
        if self.fc1_lora is not None:
            h = h + self.fc1_lora(x)
        h = F.gelu(h, approximate=self.approximate)
        out = linear(h, self.fc2, self.dtype)
        if self.fc2_lora is not None:
            out = out + self.fc2_lora(h)
        return out


def einsum_attention(qkv: torch.Tensor, num_heads: int, softmax_dtype: torch.dtype,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """JAX's einsum attention (models/vit.py:190-197 there) in plain
    PyTorch: (B, N, 3C) qkv-major -> (B, N, C). The scores are scaled in
    float32 (JAX's NumPy-scalar scale promotes them), the softmax runs in
    `softmax_dtype` and its probabilities are cast to `out_dtype`."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.unflatten(-1, (3, num_heads, -1)).unbind(2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
    attn = torch.softmax(attn.to(softmax_dtype), dim=-1).to(out_dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C3 // 3)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, impl: str = "fused",
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.num_heads = num_heads
        self.dtype = dtype
        self.impl = impl
        self.softmax_dtype = softmax_dtype
        lora = lambda i, o: LoRADelta(i, o, lora_rank, lora_alpha, dtype) if lora_rank else None
        self.qkv_lora, self.proj_lora = lora(dim, 3 * dim), lora(dim, dim)
        # The model group when qkv and proj hold this rank's heads
        # (num_heads is then the rank's own count).
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            qkv = linear(tp_enter(x, self.tp_group), self.qkv, self.dtype)
            ctx = packed_attention(qkv, self.num_heads, "head_major")
            out = F.linear(ctx, self.proj.weight.to(self.dtype))
            return tp_leave(out, self.tp_group) + self.proj.bias.to(self.dtype)
        # (B, N, 3C), qkv-major, or head-major under "fused_tp"
        qkv = linear(x, self.qkv, self.dtype)
        if self.qkv_lora is not None:
            qkv = qkv + self.qkv_lora(x)
        if self.impl == "pallas":
            B, N, C3 = qkv.shape
            q, k, v = qkv.unflatten(-1, (3, self.num_heads, -1)).unbind(2)
            ctx = fused_attention(q, k, v).reshape(B, N, C3 // 3)
        elif self.impl == "einsum" and self.softmax_dtype != torch.float32:
            ctx = einsum_attention(qkv, self.num_heads, self.softmax_dtype, self.dtype)
        elif self.impl == "fused_tp":
            ctx = packed_attention(qkv, self.num_heads, "head_major")
        else:
            ctx = packed_attention(qkv, self.num_heads)
        out = linear(ctx, self.proj, self.dtype)
        if self.proj_lora is not None:
            out = out + self.proj_lora(ctx)
        return out


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype, exact_gelu: bool = False,
                 attn_impl: str = "fused", mlp_impl: str = "dense",
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dtype, attn_impl, lora_rank, lora_alpha,
                              softmax_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype, exact_gelu, lora_rank, lora_alpha)
        self.mlp_impl = mlp_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1))
        if self.mlp_impl == "fused":
            B, N, C = x.shape
            fc1, fc2, dt = self.mlp.fc1, self.mlp.fc2, self.mlp.dtype
            out = fused_ln_mlp(x.reshape(B * N, C), self.norm2.weight, self.norm2.bias,
                               fc1.weight.to(dt).t(), fc1.bias, fc2.weight.to(dt).t(),
                               fc2.bias, self.mlp.approximate == "none")
            return out.reshape(B, N, C)
        return x + self.mlp(layer_norm(x, self.norm2))


class ViTBackbone(nn.Module):
    """ViT trunk: (B, H, W, 3) image in [0, 1] -> (B, H/p, W/p, C) features.

    `num_prefix_tokens` learned tokens join attention and are stripped
    before the grid reshape; `frozen` detaches the trunk output;
    `adapter_hidden` adds a token MLP (ReLU between layers) after it.
    Parameters stay float32 and are cast to the compute dtype per call, so
    gradients reach the float32 masters through the casts, as flax's f32
    `param_dtype` does. The JAX trunk has no dropout, nor does this one.
    `remat` recomputes each block in the backward (`nn.remat(Block)` in
    JAX): in training, each block runs under `torch.utils.checkpoint`, which
    keeps only the block's input.
    """

    def __init__(
        self,
        img_size: tuple[int, int] = (256, 192),
        patch_size: int = 16,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        dtype: torch.dtype = torch.bfloat16,
        frozen: bool = False,
        adapter_hidden: Sequence[int] = (),
        num_prefix_tokens: int = 0,
        exact_gelu: bool = False,
        remat: bool = False,
        attn_impl: str = "fused",
        mlp_impl: str = "dense",
        lora_rank: int = 0,
        lora_alpha: float = 16.0,
        softmax_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.remat = remat
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.frozen = frozen
        self.num_prefix_tokens = num_prefix_tokens
        gh, gw = self.grid_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw, embed_dim))
        self.prefix_tokens = (
            nn.Parameter(torch.zeros(1, num_prefix_tokens, embed_dim))
            if num_prefix_tokens else None
        )
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype, exact_gelu, attn_impl, mlp_impl,
                  lora_rank, lora_alpha, softmax_dtype)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        widths = [embed_dim, *adapter_hidden]
        self.adapters = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )

    @property
    def grid_size(self) -> tuple[int, int]:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        gh, gw = self.grid_size
        dt = self.dtype
        bias = None if self.patch_embed.bias is None else self.patch_embed.bias.to(dt)
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     bias, stride=self.patch_size)
        # (B, N, C) with row-major patches, made contiguous once so the
        # residual stream is not re-laid-out by every LayerNorm and Linear.
        x = x.flatten(2).transpose(1, 2).contiguous()
        x = x + self.pos_embed.to(dt)
        if self.prefix_tokens is not None:
            prefix = self.prefix_tokens.to(dt).expand(B, -1, -1)
            x = torch.cat([prefix, x], dim=1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = layer_norm(x, self.norm)
        if self.num_prefix_tokens:
            x = x[:, self.num_prefix_tokens:]
        if self.frozen:
            x = x.detach()
        for j, adapter in enumerate(self.adapters):
            x = linear(x, adapter, dt)
            if j < len(self.adapters) - 1:
                x = F.relu(x)
        return x.reshape(B, gh, gw, x.shape[-1])
