"""int8 serving forward of the ViT backbone (port of
probpose_pytorch_tpu/models/vit_int8.py).

`QuantizedViT` is JAX's `vit_forward_int8` over the parameters that
`quantize_vit_params` makes, as a module: every Dense product of the
transformer (qkv, proj, fc1, fc2) runs int8 x int8 -> int32
(ops/quant.py:int8_matmul, `torch._int_mm`), or with `weight_only` int8
weights dequantized into a bf16 product (`weight_only_matmul`). It holds
the int8 codes and float32 scales as buffers, so an exported bundle
(serve/export.py) stores them as weights. Its numerics are JAX's, which
differ from models/vit.py's in places:
  * the patch embedding is a bf16 convolution, then a bf16 bias add; the
    position embedding is added in bf16;
  * LayerNorm (eps 1e-6, JAX's mean / variance / rsqrt formula) returns
    float32, and the int8 products quantize float32 rows;
  * each product returns bf16, and the residual stream is bf16;
  * attention is the plain einsum with a float32 softmax cast to bf16 (no
    kernel), the GELU always `jax.nn.gelu`'s tanh approximation, rounded
    to bf16 op by op as XLA runs it (`exact_gelu`, `attn_impl` and
    `compute_dtype` of the float model do not apply);
  * the final LayerNorm's float32 output is the (B, H/p, W/p, C) feature
    grid the heads take.
The weights are quantized once, when the module is built from a float
`ViTBackbone` (plain: no prefix tokens, no adapters; LoRA deltas are left
out, as JAX's `quantize_vit_params` reads only the base kernels).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from probpose_pytorch_tpu_torch.models.vit import ViTBackbone, einsum_attention
from probpose_pytorch_tpu_torch.ops.quant import int8_matmul, quantize_weight, weight_only_matmul

__all__ = ["QuantizedViT", "quantize_vit_params", "vit_forward_int8"]

# the quantized layers, by their module paths in a Block (JAX's "attn/qkv", ...)
_QUANT_LAYERS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
LN_EPS = 1e-6


def quantize_vit_params(backbone: nn.Module) -> dict[str, torch.Tensor]:
    """A float `ViTBackbone`'s weights -> the quantized serving state, flat
    by QuantizedViT's buffer names: patch embedding, position embedding and
    norms as they are (float32), and for each block's qkv, proj, fc1 and
    fc2 the int8 codes of its (in, out) kernel stored (out, in), the
    float32 per-output-channel scales and the float32 bias."""
    out = {
        "patch_embed.weight": backbone.patch_embed.weight.detach().float(),
        "patch_embed.bias": backbone.patch_embed.bias.detach().float(),
        "pos_embed": backbone.pos_embed.detach().float(),
        "norm.weight": backbone.norm.weight.detach().float(),
        "norm.bias": backbone.norm.bias.detach().float(),
    }
    for i, blk in enumerate(backbone.blocks):
        for norm in ("norm1", "norm2"):
            out[f"blocks.{i}.{norm}.weight"] = getattr(blk, norm).weight.detach().float()
            out[f"blocks.{i}.{norm}.bias"] = getattr(blk, norm).bias.detach().float()
        for path in _QUANT_LAYERS:
            layer = blk.get_submodule(path)
            q, scale = quantize_weight(layer.weight.detach().t())
            key = f"blocks.{i}.{path.replace('.', '_')}"
            out[f"{key}.weight_q"] = q.t().contiguous()
            out[f"{key}.scale"] = scale
            out[f"{key}.bias"] = layer.bias.detach().float()
    return out


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """JAX's LayerNorm of the int8 trunk (eps 1e-6) in float32; returns
    float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return y * weight + bias


def _gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (the tanh approximation) on a bf16 tensor as XLA runs
    it: its constants rounded to bf16 and every operation rounded to bf16
    (x**3 as (x * x) * x); F.gelu rounds once."""
    c0 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    inner = (x + c0 * (x * x * x)) * c1
    return x * ((1.0 + torch.tanh(inner)) * 0.5)


def _qdense(x: torch.Tensor, state: dict, key: str, weight_only: bool) -> torch.Tensor:
    w_q = state[f"{key}.weight_q"].t()  # (in, out), a view of the stored (out, in)
    if weight_only:
        return weight_only_matmul(x.to(torch.bfloat16), w_q, state[f"{key}.scale"],
                                  state[f"{key}.bias"])
    return int8_matmul(x, w_q, state[f"{key}.scale"], state[f"{key}.bias"])


def embed_int8(state: dict[str, torch.Tensor], images: torch.Tensor,
               patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) images -> the (B, N, C) bf16 residual stream: the bf16
    patch convolution, its bf16 bias, the bf16 position embedding."""
    bf = torch.bfloat16
    x = F.conv2d(images.to(bf).permute(0, 3, 1, 2), state["patch_embed.weight"].to(bf),
                 stride=patch_size)
    x = x + state["patch_embed.bias"].to(bf)[:, None, None]
    return x.flatten(2).transpose(1, 2) + state["pos_embed"].to(bf)


def block_int8(state: dict[str, torch.Tensor], i: int, x: torch.Tensor, num_heads: int,
               weight_only: bool = False) -> torch.Tensor:
    """Block `i` on the bf16 residual stream x (B, N, C)."""
    b = f"blocks.{i}"
    y = layernorm(x, state[f"{b}.norm1.weight"], state[f"{b}.norm1.bias"])
    o = einsum_attention(_qdense(y, state, f"{b}.attn_qkv", weight_only), num_heads,
                         torch.float32, torch.bfloat16)
    x = x + _qdense(o, state, f"{b}.attn_proj", weight_only)
    y = layernorm(x, state[f"{b}.norm2.weight"], state[f"{b}.norm2.bias"])
    h = _gelu_tanh_bf16(_qdense(y, state, f"{b}.mlp_fc1", weight_only))
    return x + _qdense(h, state, f"{b}.mlp_fc2", weight_only)


def vit_forward_int8(state: dict[str, torch.Tensor], images: torch.Tensor, *, patch_size: int,
                     depth: int, num_heads: int, weight_only: bool = False) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H/p, W/p, C) float32 features, with the
    int8 products throughout the transformer; `state` as
    `quantize_vit_params` makes it."""
    B, H, W, _ = images.shape
    x = embed_int8(state, images, patch_size)
    for i in range(depth):
        x = block_int8(state, i, x, num_heads, weight_only)
    x = layernorm(x, state["norm.weight"], state["norm.bias"]).float()
    return x.reshape(B, H // patch_size, W // patch_size, x.shape[-1])


class QuantizedViT(nn.Module):
    """The int8 serving trunk of a float `ViTBackbone`: (B, H, W, 3) images
    in [0, 1] -> (B, H/p, W/p, C) float32 features. Quantizes the
    backbone's weights once; every tensor it holds is a buffer."""

    def __init__(self, backbone: nn.Module, weight_only: bool = False):
        super().__init__()
        if (not isinstance(backbone, ViTBackbone) or backbone.num_prefix_tokens
                or len(backbone.adapters)):
            raise ValueError("quantize='int8' supports plain ViTBackbones (no prefix "
                             "tokens, no adapters)")
        self.patch_size = backbone.patch_size
        self.depth = len(backbone.blocks)
        self.num_heads = backbone.num_heads
        self.weight_only = weight_only
        with torch.no_grad():
            for name, t in quantize_vit_params(backbone).items():
                *path, leaf = name.split(".")
                owner = self
                for part in path:
                    if not hasattr(owner, part):
                        owner.add_module(part, nn.Module())
                    owner = getattr(owner, part)
                owner.register_buffer(leaf, t)

    def state(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vit_forward_int8(self.state(), x, patch_size=self.patch_size, depth=self.depth,
                                num_heads=self.num_heads, weight_only=self.weight_only)
