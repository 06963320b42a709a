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
summed projection, and fc2's reads the hidden state after the GELU. On a
model-parallel mesh the deltas stay whole, as JAX's `_param_spec` keeps
them: a split projection adds the rank's output columns of its delta
(qkv, fc1) or, inside the model group's sum, the delta of the rank's input
rows (proj, fc2), so each rank's gradients of `a` and `b` are its part of
the whole (the trainer sums them over the model axis).

Pipeline parallelism (`pp_stages > 1`, parallel/pipeline.py): the blocks'
parameters are stacked as JAX's `_StackedBlockParams` holds them, one
leaf per name of `BLOCK_LEAF_PATHS` with a leading depth axis and JAX's
layout ((in, out) kernels), under `blocks.<name>`. On a mesh with a pipe
axis a rank keeps its stage's rows of every leaf, and its model-axis slice
of the Megatron leaves (`stacked_param_specs`, parallel/sharding.py); the
trunk then runs as `pipeline_spmd`'s GPipe forward (`_pp_trunk`), one
block at a time through `stacked_block_apply`, which runs K1 (qkv-major,
or head-major under "fused_tp" and on a model axis) and, with
`mlp_impl="fused"`, K5, as the per-block Block does. `segment="embed"` and
`"post_trunk"` run the parts before and after the trunk, for the 1F1B
step (train/loop.py).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from probpose_pytorch_tpu_torch.compat.layouts import BLOCK_LEAF_PATHS
from probpose_pytorch_tpu_torch.models.lora import LoRADelta
from probpose_pytorch_tpu_torch.ops.kernels.attention import fused_attention, packed_attention
from probpose_pytorch_tpu_torch.ops.kernels.mlp import fused_ln_mlp
from probpose_pytorch_tpu_torch.parallel.collectives import group_rank, group_size
from probpose_pytorch_tpu_torch.parallel.pipeline import pipeline_spmd, tp_enter, tp_leave

__all__ = ["ViTConfig", "Attention", "MlpBlock", "Block", "ViTBackbone", "BLOCK_LEAF_PATHS",
           "stacked_block_apply", "pp_block_fns", "stacked_param_specs"]

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
            g = self.tp_group
            x = tp_enter(x, g)
            h = linear(x, self.fc1, self.dtype)
            if self.fc1_lora is not None:
                h = h + tp_columns(self.fc1_lora(x), g)
            h = F.gelu(h, approximate=self.approximate)
            out = F.linear(h, self.fc2.weight.to(self.dtype))
            if self.fc2_lora is not None:
                out = out + tp_rows_delta(self.fc2_lora, h, g)
            return tp_leave(out, g) + self.fc2.bias.to(self.dtype)
        h = linear(x, self.fc1, self.dtype)
        if self.fc1_lora is not None:
            h = h + self.fc1_lora(x)
        h = F.gelu(h, approximate=self.approximate)
        out = linear(h, self.fc2, self.dtype)
        if self.fc2_lora is not None:
            out = out + self.fc2_lora(h)
        return out


def tp_columns(t: torch.Tensor, group) -> torch.Tensor:
    """This model rank's share of the last dim of a whole `t` (a whole
    LoRA delta beside a column-split projection)."""
    n = t.shape[-1] // group_size(group)
    return t[..., group_rank(group) * n:(group_rank(group) + 1) * n]


def tp_rows_delta(lora: LoRADelta, x: torch.Tensor, group) -> torch.Tensor:
    """The part of a whole LoRA delta that this rank's input columns `x`
    of a row-split projection contribute: x @ a[rank's rows] @ b, summed
    over the model group with the projection's partial sums."""
    dt, n = lora.dtype, x.shape[-1]
    a = lora.a[group_rank(group) * n:(group_rank(group) + 1) * n]
    return ((x.to(dt) @ a.to(dt)) @ lora.b.to(dt)) * lora.scale


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
            g = self.tp_group
            x = tp_enter(x, g)
            qkv = linear(x, self.qkv, self.dtype)
            if self.qkv_lora is not None:
                qkv = qkv + tp_columns(self.qkv_lora(x), g)
            ctx = packed_attention(qkv, self.num_heads, "head_major")
            out = F.linear(ctx, self.proj.weight.to(self.dtype))
            if self.proj_lora is not None:
                out = out + tp_rows_delta(self.proj_lora, ctx, g)
            return tp_leave(out, g) + self.proj.bias.to(self.dtype)
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


def stacked_param_specs(pipe_axis: str = "pipe", model_axis: str = "model") -> dict:
    """JAX's PartitionSpecs of the stacked leaves (as tuples): the depth
    axis over `pipe_axis`; qkv and fc1 column-split, proj and fc2
    row-split over `model_axis` (their biases replicated)."""
    return {
        "norm1_scale": (pipe_axis,), "norm1_bias": (pipe_axis,),
        "qkv_kernel": (pipe_axis, None, model_axis), "qkv_bias": (pipe_axis, model_axis),
        "proj_kernel": (pipe_axis, model_axis, None), "proj_bias": (pipe_axis,),
        "norm2_scale": (pipe_axis,), "norm2_bias": (pipe_axis,),
        "fc1_kernel": (pipe_axis, None, model_axis), "fc1_bias": (pipe_axis, model_axis),
        "fc2_kernel": (pipe_axis, model_axis, None), "fc2_bias": (pipe_axis,),
    }


def _stacked_shapes(depth: int, dim: int, hidden: int) -> dict[str, tuple[int, ...]]:
    D, C, H = depth, dim, hidden
    return {"norm1_scale": (D, C), "norm1_bias": (D, C), "qkv_kernel": (D, C, 3 * C),
            "qkv_bias": (D, 3 * C), "proj_kernel": (D, C, C), "proj_bias": (D, C),
            "norm2_scale": (D, C), "norm2_bias": (D, C), "fc1_kernel": (D, C, H),
            "fc1_bias": (D, H), "fc2_kernel": (D, H, C), "fc2_bias": (D, C)}


class _StackedBlockParams(nn.Module):
    """All the trunk's blocks as JAX's stacked leaves (`BLOCK_LEAF_PATHS`
    names, a leading depth axis, (in, out) kernels); on a mesh, a rank's
    stage and model slice of them (parallel/sharding.py:shard_params, which
    also sets `tp_group`). The LayerNorm scales start at one, the rest at
    zero: models/model.py:init_weights draws the kernels block by block, as
    it draws the per-block trunk's."""

    def __init__(self, depth: int, dim: int, hidden: int):
        super().__init__()
        for name, shape in _stacked_shapes(depth, dim, hidden).items():
            init = torch.ones if name.endswith("_scale") else torch.zeros
            self.register_parameter(name, nn.Parameter(init(shape)))
        self.tp_group = None

    def flat(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in BLOCK_LEAF_PATHS}


def _attend(qkv: torch.Tensor, heads: int, layout: str, attn_impl: str,
            softmax_dtype: torch.dtype, dtype: torch.dtype) -> torch.Tensor:
    if layout == "qkv_major" and attn_impl == "einsum" and softmax_dtype != torch.float32:
        return einsum_attention(qkv, heads, softmax_dtype, dtype)
    return packed_attention(qkv, heads, layout)


def stacked_block_apply(p: dict, h: torch.Tensor, *, heads: int, dtype: torch.dtype,
                        softmax_dtype: torch.dtype = torch.float32, attn_impl: str = "fused",
                        mlp_impl: str = "dense", exact_gelu: bool = False,
                        tp_group=None) -> torch.Tensor:
    """One block over flat stacked-layout parameters (`BLOCK_LEAF_PATHS`
    names, the depth axis indexed away): the port's Block on JAX's leaves,
    and JAX's `tp_block_apply` with `tp_group` (a model group): then the
    leaves are the rank's Megatron slices, `heads` its own heads
    (head-major qkv), the input of qkv and fc1 enters through `tp_enter`
    and the row-parallel products leave through `tp_leave` before their
    whole biases. K1 runs the attention (head-major under "fused_tp" or
    on a model group), K5 the second half with `mlp_impl="fused"`."""
    dt, C = dtype, h.shape[-1]
    layout = "head_major" if attn_impl == "fused_tp" or tp_group is not None else "qkv_major"
    lin = lambda x, k, b=None: F.linear(x.to(dt), p[k].to(dt).t(),
                                        None if b is None else p[b].to(dt))
    y = F.layer_norm(h.float(), (C,), p["norm1_scale"], p["norm1_bias"], LN_EPS)
    if tp_group is not None:
        qkv = lin(tp_enter(y, tp_group), "qkv_kernel", "qkv_bias")
        ctx = _attend(qkv, heads, layout, attn_impl, softmax_dtype, dt)
        out = tp_leave(lin(ctx, "proj_kernel"), tp_group) + p["proj_bias"].to(dt)
    else:
        ctx = _attend(lin(y, "qkv_kernel", "qkv_bias"), heads, layout, attn_impl,
                      softmax_dtype, dt)
        out = lin(ctx, "proj_kernel", "proj_bias")
    h = h + out
    if mlp_impl == "fused" and tp_group is None:
        B, N, _ = h.shape
        return fused_ln_mlp(h.reshape(B * N, C), p["norm2_scale"], p["norm2_bias"],
                            p["fc1_kernel"].to(dt), p["fc1_bias"], p["fc2_kernel"].to(dt),
                            p["fc2_bias"], exact_gelu).reshape(B, N, C)
    y = F.layer_norm(h.float(), (C,), p["norm2_scale"], p["norm2_bias"], LN_EPS)
    approximate = "none" if exact_gelu else "tanh"
    if tp_group is not None:
        a = F.gelu(lin(tp_enter(y, tp_group), "fc1_kernel", "fc1_bias"), approximate=approximate)
        return h + (tp_leave(lin(a, "fc2_kernel"), tp_group) + p["fc2_bias"].to(dt))
    a = F.gelu(lin(y, "fc1_kernel", "fc1_bias"), approximate=approximate)
    return h + lin(a, "fc2_kernel", "fc2_bias")


def _remat(fn):
    """`fn` recomputed in the backward (JAX's jax.checkpoint) when a graph
    is recorded."""
    def wrapped(p, h):
        if torch.is_grad_enabled():
            return checkpoint(fn, p, h, use_reentrant=False)
        return fn(p, h)
    return wrapped


def pp_block_fns(*, num_heads: int, mlp_ratio: float, embed_dim: int, dtype: torch.dtype,
                 softmax_dtype: torch.dtype = torch.float32, attn_impl: str = "einsum",
                 mlp_impl: str = "dense", exact_gelu: bool = False, tp: int = 1,
                 remat: bool = False, vjp_boundaries: bool = False, tp_group=None):
    """(block_fn, seq_block_fn, param_specs) of the stacked trunk, JAX's:
    at tp > 1 the Megatron block on the rank's slices (its three
    ValueErrors first) with `stacked_param_specs()`; at tp = 1 the block
    with "pallas" read as "einsum" (K1 in a stage; K6 is forward only),
    specs None. One form serves GPipe and 1F1B alike (`vjp_boundaries` is
    accepted for JAX's signature: the port's model block always runs
    tp_enter / tp_leave). `remat` recomputes each block in the backward."""
    hidden = int(embed_dim * mlp_ratio)
    kw = dict(dtype=dtype, softmax_dtype=softmax_dtype, exact_gelu=exact_gelu)
    if tp > 1:
        if attn_impl != "fused_tp":
            raise ValueError(
                "tensor parallelism inside a pipeline stage requires attn_impl='fused_tp' "
                f"(got {attn_impl!r}); the head-major qkv packing is what the model-axis "
                "column shard slices into whole heads")
        if num_heads % tp or hidden % tp:
            raise ValueError(f"heads ({num_heads}) and mlp hidden ({hidden}) must divide the "
                             f"model axis ({tp})")
        if mlp_impl == "fused":
            raise ValueError("mlp_impl='fused' does not compose with tensor parallelism inside "
                             "a pipeline stage")

        def block_fn(p, h):
            return stacked_block_apply(p, h, heads=num_heads // tp, attn_impl="fused_tp",
                                       tp_group=tp_group, **kw)

        def seq_block_fn(p, h):
            return stacked_block_apply(p, h, heads=num_heads, attn_impl="fused_tp", **kw)

        if remat:
            block_fn, seq_block_fn = _remat(block_fn), _remat(seq_block_fn)
        return block_fn, seq_block_fn, stacked_param_specs()
    impl = "einsum" if attn_impl == "pallas" else attn_impl

    def block_fn(p, h):
        return stacked_block_apply(p, h, heads=num_heads, attn_impl=impl, mlp_impl=mlp_impl,
                                   **kw)

    if remat:
        block_fn = _remat(block_fn)
    return block_fn, block_fn, None


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
    keeps only the block's input. `pp_stages > 1` stacks the blocks
    (`_StackedBlockParams`, JAX's layout) and runs them as a pipeline over
    the mesh's pipe axis (`mesh`, set by parallel/sharding.py), in
    `pp_microbatches` microbatches (0: `pick_microbatches`); with no mesh,
    one block after another, JAX's sequential fallback.
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
        pp_stages: int = 1,
        pp_microbatches: int = 0,
    ):
        super().__init__()
        if pp_stages > 1 and depth % pp_stages:
            raise ValueError(f"depth={depth} not divisible by pp_stages={pp_stages}")
        self.remat = remat
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.frozen = frozen
        self.num_prefix_tokens = num_prefix_tokens
        self.mlp_ratio, self.exact_gelu, self.softmax_dtype = mlp_ratio, exact_gelu, softmax_dtype
        self.attn_impl, self.mlp_impl = attn_impl, mlp_impl
        self.pp_stages, self.pp_microbatches = pp_stages, pp_microbatches
        self.mesh = None
        gh, gw = self.grid_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw, embed_dim))
        self.prefix_tokens = (
            nn.Parameter(torch.zeros(1, num_prefix_tokens, embed_dim))
            if num_prefix_tokens else None
        )
        if pp_stages > 1:
            self.blocks = _StackedBlockParams(depth, embed_dim, int(embed_dim * mlp_ratio))
        else:
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

    @property
    def stacked(self) -> bool:
        return isinstance(self.blocks, _StackedBlockParams)

    def forward(self, x: torch.Tensor, segment: str = "all") -> torch.Tensor:
        """(B, H, W, 3) image -> (B, H/p, W/p, C) features. `segment`, as
        JAX's: "embed" stops at the token stream entering the trunk;
        "post_trunk" takes `x` as the stream leaving it and runs the final
        norm, the prefix strip, the frozen detach, the adapters and the grid
        reshape."""
        if segment not in ("all", "embed", "post_trunk"):
            raise ValueError(f"unknown segment {segment!r}")
        if segment != "post_trunk":
            x = self.embed(x)
            if segment == "embed":
                return x
            x = self.trunk(x)
        return self.post_trunk(x)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
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
        return x

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        if self.stacked:
            return self._pp_trunk(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return x

    def block_fns(self):
        """`pp_block_fns` of this trunk on its mesh (the model group's
        slices where the blocks hold them)."""
        group = self.blocks.tp_group
        return pp_block_fns(
            num_heads=self.num_heads, mlp_ratio=self.mlp_ratio, embed_dim=self.embed_dim,
            dtype=self.dtype, softmax_dtype=self.softmax_dtype, attn_impl=self.attn_impl,
            mlp_impl=self.mlp_impl, exact_gelu=self.exact_gelu,
            tp=1 if group is None else group_size(group),
            remat=self.remat and self.training, tp_group=group)

    def _pp_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The stacked blocks as `pipeline_spmd`'s pipeline over the mesh's
        pipe axis (one block after another without one)."""
        block_fn, seq_block_fn, specs = self.block_fns()
        return pipeline_spmd(block_fn, self.blocks.flat(), x, self.mesh,
                             microbatches=self.pp_microbatches, param_specs=specs,
                             seq_block_fn=seq_block_fn)

    def post_trunk(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        gh, gw = self.grid_size
        x = layer_norm(x, self.norm)
        if self.num_prefix_tokens:
            x = x[:, self.num_prefix_tokens:]
        if self.frozen:
            x = x.detach()
        for j, adapter in enumerate(self.adapters):
            x = linear(x, adapter, self.dtype)
            if j < len(self.adapters) - 1:
                x = F.relu(x)
        return x.reshape(B, gh, gw, x.shape[-1])
