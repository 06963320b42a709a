"""Parameter layout conversions (port of probpose_pytorch_tpu/compat/
layouts.py; numpy and torch, no jax).

`attn_impl="fused_tp"` reads the qkv projection's 3C output columns
head-major ([h0 (q | k | v) | h1 (q | k | v) | ...]), so a Megatron column
slice hands each model rank whole heads; every other attn_impl reads them
qkv-major ([q | k | v], heads within each, the torch/timm order). A model
converts losslessly by permuting the qkv weight's output rows (the port's
Linear is (out, in)), its bias and its LoRA `b` columns; the attention
context is h-major in both layouts, so nothing else changes.

The functions take the port's state dicts ({"backbone.blocks.0.attn.qkv.
weight": tensor, ...}) and the JAX package's nested numpy trees
({"backbone": {"block0": {"attn": {"qkv": {"kernel": ...}}}}}) alike: a
leaf's path is its keys split at "/" and ".". `stack_vit_blocks`,
`unstack_vit_blocks` and `convert_trunk_layout` move a nested tree between
the per-block trunk and the stacked one of pipeline parallelism (ROADMAP
item 13b runs it); they are dict operations.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "convert_qkv_layout",
    "convert_trunk_layout",
    "qkv_head_major_permutation",
    "qkv_to_head_major",
    "qkv_to_qkv_major",
    "stack_vit_blocks",
    "unstack_vit_blocks",
    "BLOCK_LEAF_PATHS",
]

# The JAX block's leaves by their stacked names (models/vit.py there).
BLOCK_LEAF_PATHS = {
    "norm1_scale": ("norm1", "scale"),
    "norm1_bias": ("norm1", "bias"),
    "qkv_kernel": ("attn", "qkv", "kernel"),
    "qkv_bias": ("attn", "qkv", "bias"),
    "proj_kernel": ("attn", "proj", "kernel"),
    "proj_bias": ("attn", "proj", "bias"),
    "norm2_scale": ("norm2", "scale"),
    "norm2_bias": ("norm2", "bias"),
    "fc1_kernel": ("mlp", "fc1", "kernel"),
    "fc1_bias": ("mlp", "fc1", "bias"),
    "fc2_kernel": ("mlp", "fc2", "kernel"),
    "fc2_bias": ("mlp", "fc2", "bias"),
}


def qkv_head_major_permutation(embed_dim: int, num_heads: int) -> np.ndarray:
    """perm such that head_major[i] = qkv_major[perm[i]] over the 3C dim."""
    d = embed_dim // num_heads
    idx = np.arange(3 * embed_dim).reshape(3, num_heads, d)
    return np.transpose(idx, (1, 0, 2)).reshape(-1)


def _take(leaf: Any, perm: np.ndarray, axis: int) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.index_select(axis, torch.as_tensor(perm, device=leaf.device))
    return np.take(np.asarray(leaf), perm, axis=axis)


def _qkv_axis(names: list[str], ndim: int) -> int | None:
    """The axis of a leaf that holds the 3C qkv columns, None for a leaf
    the layout does not touch."""
    joined = "/".join(names)
    if names[-1] == "qkv_kernel" and ndim == 3:  # stacked JAX trunk
        return 2
    if names[-1] == "qkv_bias" and ndim == 2:
        return 1
    if "attn" not in joined or "qkv" not in joined:
        return None
    if "qkv_lora" in names:  # b's columns are qkv's; a is input-side
        return 1 if names[-1] == "b" and ndim == 2 else None
    if names[-1] == "kernel" and ndim == 2:  # JAX Dense (in, out)
        return 1
    if names[-1] == "weight" and ndim == 2:  # port Linear (out, in)
        return 0
    if names[-1] == "bias" and ndim == 1:
        return 0
    return None


def _permute_qkv(tree: Any, num_heads: int, invert: bool, path: tuple = ()) -> Any:
    if isinstance(tree, Mapping):
        return {k: _permute_qkv(v, num_heads, invert, path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if tree is None or not hasattr(tree, "shape"):
        return tree
    axis = _qkv_axis(list(path), len(tree.shape))
    if axis is None:
        return tree
    perm = qkv_head_major_permutation(tree.shape[axis] // 3, num_heads)
    return _take(tree, np.argsort(perm) if invert else perm, axis)


def qkv_to_head_major(params: Any, num_heads: int) -> Any:
    """A state dict or nested tree with its qkv weights, biases and LoRA
    `b`s converted from the default qkv-major layout to head-major (for
    `attn_impl="fused_tp"`); a new dict, the leaves it does not touch shared."""
    return _permute_qkv(params, num_heads, invert=False)


def qkv_to_qkv_major(params: Any, num_heads: int) -> Any:
    """Inverse of `qkv_to_head_major`."""
    return _permute_qkv(params, num_heads, invert=True)


def _is_block_key(key: str) -> bool:
    return key.startswith("block") and key != "blocks" and key[len("block"):].isdigit()


def stack_vit_blocks(backbone_params: Mapping) -> dict:
    """A nested ViT trunk tree from the per-block layout (block0 ...
    block{D-1}) to the stacked one (one "blocks" subtree, every leaf with a
    leading depth axis); the other entries pass through."""
    out = {k: v for k, v in backbone_params.items() if not _is_block_key(k)}
    keys = sorted((k for k in backbone_params if _is_block_key(k)),
                  key=lambda k: int(k[len("block"):]))
    if not keys:
        return dict(backbone_params)
    flat = {}
    for name, path in BLOCK_LEAF_PATHS.items():
        leaves = []
        for k in keys:
            node = backbone_params[k]
            for p in path:
                node = node[p]
            leaves.append(np.asarray(node))
        flat[name] = np.stack(leaves, axis=0)
    out["blocks"] = flat
    return out


def unstack_vit_blocks(backbone_params: Mapping) -> dict:
    """Inverse of `stack_vit_blocks`."""
    if "blocks" not in backbone_params:
        return dict(backbone_params)
    out = {k: v for k, v in backbone_params.items() if k != "blocks"}
    flat = backbone_params["blocks"]
    depth = np.asarray(next(iter(flat.values()))).shape[0]
    for i in range(depth):
        tree: dict = {}
        for name, path in BLOCK_LEAF_PATHS.items():
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = np.asarray(flat[name])[i]
        out[f"block{i}"] = tree
    return out


def convert_trunk_layout(tree: Any, src: str, dst: str) -> Any:
    """Every ViT trunk in a nested tree (a dict holding block{i} keys or a
    "blocks" key, wherever it nests: params, EMA, moments) between the
    "per_block" and "stacked" layouts. No-op when src == dst."""
    if src == dst:
        return tree
    if {src, dst} != {"per_block", "stacked"}:
        raise ValueError(f"unknown trunk layout conversion {src!r} -> {dst!r}")

    def convert(node: Any) -> Any:
        if not isinstance(node, Mapping):
            return node
        if "blocks" in node or any(_is_block_key(k) for k in node):
            return stack_vit_blocks(node) if dst == "stacked" else unstack_vit_blocks(node)
        return {k: convert(v) for k, v in node.items()}

    return convert(tree)


def convert_qkv_layout(tree: Any, num_heads: int, src: str, dst: str) -> Any:
    """Any params-shaped tree or state dict between the qkv layouts. No-op
    when src == dst."""
    if src == dst:
        return tree
    if (src, dst) == ("qkv_major", "head_major"):
        return qkv_to_head_major(tree, num_heads)
    if (src, dst) == ("head_major", "qkv_major"):
        return qkv_to_qkv_major(tree, num_heads)
    raise ValueError(f"unknown qkv layout conversion {src!r} -> {dst!r}")
