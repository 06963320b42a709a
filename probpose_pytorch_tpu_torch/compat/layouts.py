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
the per-block trunk and the stacked one of pipeline parallelism; they are
dict operations. `stack_state_dict` and `unstack_state_dict` do the same
for the port's state dicts: `backbone.blocks.<i>.attn.qkv.weight` (out,
in) and its siblings against `backbone.blocks.qkv_kernel` (depth, in, out),
JAX's stacked leaves (models/vit.py:_StackedBlockParams).
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
    "stack_state_dict",
    "unstack_state_dict",
    "BLOCK_LEAF_PATHS",
    "PORT_BLOCK_LEAVES",
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


# The port's per-block name of each stacked leaf (after blocks.<i>.), and
# whether it is a Linear weight, stored (out, in) per block and (in, out)
# stacked.
PORT_BLOCK_LEAVES = {
    "norm1_scale": ("norm1.weight", False), "norm1_bias": ("norm1.bias", False),
    "qkv_kernel": ("attn.qkv.weight", True), "qkv_bias": ("attn.qkv.bias", False),
    "proj_kernel": ("attn.proj.weight", True), "proj_bias": ("attn.proj.bias", False),
    "norm2_scale": ("norm2.weight", False), "norm2_bias": ("norm2.bias", False),
    "fc1_kernel": ("mlp.fc1.weight", True), "fc1_bias": ("mlp.fc1.bias", False),
    "fc2_kernel": ("mlp.fc2.weight", True), "fc2_bias": ("mlp.fc2.bias", False),
}


def _swap(t: Any) -> Any:
    return t.transpose(-1, -2) if isinstance(t, torch.Tensor) else np.swapaxes(t, -1, -2)


def _stack(parts: list) -> Any:
    if isinstance(parts[0], torch.Tensor):
        return torch.stack([p.contiguous() for p in parts])
    return np.stack([np.asarray(p) for p in parts])


def _block_index(key: str, prefix: str) -> int | None:
    if not key.startswith(prefix):
        return None
    head = key[len(prefix):].split(".")[0]
    return int(head) if head.isdigit() else None


def _moment_kind(t: Any, shape: tuple | None) -> str:
    """How a tensor of a leaf whose parameter has `shape` moves between the
    layouts: "param" (its parameter's shape, or no shape given), "scalar"
    (a (1,) placeholder, as Adafactor keeps), "reduced" (one axis of each
    block's kernel reduced away: Adafactor's rows and columns, stacked along
    the depth axis as they are)."""
    if shape is None or tuple(t.shape) == tuple(shape):
        return "param"
    return "scalar" if tuple(t.shape) == (1,) else "reduced"


def stack_state_dict(sd: Mapping[str, Any], prefix: str = "backbone.blocks.",
                     shapes: Mapping[str, tuple] | None = None) -> dict:
    """A port state dict (tensors or arrays) from the per-block trunk to the
    stacked one; every other entry passes through. The per-block trunk
    must hold exactly `PORT_BLOCK_LEAVES` (no LoRA, as JAX's stacked trunk
    takes none). With `shapes` ({name: its parameter's shape}) the entries
    may be optimizer moments of those parameters (`_moment_kind`)."""
    depth = 1 + max((i for k in sd if (i := _block_index(k, prefix)) is not None), default=-1)
    if not depth:
        return dict(sd)
    out = {k: v for k, v in sd.items() if _block_index(k, prefix) is None}
    per_block = {k for k in sd if _block_index(k, prefix) is not None}
    for name, (leaf, kernel) in PORT_BLOCK_LEAVES.items():
        keys = [f"{prefix}{i}.{leaf}" for i in range(depth)]
        per_block -= set(keys)
        kinds = {_moment_kind(sd[k], None if shapes is None else shapes[k]) for k in keys}
        if kinds == {"scalar"}:
            out[prefix + name] = sd[keys[0]]
        else:
            swap = kernel and kinds == {"param"}
            out[prefix + name] = _stack([_swap(sd[k]) if swap else sd[k] for k in keys])
    if per_block:
        raise ValueError(f"per-block entries the stacked trunk has no place for: "
                         f"{sorted(per_block)[:4]}")
    return out


def unstack_state_dict(sd: Mapping[str, Any], prefix: str = "backbone.blocks.",
                       shapes: Mapping[str, tuple] | None = None) -> dict:
    """Inverse of `stack_state_dict` (with `shapes`, the stacked
    parameters' shapes)."""
    if prefix + "qkv_kernel" not in sd:
        return dict(sd)
    out = {k: v for k, v in sd.items()
           if not (k.startswith(prefix) and k[len(prefix):] in PORT_BLOCK_LEAVES)}
    depth = (shapes or {}).get(prefix + "qkv_kernel", sd[prefix + "qkv_kernel"].shape)[0]
    for name, (leaf, kernel) in PORT_BLOCK_LEAVES.items():
        t = sd[prefix + name]
        kind = _moment_kind(t, None if shapes is None else shapes[prefix + name])
        for i in range(depth):
            part = t if kind == "scalar" else t[i]
            part = _swap(part) if kernel and kind == "param" else part
            out[f"{prefix}{i}.{leaf}"] = (part.contiguous() if isinstance(part, torch.Tensor)
                                          else np.ascontiguousarray(part))
    return out


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
