"""How parameters, batches and optimizer moments lie on a (data, model[,
pipe]) mesh (port of probpose_pytorch_tpu/parallel/sharding.py).

JAX states shardings and GSPMD moves the data; here each rank holds its
slice and the code that reads it calls the collectives
(parallel/collectives.py). A spec is a tuple with an axis name or None per
dimension of the port's tensor (a Linear's weight is (out, in), the
transpose of JAX's (in, out) kernel), () for a whole tensor.

`param_shardings` decides per parameter what JAX's `_param_spec` decides:
the Megatron split of the ViT block, qkv and fc1 by output columns (their
biases too), proj and fc2 by input columns, everything else whole.
`shard_params` then keeps the rank's slice where the port's block can run
on it: a head-major ("fused_tp") attention whose heads divide the model
axis, and the dense MLP. An attention with qkv-major weights (heads that do
not divide the axis, "einsum") and the fused MLP (kernel K5 takes whole
weights, as GSPMD gives JAX's pallas_call) keep their weights whole on
every model rank and compute the same numbers there. LoRA deltas stay
whole (JAX's `_param_spec` names no axis for them); beside a split
projection each rank's gradients of them are its part of the sum
(`model.tp_partial`). A stacked (pipeline) trunk's leaves follow JAX's
"blocks" specs: a rank keeps its stage's rows along the depth axis on a
pipe axis > 1 and, on a model axis > 1, its Megatron slice
(models/vit.py:stacked_param_specs). It records what it split in
`model.tp_splits` and `model.pp_splits` ({name: dim}), which the
optimizer, the norm of the gradient and the checkpoint read.

ZeRO-1 (`opt_state_shardings`, `shard_opt_state`): each moment leaf of at
least `min_size` elements is split over "data" along its largest
dimension that the data axis divides, the dimension JAX picks on its own
layout of the leaf; the optimizer updates the rank's slice and gathers the
parameter delta (train/state.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from probpose_pytorch_tpu_torch.parallel.mesh import mesh_coords, mesh_shape

__all__ = ["param_shardings", "batch_sharding", "head_batch_spec", "shard_params",
           "shard_batch", "opt_state_shardings", "shard_opt_state", "local_slice"]

# The port axis of a Linear weight that JAX's kernel spec P(None, "model")
# (output columns) and P("model", None) (input columns) name.
_OUT, _IN = ("model", None), (None, "model")


def head_batch_spec(mesh: Any, batch_size: int) -> tuple[str, ...] | None:
    """The axes the head's batch splits over: every axis of size > 1 when
    the batch divides them all (the head's parameters are whole, so the
    model ranks share the head's rows instead of repeating them), else None
    (the head takes the data rows only, as on a data-parallel mesh)."""
    if mesh is None:
        return None
    shape = mesh_shape(mesh)
    extra = tuple(ax for ax in mesh.mesh_dim_names if ax != "data" and shape[ax] > 1)
    if not extra:
        return None
    total = int(np.prod([shape[ax] for ax in ("data", *extra)]))
    if batch_size % total:
        return None
    return ("data", *extra)


def _param_spec(name: str, ndim: int, axes: tuple = ()) -> tuple:
    names = name.split(".")
    joined = "/".join(names)
    if "blocks" in names and not names[names.index("blocks") + 1].isdigit():
        # the stacked trunk: JAX's specs, which name an axis the mesh has
        from probpose_pytorch_tpu_torch.models.vit import stacked_param_specs

        if "pipe" not in axes:
            return ()
        spec = stacked_param_specs()[names[-1]]
        return tuple(a if a in axes else None for a in spec)
    if "attn" in joined and names[-1] == "weight" and ndim == 2:
        if "qkv" in joined:
            return _OUT
        if "proj" in joined:
            return _IN
    if "mlp" in joined and names[-1] == "weight" and ndim == 2:
        if "fc1" in joined:
            return _OUT
        if "fc2" in joined:
            return _IN
    if "mlp" in joined and names[-1] == "bias" and "fc1" in joined and ndim == 1:
        return ("model",)
    if "attn" in joined and names[-1] == "bias" and "qkv" in joined and ndim == 1:
        return ("model",)
    return ()


def param_shardings(params: nn.Module | Mapping[str, torch.Tensor], mesh: Any = None
                    ) -> dict[str, tuple]:
    """{name: spec} for a model's parameters (or a state dict), JAX's
    `_param_spec` on the port's names and axes (a stacked trunk's leaves
    by the axes of `mesh`)."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    axes = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return {n: _param_spec(n, p.dim(), axes) for n, p in items}


def local_slice(t: torch.Tensor, dim: int | None, index: int, count: int) -> torch.Tensor:
    """Slice `index` of `count` equal slices of `t` (a tensor or an array)
    along `dim` (None: t)."""
    if dim is None or count == 1:
        return t
    n = t.shape[dim] // count
    return t[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]


def shard_params(model: nn.Module, mesh: Any) -> nn.Module:
    """Keep this rank's slices of the parameters (see the module's
    docstring), in place: on a model axis, of every parameter the port's
    block runs split, and the blocks get their model group; on a pipe
    axis, its stage of a stacked trunk. Records the splits in
    `model.tp_splits`, `model.pp_splits` and the partial LoRA leaves in
    `model.tp_partial`. Returns the model."""
    model.tp_splits, model.pp_splits, model.tp_partial = {}, {}, set()
    shape = mesh_shape(mesh)
    m, pipe = shape.get("model", 1), shape.get("pipe", 1)
    from probpose_pytorch_tpu_torch.models.vit import ViTBackbone

    backbone = getattr(model, "backbone", None)
    if not isinstance(backbone, ViTBackbone) or (m == 1 and pipe == 1):
        return model
    coords = mesh_coords(mesh)
    specs = param_shardings(model, mesh)
    if backbone.stacked:
        backbone.mesh = mesh
        if m > 1:
            backbone.blocks.tp_group = mesh.get_group("model")
        for pname, p in backbone.blocks.named_parameters():
            name = f"backbone.blocks.{pname}"
            data = p.data
            for dim, ax in enumerate(specs[name]):
                if ax is not None and shape[ax] > 1:
                    data = local_slice(data, dim, coords[ax], shape[ax])
                    (model.pp_splits if ax == "pipe" else model.tp_splits)[name] = dim
            p.data = data.clone()
        return model
    if m == 1:
        return model
    group, index = mesh.get_group("model"), coords["model"]
    for i, block in enumerate(backbone.blocks):
        split = []
        if block.attn.impl == "fused_tp" and block.attn.num_heads % m == 0:
            block.attn.tp_group = group
            block.attn.num_heads //= m
            split.append("attn")
        if block.mlp_impl == "dense" and block.mlp.fc1.out_features % m == 0:
            block.mlp.tp_group = group
            split.append("mlp")
        for sub in split:
            for pname, p in getattr(block, sub).named_parameters():
                name = f"backbone.blocks.{i}.{sub}.{pname}"
                spec = specs[name]
                if "_lora." in name:
                    model.tp_partial.add(name)
                if "model" not in spec:
                    continue
                dim = spec.index("model")
                p.data = local_slice(p.data, dim, index, m).clone()
                model.tp_splits[name] = dim
    return model


def batch_sharding(mesh: Any) -> tuple[str]:
    """The batch's spec: rows split over the data axis."""
    return ("data",)


def _rows(x: Any, index: int, count: int) -> Any:
    if isinstance(x, Mapping):
        return {k: _rows(v, index, count) for k, v in x.items()}
    if x.shape[0] % count:
        raise ValueError(f"batch of {x.shape[0]} rows does not divide the data axis ({count})")
    return local_slice(x, 0, index, count)


def shard_batch(batch: Any, mesh: Any) -> Any:
    """This rank's rows of the global batch (a dict of arrays or tensors,
    or one): the slice of its data coordinate."""
    return _rows(batch, mesh_coords(mesh)["data"], mesh_shape(mesh)["data"])


def _zero1_dim(shape: tuple[int, ...], dp: int, layout: str, min_size: int) -> int | None:
    """The port axis JAX's ZeRO-1 rule splits a leaf of `shape` along: the
    largest axis of its JAX layout that the data axis divides (ties to the
    lower JAX axis), None below `min_size` elements or where none divides."""
    from probpose_pytorch_tpu_torch.train.state import JAX_AXES

    if len(shape) == 0 or int(np.prod(shape)) < min_size:
        return None
    axes = JAX_AXES.get(layout, tuple(range(len(shape))))
    if len(axes) != len(shape):
        axes = tuple(range(len(shape)))
    jax_shape = [0] * len(shape)
    for a, j in enumerate(axes):
        jax_shape[j] = shape[a]
    for j in sorted(range(len(shape)), key=lambda j: jax_shape[j], reverse=True):
        if jax_shape[j] % dp == 0 and jax_shape[j] >= dp:
            return axes.index(j)
    return None


def _family_state(opt_state: Any) -> Any:
    """The family's state under MultiSteps (whose accumulator stays whole)."""
    return getattr(opt_state, "inner", opt_state)


def opt_state_shardings(opt_state: Any, mesh: Any, min_size: int = 1024,
                        layouts: list[str] | None = None) -> dict[str, list[int | None]]:
    """{moment field: [dim or None per leaf]} of the family's moments under
    ZeRO-1 over the data axis. `layouts` are the trainable leaves' JAX
    layouts (`train.state.param_layouts`, masked); a moment of its leaf's
    shape is judged on that layout, a reduced one (Adafactor's rows and
    columns) on its own."""
    dp = mesh_shape(mesh).get("data", 1)
    fam = _family_state(opt_state)
    dims = {}
    for f in dataclasses.fields(fam):
        leaves = getattr(fam, f.name)
        if not isinstance(leaves, (list, tuple)):
            continue
        kinds = layouts if layouts is not None and len(layouts) == len(leaves) else None
        dims[f.name] = [
            _zero1_dim(tuple(t.shape), dp, kinds[i] if kinds else "plain", min_size)
            for i, t in enumerate(leaves)]
    return dims


def shard_opt_state(opt_state: Any, mesh: Any, min_size: int = 1024,
                    layouts: list[str] | None = None) -> tuple[Any, dict[str, list]]:
    """(the optimizer state with this rank's data-axis slice of every moment
    `opt_state_shardings` splits, those dims)."""
    dims = opt_state_shardings(opt_state, mesh, min_size, layouts)
    index, count = mesh_coords(mesh)["data"], mesh_shape(mesh)["data"]
    fam = _family_state(opt_state)
    local = dataclasses.replace(fam, **{
        f: [local_slice(t, d, index, count).clone() for t, d in zip(getattr(fam, f), ds)]
        for f, ds in dims.items()})
    if fam is not opt_state:
        return dataclasses.replace(opt_state, inner=local), dims
    return local, dims
