"""Device meshes (port of probpose_pytorch_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the world (parallel/distributed.py) with JAX's axis names ("data",
"model"), and "pipe" after them when `pipeline_parallel > 1`. The last
axis is innermost: rank = (data index * model + model index) * pipe + pipe
index, so a pipeline's stages are consecutive ranks (neighbours for the
per-tick send, as JAX keeps them ICI neighbours) and the world's rank order
is the order of the global batch's rows. The trainer and the predictor
reduce over its groups explicitly (parallel/collectives.py): gradients over
"data", the Megatron block's two activations over "model", a pipeline's
activations and cotangents between the "pipe" neighbours
(parallel/pipeline.py). `mesh_shape(mesh)` reads the axis sizes as JAX's
`dict(mesh.shape)` does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "make_hybrid_mesh", "mesh_shape", "mesh_coords", "mesh_device"]


def _device_type() -> str:
    """The mesh's device type: the CPU on a gloo world without cards."""
    return "cuda" if torch.cuda.is_available() and dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              axis_names: tuple[str, str] = ("data", "model"),
              pipeline_parallel: int = 1) -> DeviceMesh:
    """A (data, model[, pipe]) mesh over the first `n_devices` ranks
    (default: the world). `model_parallel * pipeline_parallel` must divide
    them; 1 and 1 is pure data parallelism. With `pipeline_parallel > 1`
    the mesh gains a trailing "pipe" axis, innermost, as JAX's."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, only {world} available")
    if n_devices % (model_parallel * pipeline_parallel) != 0:
        raise ValueError(
            f"model_parallel={model_parallel} * pipeline_parallel="
            f"{pipeline_parallel} must divide n_devices={n_devices}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world: start one with "
                           "parallel.maybe_initialize_distributed (JAX's launcher variables "
                           "or torchrun's)")
    if n_devices != world:
        raise ValueError(f"a mesh spans the whole world of {world} ranks, not {n_devices}")
    if pipeline_parallel > 1:
        grid = torch.arange(n_devices).reshape(
            n_devices // (model_parallel * pipeline_parallel), model_parallel, pipeline_parallel)
        return DeviceMesh(_device_type(), grid, mesh_dim_names=(*axis_names[:2], "pipe"))
    grid = torch.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)
    return DeviceMesh(_device_type(), grid, mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(model_parallel: int = 1,
                     axis_names: tuple[str, str] = ("data", "model"), *,
                     pipeline_parallel: int = 1) -> DeviceMesh:
    """JAX's multi-slice mesh: data parallelism across hosts, the model (and
    pipe) axes within one. With those axes innermost and a launcher that
    numbers a host's ranks consecutively, `make_mesh`'s layout is that
    already: only the gradient all-reduce crosses hosts."""
    return make_mesh(None, model_parallel, axis_names, pipeline_parallel)


def mesh_shape(mesh: DeviceMesh | None) -> dict[str, int]:
    """{axis name: size}, JAX's `dict(mesh.shape)`; {} for no mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh: DeviceMesh) -> dict[str, int]:
    """This rank's index along every axis of `mesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def mesh_device(mesh: DeviceMesh | None, device: torch.device | str) -> torch.device:
    """The device a rank of `mesh` computes on: its card where the mesh is
    on cards (the current CUDA device, set when the world started), else
    `device`."""
    if mesh is not None and torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
