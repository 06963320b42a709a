"""Scale-out over a torch.distributed world (port of
probpose_pytorch_tpu/parallel): several processes, (data, model[, pipe])
meshes, the Megatron split of the ViT block, ZeRO-1, and pipeline
parallelism (GPipe, 1F1B and interleaved 1F1B over the pipe axis)."""

from probpose_pytorch_tpu_torch.parallel.distributed import (  # noqa: F401
    local_batch_size,
    maybe_initialize_distributed,
    process_info,
)
from probpose_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    make_hybrid_mesh,
    make_mesh,
    mesh_shape,
)
from probpose_pytorch_tpu_torch.parallel.pipeline import (  # noqa: F401
    circular_chunk_order,
    pick_microbatches,
    pipeline_1f1b,
    pipeline_1f1b_interleaved,
    pipeline_spmd,
)
from probpose_pytorch_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    head_batch_spec,
    opt_state_shardings,
    param_shardings,
    shard_batch,
    shard_opt_state,
    shard_params,
)
