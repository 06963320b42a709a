"""Training CLI (port of probpose_pytorch_tpu/train/cli.py):

    python -m probpose_pytorch_tpu_torch.train.cli <out_dir> [--config cfg.json]
        [--data-root DIR] [--dataset-format {yolo,coco,synthetic}]
        [--max-steps N] [--no-resume] [--device cuda]

Writes `config.json` into `out_dir`, builds the datasets of the config
(for `mixed`, those of its `mixed_datasets`: data/mixed.py) and their crop
cache when `cache_dir` is set, and runs `Trainer.fit`, which logs to
`out_dir/metrics.jsonl` and checkpoints into `out_dir/checkpoints`.
It runs on the card unless `--device cpu` is given.

Several processes, one per rank (parallel/distributed.py): JAX's launcher
variables on every process,

    JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=<i> \
        python -m probpose_pytorch_tpu_torch.train.cli <out_dir> --config cfg.json

or torchrun (`torchrun --nproc-per-node 2 -m probpose_pytorch_tpu_torch.train.cli
...`). The mesh is built as JAX's CLI builds it: (data, model[, pipe]) over
the world with `model_parallel` on the model axis and `pipeline_parallel`
on a pipe axis (make_hybrid_mesh), the data axis the rest. Every rank
loads its data slice of each global batch; rank 0 writes config.json, the
log and the checkpoints. The data axis must divide the train and val
batches (JAX's CLI shrinks its mesh to a sub-mesh there; a port mesh spans
the world), and model_parallel * pipeline_parallel the world (JAX's error
where they exceed it).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

__all__ = ["main", "build_datasets"]


def build_datasets(cfg):
    """(train, val) datasets of `cfg.dataset_format`, behind the crop cache
    when `cfg.cache_dir` is set."""
    from probpose_pytorch_tpu_torch.data import (
        CachedCropDataset,
        COCOPoseDataset,
        SyntheticPoseDataset,
        YOLOPoseDataset,
        build_crop_cache,
    )

    kw = dict(resample=cfg.resample) if cfg.resample else {}
    if cfg.dataset_format == "synthetic":
        train_ds = SyntheticPoseDataset(3200, cfg.model.img_size, cfg.model.num_keypoints, seed=1)
        val_ds = SyntheticPoseDataset(320, cfg.model.img_size, cfg.model.num_keypoints, seed=2)
    elif cfg.dataset_format == "mixed":
        from probpose_pytorch_tpu_torch.data.mixed import build_mixed_datasets

        train_ds, val_ds = build_mixed_datasets(cfg)
    elif cfg.dataset_format == "coco":
        root = Path(cfg.data_root)
        train_ds = COCOPoseDataset(root / "annotations/person_keypoints_train2017.json",
                                   root / "train2017", cfg.model.img_size, **kw)
        val_ds = COCOPoseDataset(root / "annotations/person_keypoints_val2017.json",
                                 root / "val2017", cfg.model.img_size, **kw)
    else:
        train_ds = YOLOPoseDataset(cfg.data_root, "train", cfg.model.img_size, **kw)
        val_ds = YOLOPoseDataset(cfg.data_root, "valid", cfg.model.img_size, **kw)
    if cfg.cache_dir:
        root = Path(cfg.cache_dir)
        train_ds = CachedCropDataset(build_crop_cache(train_ds, root / "train", cfg.num_workers))
        val_ds = CachedCropDataset(build_crop_cache(val_ds, root / "val", cfg.num_workers))
    return train_ds, val_ds


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="ProbPose training (PyTorch)")
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--dataset-format", type=str, default=None,
                        choices=["yolo", "coco", "synthetic"])
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from probpose_pytorch_tpu_torch.data import batch_iterator
    from probpose_pytorch_tpu_torch.parallel import (
        make_hybrid_mesh,
        maybe_initialize_distributed,
        process_info,
    )
    from probpose_pytorch_tpu_torch.parallel.mesh import mesh_coords, mesh_shape
    from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer

    maybe_initialize_distributed(device=args.device)
    rank, world = process_info()
    cfg = TrainConfig.load(args.config) if args.config else TrainConfig()
    updates: dict = {"out_dir": str(args.out_dir)}
    if args.data_root:
        updates["data_root"] = args.data_root
    if args.dataset_format:
        updates["dataset_format"] = args.dataset_format
    if args.no_resume:
        updates["resume"] = False
    cfg = dataclasses.replace(cfg, **updates)
    if rank == 0:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        cfg.save(args.out_dir / "config.json")
        train_ds, val_ds = build_datasets(cfg)  # rank 0 fills a crop cache first
    if world > 1:
        dist.barrier()
    if rank != 0:
        train_ds, val_ds = build_datasets(cfg)

    steps_per_epoch = max(len(train_ds) // cfg.train_batch_size, 1)
    mesh, shard_kw = None, {}
    if world > 1 or cfg.model_parallel > 1 or cfg.pipeline_parallel > 1:
        mp_total = cfg.model_parallel * cfg.pipeline_parallel
        data = world // mp_total
        if cfg.pipeline_parallel > 1 and data < 1:
            raise ValueError(
                f"pipeline_parallel={cfg.pipeline_parallel} * model_parallel="
                f"{cfg.model_parallel} exceeds the {world} available devices")
        if data and (cfg.train_batch_size % data or cfg.val_batch_size % data):
            raise ValueError(f"the data axis ({data} = {world} processes / model_parallel "
                             f"{cfg.model_parallel} / pipeline_parallel "
                             f"{cfg.pipeline_parallel}) must divide train_batch_size "
                             f"{cfg.train_batch_size} and val_batch_size {cfg.val_batch_size}")
        mesh = make_hybrid_mesh(cfg.model_parallel, pipeline_parallel=cfg.pipeline_parallel)
        # each rank loads its data slice of every global batch
        shard_kw = dict(process_index=mesh_coords(mesh)["data"],
                        process_count=mesh_shape(mesh)["data"])
    trainer = Trainer.create(cfg, steps_per_epoch, mesh, device=args.device)
    trainer.local_batches = mesh is not None

    def train_batches():
        # The (seed, 0) permutation every epoch, as the JAX CLI draws it.
        return batch_iterator(train_ds, cfg.train_batch_size, shuffle=True, seed=cfg.seed,
                              num_workers=cfg.num_workers, **shard_kw)

    def val_batches():
        return batch_iterator(val_ds, cfg.val_batch_size, num_workers=cfg.num_workers,
                              **shard_kw)

    trainer.fit(train_batches, val_batches, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
