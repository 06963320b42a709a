"""Fold LoRA deltas into a standard checkpoint (port of
probpose_pytorch_tpu/compat/merge_lora.py):

    python -m probpose_pytorch_tpu_torch.compat.merge_lora \
        --checkpoint runs/lora/checkpoints --out runs/merged \
        [--config runs/lora/config.json] [--device cuda]

Reads the latest checkpoint of a LoRA run (config with model.lora_rank >
0), folds every delta into its base weight (models/lora.py:
merge_lora_state_dict, on the live and the EMA parameters alike), keeps
the BN statistics and the step, and writes `<out>/checkpoints/<step>` with
a fresh optimizer state and `<out>/config.json` with lora_rank = 0 and
train_lora_only = false. The merged run loads wherever a standard
checkpoint does (load_predictor, the eval CLI, compat/torch_export.py); it
is a deployment artifact, not a resume point. The fresh state is built on
the card unless `--device cpu` is given; the fold runs on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

__all__ = ["main"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="fold LoRA into base weights")
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from probpose_pytorch_tpu_torch.models.lora import merge_lora_state_dict
    from probpose_pytorch_tpu_torch.train import TrainConfig
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager, write_run

    config_path = args.config or args.checkpoint.parent / "config.json"
    cfg = TrainConfig.load(config_path)
    if cfg.model.lora_rank <= 0:
        raise ValueError(f"{config_path} has model.lora_rank == 0: nothing to merge")
    payload = CheckpointManager(args.checkpoint).read()
    alpha = cfg.model.lora_alpha
    merged_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, lora_rank=0), train_lora_only=False,
        out_dir=str(args.out), resume=False)
    ema = payload["ema"]
    write_run(merged_cfg, args.out, payload["step"],
              {**merge_lora_state_dict(payload["params"], alpha), **payload["buffers"]},
              None if ema is None else merge_lora_state_dict(ema, alpha), args.device)
    print(f"merged LoRA (rank {cfg.model.lora_rank}, alpha {alpha}) -> {args.out}")


if __name__ == "__main__":
    main()
