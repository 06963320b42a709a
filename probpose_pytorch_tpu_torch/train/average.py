"""Checkpoint averaging (port of probpose_pytorch_tpu/train/average.py):

    python -m probpose_pytorch_tpu_torch.train.average \
        --checkpoint runs/flagship/checkpoints --last 3 --out runs/avg
    # or: --steps 1000,1200,1400     (explicit step list)
    # or: --weights 0.2,0.3,0.5      (non-uniform; default uniform)
    # and --device cpu to build the fresh state on the CPU

Averages the parameters, the EMA parameters (when every checkpoint has
them) and the BN statistics of the port's `torch.save` checkpoints name by
name, and writes `<out>/checkpoints/<last step>` with a fresh optimizer
state and `<out>/config.json`: a deployment artifact, not a resume point.
Averaged BN statistics are an approximation (exact SWA recomputes them
with a pass over the data); the BN layers sit in the head's small conv
stacks.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = ["average_trees", "main"]


def average_trees(trees: Sequence[Mapping[str, torch.Tensor]],
                  weights: Sequence[float] | None = None) -> dict[str, torch.Tensor]:
    """Name-wise weighted average of state dicts with the same names: each
    entry accumulated in float64 on the host, in the order of `trees`, and
    cast back to the first state dict's dtype, as the JAX average does its
    leaves (so many checkpoints lose nothing to the accumulation order).
    `weights` (default uniform) must sum to 1."""
    if not trees:
        raise ValueError("no trees to average")
    if weights is None:
        weights = [1.0 / len(trees)] * len(trees)
    w = np.asarray(list(weights), np.float64)
    if len(w) != len(trees):
        raise ValueError(f"{len(w)} weights != {len(trees)} trees")
    if not np.isclose(w.sum(), 1.0):
        raise ValueError(f"weights sum to {w.sum()}, expected 1")
    out = {}
    for name, first in trees[0].items():
        acc = sum(wi * t[name].detach().cpu().double().numpy() for wi, t in zip(w, trees))
        out[name] = torch.from_numpy(np.asarray(acc)).to(first.dtype)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="average checkpoints")
    parser.add_argument("--checkpoint", type=Path, required=True,
                        help="checkpoint directory of the run")
    parser.add_argument("--config", type=Path, default=None,
                        help="TrainConfig JSON (default: beside the checkpoint)")
    parser.add_argument("--steps", type=str, default=None,
                        help="comma-separated step list (default: --last)")
    parser.add_argument("--last", type=int, default=3,
                        help="average the last N available steps")
    parser.add_argument("--weights", type=str, default=None,
                        help="comma-separated weights (default uniform)")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import dataclasses

    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager, write_run
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    config_path = args.config or args.checkpoint.parent / "config.json"
    cfg = TrainConfig.load(config_path) if Path(config_path).exists() else TrainConfig()
    ckpt = CheckpointManager(args.checkpoint)
    available = ckpt.all_steps()
    if not available:
        raise FileNotFoundError(f"no checkpoints under {args.checkpoint}")
    if args.steps:
        steps = [int(s) for s in args.steps.split(",")]
        missing = [s for s in steps if s not in available]
        if missing:
            raise ValueError(f"steps {missing} not in checkpoint dir (available: {available})")
    else:
        steps = available[-args.last:]
    if len(steps) < 2:
        raise ValueError(f"need >= 2 checkpoints to average, have {steps} "
                         f"(available: {available})")
    weights = [float(v) for v in args.weights.split(",")] if args.weights else None

    payloads = [ckpt.read(s) for s in steps]
    emas = [p["ema"] for p in payloads]
    out_cfg = dataclasses.replace(cfg, out_dir=str(args.out), resume=False)
    write_run(out_cfg, args.out, max(steps),
              average_trees([{**p["params"], **p["buffers"]} for p in payloads], weights),
              average_trees(emas, weights) if all(e is not None for e in emas) else None,
              args.device)
    print(f"averaged steps {steps} ({'uniform' if weights is None else weights}) -> {args.out}")


if __name__ == "__main__":
    main()
