"""Export the port's state dict to PyTorch reference-style state dicts (port
of probpose_pytorch_tpu/compat/torch_export.py).

The exact inverse of compat/torch_import.py: the trunk as a timm
VisionTransformer state dict (class_token=False, the layout the reference's
ScratchViTBackbone wraps) and the head as the reference ProbMapHead's
Sequential-index state dict. Only key renames: the port keeps torch's
layouts.

    python -m probpose_pytorch_tpu_torch.compat.torch_export \
        --checkpoint runs/flagship/checkpoints --out export_dir [--ema]

writes backbone.pth and head.pth.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Mapping

import torch

from probpose_pytorch_tpu_torch.compat.torch_import import BN_KEYS, BRANCHES

__all__ = ["export_head_state_dict", "export_timm_vit_state_dict", "save_reference_checkpoint",
           "main"]

StateDict = Mapping[str, torch.Tensor]


def _copy(out: dict, dst: str, sd: StateDict, src: str, keys=("weight", "bias")) -> None:
    for k in keys:
        if f"{src}.{k}" in sd:
            out[f"{dst}.{k}"] = sd[f"{src}.{k}"]


def _count(sd: StateDict, stem: str) -> int:
    """The number of `<stem>.<i>.` modules among the keys."""
    pat = re.compile(re.escape(stem) + r"\.(\d+)\.")
    return len({m.group(1) for k in sd for m in [pat.match(k)] if m})


def export_head_state_dict(sd: StateDict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The port's `head.*` entries as a reference ProbMapHead state dict;
    the stage counts are read from the keys, so any geometry exports."""
    q = lambda s: f"{prefix}{s}"
    out: dict[str, torch.Tensor] = {}
    for i in range(_count(sd, "head.deconvs")):
        _copy(out, q(f"deconv_layers.{3 * i}"), sd, f"head.deconvs.{i}")
        _copy(out, q(f"deconv_layers.{3 * i + 1}"), sd, f"head.deconv_bns.{i}", BN_KEYS)
    for i in range(_count(sd, "head.convs")):
        _copy(out, q(f"conv_layers.{3 * i}"), sd, f"head.convs.{i}")
        _copy(out, q(f"conv_layers.{3 * i + 1}"), sd, f"head.conv_bns.{i}", BN_KEYS)
    _copy(out, q("final_layer"), sd, "head.final")
    for ours, theirs in BRANCHES.items():
        b = f"head.branches.{ours}"
        n = _count(sd, f"{b}.convs")
        for i in range(n):
            _copy(out, q(f"{theirs}.{4 * i}"), sd, f"{b}.convs.{i}")
            _copy(out, q(f"{theirs}.{4 * i + 1}"), sd, f"{b}.bns.{i}", BN_KEYS)
        _copy(out, q(f"{theirs}.{4 * n}"), sd, f"{b}.final")
    return out


def export_timm_vit_state_dict(sd: StateDict, prefix: str = "model.") -> dict[str, torch.Tensor]:
    """The port's `backbone.*` entries as a timm VisionTransformer state
    dict. Plain trunks only: prefix tokens, adapters and LoRA deltas have
    no timm counterpart (merge LoRA with compat/merge_lora.py first)."""
    bad = [k for k in sd if k.startswith("backbone.")
           and (k == "backbone.prefix_tokens" or k.startswith("backbone.adapters.")
                or "_lora." in k)]
    if bad:
        raise ValueError(f"no timm counterpart for {bad}; export plain ViT trunks "
                         "(merge LoRA / drop adapters first)")
    q = lambda s: f"{prefix}{s}"
    out: dict[str, torch.Tensor] = {}
    _copy(out, q("patch_embed.proj"), sd, "backbone.patch_embed")
    out[q("pos_embed")] = sd["backbone.pos_embed"]
    _copy(out, q("norm"), sd, "backbone.norm")
    for i in range(_count(sd, "backbone.blocks")):
        for layer in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            _copy(out, q(f"blocks.{i}.{layer}"), sd, f"backbone.blocks.{i}.{layer}")
    return out


def save_reference_checkpoint(sd: StateDict, path: str | Path) -> None:
    """torch.save a state dict as contiguous CPU tensors, loadable with
    torch.load and load_state_dict on the reference's modules."""
    torch.save({k: v.detach().cpu().contiguous().clone() for k, v in sd.items()}, str(path))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="export a port checkpoint to torch state dicts")
    parser.add_argument("--checkpoint", type=Path, required=True,
                        help="checkpoint directory of the port's training CLI")
    parser.add_argument("--config", type=Path, default=None,
                        help="TrainConfig JSON (default: beside the checkpoint)")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--ema", action="store_true", help="use the EMA parameters")
    args = parser.parse_args(argv)

    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    config_path = args.config or args.checkpoint.parent / "config.json"
    cfg = TrainConfig.load(config_path) if Path(config_path).exists() else TrainConfig()
    if cfg.model.lora_rank > 0:
        raise ValueError("LoRA checkpoints export after merging: run "
                         "python -m probpose_pytorch_tpu_torch.compat.merge_lora first")
    payload = CheckpointManager(args.checkpoint).read()
    params = payload["ema"] if args.ema and payload["ema"] is not None else payload["params"]
    sd = {**params, **payload["buffers"]}
    args.out.mkdir(parents=True, exist_ok=True)
    save_reference_checkpoint(export_timm_vit_state_dict(sd), args.out / "backbone.pth")
    save_reference_checkpoint(export_head_state_dict(sd), args.out / "head.pth")
    print(f"wrote {args.out}/backbone.pth, head.pth")


if __name__ == "__main__":
    main()
