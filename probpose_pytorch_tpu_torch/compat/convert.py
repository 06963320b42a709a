"""Reference-checkpoint conversion CLI (port of
probpose_pytorch_tpu/compat/convert.py):

    python -m probpose_pytorch_tpu_torch.compat.convert \
        --torch-checkpoint head_epoch_190.pth \
        --config configs/reference_parity_fieldsynth.json \
        --out runs/imported [--head-only] [--device cuda]
    # RADIO-only: a frozen pretrained trunk and a fresh head
    python -m probpose_pytorch_tpu_torch.compat.convert \
        --radio-checkpoint radio.pth --config configs/radio_frozen_vitb.json \
        --out runs/radio [--radio-registers R] [--radio-src-grid GH GW]

Writes a port checkpoint, `<out>/checkpoints/0`, and `<out>/config.json`
(with resume on, so `train.cli --config <out>/config.json` continues from
the import) that load_predictor and the training CLI take. The head maps
by compat/torch_import.py; the trunk imports from a full-model save (a timm
ViT under `backbone.model.`) or a RADIO checkpoint, else the config's
seeded trunk is kept, as the reference's own head-only reload keeps its
trunk. The fresh state is built on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

__all__ = ["main"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="reference checkpoint -> port checkpoint")
    parser.add_argument("--torch-checkpoint", type=Path, default=None,
                        help="reference head or full-model save; omit for the RADIO-only "
                        "flow (frozen pretrained trunk and a fresh head)")
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--head-only", action="store_true",
                        help="the checkpoint holds only the head module")
    parser.add_argument("--radio-checkpoint", type=Path, default=None,
                        help="RADIO-style trunk state dict (class and register tokens, "
                        "pos-embed resampled to the pose grid); the model config must set "
                        "num_prefix_tokens, exact_gelu and frozen_backbone to match")
    parser.add_argument("--radio-prefix", default="model.",
                        help="key prefix of the ViT inside the RADIO checkpoint")
    parser.add_argument("--radio-src-grid", type=int, nargs=2, default=None,
                        help="the checkpoint's native patch grid (gh gw); default: the "
                        "square grid of its pos_embed")
    parser.add_argument("--radio-registers", type=int, default=0,
                        help="number of register tokens in the checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from probpose_pytorch_tpu_torch.compat.torch_import import (
        import_head_state_dict,
        import_radio_adapter_state_dict,
        import_radio_vit_state_dict,
        import_timm_vit_state_dict,
        state_dict_from_checkpoint,
    )
    from probpose_pytorch_tpu_torch.models.vit import ViTConfig
    from probpose_pytorch_tpu_torch.train.checkpoint import write_run
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    if args.torch_checkpoint is None and args.radio_checkpoint is None:
        parser.error("need --torch-checkpoint and/or --radio-checkpoint")
    cfg = TrainConfig.load(args.config) if args.config else TrainConfig()
    cfg = dataclasses.replace(cfg, out_dir=str(args.out), resume=True)
    m = cfg.model
    depth = ViTConfig.PRESETS[m.backbone]["depth"]
    imported: dict = {}
    sd: dict = {}
    if args.torch_checkpoint is not None:
        sd = state_dict_from_checkpoint(str(args.torch_checkpoint))
        imported.update(import_head_state_dict(
            sd, num_deconv=len(m.deconv_out_channels), num_conv=len(m.conv_out_channels),
            num_pool_stages=len(m.pool_sizes), prefix="" if args.head_only else "head."))
    else:
        print("no head checkpoint: kept the seeded head (train it with the frozen trunk, "
              "the reference recipe)")
    if args.radio_checkpoint is not None:
        rsd = state_dict_from_checkpoint(str(args.radio_checkpoint))
        n_prefix = m.num_prefix_tokens
        if args.radio_src_grid is not None:
            src_grid = tuple(args.radio_src_grid)
        else:
            side = int(round((rsd[f"{args.radio_prefix}pos_embed"].shape[1] - n_prefix) ** 0.5))
            src_grid = (side, side)
        grid = (m.img_size[0] // m.patch_size, m.img_size[1] // m.patch_size)
        imported.update(import_radio_vit_state_dict(
            rsd, depth=depth, src_grid=src_grid, dst_grid=grid,
            num_prefix_tokens=n_prefix - args.radio_registers,
            num_register_tokens=args.radio_registers, prefix=args.radio_prefix))
        imported.update(import_radio_adapter_state_dict(rsd))
        print(f"imported RADIO backbone ({src_grid} -> {grid} pos grid, "
              f"{n_prefix} prefix tokens)")
    elif not args.head_only and any(k.startswith("backbone.model.") for k in sd):
        imported.update(import_timm_vit_state_dict(sd, depth=depth, prefix="backbone.model."))
        print("imported timm ViT backbone weights")
    else:
        print("kept the seeded backbone (head-only checkpoint)")

    write_run(cfg, args.out, 0, imported, None, args.device, partial=True)
    print(f"wrote a port checkpoint to {args.out}/checkpoints (step 0)")


if __name__ == "__main__":
    main()
