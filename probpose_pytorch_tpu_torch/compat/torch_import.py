"""Import PyTorch reference checkpoints into the port's state dict (port of
probpose_pytorch_tpu/compat/torch_import.py).

The reference saves pickled torch modules or state dicts. In the port an
import is state-dict loading with key renames, since the port's modules
keep torch's layouts (Conv2d, ConvTranspose2d and Linear weights as torch
stores them):
  * the reference ProbMapHead's Sequential indices -> `head.*`;
  * a timm VisionTransformer (class_token=False, as the reference builds
    it; keys the port has no place for are left out) -> `backbone.*`;
  * a RADIO-style ViT: its class and register tokens, with the rows of the
    positional embedding that belong to them, become `prefix_tokens`, the
    patch positional embedding is resampled to the pose grid, and a linear
    patchifier is folded into the patch convolution; its token-MLP adapter
    -> `backbone.adapters.*`; `radio_input_stats` reads its input mean and
    std.

`interpolate_pos_embed` computes what `jax.image.resize(..., "bicubic")`
computes: the Keys cubic (a = -0.5) at half-pixel centres, with the kernel
widened by the scale when shrinking (antialiasing), each axis a weight
matrix. `F.interpolate(mode="bicubic")` uses a = -0.75 and does not
antialias, so it is not used.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "state_dict_from_checkpoint",
    "import_head_state_dict",
    "import_timm_vit_state_dict",
    "interpolate_pos_embed",
    "import_radio_vit_state_dict",
    "import_radio_adapter_state_dict",
    "radio_input_stats",
]

StateDict = Mapping[str, torch.Tensor]
BRANCHES = {"probability": "probability_layers", "visibility": "visibility_layers",
            "oks": "oks_layers", "error": "error_layers"}
BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def state_dict_from_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint (a pickled module or a state dict) as a flat
    {name: tensor} dict on the CPU. Unpickles: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach() for k, v in sd.items()}


def _copy(out: dict, dst: str, sd: StateDict, src: str, keys=("weight", "bias")) -> None:
    for k in keys:
        if f"{src}.{k}" in sd:
            out[f"{dst}.{k}"] = sd[f"{src}.{k}"]
        elif k == "num_batches_tracked":
            out[f"{dst}.{k}"] = torch.zeros((), dtype=torch.int64)


def import_head_state_dict(sd: StateDict, num_deconv: int = 2, num_conv: int = 0,
                           num_pool_stages: int = 3, prefix: str = "") -> dict[str, torch.Tensor]:
    """A reference ProbMapHead state dict as the port's `head.*` entries.
    The reference's Sequentials ([deconv, BN, ReLU] per stage; [conv, BN,
    pool, ReLU] per stage, then a final 1x1 conv) map by position."""
    p = lambda s: f"{prefix}{s}"
    out: dict[str, torch.Tensor] = {}
    for i in range(num_deconv):
        _copy(out, f"head.deconvs.{i}", sd, p(f"deconv_layers.{3 * i}"))
        _copy(out, f"head.deconv_bns.{i}", sd, p(f"deconv_layers.{3 * i + 1}"), BN_KEYS)
    for i in range(num_conv):
        _copy(out, f"head.convs.{i}", sd, p(f"conv_layers.{3 * i}"))
        _copy(out, f"head.conv_bns.{i}", sd, p(f"conv_layers.{3 * i + 1}"), BN_KEYS)
    if any(k.startswith(p("final_layer.")) for k in sd):
        _copy(out, "head.final", sd, p("final_layer"))
    for ours, theirs in BRANCHES.items():
        b = f"head.branches.{ours}"
        for i in range(num_pool_stages):
            _copy(out, f"{b}.convs.{i}", sd, p(f"{theirs}.{4 * i}"))
            _copy(out, f"{b}.bns.{i}", sd, p(f"{theirs}.{4 * i + 1}"), BN_KEYS)
        _copy(out, f"{b}.final", sd, p(f"{theirs}.{4 * num_pool_stages}"))
    return out


def _blocks(out: dict, sd: StateDict, prefix: str, depth: int) -> None:
    for i in range(depth):
        for layer in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            _copy(out, f"backbone.blocks.{i}.{layer}", sd, f"{prefix}blocks.{i}.{layer}")


def import_timm_vit_state_dict(sd: StateDict, depth: int = 12,
                               prefix: str = "model.") -> dict[str, torch.Tensor]:
    """A timm VisionTransformer state dict (class_token=False,
    global_pool='', the reference's ScratchViTBackbone) as the port's
    `backbone.*` entries."""
    p = lambda s: f"{prefix}{s}"
    out: dict[str, torch.Tensor] = {}
    _copy(out, "backbone.patch_embed", sd, p("patch_embed.proj"))
    out["backbone.pos_embed"] = sd[p("pos_embed")]
    _copy(out, "backbone.norm", sd, p("norm"))
    _blocks(out, sd, prefix, depth)
    return out


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic with a = -0.5, as jax.image's bicubic kernel."""
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0))
                   * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of one axis of jax.image.resize's
    antialiased bicubic scale, in its float32 operations: half-pixel
    sample points, the kernel widened by 1/scale when shrinking, columns
    normalised to sum 1, samples outside the input zeroed."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
                    / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def interpolate_pos_embed(pos: torch.Tensor, src_grid: tuple[int, int],
                          dst_grid: tuple[int, int]) -> torch.Tensor:
    """Resample a (1, gh*gw, C) patch positional embedding from the
    checkpoint's grid to the pose model's (e.g. RADIO's square grid to the
    16 x 12 grid of 256 x 192 crops) in float32, as jax.image.resize's
    "bicubic" does."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos
    (sh, sw), (dh, dw) = src_grid, dst_grid
    grid = pos.detach().float().reshape(sh, sw, -1)
    rows = lambda g: torch.einsum("hwc,hy->ywc", g, torch.from_numpy(_resize_weights(sh, dh)))
    cols = lambda g: torch.einsum("hwc,wx->hxc", g, torch.from_numpy(_resize_weights(sw, dw)))
    if sh != dh:
        grid = rows(grid)
    if sw != dw:
        grid = cols(grid)
    return grid.reshape(1, dh * dw, -1)


def import_radio_vit_state_dict(
    sd: StateDict,
    depth: int,
    src_grid: tuple[int, int],
    dst_grid: tuple[int, int] | None = None,
    num_prefix_tokens: int = 1,
    num_register_tokens: int = 0,
    pos_embed_includes_prefix: bool = True,
    prefix: str = "",
) -> dict[str, torch.Tensor]:
    """A RADIO-style frozen ViT checkpoint as the port's `backbone.*`
    entries, for a ViTBackbone with num_prefix_tokens = num_prefix_tokens
    + num_register_tokens (and frozen, exact GELU, an adapter, as
    configs/radio_frozen_vitb.json sets them):
      * `cls_token` and `reg_token` become `prefix_tokens`, with the
        positional-embedding rows the source adds to them folded in (both
        are additive learned constants, so the forward is unchanged);
      * the patch positional embedding is resampled from `src_grid` to
        `dst_grid` (`interpolate_pos_embed`);
      * a linear patchifier (C, 3*ph*pw) becomes the equivalent Conv2d
        weight (C, 3, ph, pw)."""
    p = lambda s: f"{prefix}{s}"
    n_prefix = num_prefix_tokens + num_register_tokens
    pe = sd[p("patch_embed.proj.weight")]
    if pe.ndim == 2:
        n_patch = int(round(np.sqrt(pe.shape[1] / 3)))
        pe = pe.reshape(pe.shape[0], 3, n_patch, n_patch)
    out: dict[str, torch.Tensor] = {"backbone.patch_embed.weight": pe}
    if p("patch_embed.proj.bias") in sd:
        out["backbone.patch_embed.bias"] = sd[p("patch_embed.proj.bias")]
    _copy(out, "backbone.norm", sd, p("norm"))
    pos = sd[p("pos_embed")]
    pos_prefix = 0.0
    if pos_embed_includes_prefix and n_prefix:
        pos_prefix, pos = pos[:, :n_prefix], pos[:, n_prefix:]
    out["backbone.pos_embed"] = interpolate_pos_embed(pos, src_grid, dst_grid or src_grid)
    if n_prefix:
        C = pos.shape[-1]
        toks = [sd[p(k)].reshape(1, -1, C) for k, n in (("cls_token", num_prefix_tokens),
                                                         ("reg_token", num_register_tokens)) if n]
        out["backbone.prefix_tokens"] = torch.cat(toks, dim=1) + pos_prefix
    _blocks(out, sd, prefix, depth)
    return out


def import_radio_adapter_state_dict(sd: StateDict, prefix: str = "mlp.") -> dict[str, torch.Tensor]:
    """The reference RadioBackbone's token-MLP adapter (a Sequential of
    Linear and activation layers) as `backbone.adapters.{j}.*`; {} when
    the checkpoint has none."""
    linear = sorted(int(k[len(prefix):].split(".")[0]) for k in sd
                    if k.startswith(prefix) and k.endswith(".weight"))
    out: dict[str, torch.Tensor] = {}
    for j, i in enumerate(linear):
        _copy(out, f"backbone.adapters.{j}", sd, f"{prefix}{i}")
    return out


def radio_input_stats(sd: StateDict, prefix: str = "input_conditioner."
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """RADIO's input (mean, std) from its input conditioner, to apply in
    preprocessing; None when the checkpoint has none."""
    mean_k, std_k = f"{prefix}norm_mean", f"{prefix}norm_std"
    if mean_k not in sd:
        return None
    return (np.asarray(sd[mean_k]).reshape(-1), np.asarray(sd[std_k]).reshape(-1))
