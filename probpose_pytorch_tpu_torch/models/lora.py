"""LoRA: low-rank adaptation for fine-tuning (port of
probpose_pytorch_tpu/models/lora.py).

A rank-r delta (alpha / r) * (x @ a) @ b sits beside each of the ViT's
qkv, proj, fc1 and fc2 projections and is added to the projection's
OUTPUT (activation side), so the base Linear runs unchanged and kernel K1
reads the summed qkv. The delta runs in the compute dtype, its input cast
to it, as the JAX docstring describes ("two skinny matmuls in the compute
dtype"); the JAX module leaves its float32 LayerNorm input uncast, so
there jnp's promotion makes the qkv and fc1 deltas, and the sums, float32
under a bf16 compute dtype. In float32 the two are the same function; in
bf16 the port keeps a bf16 qkv, the input of the bf16 attention kernels. `a` (I, r) and `b` (r, O) are float32 parameters in
the JAX orientation under the JAX names (`<layer>_lora.a`, `.b`), so
compat/from_jax.py carries them without a transpose. `b` starts at zero:
a LoRA model equals its base model until training moves the deltas.

`lora_frozen_labels` marks the deltas and the head trainable for
`TrainConfig.train_lora_only`; `merge_lora_state_dict` folds the trained
deltas into the base weights for deployment (compat/merge_lora.py).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["LoRADelta", "lora_frozen_labels", "merge_lora_state_dict"]


class LoRADelta(nn.Module):
    """(alpha / r) * (x @ a) @ b in the compute dtype `dtype`. `b` starts at
    zero; models/model.py:init_weights draws `a` N(0, 0.02) from the
    model's generator."""

    def __init__(self, in_features: int, features: int, rank: int, alpha: float = 16.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(in_features, rank))
        self.b = nn.Parameter(torch.zeros(rank, features))
        self.scale = alpha / rank
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return ((x.to(dt) @ self.a.to(dt)) @ self.b.to(dt)) * self.scale


def lora_frozen_labels(names: Sequence[str]) -> list[str]:
    """"trainable" for the LoRA deltas (a name containing "lora") and the
    head, "frozen" for everything else, in the order of `names`."""
    return ["trainable" if "lora" in n or n.split(".")[0] == "head" else "frozen"
            for n in names]


def merge_lora_state_dict(sd: Mapping[str, torch.Tensor], alpha: float) -> dict[str, torch.Tensor]:
    """`sd` with every `<layer>_lora.{a, b}` delta folded into its sibling
    Linear `<layer>.weight` and the delta entries dropped: in the JAX
    kernel's (I, O) orientation, kernel + (alpha / r) * (a @ b) in float32
    numpy, as the JAX merge computes it, so both give the same bits.

    `alpha` is required: it is the `ModelConfig.lora_alpha` the deltas were
    trained with and cannot be read from the state dict. A delta with no
    sibling weight raises ValueError."""
    out = {k: v for k, v in sd.items() if "_lora." not in k}
    host = lambda t: t.detach().cpu().numpy().astype(np.float32)
    for k in sd:
        if not k.endswith("_lora.a"):
            continue
        stem = k[: -len("_lora.a")]
        base = f"{stem}.weight"
        if base not in out:
            raise ValueError(f"LoRA params {stem + '_lora'!r} have no sibling {base}")
        a, b = host(sd[k]), host(sd[f"{stem}_lora.b"])
        weight = out[base]
        kernel = host(weight).T + (alpha / a.shape[-1]) * (a @ b)
        out[base] = torch.from_numpy(np.ascontiguousarray(kernel.T)).to(weight)
    return out
