#!/usr/bin/env python3
"""K5 (the port's fused LayerNorm + MLP) at ViT-g/14's widths on one NVIDIA
GPU, CUDA events:

    python3 scripts/k5_vitg_times.py

At SHAPES (rows, C, hidden) in bf16, random weights from a seed, it times
K5's CUDA-core kernels (csrc/fused_mlp.cu, called directly whatever
`mlp_route` gives the shape), the route's kernel through `fused_ln_mlp` and
`fused_ln_mlp_backward` where the route is not the CUDA cores, and the same
half-block as PyTorch's dense operators on cuBLAS, forward and backward,
each in turns with the dense half-block (dense, kernel, kernel, dense;
ITERS launches a window after one to warm up). It prints the card's name
and power limit, then one JSON line a shape and direction with the mean ms
of each and the bound (operations over 989 TFLOP/s). Run it from the root
of a checkout; it imports no JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from probpose_pytorch_tpu_torch.ops.kernels.mlp import (  # noqa: E402
    fused_ln_mlp,
    fused_ln_mlp_backward,
    mlp_route,
)

# ViT-g serving (B = 64 crops of 192 tokens), its step (B = 32) and the
# widest shape phase 19 gates
SHAPES = ((12288, 1408, 6144), (6144, 1408, 6144), (12288, 1536, 6144))
ITERS = 3


def in_turns(kernel_fn, dense_fn) -> tuple[float, float]:
    d1 = cs.cuda_ms(torch, dense_fn, ITERS, warmup=1)
    k1 = cs.cuda_ms(torch, kernel_fn, ITERS, warmup=1)
    k2 = cs.cuda_ms(torch, kernel_fn, ITERS, warmup=1)
    d2 = cs.cuda_ms(torch, dense_fn, ITERS, warmup=1)
    return (k1 + k2) / 2, (d1 + d2) / 2


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    for R, C, Hd in SHAPES:
        route = mlp_route(C, Hd, torch.bfloat16)
        a = cs.p19_mlp_args(torch, g, dev, R, C, Hd, torch.bfloat16)
        dout = torch.randn(R, C, generator=g, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            dense_f = cs.dense_fwd_fn(torch, a)
            times = {}
            times["cuda_cores_ms"], times["dense_ms"] = in_turns(
                lambda: cs.cuda_core_mlp(torch, a), dense_f)
            if route != "CUDA cores":
                times["route_ms"], times["dense_ms_2"] = in_turns(lambda: fused_ln_mlp(*a), dense_f)
        bound = cs.bound_ms(cs.nbytes(*a, a[0]), 4 * R * C * Hd)
        print(json.dumps(dict(card=card, direction="forward", rows=R, C=C, hidden=Hd,
                              route=route, bound_ms=bound[0], **times)), flush=True)
        dense_b = cs.dense_bwd_fn(torch, a, dout)
        times = {}
        times["cuda_cores_ms"], times["dense_ms"] = in_turns(
            lambda: cs.cuda_core_mlp(torch, a, dout), dense_b)
        if route != "CUDA cores":
            times["route_ms"], times["dense_ms_2"] = in_turns(
                lambda: fused_ln_mlp_backward(*a, dout), dense_b)
        grads = cs.cuda_core_mlp(torch, a, dout)
        bound = cs.bound_ms(cs.nbytes(*a, dout) + cs.nbytes(*grads), 10 * R * C * Hd)
        print(json.dumps(dict(card=card, direction="backward", rows=R, C=C, hidden=Hd,
                              route=route, bound_ms=bound[0], **times)), flush=True)
        del a, dout, dense_f, dense_b, grads
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
