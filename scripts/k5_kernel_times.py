#!/usr/bin/env python3
"""Device time of each kernel of K5 (the port's fused LayerNorm + MLP) on one
NVIDIA GPU, from torch.profiler:

    python3 scripts/k5_kernel_times.py

At ViT-B's widths (C = 768, hidden 3072, bf16, random weights from a seed)
it runs K5 forward at 49,152 rows (ViT-B serving at a batch of 256) and K5
forward and backward at 12,288 rows (the ViT-B step at a batch of 64), five
calls each after three to warm up, and prints one JSON line per kernel:
its name, launches and mean device time in microseconds. The first line is
the card's name and power limit. Run it from the root of a checkout; it
imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from probpose_pytorch_tpu_torch.ops.kernels.mlp import (  # noqa: E402
    fused_ln_mlp,
    fused_ln_mlp_backward,
)

C, HIDDEN = 768, 3072
CALLS, WARMUP = 5, 3


def inputs(rows: int, g: torch.Generator, dev: torch.device):
    """K5's arguments as a ViT-B block passes them, and a cotangent."""
    f32 = dict(generator=g, device=dev)
    bf16 = torch.bfloat16
    x = torch.randn(rows, C, **f32).to(bf16)
    scale, bias = 1 + 0.1 * torch.randn(C, **f32), 0.1 * torch.randn(C, **f32)
    w1 = (torch.randn(HIDDEN, C, **f32) / C**0.5).to(bf16).t()
    w2 = (torch.randn(C, HIDDEN, **f32) / HIDDEN**0.5).to(bf16).t()
    args = (x, scale, bias, w1, 0.1 * torch.randn(HIDDEN, **f32), w2, 0.1 * torch.randn(C, **f32))
    return args, torch.randn(rows, C, **f32).to(bf16)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, backward in ((49152, False), (12288, True)):
        args, dout = inputs(rows, g, dev)

        def run():
            fused_ln_mlp(*args)
            if backward:
                fused_ln_mlp_backward(*args, dout)

        with torch.no_grad():
            for _ in range(WARMUP):
                run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    run()
                torch.cuda.synchronize()
        for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
            if e.device_time_total <= 0:
                continue
            print(json.dumps(dict(card=card, rows=rows, kernel=e.key, launches=e.count,
                                  mean_us=e.device_time_total / e.count)), flush=True)
        del args, dout


if __name__ == "__main__":
    main()
