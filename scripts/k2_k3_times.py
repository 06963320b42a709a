#!/usr/bin/env python3
"""Device times of K2 (sparsemax) and K3 (fused decode) on one NVIDIA GPU,
against the kernels they replaced:

    python3 scripts/k2_k3_times.py [--parent DIR]

K2 runs at the flagship's rows (4,352 x 3,072: a batch of 256 crops, 17
keypoints), at the 768 x 768 path's (1,088 x 36,864) and at 65,536-pixel
rows, each on random rows (N(0, 2), as chip_smoke.py draws them) and on
rows whose every element is a candidate (uniform in [0, 1)). K3 runs at
(64, 17, 192, 192) and (256, 17, 64, 48) on peaked maps with the OKS
operators at sigma 0.05 and at the COCO sigmas.

With --parent DIR (a checkout of the commit before the redesign, e.g. a
`git archive` of it) the script also loads that commit's K2 (the Triton
kernels of DIR/probpose_pytorch_tpu_torch/ops/kernels/sparsemax.py) and K3
(DIR/probpose_pytorch_tpu_torch/csrc/decode.cu, built here alone with nvcc),
checks that both K3 kernels give equal values (==, which counts +0 and -0
equal) and times each pair in turns (new, old, old, new; medians of three
windows). Each line of output is one JSON object; the first names the card
and its power limit. Run it from the root of a checkout; it imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from probpose_pytorch_tpu_torch.ops.heatmap import (  # noqa: E402
    build_oks_conv_operators,
    expected_value_decode,
)
from probpose_pytorch_tpu_torch.ops.kernels.decode import (  # noqa: E402
    band_radius,
    expected_value_decode_fused,
)
from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (  # noqa: E402
    sparsemax_reference,
    sparsemax_rows,
)

COCO_SIGMAS = [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
               0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def window_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(new, old, iters: int) -> tuple[float, float]:
    """Medians over three windows of (new, old, old, new); `old` may be None."""
    news, olds = [], []
    for _ in range(3):
        a = window_ms(new, iters)
        b = window_ms(old, iters) if old else float("nan")
        c = window_ms(old, iters) if old else float("nan")
        d = window_ms(new, iters)
        news.append((a + d) / 2)
        olds.append((b + c) / 2)
    return float(np.median(news)), float(np.median(olds))


def parent_k2(parent: Path):
    """The parent commit's sparsemax_rows (Triton), loaded from its file."""
    path = parent / "probpose_pytorch_tpu_torch/ops/kernels/sparsemax.py"
    spec = importlib.util.spec_from_file_location("parent_sparsemax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.sparsemax_rows


def parent_k3(parent: Path):
    """The parent commit's csrc/decode.cu, built alone; returns a function
    with expected_value_decode_fused's arguments."""
    out = ROOT / "build" / "parent_k3" / "libdecode.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = "/usr/local/cuda/bin/nvcc" if Path("/usr/local/cuda/bin/nvcc").exists() else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(parent / "probpose_pytorch_tpu_torch/csrc/decode.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.expected_value_decode_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.expected_value_decode_fwd.restype = i32

    def decode(hm, row_op, col_op):
        B, K, H, W = hm.shape
        locs = torch.empty(B, K, 2, device=hm.device)
        vals = torch.empty(B, K, device=hm.device)
        err = lib.expected_value_decode_fwd(hm.data_ptr(), row_op.data_ptr(), col_op.data_ptr(),
                                            locs.data_ptr(), vals.data_ptr(), B, K, H, W,
                                            hm.device.index or 0,
                                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K3 failed with cudaError {err}")
        return locs, vals

    return decode


def peaked_maps(g, B, K, H, W, dev):
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    c = torch.rand(B, K, 2, 1, 1, generator=g, device=dev) * torch.tensor(
        [W - 8.0, H - 8.0], device=dev).reshape(2, 1, 1) + 4
    maps = torch.exp(-((xx - c[:, :, 0]) ** 2 + (yy - c[:, :, 1]) ** 2) / (2 * (H / 32) ** 2))
    return maps + 0.03 * torch.rand(B, K, H, W, generator=g, device=dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="checkout of the commit before the redesign")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    say(card=card, torch=torch.__version__)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    old_k2 = parent_k2(args.parent) if args.parent else None
    old_k3 = parent_k3(args.parent) if args.parent else None

    for R, N in ((4352, 3072), (1088, 36864), (544, 65536)):
        for rows in ("random", "all candidates"):
            z = (torch.randn(R, N, generator=g, device=dev) / 0.5 if rows == "random"
                 else torch.rand(R, N, generator=g, device=dev))
            out = sparsemax_rows(z)
            ref = sparsemax_reference(z)
            line = dict(kernel="K2", shape=[R, N], rows=rows,
                        max_abs_err=(out - ref).abs().max().item(),
                        row_sum_err=(out.sum(-1) - 1).abs().max().item(),
                        plain_row_sum_err=(ref.sum(-1) - 1).abs().max().item(),
                        bound_ms=2 * z.numel() * 4 / HBM_BYTES_PER_S * 1e3)
            del ref
            if old_k2:
                line["parent_max_abs_err"] = (old_k2(z) - out).abs().max().item()
            line["ms"], line["parent_ms"] = in_turns(lambda: sparsemax_rows(z),
                                                     old_k2 and (lambda: old_k2(z)), iters=20)
            say(**line)
            del z, out

    for B, K, H, W in ((64, 17, 192, 192), (256, 17, 64, 48)):
        for name, sigmas in (("sigma 0.05", [0.05] * K), ("COCO", COCO_SIGMAS)):
            hm = peaked_maps(g, B, K, H, W, dev).contiguous()
            ops = build_oks_conv_operators(np.asarray(sigmas), H, W)
            row_op = torch.from_numpy(ops.row_op).to(dev)
            col_op = torch.from_numpy(ops.col_op).to(dev)
            locs, vals = expected_value_decode_fused(hm, row_op, col_op)
            ref_locs, ref_vals = expected_value_decode(hm, row_op, col_op)
            rr, rc = band_radius(row_op), band_radius(col_op)
            band_ops = 2 * B * H * W * float(((2 * rr + 1) + (2 * rc + 1)).sum())
            band_bytes = 4 * (hm.numel() + row_op.numel() + col_op.numel() + 3 * B * K)
            line = dict(kernel="K3", shape=[B, K, H, W], operators=name,
                        max_px_err=(locs - ref_locs).abs().max().item(),
                        max_val_err=(vals - ref_vals).abs().max().item(),
                        bound_ms=max(band_bytes / HBM_BYTES_PER_S, band_ops / F32_OPS_PER_S) * 1e3,
                        dense_bound_ms=max(band_bytes / HBM_BYTES_PER_S,
                                           2 * B * K * H * W * (H + W) / F32_OPS_PER_S) * 1e3)
            if old_k3:
                old_locs, old_vals = old_k3(hm, row_op, col_op)
                line["equal_to_parent"] = bool(torch.equal(locs, old_locs)
                                               and torch.equal(vals, old_vals))
                line["parent_max_px_diff"] = (locs - old_locs).abs().max().item()
            line["ms"], line["parent_ms"] = in_turns(
                lambda: expected_value_decode_fused(hm, row_op, col_op),
                old_k3 and (lambda: old_k3(hm, row_op, col_op)), iters=20)
            say(**line)


if __name__ == "__main__":
    main()
