#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (probpose_pytorch_tpu_torch) end to end at
the full ViT-S flagship width, with weights drawn from a seeded generator:

  phase 0  card name and power limit; TF32 off; nvcc build of csrc/*.cu with
           its -Xptxas -v register / shared-memory report
  phase 1  each hand-written kernel against its plain PyTorch version at the
           flagship shapes (K1 packed attention in CUDA C++, K2 sparsemax in
           Triton), plus one ragged case each
  phase 2  a TopDownPredictor answers requests of 1, 8 and 64 crops; every
           output is checked for shape and finiteness, the kernels' launch
           counters must show 12 K1 and 1 K2 launch per forward, and a
           float32 rerun through the kernels must agree with the same run
           through the plain versions
  phase 3  first numbers from the card, printed and not gated: per-kernel
           time against the plain version (CUDA events), serving crops/s at
           a batch of 256, peak device memory

Every failure ends the run with a non-zero exit and no result line. The
last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.

Nothing of JAX is imported: the port stands alone on the card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
REQUEST_SIZES = (1, 8, 64)
SERVE_BATCH = 256
K1_TOL = {"bfloat16": 4e-3, "float32": 1e-5}
K2_TOL = 1e-6
K2_SUM_TOL = 1e-5
KPT_TOL_PX = 1e-2
PROB_TOL = 1e-4
MARGIN = 1e-4


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, kernel_fn, plain_fn, iters: int) -> tuple[float, float]:
    """Times in turns plain, kernel, kernel, plain; returns the means."""
    p1 = cuda_ms(torch, plain_fn, iters)
    k1 = cuda_ms(torch, kernel_fn, iters)
    k2 = cuda_ms(torch, kernel_fn, iters)
    p2 = cuda_ms(torch, plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def request(seed: int, B: int):
    """uint8 frames (B, 320, 256, 3) and boxes drawn as bench.py draws them."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, 320, 256, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 120, 180], [60, 60, 196, 260], (B, 4)).astype(np.float32)
    return frames, boxes


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this smoke "
                         "run needs an NVIDIA GPU")

    from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
    from probpose_pytorch_tpu_torch.ops.heatmap import oks_conv
    from probpose_pytorch_tpu_torch.ops.kernels import _build, plain_versions
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
        sparsemax_reference,
        sparsemax_rows,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---------------------------------------------------------------- phase 0
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls still enabled")
    t0 = time.perf_counter()
    _build.library()
    report = _build.build_report()
    say(f"phase 0: kernel library {report['path']} "
        f"({'built' if report.get('built') else 'cached'}) in "
        f"{time.perf_counter() - t0:.2f} s")
    if report.get("ptxas"):
        for line in report["ptxas"].strip().splitlines():
            say(f"  ptxas: {line.strip()}")

    # ---------------------------------------------------------------- phase 1
    g = torch.Generator(device=dev).manual_seed(0)
    k1_err = {}
    for B, dtype in ((64, torch.bfloat16), (64, torch.float32), (3, torch.bfloat16)):
        qkv = torch.randn(B, 192, 1152, generator=g, device=dev).to(dtype)
        out = packed_attention(qkv, 6)
        torch.cuda.synchronize()
        ref = packed_attention_reference(qkv, 6)
        err = (out.float() - ref.float()).abs().max().item()
        name = str(dtype).split(".")[-1]
        tol = K1_TOL[name]
        say(f"phase 1: K1 packed_attention qkv ({B}, 192, 1152) {name} on the "
            f"{kernel_path(192, 64, dtype)}: max_abs_err {err:.3e} (tolerance {tol:g}; "
            f"max |ctx| {ref.float().abs().max().item():.3f})")
        check(err <= tol and np.isfinite(err), f"K1 {name} B={B} error {err}")
        k1_err.setdefault(name, err)

    t0 = time.perf_counter()
    k2_err = None
    for R in (64 * 17, 17 * 3 + 5):
        z = torch.randn(R, 3072, generator=g, device=dev) / 0.5
        out = sparsemax_rows(z)
        torch.cuda.synchronize()
        if k2_err is None:
            say(f"phase 1: K2 Triton compile + first launch {time.perf_counter() - t0:.2f} s")
        err = (out - sparsemax_reference(z)).abs().max().item()
        sum_err = (out.sum(-1) - 1.0).abs().max().item()
        say(f"phase 1: K2 sparsemax ({R}, 3072) float32: max_abs_err {err:.3e} "
            f"(tolerance {K2_TOL:g}), row-sum err {sum_err:.3e} ({K2_SUM_TOL:g})")
        check(err <= K2_TOL, f"K2 R={R} error {err}")
        check(sum_err <= K2_SUM_TOL, f"K2 R={R} row sums off by {sum_err}")
        k2_err = err if k2_err is None else k2_err

    # ---------------------------------------------------------------- phase 2
    block = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())["model"]
    cfg = ModelConfig(**block)
    check(cfg.attn_impl == "fused", "flagship config does not select kernel K1")
    model = build_model(cfg, dev, seed=0)
    # Freshly drawn head convs (std 0.001) give nearly flat heatmaps, whose
    # argmax is ill-defined. Redraw the heatmap branch's convs at fan-in
    # scale so the maps are peaked; keypoints are further compared only
    # where the convolved map's top-2 margin exceeds MARGIN.
    hg = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in [*model.head.deconvs, model.head.final]:
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[0] * 4
            w.copy_(torch.randn(w.shape, generator=hg).to(dev) / fan_in**0.5)
    W, H = cfg.heatmap_size
    codec = Codec(ProbMap((cfg.img_size[1], cfg.img_size[0]), (W, H),
                          sigmas=np.full(cfg.num_keypoints, 0.05, np.float32), sigma=2.0))
    predictor = TopDownPredictor(model, codec, cfg.img_size, return_heatmaps=True)
    requests = [request(i, B) for i, B in enumerate(REQUEST_SIZES)]
    K = cfg.num_keypoints
    shapes = dict(keypoints=(K, 2), scores=(K,), probabilities=(1, K),
                  visibilities=(1, K), oks=(1, K), errors=(1, K), heatmaps=(K, H, W))

    packed_attention.launches = 0
    sparsemax_rows.launches = 0
    answers = [predictor(frames, boxes) for frames, boxes in requests]
    torch.cuda.synchronize()
    k1_launches = packed_attention.launches
    k2_launches = sparsemax_rows.launches
    depth = len(model.backbone.blocks)
    for (frames, _), out in zip(requests, answers):
        B = len(frames)
        for key, shape in shapes.items():
            check(out[key].shape == (B, *shape), f"{key} shape {out[key].shape}")
            check(np.isfinite(out[key]).all(), f"{key} not finite at B={B}")
        say(f"phase 2: request of {B} crops answered: keypoints {out['keypoints'].shape}, "
            f"mean score {out['scores'].mean():.4f}, all fields finite")
    say(f"phase 2: launches over {len(requests)} forwards: K1 {k1_launches} "
        f"(expect {depth * len(requests)}), K2 {k2_launches} (expect {len(requests)})")
    check(k1_launches == depth * len(requests), "K1 did not run once per block")
    check(k2_launches == len(requests), "K2 did not run once per forward")

    with plain_versions():
        plain_bf16 = [predictor(f, b) for f, b in requests]
    hm_diff = max(float(np.abs(a["heatmaps"] - p["heatmaps"]).max())
                  for a, p in zip(answers, plain_bf16))
    say(f"phase 2: bf16 kernel-vs-plain heatmap max abs diff {hm_diff:.3e} (not gated)")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(model.state_dict())
    pred32 = TopDownPredictor(model32, codec, cfg.img_size, return_heatmaps=True)
    row_op, col_op = codec.probmap.conv_operators(dev)
    for frames, boxes in requests:
        kern = pred32(frames, boxes)
        with plain_versions():
            plain = pred32(frames, boxes)
        hm = torch.from_numpy(plain["heatmaps"]).to(dev)
        conv = oks_conv(hm, row_op, col_op).flatten(2)
        top2 = conv.topk(2, dim=-1).values
        sel = ((top2[..., 0] - top2[..., 1]) > MARGIN).cpu().numpy()
        kerr = float(np.abs(kern["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
        perr = float(np.abs(kern["probabilities"] - plain["probabilities"]).max())
        say(f"phase 2: f32 kernel vs plain, {len(frames)} crops: keypoint max diff "
            f"{kerr:.3e} px over {int(sel.sum())}/{sel.size} well-defined keypoints "
            f"(tolerance {KPT_TOL_PX:g}), probability max diff {perr:.3e} ({PROB_TOL:g})")
        check(sel.mean() > 0.5, "too few keypoints with a well-defined argmax")
        check(kerr <= KPT_TOL_PX, f"f32 keypoints differ by {kerr} px")
        check(perr <= PROB_TOL, f"f32 probabilities differ by {perr}")
    del model32, pred32

    # ---------------------------------------------------------------- phase 3
    qkv = torch.randn(SERVE_BATCH, 192, 1152, generator=g, device=dev).to(torch.bfloat16)
    k1_ms, k1_plain_ms = paired_ms(
        torch, lambda: packed_attention(qkv, 6),
        lambda: packed_attention_reference(qkv, 6), iters=20)
    z = torch.randn(SERVE_BATCH * K, H * W, generator=g, device=dev) / 0.5
    k2_ms, k2_plain_ms = paired_ms(
        torch, lambda: sparsemax_rows(z), lambda: sparsemax_reference(z), iters=20)
    say(f"phase 3 [{card}]: K1 qkv ({SERVE_BATCH}, 192, 1152) bf16: kernel "
        f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    say(f"phase 3 [{card}]: K2 ({SERVE_BATCH * K}, {H * W}) f32: kernel "
        f"{k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")
    del qkv, z

    frames, boxes = request(7, SERVE_BATCH)
    predictor.return_heatmaps = False
    f_dev = torch.from_numpy(frames).to(dev)
    b_dev = torch.from_numpy(boxes).to(dev)
    predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    dev_s = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    for _ in range(3):
        predictor(frames, boxes)
    host_s = (time.perf_counter() - t0) / 3
    say(f"phase 3 [{card}]: serving B={SERVE_BATCH}, frames resident on the card: "
        f"{dev_s * 1e3:.3f} ms/batch = {SERVE_BATCH / dev_s:.1f} crops/s")
    say(f"phase 3 [{card}]: serving B={SERVE_BATCH} from host numpy (upload + "
        f"download included): {host_s * 1e3:.3f} ms/batch = {SERVE_BATCH / host_s:.1f} crops/s")
    say(f"phase 3 [{card}]: peak device memory in the serving loop "
        f"{peak / 2**20:.1f} MiB")

    kernels = [
        dict(name="K1 packed_attention forward", route="cuda",
             source="probpose_pytorch_tpu_torch/csrc/packed_attention.cu",
             replaces="probpose_pytorch_tpu/ops/pallas/attention_kernel.py:120",
             launches=k1_launches, max_abs_err=k1_err["bfloat16"],
             ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="K2 sparsemax", route="triton",
             source="probpose_pytorch_tpu_torch/ops/kernels/sparsemax.py",
             replaces="probpose_pytorch_tpu/ops/pallas/sparsemax_kernel.py:29",
             launches=k2_launches, max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms),
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
