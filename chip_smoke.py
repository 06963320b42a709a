#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path and training step (probpose_pytorch_tpu_torch)
end to end at the full ViT-S flagship width, with weights drawn from a seeded
generator:

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
  phase 3  K1 forward and K2 against their plain versions at the shapes of a
           batch of 256; then numbers, printed and not gated: per-kernel
           time against the plain version (CUDA events), serving crops/s at
           a batch of 256, peak device memory
  phase 4  the K1 backward kernel against its plain version at the flagship
           shapes (bf16, f32, a ragged batch), and torch.autograd.grad
           through packed_attention against the plain path
  phase 5  the flagship training step through Trainer (augmentation off): a
           float32 step through the kernels against the same step through
           the plain versions (loss terms, grad_norm, per-leaf gradients,
           params); Trainer.fit for 20 bf16 steps at a batch of 256, whose
           losses must be finite and fall, with 12 K1 forward, 12 K1
           backward and 1 K2 launch per step; K1 backward against its plain
           version at that batch; then, not gated, the K1 backward time,
           step time, crops/s, a per-stage split (CUDA events) and peak
           device memory

`--profile` adds a torch.profiler table of three bf16 training steps.

Every failure ends the run with a non-zero exit and no result line. The
last three lines are the card's name and power limit, a JSON summary of
the kernels and {"ok": true, "device": {...}}.

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
TRAIN_BATCH = 256
TRAIN_STEPS = 20
F32_TRAIN_BATCH = 32
K2_TOL = 1e-6
K2_SUM_TOL = 1e-5
KPT_TOL_PX = 1e-2
PROB_TOL = 1e-4
MARGIN = 1e-4


def k1_bound(ref) -> float:
    """K1's error bound, relative to the output's magnitude: bf16 two ulps
    (2 * 2**-8) of max(1, max|ref|) -- an f32 sum taken in another order
    can move a bf16 output across a rounding boundary, one ulp of its own
    size, which an absolute bound misses for outputs >= 1; f32 1e-5 of the
    same scale, for sums in another order."""
    rel = 2 * 2**-8 if str(ref.dtype).endswith("bfloat16") else 1e-5
    return rel * max(1.0, ref.float().abs().max().item())


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def gate(torch, label: str, out, ref, phase: int, bound: float | None = None) -> float:
    """Max abs error of a kernel's output against its plain version, which
    must be finite and within `bound` (K1's relative bound by default)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    bound = k1_bound(ref) if bound is None else bound
    say(f"phase {phase}: {label}: max_abs_err {err:.3e} (bound {bound:.3e}; "
        f"max |ref| {ref.float().abs().max().item():.3f})")
    check(err <= bound and np.isfinite(err), f"{label}: error {err}")
    return err


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


def peak_heatmap_branch(torch, model, seed: int = 1) -> None:
    """Freshly drawn head convs (std 0.001) give nearly flat heatmaps, whose
    argmax is ill-defined. Redraw the heatmap branch's convs at fan-in
    scale, from a seeded generator, so the maps are peaked."""
    hg = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in [*model.head.deconvs, model.head.final]:
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[0] * 4
            w.copy_(torch.randn(w.shape, generator=hg).to(w.device) / fan_in**0.5)


def request(seed: int, B: int):
    """uint8 frames (B, 320, 256, 3) and boxes drawn as bench.py draws them."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, 320, 256, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 120, 180], [60, 60, 196, 260], (B, 4)).astype(np.float32)
    return frames, boxes


def phase4_k1_backward(torch, dev, g) -> None:
    """K1 backward against its plain version at the flagship shapes, and
    autograd through packed_attention."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_backward,
        packed_attention_bwd_reference,
        packed_attention_reference,
    )

    for B, dtype in ((64, torch.bfloat16), (64, torch.float32), (3, torch.bfloat16)):
        qkv = torch.randn(B, 192, 1152, generator=g, device=dev).to(dtype)
        dout = torch.randn(B, 192, 384, generator=g, device=dev).to(dtype)
        gate(torch, f"K1 backward qkv ({B}, 192, 1152) {str(dtype).split('.')[-1]} on the "
             f"{kernel_path(192, 64, dtype, backward=True)}",
             packed_attention_backward(qkv, dout, 6),
             packed_attention_bwd_reference(qkv, dout, 6), phase=4)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(8, 192, 1152, generator=g, device=dev).to(dtype)
        w = torch.randn(8, 192, 384, generator=g, device=dev).to(dtype)
        x = qkv.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad((packed_attention(x, 6).float() * w.float()).sum(), x)
        torch.cuda.synchronize()
        if dtype == torch.float32:  # autograd through the plain forward
            y = qkv.clone().requires_grad_(True)
            (ref,) = torch.autograd.grad((packed_attention_reference(y, 6) * w).sum(), y)
        else:  # the plain backward, with the kernel's two bf16 roundings
            ref = packed_attention_bwd_reference(qkv, w, 6)
        err = (grad.float() - ref.float()).abs().max().item()
        name = str(dtype).split(".")[-1]
        say(f"phase 4: autograd.grad through packed_attention (8, 192, 1152) {name}: "
            f"max_abs_err {err:.3e} against the plain path (bound {k1_bound(ref):.3e})")
        check(err <= k1_bound(ref), f"K1 autograd {name} error {err}")


def train_config(dtype: str, batch: int):
    """The flagship TrainConfig (configs/flagship_coco_vits.json) with
    augmentation off, at `dtype` and `batch`, logging every step."""
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig.load(REPO / "configs/flagship_coco_vits.json")
    return dataclasses.replace(
        cfg, augment=None, train_batch_size=batch, log_every=1, resume=False,
        model=dataclasses.replace(cfg.model, compute_dtype=dtype))


def make_trainer(torch, cfg, dev):
    """A Trainer with weights from cfg.seed and a peaked heatmap branch; the
    one-cycle schedule spans cfg.epochs steps."""
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    trainer = Trainer.create(cfg, steps_per_epoch=1, device=dev)
    peak_heatmap_branch(torch, trainer.model)
    return trainer


def capture_grads(state, into: list) -> None:
    """Keep a copy of the gradients each step hands the optimizer."""
    apply = state.apply_gradients

    def wrapped(grads, tx, ema_decay=None):
        into.append([g.detach().clone() for g in grads])
        return apply(grads, tx, ema_decay)

    state.apply_gradients = wrapped


def f32_step_pair(torch, dev, batch):
    """Two fresh float32 trainers from the same weights, one step each on
    `batch`: through the kernels, then through the plain versions. Returns
    both trainers, their metrics and the gradients each step produced."""
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions

    cfg = train_config("float32", F32_TRAIN_BATCH)
    kern, plain = make_trainer(torch, cfg, dev), make_trainer(torch, cfg, dev)
    gk, gp = [], []
    capture_grads(kern.state, gk)
    capture_grads(plain.state, gp)
    _, mk = kern.train_step(kern.state, kern.device_batch(batch))
    with plain_versions():
        _, mp = plain.train_step(plain.state, plain.device_batch(batch))
    torch.cuda.synchronize()
    return kern, plain, mk, mp, gk[0], gp[0]


def compare_f32_step(torch, dev, batch, lr: float) -> None:
    """One float32 step through the kernels against the same step through
    the plain versions, from the same weights and batch. cuDNN is held to
    deterministic algorithms and a first, unchecked pair of steps settles
    its choice for these shapes, so both compared steps convolve alike and
    only the kernels differ between them."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        f32_step_pair(torch, dev, batch)
        kern, plain, mk, mp, gk, gp = f32_step_pair(torch, dev, batch)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    for key in mp:
        if key.startswith("loss"):
            a, b = float(mk[key]), float(mp[key])
            say(f"phase 5: f32 {key}: kernel {a:.9g}, plain {b:.9g}")
            check(abs(a - b) <= 1e-5 * abs(b) + 1e-12, f"f32 {key} differs: {a} vs {b}")
    a, b = float(mk["grad_norm"]), float(mp["grad_norm"])
    say(f"phase 5: f32 grad_norm: kernel {a:.9g}, plain {b:.9g} (1e-4 relative)")
    check(abs(a - b) <= 1e-4 * abs(b), f"f32 grad_norm differs: {a} vs {b}")
    # The grad tolerance: 1e-4 of the plain gradient's max in each leaf, or,
    # for a leaf whose gradient is rounding noise below 1e-6 of the largest
    # anywhere (head.final.bias, exactly 0 through sparsemax's shift
    # invariance), 1e-6 of that largest. Gradients agree within it, leaf by
    # leaf. Params agree within 1e-6, except elements whose plain gradient
    # is below the grad tolerance (or in a noise leaf): Adam's first step
    # moves those by up to lr whatever their size, so they may differ by 2 lr.
    gmax = max(g.abs().max().item() for g in gp)
    worst, worst_g, loose, n_small = 0.0, 0.0, 0, 0
    for name, pk, pp, g, g_k in zip(kern.state.names, kern.state.params, plain.state.params,
                                    gp, gk):
        noise = g.abs().max().item() < 1e-6 * gmax
        gtol = 1e-6 * gmax if noise else 1e-4 * g.abs().max().item()
        g_err = (g_k - g).abs().max().item()
        worst_g = max(worst_g, g_err / gtol)
        check(g_err <= gtol, f"f32 grad {name} differs by {g_err} (tolerance {gtol:.3e})")
        d = (pk - pp).abs()
        small = (g.abs() < 1e-4 * g.abs().max()) | noise
        big_err = d[~small].max().item() if (~small).any() else 0.0
        worst = max(worst, big_err)
        check(big_err <= 1e-6, f"f32 param {name} differs by {big_err}")
        check(bool((d[small] <= 2 * lr).all()), f"f32 param {name} beyond 2 lr")
        n_small += int(small.sum())
        loose += int((small & (d > 1e-6)).sum())
    say(f"phase 5: f32 grads, every leaf within its grad tolerance (worst leaf at "
        f"{worst_g:.3e} of it)")
    say(f"phase 5: f32 params after one step: max diff {worst:.3e} (bound 1e-6) where "
        f"the gradient is above the grad tolerance; {loose} of {n_small} elements under "
        f"it moved by more than 1e-6 (allowed 2 lr = {2 * lr:.3e})")


def phase5_training(torch, dev, card: str, profile: bool) -> dict:
    """The training step at full ViT-S width; returns the main path's
    launch counts and the K1 backward times."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_backward,
        packed_attention_bwd_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_rows

    cfg = train_config("bfloat16", TRAIN_BATCH)
    H, W = cfg.model.img_size
    t0 = time.perf_counter()
    ds = SyntheticPoseDataset(TRAIN_BATCH, (H, W), cfg.model.num_keypoints, seed=0)
    batch = next(iter(batch_iterator(ds, TRAIN_BATCH, num_workers=8)))
    say(f"phase 5: synthetic batch of {TRAIN_BATCH} crops made in "
        f"{time.perf_counter() - t0:.2f} s")
    trainer = make_trainer(torch, cfg, dev)
    lr0 = float(trainer.tx.schedule(torch.zeros((), dtype=torch.int32, device=dev)))
    compare_f32_step(torch, dev, {k: v[:F32_TRAIN_BATCH] for k, v in batch.items()}, lr0)

    # The main path: Trainer.fit on the fixed batch, bf16.
    depth = len(trainer.model.backbone.blocks)
    packed_attention.launches = 0
    packed_attention_backward.launches = 0
    sparsemax_rows.launches = 0
    t0 = time.perf_counter()
    trainer.fit(lambda: iter([batch]), max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(k1f=packed_attention.launches, k1b=packed_attention_backward.launches,
                  k2=sparsemax_rows.launches)
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 5: Trainer.fit, {TRAIN_STEPS} bf16 steps at B={TRAIN_BATCH} in "
        f"{fit_s:.2f} s; loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    say(f"phase 5: launches over {TRAIN_STEPS} steps: K1 forward {counts['k1f']}, K1 backward "
        f"{counts['k1b']} (expect {depth * TRAIN_STEPS} each), K2 {counts['k2']} "
        f"(expect {TRAIN_STEPS})")
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} steps logged")
    check(all(np.isfinite(losses)), "a bf16 training loss is not finite")
    check(losses[-1] < losses[0], "the total loss did not fall over the fixed batch")
    check(counts["k1f"] == depth * TRAIN_STEPS, "K1 forward did not run once per block")
    check(counts["k1b"] == depth * TRAIN_STEPS, "K1 backward did not run once per block")
    check(counts["k2"] == TRAIN_STEPS, "K2 did not run once per step")

    # K1 backward at the main path's shape, gated against its plain
    # version; then numbers, not gated.
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(TRAIN_BATCH, 192, 1152, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(TRAIN_BATCH, 192, 384, generator=g, device=dev).to(torch.bfloat16)
    k1b_err = gate(torch, f"K1 backward qkv ({TRAIN_BATCH}, 192, 1152) bf16 on the "
                   f"{kernel_path(192, 64, torch.bfloat16, backward=True)}",
                   packed_attention_backward(qkv, dout, 6),
                   packed_attention_bwd_reference(qkv, dout, 6), phase=5)
    k1b_ms, k1b_plain_ms = paired_ms(
        torch, lambda: packed_attention_backward(qkv, dout, 6),
        lambda: packed_attention_bwd_reference(qkv, dout, 6), iters=10)
    say(f"phase 5 [{card}]: K1 backward qkv ({TRAIN_BATCH}, 192, 1152) bf16: kernel "
        f"{k1b_ms:.4f} ms, plain {k1b_plain_ms:.4f} ms")
    del qkv, dout

    db = trainer.device_batch(batch)
    for _ in range(2):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 5 [{card}]: bf16 train step B={TRAIN_BATCH}, batch on the card: "
        f"{step_s * 1e3:.3f} ms/step = {TRAIN_BATCH / step_s:.1f} crops/s; peak device "
        f"memory {peak / 2**20:.1f} MiB")

    stages = ("encode", "forward", "loss", "backward", "optimizer")
    totals = dict.fromkeys(stages, 0.0)
    for _ in range(5):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        trainer.train_step(trainer.state, db, mark)
        torch.cuda.synchronize()
        for name, a, b in zip(stages, events[:-1], events[1:]):
            totals[name] += a.elapsed_time(b) / 5
    say(f"phase 5 [{card}]: bf16 step split (CUDA events, mean of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in totals.items())
        + f"; sum {sum(totals.values()):.3f} ms")

    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(trainer.state, db)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        say(f"profile [{card}]: 3 bf16 steps, wall {wall * 1e3:.3f} ms, device busy "
            f"{busy_ms:.3f} ms in {len(kernels)} kernels (idle share "
            f"{1 - busy_ms / (wall * 1e3):.3f})")
        say(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    return dict(counts, k1b_err=k1b_err, k1b_ms=k1b_ms, k1b_plain_ms=k1b_plain_ms)


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
    for B, dtype in ((64, torch.bfloat16), (64, torch.float32), (3, torch.bfloat16)):
        qkv = torch.randn(B, 192, 1152, generator=g, device=dev).to(dtype)
        gate(torch, f"K1 packed_attention qkv ({B}, 192, 1152) {str(dtype).split('.')[-1]} "
             f"on the {kernel_path(192, 64, dtype)}",
             packed_attention(qkv, 6), packed_attention_reference(qkv, 6), phase=1)

    t0 = time.perf_counter()
    for R in (64 * 17, 17 * 3 + 5):
        z = torch.randn(R, 3072, generator=g, device=dev) / 0.5
        out = sparsemax_rows(z)
        torch.cuda.synchronize()
        if R == 64 * 17:
            say(f"phase 1: K2 Triton compile + first launch {time.perf_counter() - t0:.2f} s")
        err = (out - sparsemax_reference(z)).abs().max().item()
        sum_err = (out.sum(-1) - 1.0).abs().max().item()
        say(f"phase 1: K2 sparsemax ({R}, 3072) float32: max_abs_err {err:.3e} "
            f"(tolerance {K2_TOL:g}), row-sum err {sum_err:.3e} ({K2_SUM_TOL:g})")
        check(err <= K2_TOL, f"K2 R={R} error {err}")
        check(sum_err <= K2_SUM_TOL, f"K2 R={R} row sums off by {sum_err}")

    # ---------------------------------------------------------------- phase 2
    block = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())["model"]
    cfg = ModelConfig(**block)
    check(cfg.attn_impl == "fused", "flagship config does not select kernel K1")
    model = build_model(cfg, dev, seed=0)
    # Keypoints are further compared only where the convolved map's top-2
    # margin exceeds MARGIN.
    peak_heatmap_branch(torch, model)
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
    # K1 forward and K2 at the shapes of a batch of 256 (serving and the
    # training step alike), gated against their plain versions, then timed.
    qkv = torch.randn(SERVE_BATCH, 192, 1152, generator=g, device=dev).to(torch.bfloat16)
    k1_err_main = gate(torch, f"K1 packed_attention qkv ({SERVE_BATCH}, 192, 1152) bfloat16 "
                       f"on the {kernel_path(192, 64, torch.bfloat16)}",
                       packed_attention(qkv, 6), packed_attention_reference(qkv, 6), phase=3)
    k1_ms, k1_plain_ms = paired_ms(
        torch, lambda: packed_attention(qkv, 6),
        lambda: packed_attention_reference(qkv, 6), iters=20)
    z = torch.randn(SERVE_BATCH * K, H * W, generator=g, device=dev) / 0.5
    k2_err_main = gate(torch, f"K2 sparsemax ({SERVE_BATCH * K}, {H * W}) float32",
                       sparsemax_rows(z), sparsemax_reference(z), phase=3, bound=K2_TOL)
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

    # ---------------------------------------------------------------- phase 4
    phase4_k1_backward(torch, dev, g)

    # ---------------------------------------------------------------- phase 5
    train = phase5_training(torch, dev, card, profile="--profile" in sys.argv[1:])

    kernels = [
        dict(name="K1 packed_attention forward", route="cuda",
             source="probpose_pytorch_tpu_torch/csrc/packed_attention.cu",
             replaces="probpose_pytorch_tpu/ops/pallas/attention_kernel.py:120",
             launches=train["k1f"], max_abs_err=k1_err_main,
             ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="K1 packed_attention backward", route="cuda",
             source="probpose_pytorch_tpu_torch/csrc/packed_attention.cu",
             replaces="probpose_pytorch_tpu/ops/pallas/attention_kernel.py:146",
             launches=train["k1b"], max_abs_err=train["k1b_err"],
             ms=train["k1b_ms"], plain_ms=train["k1b_plain_ms"]),
        dict(name="K2 sparsemax", route="triton",
             source="probpose_pytorch_tpu_torch/ops/kernels/sparsemax.py",
             replaces="probpose_pytorch_tpu/ops/pallas/sparsemax_kernel.py:29",
             launches=train["k2"], max_abs_err=k2_err_main,
             ms=k2_ms, plain_ms=k2_plain_ms),
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
