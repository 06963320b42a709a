#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path, training step and evaluation
(probpose_pytorch_tpu_torch) end to end at the full ViT-S flagship width,
with weights drawn from a seeded generator:

  phase 0  card name and power limit; TF32 off; nvcc build of csrc/*.cu with
           its -Xptxas -v register / shared-memory report (no spills in K2
           or K3)
  phase 1  each hand-written kernel against its plain PyTorch version at the
           flagship shapes (K1 packed attention: bf16 on the short wgmma
           forward of csrc/tiled_attention_sm90.cu, f32 on K1's CUDA cores;
           K2 sparsemax, csrc/sparsemax.cu), plus ragged cases, the short
           forward's other head widths and K2's adversarial rows (every
           element a candidate, ties at the max), bit-identical twice
  phase 2  a TopDownPredictor answers requests of 1, 8 and 64 crops; every
           output is checked for shape and finiteness, the kernels' launch
           counters must show 12 short attention forwards (and no K1
           CUDA-core launch) and 1 K2 launch per
           forward, and a float32 rerun through the kernels must agree with
           the same run through the plain versions
  phase 3  K1 forward and K2 (random and adversarial rows) against their
           plain versions at the shapes of a batch of 256; then numbers,
           printed and not gated: per-kernel
           time against the plain version (CUDA events) and, for attention,
           against scaled_dot_product_attention (medians of three windows
           of 50 launches in turns) and against K4's tiled forward, serving
           crops/s at a batch of 256, peak device memory; K3 (the fused decode, which no path calls) on the
           heatmaps of that batch against the plain decode
  phase 4  K1's backward (bf16: K4's wgmma backward from the short forward's
           saved out and lse) against its plain versions at the flagship
           shapes (bf16, f32, a ragged batch), bit-identical across two
           runs, and torch.autograd.grad through packed_attention against
           the plain path
  phase 5  the flagship training step through Trainer (augmentation off): a
           float32 step through the kernels against the same step through
           the plain versions (loss terms, grad_norm, per-leaf gradients,
           params); Trainer.fit for 20 bf16 steps at a batch of 256, whose
           losses must be finite and fall, with 12 short attention forwards,
           12 attention backwards that read the saved out and lse (no
           forward of their own, no K1 CUDA-core launch) and 1
           K2 launch per step; K1 backward against its plain versions at
           that batch, on K1B_SEEDS draws; then, not gated, the K1 backward
           time against the
           library's, step time, crops/s, a per-stage split (CUDA events)
           and peak device memory
  phase 6  ViT-B with mlp_impl="fused" (configs/vitb_coco.json, full width
           and depth) served at a batch of 256: requests of 1, 8 and 64
           crops with 12 short attention forwards, 12 K5 forward and 1 K2
           launch per forward; the
           same weights with attn_impl="pallas" launch K6 instead of K1 and
           give the same keypoints; K5 forward (bf16 on the wgmma kernels of
           csrc/fused_mlp_sm90.cu) and K6 against their plain versions at
           the batch's shapes (and a ragged K5 case); then, not gated, K5,
           K6 and ViT-B's K1 against their plain versions, the dense
           half-block (cuBLAS) and scaled_dot_product_attention, serving
           crops/s and peak device memory
  phase 7  that ViT-B trained through Trainer with per-block recompute
           (remat) at its config's batch of 64, augmentation off: a float32
           step through the kernels against the plain step; Trainer.fit for
           10 bf16 steps whose losses are finite and fall, with 24 short
           attention forwards, 12 attention backwards (from the saved out
           and lse), 24 K5 forward, 12 K5 backward and 1 K2 launch per step;
           the K5 backward at that batch against its plain version and,
           within two bf16 ulps, against its plain twin in the kernel's order
           (du rounded, one f32 sum), bit-identical across two runs, and K5
           forward at the step's rows against its plain version; then, not
           gated, their times against the dense half-block's forward and
           backward (cuBLAS), step time, crops/s and peak device memory
  phase 8  the long-sequence path: the flagship configuration on 768 x 768
           inputs (N = 2304 tokens, 192 x 192 heatmaps). K4 forward and
           backward (row-tiled attention; bf16 on wgmma fed by TMA)
           against their plain versions at the path's shapes, at a ragged
           N = 1000 and at N = 77, in bf16 also against the kernel-order
           plain versions (max abs, and normwise per q/k/v slice within
           2**-7); the backward bit-identical across two runs and
           whether it reads the forward's saved (out, lse) or makes them;
           K2 at 36,864-pixel rows (random, a ragged count, adversarial)
           and at 65,536-pixel ones; K3 (the fused decode) on phase 3's
           served heatmaps and on this path's, its bound counting the
           band products the function needs.
           A TopDownPredictor answers requests of 1, 8 and 64 crops with 12
           K4 forward, 0 K1 and 1 K2 launch per forward, and a float32
           rerun agrees with the plain versions; Trainer.fit takes 10 bf16
           steps at a batch of 32 (12 K4 forward, 12 K4 backward, which
           reads the saved out and lse and runs no forward, 1 K2 per
           step) after a float32 step is held to the plain step as in
           phases 5 and 7; then, not gated, kernel, plain and
           scaled_dot_product_attention times, serving crops/s, step time,
           the stage split and peak device memory

  phase 9  the flagship recipe as shipped (configs/flagship_coco_vits.json:
           full width and depth, bf16, B = 128, its augmentation) through
           the training CLI, twice in this process on the synthetic
           dataset: 3 steps that leave checkpoints/3, then a resume to a
           checkpoint at step 6; the launch counters show K1 forward, K1
           backward and K2 in those steps. The augmented preamble with
           half-body and rotation on, crop and frame mode, B = 16, on the
           card against the CPU with the same draws. Then, not gated: the
           B = 256 frame-mode step with and without augmentation in turns,
           and a save and a restore of the flagship state (the restore
           bit for bit)

  phase 10 evaluation of phase 9's checkpoint (step 6) through the eval CLI
           (python -m probpose_pytorch_tpu_torch.eval.run) on a synthetic
           COCO-format val set (data/synth_coco.py: 160 frames of 480 x
           480), batch 128, three times in this process: plain; with
           --flip-test --calibration --per-joint --dump-predictions; with
           --scale-test 0.9,1.0,1.1. Each summary must carry the JAX CLI's
           keys with finite AP/AR/PCK/AUC in [0, 1]; the launch counters
           must show 12 short attention forwards and 1 K2 launch per model
           forward (F = batches, x 2 with flip, x 3 with three scales);
           --score-predictions on the dumped file must give the second
           run's AP and AR keys exactly; the f32 predictor with flip and
           scale test, through the kernels and through the plain versions,
           must agree within 1e-2 px on well-defined keypoints, and
           predict_stream must equal __call__ batch for batch. Then, not
           gated: each run's wall time and its split, crops/s, the
           predictor's device time per batch and peak device memory. A checkpoint of 6 steps
           scores an AP near 0: the phase checks the path, not accuracy

  phase 11 fine-tuning and checkpoint tooling through the CLIs, from a
           temporary working directory, each shipped config as it is but
           --data-root (a synthetic COCO-format set, data/synth_coco.py):
           the LoRA recipe (configs/lora_finetune_vits.json, 3 steps):
           frozen tensors bit-identical to the seed's, LoRA and head
           tensors moved, 12 short forwards, 12 backwards and 1 K2 a step,
           and an f32 LoRA-only step through the kernels held to the plain
           one as in phase 5; compat.merge_lora on it, the eval CLI on the
           merged checkpoint and the f32 merged predictor against the
           unmerged one within 1e-4; train.average --last 2 over phase 9's
           checkpoints 3 and 6 (the mean bit for bit) and the eval CLI on
           it; the ViT-L teacher's vitl_coco.json run (4 micro-steps, one
           update), then configs/distill_vits_from_vitl.json (3 steps):
           the teacher unchanged, both distillation terms finite, 12 + 24
           short forwards, 12 backwards and 2 K2 a step; the frozen RADIO
           recipe (configs/radio_frozen_vitb.json, 3 steps at B = 64, seed
           weights): the trunk bit-identical, adapter and head moved, 12
           short forwards and no backward a step, and the short forward at
           N = 193 against its plain version. Then, not gated: each
           recipe's step time, the LoRA run's optimizer-state bytes
           against the flagship's, the merge and average CLIs' wall time,
           peak memory with the teacher and the phase's wall time

  phase 12 the serving front ends on phase 9's checkpoint (step 6), bf16
           unless said: predict_frame on a 1080 x 1920 frame at 1, 7, 64
           and 300 boxes over the card's bucket ladder (JAX's keys and
           shapes, finite; 12 short attention forwards, no K1 CUDA-core
           launch and 1 K2 a dispatch, as many dispatches as the buckets
           imply); OKS-NMS on each box given twice ("oks" keeps one of each
           pair, "soft_oks" decays the twin); f32 predict_frame through the
           kernels against the plain versions within KPT_TOL_PX; the HTTP
           server in this process over an f32 MicroBatcher at frame shape
           1080,1920, 8 clients, every reply against the direct predictor
           within KPT_TOL_PX, /healthz, /stats and /metrics; the server CLI
           as a subprocess (--warmup), /healthz and /predict, exit 0 on
           SIGTERM within SERVER_EXIT_S; the inference CLI on a PNG (17
           heatmaps, the overlay, predictions.json against an in-process
           predictor); f32 run_video against run_video_stream on 12 frames
           of 720 x 1280 (track ids equal, keypoints and smoothed keypoints
           within KPT_TOL_PX); the video CLI per frame and at 64 crops a
           dispatch on 60 frames. Then, not gated: predict_frame's times,
           a dispatch's device time at 1 to 512 boxes and the serving
           record's entry derived from it, crop_resize's share and the peak
           memory at bucket 256, the bf16 server under 32 clients x 16
           requests (crops/s, p50/p99, mean batch), the server CLI's start
           and stop, the video CLI's frames/s and the phase's wall time

  phase 13 the remaining shipped recipes and training options, on phase 11's
           synthetic COCO-format set, bf16 unless said:
           configs/simcc_coco_vits.json as shipped (B = 128, its
           augmentation) through the training CLI, 3 steps then a resume
           to 6, with 12 short attention forwards, 12 backwards and no K2 a
           step; its f32 step through the kernels against the plain one;
           the eval CLI on its checkpoint, plain and with --flip-test (no
           K2); predict_frame on a 1080 x 1920 frame at 1, 64 and 256 boxes;
           the f32 predictor with flip test, kernels against plain within
           KPT_TOL_PX; the inference CLI's PNG dump (17 maps of Hb x Wb).
           configs/reference_parity_fieldsynth.json as shipped (B = 32,
           384 x 384, vit-s-timm, 20 keypoints) on a YOLO set this phase
           writes, 3 steps then a resume to 6, with 12 tiled wgmma
           forwards, 12 wgmma backwards and 1 K2 a step (N = 576, d = 32),
           Trainer.validate on its valid split, its f32 step against
           plain; K4 forward and backward at (32, 576, 1152) and K2 at
           (640, 9216) against their plain versions; yolo2coco on the set,
           whose COCOPoseDataset gives YOLOPoseDataset's samples bit for
           bit. The flagship with AdamW, Lion, then Adafactor, on the
           cosine schedule: 3 bf16 steps at B = 64 after an untimed first,
           and for Lion and Adafactor one f32 step against plain; the training CLI with dataset_format "mixed" over the
           COCO-format set and its coco2yolo copy (repeats 1 and 2), 2
           steps. Then, not gated: step times, crops/s, the eval CLI's and
           predict_frame's times, the optimizers' state bytes against
           AdamW's, K4 and K2 times against the library at those shapes,
           and the phase's wall time

  phase 14 the detector and bottom-up family (models/convnet.py, detect/) on
           a generate_coco_synth set the phase writes (32 + 16 frames of 480 x
           480, crowds and unlabeled people included) and phase 9's
           checkpoint, bf16 unless said: the detect CLI (conv-s, 512^2, B =
           16, 3 steps), then with --keypoints 17 --kpt-heatmaps, finite
           losses, detector.json and the checkpoint, which load_detector and
           load_bottomup restore bit for bit; the f32 bottom-up model's maps
           on the card against the CPU (normwise 1e-5, TF32 off), then
           decode_boxes and decode_poses card against CPU on the same maps
           (equal); an f32 DetectorTrainer step card against CPU (256^2, B =
           2); the eval CLI with --detector (threshold 0: 12 short K1
           forwards and 1 K2 a pose forward) and with --bottomup (no
           kernel); TopDownPredictor(detector=).predict_frame and
           FusedTwoStagePredictor (8 slots) on 1080 x 1920 frames, f32 fused
           slots against the two-stage poses and the fused kernels against
           the plain versions within KPT_TOL_PX, the fused device path under
           torch.cuda.set_sync_debug_mode("error"), bf16 launches; the
           server in process with a detector, a bottom-up and a fused model;
           the video CLI with --detector, --detector --fused and --bottomup;
           the flagship's ProbMap model on a conv-s trunk at 1, 8 and 64
           crops (0 K1, 1 K2 a forward; f32 kernels vs plain); `python -m
           probpose_pytorch_tpu_torch.doctor` exits 0. Then, not gated: the
           detector's and bottom-up model's step at B = 16, 512^2, their
           serving frames/s, two-stage against fused frames/s at 1080p in
           turns, the conv-s pose model's crops/s, peak memory and the
           phase's wall time

  phase 15 the serving bundles and the native data plane, bf16, on phase
           9's checkpoint, phase 14's detector runs and 1088 x 1920
           frames: the export CLI writes a pose bundle (buckets 1 and 64,
           with the frame-indexed program), an eval bundle (64 crops of
           256 x 192), a detector, a bottom-up and a fused bundle (8
           slots); export_predictor_bundle a ViT-B (configs/vitb_coco.json
           with the fused MLP, phase 6's random weights) and a 768 x 768
           bundle at bucket 8; every program's graph holds the probpose::
           ops it should (12 short K1 forwards and 1 K2 in a pose program,
           plus 12 K5 at ViT-B, 12 K4 forwards at 768^2, none in the
           detector's and the bottom-up model's); a fresh process with
           none of the port's models, train, detect.model, codec or
           inference modules loaded serves each bundle, with 12 K1 and 1
           K2 launches a pose program call, and its outputs equal the live
           predictors' within KPT_TOL_PX and PROB_TOL (TF32 off on both
           sides); the pose bundle's dispatch under
           set_sync_debug_mode("error"); predict_frame at 1, 64 and 256
           boxes, bundle against live in turns; the eval CLI with --bundle
           on phase 10's set (320 instances, batch 64), its summary equal
           to the live checkpoint's; the server CLI with --bundle (crops/s,
           p50/p99); the video CLI with --bundle --stream-batch 64
           (frames/s). Then the native data plane: its build report (the
           JPEG half where jpeglib.h is found), crop_resize_batch against
           crop_resize(..., "bilinear_gather") on the card within one
           uint8 level, the JPEG half against PIL's decode where built,
           native against PIL crops/s on the same records (a PNG copy of
           phase 11's set without the JPEG half), and the training CLI
           for 2 steps with resample="native"

`--attention-times` runs no phase: it times packed_attention's forward and
its backward through autograd at the phases' attention shapes against
scaled_dot_product_attention (medians of three windows of 50, in turns),
one JSON line per shape, with the package beside this script. It uses only
packed_attention, so a copy of this script in another commit's checkout
times that commit on the same card.

`--profile` adds torch.profiler tables of three bf16 flagship training steps,
three ViT-B serving batches, three ViT-B training steps, and three 768 x 768
serving batches and training steps.

Every failure ends the run with a non-zero exit and no result line. The
last three lines are the card's name and power limit, a JSON summary of
the kernels (launches on the main paths and, as `eval_launches`, in phase
10's three eval runs, as `finetune_launches`, in each of phase 11's runs,
as `frontend_launches`, summed over phase 12's runs, as
`phase13_launches`, in each of phase 13's runs, as `phase14_launches`,
in each of phase 14's counted runs, and as `phase15_launches`, in each
bundle call and bundle CLI run of phase 15; K4's entries carry its
numbers at the fieldsynth step's shape and K2's at its rows), error against the
plain version, times, and the
least time the card could take, `bound_ms`, from the H100 SXM's published
peaks) and {"ok": true, "device": {...}}.

Nothing of JAX is imported: the port stands alone on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
VITB_SERVE_BATCH = 256
VITB_TRAIN_STEPS = 10
VITB_F32_BATCH = 8
IMG_768 = (768, 768)
SERVE_768_BATCH = 64
TRAIN_768_BATCH = 32
TRAIN_768_STEPS = 10
F32_768_BATCH = 2
K3_PX_TOL = 1e-3  # K3 against the plain decode, px
# Draws of K1's backward gate at the flagship step's shape (phase 5). With
# D = rowsum(dO * O) it sat one bf16 ulp of the largest gradients from the
# TPU-order plain version and two on one of these draws, past the bound;
# one draw says little about the margin.
K1B_SEEDS = tuple(range(3, 11))
K3_VAL_TOL = 1e-6  # and the raw values it reads
# K2's rows beside the random ones: every element a candidate (within 1 of
# the max, so the candidate buffer overflows past 1,024 or 4,096 and the
# bisection runs over the whole row), and ties at the max.
K2_ROWS = ("random", "all candidates", "ties")
# Phase 9: the augmented preamble on the card against the CPU. Crop mode
# has no bf16 product; frame mode's crop_resize rounds to bf16 and cuBLAS
# sums in another order, so its crops may differ by one bf16 ulp of a value
# <= 1 scaled by up to 1 + contrast.
AUG_CROP_TOL = 1e-5
AUG_FRAME_TOL = 2.0**-7
AUG_KPT_TOL_PX = 1e-3
AUG_HEATMAP_TOL = 1e-5
AUG_BATCH = 16
RECIPE_STEPS = 3
# Phase 10: the eval CLI on phase 9's checkpoint, at the flagship's
# val_batch_size.
EVAL_BATCH = 128
EVAL_SCALES = (0.9, 1.0, 1.1)
EVAL_F32_CROPS = 32
# The summary keys of the JAX eval CLI's line (probpose_pytorch_tpu/eval/
# run.py): the ten COCO keypoint stats, then EPE, PCK@0.2 and AUC.
EVAL_AP_KEYS = ("AP", "AP50", "AP75", "AR", "AR50", "AR75", "AP_medium", "AP_large",
                "AR_medium", "AR_large")
EVAL_KEYS = EVAL_AP_KEYS + ("EPE", "PCK@0.2", "AUC")
EVAL_CAL_KEYS = tuple(f"{k}_{b}" for b in ("presence", "visibility")
                      for k in ("ece", "mce", "brier", "nll", "temperature"))
# Phase 11: the fine-tuning recipes through the CLIs on a synthetic
# COCO-format set of FT_TRAIN_IMAGES + FT_VAL_IMAGES frames (at least one
# batch of 128 to train on).
FT_TRAIN_IMAGES = 80
FT_VAL_IMAGES = 40
FT_STEPS = 3
FT_TIMED_STEPS = 5
# The f32 merged predictor against the unmerged one: JAX's bound for the
# merge (tests/test_lora.py), on outputs and well-defined keypoints (px).
MERGE_TOL = 1e-4
# Phase 12: the serving front ends on phase 9's checkpoint at camera frames.
FRAME_HW = (1080, 1920)
FRAME_BOX_COUNTS = (1, 7, 64, 300)
NMS_PAIRS = 7
SERVER_CLIENTS = 8
SERVER_REQUESTS = 3  # each client's, gated against the direct predictor
LOAD_CLIENTS = 32
LOAD_REQUESTS = 16
MAX_REQUEST_BOXES = 12
SWEEP_BATCHES = tuple(2**i for i in range(10))  # 1 .. 512
THROUGHPUT_BATCHES = (64, 128, 256, 512)
VIDEO_HW = (720, 1280)
VIDEO_PEOPLE = 6
VIDEO_F32_FRAMES = 12
VIDEO_F32_BATCH = 16
VIDEO_CLI_FRAMES = 60
VIDEO_CLI_BATCH = 64
SERVER_EXIT_S = 30
# Where Trainer.fit writes metrics and checkpoints in this run (under
# TMPDIR; removed at the end).
RUN_DIR = Path(tempfile.gettempdir())
# H100 SXM at 700 W, NVIDIA's data sheet: device memory bytes/s, and dense
# operations/s by type (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: float, ops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """The least time the card could take for a call: the larger of the
    bytes it must move (each input read once, each output written once)
    over the memory rate, and its operations over the peak rate of their
    type. Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_wrappers():
    """name -> the wrapper whose `launches` counts that kernel."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        fused_attention,
        packed_attention,
        packed_attention_backward,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        short_forward,
        tiled_attention,
        tiled_attention_backward,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.decode import expected_value_decode_fused
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import fused_ln_mlp, fused_ln_mlp_backward
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_rows

    # k1f / k1b: K1's CUDA-core kernels (f32, other head widths); k1s: K1's
    # bf16 forward for N <= 256 on wgmma; k4f / k4b: the tiled wgmma (or
    # f32) kernels, whose backward is also K1's bf16 backward.
    return dict(k1f=packed_attention, k1b=packed_attention_backward, k1s=short_forward,
                k2=sparsemax_rows, k3=expected_value_decode_fused, k4f=tiled_attention,
                k4b=tiled_attention_backward, k5f=fused_ln_mlp, k5b=fused_ln_mlp_backward,
                k6=fused_attention)


def reset_counts() -> None:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["k4b"].recomputes = 0


def read_counts() -> dict:
    """Launches per kernel, and `k4b_recomputes`, the forward kernels that
    the bf16 backward ran itself because it was given no saved out/lse."""
    wrappers = kernel_wrappers()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    counts["k4b_recomputes"] = wrappers["k4b"].recomputes
    return counts


def check_attention_route(counts: dict, forwards: int, backwards: int, phase: int) -> None:
    """The bf16 N = 192 attention of a phase's main path: `forwards` short
    wgmma forwards and `backwards` wgmma backwards that read the saved
    (out, lse), no K1 CUDA-core kernel, no tiled forward."""
    say(f"phase {phase}: attention launches: short forward {counts['k1s']} (expect "
        f"{forwards}), backward {counts['k4b']} (expect {backwards}) with "
        f"{counts['k4b_recomputes']} forwards of its own (expect 0); K1 CUDA cores "
        f"{counts['k1f']} forward, {counts['k1b']} backward, tiled forward {counts['k4f']} "
        "(expect 0 each)")
    check(counts["k1s"] == forwards, "the short forward did not run once per block")
    check(counts["k4b"] == backwards, "the attention backward did not run once per block")
    check(counts["k4b_recomputes"] == 0, "the attention backward ran a forward of its own")
    check(counts["k1f"] == counts["k1b"] == counts["k4f"] == 0,
          "the bf16 N = 192 trunk ran K1's CUDA cores or the tiled forward")


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


# Normwise relative bound of bf16 K4 against its kernel-order plain version,
# per q/k/v slice of dqkv: two bf16 ulps of the slice's norm.
ONLINE_REL_TOL = 2 * 2**-8


def rel_gate(torch, label: str, out, ref, parts: int, phase: int) -> list[float]:
    """||out - ref|| / ||ref|| of each of `parts` equal slices of the last
    axis (dq, dk, dv of a packed dqkv), each within ONLINE_REL_TOL. A wrong
    D = rowsum(dO * O) in K4's backward (dropped, or read from another row
    or head) moves the dQ slice by more than 8x this at N = 2304, and a sum
    taken in another order by far less (tests/test_torch_tiled.py)."""
    torch.cuda.synchronize()
    pairs = list(zip(out.float().chunk(parts, -1), ref.float().chunk(parts, -1)))
    rels = [((o - r).norm() / r.norm()).item() for o, r in pairs]
    say(f"phase {phase}: {label}: normwise relative error per slice "
        f"{', '.join(f'{e:.3e}' for e in rels)} (bound {ONLINE_REL_TOL:.3e} each; max |ref| "
        f"{', '.join(f'{r.abs().max().item():.4f}' for _, r in pairs)})")
    check(all(np.isfinite(rels)) and max(rels) <= ONLINE_REL_TOL, f"{label}: {rels}")
    return rels


def k2_rows(torch, g, R: int, N: int, rows: str):
    """(R, N) float32 rows of one of K2_ROWS on the card."""
    dev = torch.device("cuda")
    if rows == "all candidates":
        return torch.rand(R, N, generator=g, device=dev)
    z = torch.randn(R, N, generator=g, device=dev) / 0.5
    if rows == "ties":
        z[:, :: max(1, N // 7)] = z.amax(dim=-1, keepdim=True)
    return z


def k2_check(torch, z, label: str, phase: int) -> float:
    """K2 on rows z against its plain version (K2_TOL), on the simplex, and
    bit-identical across two launches; returns the max abs error. A row may
    sum from 1 by K2_SUM_TOL, or by one ulp of tau (2**-23 max(1, |max z|))
    for each element of its support where that is more: every output z -
    tau carries tau's rounding, and the plain version's rows of 65,536
    pixels all within 1 of the max sum 1.04e-5 from 1."""
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
        sparsemax_reference,
        sparsemax_rows,
    )

    out, again = sparsemax_rows(z), sparsemax_rows(z)
    err = gate(torch, f"K2 sparsemax {tuple(z.shape)} float32, {label}", out,
               sparsemax_reference(z), phase=phase, bound=K2_TOL)
    ulps = (out > 0).sum(-1) * 2.0**-23 * z.abs().amax(-1).clamp_min(1.0)
    sum_err = (out.sum(-1) - 1).abs()
    say(f"phase {phase}: K2 {tuple(z.shape)}, {label}: row-sum err {sum_err.max().item():.3e} "
        f"(bound {K2_SUM_TOL:g}, or {ulps.max().item():.3e} by the support's size)")
    check(bool((sum_err <= ulps.clamp_min(K2_SUM_TOL)).all()), f"K2 {label}: row sums off")
    check(torch.equal(out, again), f"K2 {tuple(z.shape)} {label} differs between launches")
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


def yardstick_ms(torch, kernel_fn, lib_fn, iters: int = 50,
                 windows: int = 3) -> tuple[float, float]:
    """A kernel and the library call that computes its function, timed in
    turns (library, kernel, kernel, library) over `iters` launches each, in
    `windows` windows; returns the medians of the windows' means. A single
    short window of the library's backward read 0.32-0.53 ms over seven
    runs; the median of windows of 50 is the stable yardstick."""
    ks, ls = zip(*(paired_ms(torch, kernel_fn, lib_fn, iters) for _ in range(windows)))
    return float(np.median(ks)), float(np.median(ls))


def sdpa_fwd_fn(torch, qkv, heads: int):
    """F.scaled_dot_product_attention on the q, k, v of a packed (B, N, 3C)
    qkv, as a thunk: the yardstick of K1's forward and K6, timed here and
    never called by the port."""
    q, k, v = qkv.unflatten(-1, (3, heads, -1)).permute(2, 0, 3, 1, 4)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def sdpa_bwd_fn(torch, qkv, dout, heads: int):
    """The backward alone of F.scaled_dot_product_attention on the same q,
    k, v and a contiguous dO (B, heads, N, d), as a thunk: the yardstick of
    K1's backward."""
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.unflatten(-1, (3, heads, -1)).permute(2, 0, 3, 1, 4))
    ctx = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    do = dout.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(ctx, (q, k, v), do, retain_graph=True)


def sdpa_ms(torch, qkv, heads: int) -> float:
    """Time of the library's attention, F.scaled_dot_product_attention, on
    the q, k, v of a packed (B, N, 3C) qkv: the yardstick of K1 and K6,
    timed here and never called by the port."""
    q, k, v = qkv.unflatten(-1, (3, heads, -1)).permute(2, 0, 3, 1, 4)
    return cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                   iters=20)


def peak_heatmap_branch(torch, model, seed: int = 1) -> None:
    """Freshly drawn head convs (std 0.001) give nearly flat heatmaps, whose
    argmax is ill-defined. Redraw the heatmap branch's convs at fan-in
    scale, from a seeded generator, so the maps are peaked."""
    if not hasattr(model.head, "deconvs"):
        return  # the SimCC head: lecun-normal projections, no heatmaps to peak
    hg = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in [*model.head.deconvs, model.head.final]:
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[0] * 4
            w.copy_(torch.randn(w.shape, generator=hg).to(w.device) / fan_in**0.5)


def make_codec(cfg):
    """The ProbMap codec of a model config, as the serving phases use it."""
    from probpose_pytorch_tpu_torch.codec import Codec, ProbMap

    return Codec(ProbMap((cfg.img_size[1], cfg.img_size[0]), tuple(cfg.heatmap_size),
                         sigmas=np.full(cfg.num_keypoints, 0.05, np.float32), sigma=2.0))


def check_answers(cfg, requests, answers, phase: int) -> None:
    """Every field of every answer has its shape and is finite."""
    K = cfg.num_keypoints
    W, H = cfg.heatmap_size
    shapes = dict(keypoints=(K, 2), scores=(K,), probabilities=(1, K),
                  visibilities=(1, K), oks=(1, K), errors=(1, K), heatmaps=(K, H, W))
    for (frames, _), out in zip(requests, answers):
        B = len(frames)
        for key, shape in shapes.items():
            if key in out:
                check(out[key].shape == (B, *shape), f"{key} shape {out[key].shape}")
                check(np.isfinite(out[key]).all(), f"{key} not finite at B={B}")
        say(f"phase {phase}: request of {B} crops answered: keypoints "
            f"{out['keypoints'].shape}, mean score {out['scores'].mean():.4f}, all fields finite")


def well_defined(torch, codec, heatmaps, dev):
    """Mask of the keypoints whose OKS-convolved map has a top-2 margin
    above MARGIN: only there is the argmax, and so the keypoint, stable
    under rounding, and only there are keypoints compared."""
    from probpose_pytorch_tpu_torch.ops.heatmap import oks_conv

    row_op, col_op = codec.probmap.conv_operators(dev)
    conv = oks_conv(torch.from_numpy(heatmaps).to(dev), row_op, col_op).flatten(2)
    top2 = conv.topk(2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]) > MARGIN).cpu().numpy()


def request(seed: int, B: int):
    """uint8 frames (B, 320, 256, 3) and boxes drawn as bench.py draws them."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, 320, 256, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 120, 180], [60, 60, 196, 260], (B, 4)).astype(np.float32)
    return frames, boxes


def phase4_k1_backward(torch, dev, g) -> None:
    """K1's backward against its plain versions at the flagship shapes, as
    the step calls it (bf16: from the short forward's saved out and lse),
    bit-identical across two runs; and autograd through packed_attention."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_backward,
        packed_attention_bwd_reference,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        short_forward,
        tiled_attention_online_bwd_reference,
    )

    for B, dtype in ((64, torch.bfloat16), (64, torch.float32), (3, torch.bfloat16)):
        qkv = torch.randn(B, 192, 1152, generator=g, device=dev).to(dtype)
        dout = torch.randn(B, 192, 384, generator=g, device=dev).to(dtype)
        name = str(dtype).split(".")[-1]
        out, lse = short_forward(qkv, 6, with_lse=True) if dtype == torch.bfloat16 else (None,) * 2
        got = packed_attention_backward(qkv, dout, 6, out, lse)
        again = packed_attention_backward(qkv, dout, 6, out, lse)
        label = (f"K1 backward qkv ({B}, 192, 1152) {name} via "
                 f"{kernel_path(192, 64, dtype, backward=True)}")
        gate(torch, label, got, packed_attention_bwd_reference(qkv, dout, 6), phase=4)
        check(torch.equal(got, again), f"{label} differs between two runs")
        if dtype == torch.bfloat16:
            ref = tiled_attention_online_bwd_reference(qkv, dout, 6, out, lse)
            label = f"{label}, from the saved (out, lse), against the kernel-order plain version"
            gate(torch, label, got, ref, phase=4)
            rel_gate(torch, label, got, ref, 3, phase=4)
    say("phase 4: K1 backward bit-identical across two runs at every shape")
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
        model=dataclasses.replace(cfg.model, compute_dtype=dtype), **fit_outputs("flagship"))


def fit_outputs(name: str) -> dict:
    """TrainConfig fields that keep Trainer.fit's files in this run's
    directory: one checkpoint kept, written after the first epoch and at
    the end only."""
    return dict(out_dir=str(RUN_DIR / name), keep_checkpoints=1, checkpoint_every_epochs=10**6)


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


def f32_step_pair(torch, dev, batch, cfg):
    """Two fresh float32 trainers of `cfg` from the same weights, one step
    each on `batch`: through the kernels, then through the plain versions.
    Returns both trainers, their metrics and the gradients each step
    produced."""
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions

    kern, plain = make_trainer(torch, cfg, dev), make_trainer(torch, cfg, dev)
    gk, gp = [], []
    capture_grads(kern.state, gk)
    capture_grads(plain.state, gp)
    _, mk = kern.train_step(kern.state, kern.device_batch(batch))
    with plain_versions():
        _, mp = plain.train_step(plain.state, plain.device_batch(batch))
    torch.cuda.synchronize()
    return kern, plain, mk, mp, gk[0], gp[0]


def compare_f32_step(torch, dev, batch, lr: float, cfg, phase: int,
                     routed: tuple[str, ...] = (), floor: float = 0.0) -> None:
    """One float32 step of `cfg` through the kernels against the same step
    through the plain versions, from the same weights and batch. cuDNN is
    held to deterministic algorithms and a first, unchecked pair of steps
    settles its choice for these shapes, so both compared steps convolve
    alike and only the kernels differ between them.

    `routed` names leaves (by prefix) whose gradient is routed by a max:
    the head's scalar branches, behind max-pools and a max over the grid.
    Where the trunk's features differ by f32 rounding between the two
    paths (K5 against cuBLAS sums in another order), a window whose top
    two values lie within that rounding sends its gradient to another
    element, and the leaf's gradient jumps. Those leaves run no kernel of
    the port; their gradients are reported, and their params held to
    Adam's first-step bound of 2 lr, but not to the grad tolerance.

    `floor`, a fraction of the largest gradient anywhere, is the least
    grad tolerance of any leaf (0: none). Phase 8 takes one f32 ulp,
    2**-23: K4 in f32 sums in another order than its plain version (K1 in
    f32 equals its plain version bit for bit), and the patch embedding's
    gradients, near-cancelling sums over 2,304 positions a crop, carry
    that rounding at ~1e-4 of their own size, far below an ulp of the
    largest gradient. Every leaf is checked before a failure is raised."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        f32_step_pair(torch, dev, batch, cfg)
        kern, plain, mk, mp, gk, gp = f32_step_pair(torch, dev, batch, cfg)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    for key in mp:
        if key.startswith("loss"):
            a, b = float(mk[key]), float(mp[key])
            say(f"phase {phase}: f32 {key}: kernel {a:.9g}, plain {b:.9g}")
            check(abs(a - b) <= 1e-5 * abs(b) + 1e-12, f"f32 {key} differs: {a} vs {b}")
    a, b = float(mk["grad_norm"]), float(mp["grad_norm"])
    say(f"phase {phase}: f32 grad_norm: kernel {a:.9g}, plain {b:.9g} (1e-4 relative)")
    check(abs(a - b) <= 1e-4 * abs(b), f"f32 grad_norm differs: {a} vs {b}")
    # The grad tolerance: 1e-4 of the plain gradient's max in each leaf, or,
    # for a leaf whose gradient is rounding noise below 1e-6 of the largest
    # anywhere (head.final.bias, exactly 0 through sparsemax's shift
    # invariance), 1e-6 of that largest. Gradients agree within it, leaf by
    # leaf. Params agree within 1e-6, except elements whose plain gradient
    # is below the grad tolerance (or in a noise leaf): Adam's first step
    # moves those by up to lr whatever their size, so they may differ by 2 lr.
    gmax = max(g.abs().max().item() for g in gp)
    worst, worst_g, worst_routed, loose, n_small = 0.0, 0.0, 0.0, 0, 0
    fails = []
    for name, pk, pp, g, g_k in zip(kern.state.names, kern.state.params, plain.state.params,
                                    gp, gk):
        noise = g.abs().max().item() < 1e-6 * gmax
        gtol = max(1e-6 * gmax if noise else 1e-4 * g.abs().max().item(), floor * gmax)
        g_err = (g_k - g).abs().max().item()
        d = (pk - pp).abs()
        if routed and name.startswith(routed):
            worst_routed = max(worst_routed, g_err / gtol)
            if not bool((d <= 2 * lr).all()):
                fails.append(f"param {name} beyond 2 lr")
            continue
        worst_g = max(worst_g, g_err / gtol)
        if g_err > gtol:
            fails.append(f"grad {name} by {g_err:.4e} (tolerance {gtol:.4e}, leaf max "
                         f"{g.abs().max():.4e})")
        small = (g.abs() < gtol) | noise
        big_err = d[~small].max().item() if (~small).any() else 0.0
        worst = max(worst, big_err)
        if big_err > 1e-6:
            fails.append(f"param {name} by {big_err:.4e}")
        if not bool((d[small] <= 2 * lr).all()):
            fails.append(f"param {name} beyond 2 lr")
        n_small += int(small.sum())
        loose += int((small & (d > 1e-6)).sum())
    check(not fails, f"f32 step differs (largest gradient {gmax:.4e}): " + "; ".join(fails))
    floor_note = f", tolerance floor {floor:.3g} of it" if floor else ""
    say(f"phase {phase}: f32 grads, every leaf within its grad tolerance (worst leaf at "
        f"{worst_g:.3e} of it; largest gradient {gmax:.4e}{floor_note})"
        + (f"; leaves under {', '.join(routed)} (max-routed, not gated): worst at "
           f"{worst_routed:.3e} of it" if routed else ""))
    say(f"phase {phase}: f32 params after one step: max diff {worst:.3e} (bound 1e-6) where "
        f"the gradient is above the grad tolerance; {loose} of {n_small} elements under "
        f"it moved by more than 1e-6 (allowed 2 lr = {2 * lr:.3e})")


def profile_window(torch, card: str, label: str, fn, runs: int = 3) -> None:
    """torch.profiler over `runs` calls of fn: wall time, device busy time
    and idle share, and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    say(f"profile [{card}]: {label}, wall {wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
        f"in {len(kernels)} kernels (idle share {1 - busy_ms / (wall * 1e3):.3f})")
    say(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))


def stage_split(torch, card: str, trainer, db, phase: str, label: str) -> None:
    """CUDA-event time of each stage of a train step, mean of 5 steps."""
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
    say(f"{phase} [{card}]: {label} split (CUDA events, mean of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in totals.items())
        + f"; sum {sum(totals.values()):.3f} ms")


def phase5_training(torch, dev, card: str, profile: bool) -> dict:
    """The training step at full ViT-S width; returns the main path's
    launch counts and the K1 backward times."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention_backward,
        packed_attention_bwd_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        short_forward,
        tiled_attention_online_bwd_reference,
    )

    cfg = train_config("bfloat16", TRAIN_BATCH)
    H, W = cfg.model.img_size
    t0 = time.perf_counter()
    ds = SyntheticPoseDataset(TRAIN_BATCH, (H, W), cfg.model.num_keypoints, seed=0)
    batch = next(iter(batch_iterator(ds, TRAIN_BATCH, num_workers=8)))
    say(f"phase 5: synthetic batch of {TRAIN_BATCH} crops made in "
        f"{time.perf_counter() - t0:.2f} s")
    trainer = make_trainer(torch, cfg, dev)
    lr0 = float(trainer.tx.schedule(torch.zeros((), dtype=torch.int32, device=dev)))
    compare_f32_step(torch, dev, {k: v[:F32_TRAIN_BATCH] for k, v in batch.items()}, lr0,
                     train_config("float32", F32_TRAIN_BATCH), phase=5)

    # The main path: Trainer.fit on the fixed batch, bf16.
    depth = len(trainer.model.backbone.blocks)
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(lambda: iter([batch]), max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 5: Trainer.fit, {TRAIN_STEPS} bf16 steps at B={TRAIN_BATCH} in "
        f"{fit_s:.2f} s; loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    say(f"phase 5: launches over {TRAIN_STEPS} steps: K2 {counts['k2']} "
        f"(expect {TRAIN_STEPS})")
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} steps logged")
    check(all(np.isfinite(losses)), "a bf16 training loss is not finite")
    check(losses[-1] < losses[0], "the total loss did not fall over the fixed batch")
    check_attention_route(counts, depth * TRAIN_STEPS, depth * TRAIN_STEPS, phase=5)
    check(counts["k2"] == TRAIN_STEPS, "K2 did not run once per step")
    check(counts["k5f"] == counts["k5b"] == counts["k6"] == 0, "the dense trunk ran K5 or K6")

    # K1 backward at the main path's shape, as the step calls it (from the
    # short forward's saved out and lse), gated against its plain versions
    # on each of K1B_SEEDS draws and rerun for the same bits; then numbers,
    # not gated, on the last draw.
    k1b_err = k1b_online_err = 0.0
    ratios = []
    for seed in K1B_SEEDS:
        g = torch.Generator(device=dev).manual_seed(seed)
        qkv = torch.randn(TRAIN_BATCH, 192, 1152, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(TRAIN_BATCH, 192, 384, generator=g, device=dev).to(torch.bfloat16)
        out, lse = short_forward(qkv, 6, with_lse=True)
        got = packed_attention_backward(qkv, dout, 6, out, lse)
        label = (f"K1 backward qkv ({TRAIN_BATCH}, 192, 1152) bf16 via "
                 f"{kernel_path(192, 64, torch.bfloat16, backward=True)}, seed {seed}")
        ref = packed_attention_bwd_reference(qkv, dout, 6)
        err = gate(torch, label, got, ref, phase=5)
        ratios.append(err / k1_bound(ref))
        check(torch.equal(got, packed_attention_backward(qkv, dout, 6, out, lse)),
              f"{label} differs between two runs")
        ref = tiled_attention_online_bwd_reference(qkv, dout, 6, out, lse)
        online_err = gate(torch, f"{label} against the kernel-order plain version", got, ref,
                          phase=5)
        k1b_err, k1b_online_err = max(k1b_err, err), max(k1b_online_err, online_err)
        del got, ref
    say(f"phase 5: K1 backward at B={TRAIN_BATCH} over {len(K1B_SEEDS)} draws: error / bound "
        f"against the TPU-order plain version {', '.join(f'{r:.3f}' for r in ratios)} "
        f"(max {max(ratios):.3f})")
    kernel = lambda: packed_attention_backward(qkv, dout, 6, out, lse)
    _, k1b_plain_ms = paired_ms(torch, kernel,
                                lambda: packed_attention_bwd_reference(qkv, dout, 6), iters=10)
    # The library's attention backward on the same q, k, v and dO (timed
    # only; the port never calls it).
    k1b_ms, k1b_lib_ms = yardstick_ms(torch, kernel, sdpa_bwd_fn(torch, qkv, dout, 6))
    # The function needs qkv and dO in and dqkv out (this design also reads
    # the saved context and lse, which its bound does not count); five
    # products of 2 N^2 d per (b, h): S, dP, dQ, dK, dV.
    k1b_bound = bound_ms(nbytes(qkv, dout, qkv), 10 * TRAIN_BATCH * 6 * 192**2 * 64)
    say(f"phase 5 [{card}]: K1 backward qkv ({TRAIN_BATCH}, 192, 1152) bf16, out and lse "
        f"saved: kernel {k1b_ms:.4f} ms, plain {k1b_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention backward {k1b_lib_ms:.4f} ms (medians of 3 windows "
        f"of 50, in turns), bound {k1b_bound[0]:.4f} ms ({k1b_bound[1]})")
    del qkv, dout, out, lse

    db = trainer.device_batch(batch)
    for _ in range(2):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    gc.collect()  # drop earlier checks' objects held by reference cycles
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

    stage_split(torch, card, trainer, db, "phase 5", "bf16 step")

    if profile:
        profile_window(torch, card, "3 bf16 flagship train steps",
                       lambda: trainer.train_step(trainer.state, db))
    return dict(counts, k1b_err=k1b_err, k1b_ms=k1b_ms, k1b_plain_ms=k1b_plain_ms,
                k1b_lib_ms=k1b_lib_ms, k1b_bound=k1b_bound, k1b_online_err=k1b_online_err)


def vitb_train_config(dtype: str, batch: int | None = None):
    """configs/vitb_coco.json with mlp_impl="fused" (kernel K5) and
    augmentation off, at `dtype` and `batch` (the config's own by default),
    logging every step. The config trains with remat."""
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig.load(REPO / "configs/vitb_coco.json")
    return dataclasses.replace(
        cfg, augment=None, train_batch_size=batch or cfg.train_batch_size, log_every=1,
        resume=False, model=dataclasses.replace(cfg.model, compute_dtype=dtype, mlp_impl="fused"),
        **fit_outputs("vitb"))


def mlp_inputs(torch, block, R: int, g, dev):
    """K5's arguments at R rows as a ViT block passes them: x drawn from
    `g` in bf16, norm2's f32 scale and bias, the fc weights cast to bf16
    (transposed views) and the f32 fc biases."""
    dt = torch.bfloat16
    x = torch.randn(R, block.norm2.normalized_shape[0], generator=g, device=dev).to(dt)
    fc1, fc2 = block.mlp.fc1, block.mlp.fc2
    return tuple(t.detach() for t in (x, block.norm2.weight, block.norm2.bias,
                                      fc1.weight.to(dt).t(), fc1.bias,
                                      fc2.weight.to(dt).t(), fc2.bias))


def dense_half_block(torch, x, scale, bias, w1, b1, w2, b2):
    """K5's yardstick: the same half-block as PyTorch's dense operators on
    cuBLAS, all in x's dtype (timed only; the port never runs it on the
    fused path)."""
    F = torch.nn.functional
    y = F.layer_norm(x, x.shape[-1:], scale, bias, 1e-6)
    return x + F.linear(F.gelu(F.linear(y, w1.t(), b1), approximate="tanh"), w2.t(), b2)


def dense_fwd_fn(torch, a):
    """The dense half-block on K5's arguments `a`, all cast to x's dtype, as
    a thunk: the yardstick of K5 forward."""
    dense = (a[0], *(t.to(a[0].dtype) for t in a[1:]))
    return lambda: dense_half_block(torch, *dense)


def dense_bwd_fn(torch, a, dout):
    """The backward alone of the dense half-block on K5's arguments `a` (cast
    to x's dtype) and dout, through torch.autograd.grad, as a thunk: the
    yardstick of K5 backward."""
    leaves = [t.detach().to(a[0].dtype).requires_grad_(True) for t in a]
    with torch.enable_grad():
        out = dense_half_block(torch, *leaves)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def k5_grad_bound(ref) -> float:
    """K5 backward's bound, relative to each cotangent's magnitude: four bf16
    ulps (4 * 2**-8) of max|ref|. The kernel's tensor-core products take du
    rounded to bf16 where the plain version keeps it f32, and dy, dW1 and
    dW2 are rounded to bf16 after sums in another order."""
    return 4 * 2**-8 * ref.float().abs().max().item()


def phase6_vitb_serving(torch, dev, card: str, g, profile: bool) -> dict:
    """ViT-B with the fused MLP served at a batch of 256; returns the
    serving runs' launch counts and K5 forward's and K6's numbers."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        fused_attention,
        fused_attention_reference,
        packed_attention,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import fused_ln_mlp, fused_ln_mlp_reference

    cfg = vitb_train_config("bfloat16").model
    check(cfg.backbone == "vit-b" and cfg.attn_impl == "fused", "vitb_coco.json changed")
    model = build_model(cfg, dev, seed=0)
    peak_heatmap_branch(torch, model)
    codec = make_codec(cfg)
    predictor = TopDownPredictor(model, codec, cfg.img_size, return_heatmaps=True)
    requests = [request(10 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    depth, n = len(model.backbone.blocks), len(requests)

    # The main path: a TopDownPredictor over ViT-B with the fused MLP.
    reset_counts()
    answers = [predictor(frames, boxes) for frames, boxes in requests]
    torch.cuda.synchronize()
    counts = read_counts()
    check_answers(cfg, requests, answers, phase=6)
    say(f"phase 6: launches over {n} ViT-B forwards: K5 forward {counts['k5f']} (expect "
        f"{depth * n}), K2 {counts['k2']} (expect {n}), K6 {counts['k6']} (expect 0)")
    check_attention_route(counts, depth * n, 0, phase=6)
    check(counts["k5f"] == depth * n, "K5 did not run once per ViT-B block")
    check(counts["k2"] == n and counts["k6"] == 0, "K2 or K6 count off")

    # The same weights with attn_impl="pallas": K6 in place of K1.
    model6 = build_model(dataclasses.replace(cfg, attn_impl="pallas"), dev)
    model6.load_state_dict(model.state_dict())
    pred6 = TopDownPredictor(model6, codec, cfg.img_size, return_heatmaps=True)
    reset_counts()
    answers6 = [pred6(frames, boxes) for frames, boxes in requests]
    torch.cuda.synchronize()
    counts6 = read_counts()
    check_answers(cfg, requests, answers6, phase=6)
    say(f"phase 6: attn_impl='pallas', launches over {n} forwards: K6 {counts6['k6']}, K5 "
        f"forward {counts6['k5f']} (expect {depth * n} each), K1 {counts6['k1s']} short, "
        f"{counts6['k1f']} CUDA cores (expect 0 each)")
    check(counts6["k6"] == depth * n and counts6["k5f"] == depth * n, "K6 or K5 count off")
    check(counts6["k1f"] == counts6["k1s"] == 0, "attn_impl='pallas' ran K1")
    for (frames, _), a, b in zip(requests, answers, answers6):
        sel = well_defined(torch, codec, a["heatmaps"], dev)
        kerr = float(np.abs(a["keypoints"] - b["keypoints"])[sel].max(initial=0.0))
        say(f"phase 6: K6 vs K1 serving, {len(frames)} crops: keypoint max diff {kerr:.3e} px "
            f"over {int(sel.sum())}/{sel.size} well-defined keypoints (tolerance {KPT_TOL_PX:g})")
        check(sel.mean() > 0.5, "too few ViT-B keypoints with a well-defined argmax")
        check(kerr <= KPT_TOL_PX, f"K6 keypoints differ from K1's by {kerr} px")
    del model6, pred6, answers, answers6

    # K5 forward and K6 at the shapes of a batch of 256, gated, then timed.
    blk = model.backbone.blocks[0]
    B, N = VITB_SERVE_BATCH, model.backbone.pos_embed.shape[1]
    C, Hd, heads = blk.mlp.fc1.in_features, blk.mlp.fc1.out_features, blk.attn.num_heads
    rows = B * N
    with torch.inference_mode():
        for R in (rows, 3 * N + 7):  # the batch's rows; a ragged last tile
            a = mlp_inputs(torch, blk, R, g, dev)
            err = gate(torch, f"K5 forward x ({R}, {C}) bf16, hidden {Hd}", fused_ln_mlp(*a),
                       fused_ln_mlp_reference(*a), phase=6)
            if R == rows:
                k5f_err = err
        a = mlp_inputs(torch, blk, rows, g, dev)
        k5f_ms, k5f_plain_ms = paired_ms(torch, lambda: fused_ln_mlp(*a),
                                         lambda: fused_ln_mlp_reference(*a), iters=10)
        k5f_lib_ms = cuda_ms(torch, dense_fwd_fn(torch, a), iters=10)
        k5f_bound = bound_ms(nbytes(*a, a[0]), 4 * rows * C * Hd)
        say(f"phase 6 [{card}]: K5 forward x ({rows}, {C}) bf16: kernel {k5f_ms:.4f} ms, plain "
            f"{k5f_plain_ms:.4f} ms, dense half-block (cuBLAS) {k5f_lib_ms:.4f} ms, bound "
            f"{k5f_bound[0]:.4f} ms ({k5f_bound[1]})")
        del a

        qkv = torch.randn(B, N, 3 * C, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unflatten(-1, (3, heads, -1)).unbind(2)
        k6_err = gate(torch, f"K6 fused_attention q, k, v {tuple(q.shape)} bf16",
                      fused_attention(q, k, v), fused_attention_reference(q, k, v), phase=6)
        gate(torch, f"K1 (short forward) packed_attention qkv {tuple(qkv.shape)} bf16",
             packed_attention(qkv, heads), packed_attention_reference(qkv, heads), phase=6)
        _, k6_plain_ms = paired_ms(torch, lambda: fused_attention(q, k, v),
                                   lambda: fused_attention_reference(q, k, v), iters=20)
        _, k1_plain_ms = paired_ms(torch, lambda: packed_attention(qkv, heads),
                                   lambda: packed_attention_reference(qkv, heads), iters=20)
        sdpa = sdpa_fwd_fn(torch, qkv, heads)
        k6_ms, attn_lib_ms = yardstick_ms(torch, lambda: fused_attention(q, k, v), sdpa)
        k1_ms, k1_lib_ms = yardstick_ms(torch, lambda: packed_attention(qkv, heads), sdpa)
        attn_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * C)
        say(f"phase 6 [{card}]: K6 q, k, v {tuple(q.shape)} bf16: kernel {k6_ms:.4f} ms, "
            f"plain {k6_plain_ms:.4f} ms, scaled_dot_product_attention {attn_lib_ms:.4f} ms; "
            f"K1 (short forward) on the packed qkv {tuple(qkv.shape)}: kernel {k1_ms:.4f} ms, "
            f"plain {k1_plain_ms:.4f} ms, scaled_dot_product_attention {k1_lib_ms:.4f} ms "
            f"(medians of 3 windows of 50, in turns); bound {attn_bound[0]:.4f} ms "
            f"({attn_bound[1]})")
        del qkv, q, k, v, sdpa

    frames, boxes = request(17, B)
    predictor.return_heatmaps = False
    f_dev = torch.from_numpy(frames).to(dev)
    b_dev = torch.from_numpy(boxes).to(dev)
    predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    gc.collect()  # drop earlier checks' objects held by reference cycles
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    dev_s = (time.perf_counter() - t0) / iters
    say(f"phase 6 [{card}]: ViT-B fused-MLP serving B={B}, frames resident on the card: "
        f"{dev_s * 1e3:.3f} ms/batch = {B / dev_s:.1f} crops/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if profile:
        profile_window(torch, card, f"3 ViT-B fused-MLP serving batches of {B}",
                       lambda: predictor.predict(f_dev, b_dev))
    return dict(k5f_err=k5f_err, k5f_ms=k5f_ms, k5f_plain_ms=k5f_plain_ms,
                k5f_lib_ms=k5f_lib_ms, k5f_bound=k5f_bound, k6=counts6["k6"],
                k6_err=k6_err, k6_ms=k6_ms, k6_plain_ms=k6_plain_ms, k6_lib_ms=attn_lib_ms,
                k6_bound=attn_bound)


def phase7_vitb_training(torch, dev, card: str, profile: bool) -> dict:
    """ViT-B with the fused MLP and remat trained through Trainer at its
    config's batch; returns the launch counts of Trainer.fit and K5
    backward's numbers."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
        fused_ln_mlp,
        fused_ln_mlp_backward,
        fused_ln_mlp_bwd_kernel_order_reference,
        fused_ln_mlp_bwd_reference,
        fused_ln_mlp_reference,
    )

    cfg = vitb_train_config("bfloat16")
    B = cfg.train_batch_size
    H, W = cfg.model.img_size
    ds = SyntheticPoseDataset(B, (H, W), cfg.model.num_keypoints, seed=1)
    batch = next(iter(batch_iterator(ds, B, num_workers=8)))
    trainer = make_trainer(torch, cfg, dev)
    check(trainer.model.backbone.remat, "configs/vitb_coco.json no longer trains with remat")
    lr0 = float(trainer.tx.schedule(torch.zeros((), dtype=torch.int32, device=dev)))
    compare_f32_step(torch, dev, {k: v[:VITB_F32_BATCH] for k, v in batch.items()}, lr0,
                     vitb_train_config("float32", VITB_F32_BATCH), phase=7,
                     routed=("head.branches.",))

    # The main path: Trainer.fit on the fixed batch, bf16, with remat.
    depth, steps = len(trainer.model.backbone.blocks), VITB_TRAIN_STEPS
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(lambda: iter([batch]), max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 7: Trainer.fit, {steps} bf16 ViT-B steps with remat at B={B} in {fit_s:.2f} s; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    say(f"phase 7: launches over {steps} steps: K5 forward {counts['k5f']} (expect "
        f"{2 * depth * steps}: remat runs each block's forward twice), K5 backward "
        f"{counts['k5b']} (expect {depth * steps}), K2 {counts['k2']} (expect {steps})")
    check(len(losses) == steps, f"{len(losses)} steps logged")
    check(all(np.isfinite(losses)), "a bf16 ViT-B training loss is not finite")
    check(losses[-1] < losses[0], "the ViT-B loss did not fall over the fixed batch")
    check_attention_route(counts, 2 * depth * steps, depth * steps, phase=7)
    check(counts["k5f"] == 2 * depth * steps, "K5 forward count off")
    check(counts["k5b"] == depth * steps, "K5 backward count off")
    check(counts["k2"] == steps and counts["k6"] == 0, "K2 or K6 launch count off")

    # K5 backward at the batch's rows, gated per cotangent against the plain
    # version and against its twin in the kernel's order, and rerun for
    # bit-identical gradients; K5 forward at the same rows; then numbers,
    # not gated. The inputs carry no grad, so no call records a graph.
    g = torch.Generator(device=dev).manual_seed(7)
    backbone = trainer.model.backbone
    fc1 = backbone.blocks[0].mlp.fc1
    rows, C, Hd = B * backbone.pos_embed.shape[1], fc1.in_features, fc1.out_features
    a = mlp_inputs(torch, backbone.blocks[0], rows, g, dev)
    dout = torch.randn(rows, C, generator=g, device=dev).to(torch.bfloat16)
    grads = fused_ln_mlp_backward(*a, dout)
    again = fused_ln_mlp_backward(*a, dout)
    refs = fused_ln_mlp_bwd_reference(*a, dout)
    twins = fused_ln_mlp_bwd_kernel_order_reference(*a, dout)
    k5b_err = k5b_twin_err = 0.0
    for name, got, rerun, ref, twin in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"),
                                           grads, again, refs, twins):
        label = f"K5 backward {name} {tuple(got.shape)} {str(got.dtype).split('.')[-1]}, " \
                f"x ({rows}, {C})"
        check(torch.equal(got, rerun), f"K5 backward {name} differs between two runs")
        k5b_err = max(k5b_err, gate(torch, label, got, ref, phase=7, bound=k5_grad_bound(ref)))
        k5b_twin_err = max(k5b_twin_err, gate(
            torch, f"{label} vs the kernel-order twin", got, twin, phase=7,
            bound=2 * 2**-8 * twin.float().abs().max().item()))
    say("phase 7: K5 backward: all seven cotangents bit-identical across two runs")
    del refs, twins
    k5b_ms, k5b_plain_ms = paired_ms(torch, lambda: fused_ln_mlp_backward(*a, dout),
                                     lambda: fused_ln_mlp_bwd_reference(*a, dout), iters=5)
    k5b_lib_ms = cuda_ms(torch, dense_bwd_fn(torch, a, dout), iters=10)
    # inputs x, the vectors, W1, W2 and dO; outputs dx, the vector gradients
    # and dW1, dW2: five products of 2 R C Hd operations (fc1 recomputed,
    # dh, dy, dW1, dW2).
    k5b_bound = bound_ms(nbytes(*a, dout) + nbytes(*grads), 10 * rows * C * Hd)
    say(f"phase 7 [{card}]: K5 backward x ({rows}, {C}) bf16: kernel {k5b_ms:.4f} ms, "
        f"plain {k5b_plain_ms:.4f} ms, dense half-block backward (cuBLAS, autograd) "
        f"{k5b_lib_ms:.4f} ms, bound {k5b_bound[0]:.4f} ms ({k5b_bound[1]})")
    k5f_err = gate(torch, f"K5 forward x ({rows}, {C}) bf16, hidden {Hd}", fused_ln_mlp(*a),
                   fused_ln_mlp_reference(*a), phase=7)
    k5f_ms, k5f_plain_ms = paired_ms(torch, lambda: fused_ln_mlp(*a),
                                     lambda: fused_ln_mlp_reference(*a), iters=10)
    k5f_lib_ms = cuda_ms(torch, dense_fwd_fn(torch, a), iters=10)
    k5f_bound = bound_ms(nbytes(*a, a[0]), 4 * rows * C * Hd)
    say(f"phase 7 [{card}]: K5 forward x ({rows}, {C}) bf16 (the step's rows): kernel "
        f"{k5f_ms:.4f} ms, plain {k5f_plain_ms:.4f} ms, dense half-block (cuBLAS) "
        f"{k5f_lib_ms:.4f} ms, bound {k5f_bound[0]:.4f} ms ({k5f_bound[1]})")
    del a, dout, grads, again

    db = trainer.device_batch(batch)
    for _ in range(2):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    gc.collect()  # drop earlier checks' objects held by reference cycles
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    say(f"phase 7 [{card}]: bf16 ViT-B train step with remat, B={B}, batch on the card: "
        f"{step_s * 1e3:.3f} ms/step = {B / step_s:.1f} crops/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    stage_split(torch, card, trainer, db, "phase 7", "bf16 ViT-B step")
    if profile:
        profile_window(torch, card, f"3 bf16 ViT-B train steps with remat at B={B}",
                       lambda: trainer.train_step(trainer.state, db))
    return dict(counts, k5b_err=k5b_err, k5b_twin_err=k5b_twin_err, k5b_ms=k5b_ms,
                k5b_plain_ms=k5b_plain_ms, k5b_lib_ms=k5b_lib_ms, k5b_bound=k5b_bound,
                k5f_step=dict(rows=rows, launches_per_step=counts["k5f"] // steps,
                              max_abs_err=k5f_err, ms=k5f_ms, plain_ms=k5f_plain_ms,
                              library_ms=k5f_lib_ms, bound_ms=k5f_bound[0]))


def config_768(dtype: str, batch: int):
    """The flagship TrainConfig on 768 x 768 inputs (model.img_size, nothing
    else changed), augmentation off, at `dtype` and `batch`."""
    cfg = train_config(dtype, batch)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, img_size=IMG_768),
                               **fit_outputs("flagship_768"))


# Mangled-name pieces of the kernels phase 0 reports, and their labels.
PTXAS_NAMES = {"10fwd_kernelILi64": "forward", "13bwd_dq_kernelILi64": "backward dQ",
               "14bwd_dkv_kernelILi64": "backward dK/dV",
               "16short_fwd_kernelILi64ELi3E": "short forward",
               "11gemm_kernelILi3ELi192ELi0ELi0ELi0E": "K5 u = y W1, GELU",
               "11gemm_kernelILi3ELi192ELi0ELi0ELi2E": "K5 o = h W2 + x",
               "11dual_kernelILi0E": "K5 u and dh",
               "11gemm_kernelILi3ELi192ELi0ELi1ELi3E": "K5 dy = du W1^T",
               "11gemm_kernelILi3ELi192ELi1ELi1ELi4E": "K5 dW1^T, dW2^T",
               "21sparsemax_warp_kernelILi96ELb1E": "K2 warp a row, 3,072 pixels",
               "22sparsemax_block_kernelILb1ELb1E": "K2 block a row, staged",
               "22sparsemax_block_kernelILb0ELb1E": "K2 block a row, unstaged",
               "13decode_kernelILi4E": "K3 strip, radii <= 4",
               "13decode_kernelILi9E": "K3 strip, radii <= 9", "18decode_pick_kernelE": "K3 pick"}


def ptxas_kernels(log: str) -> dict:
    """Registers and spill bytes (stores + loads) of each kernel of
    PTXAS_NAMES: attention at d = 64 (csrc/tiled_attention_sm90.cu; the
    short forward at N = 192), K5's at ViT-B widths (csrc/fused_mlp_sm90.cu),
    K2's (csrc/sparsemax.cu) and K3's (csrc/decode.cu), from nvcc's -Xptxas
    -v report."""
    names = PTXAS_NAMES
    found, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            current = next((v for k, v in names.items() if k in line), None)
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found.setdefault(current, {})["spill_bytes"] = nums[1] + nums[2]
        elif current and line.strip().startswith("ptxas info") and "Used" in line:
            found.setdefault(current, {})["registers"] = int(line.split("Used")[1].split()[0])
    return found


def phase8_k4_kernels(torch, dev, card: str, g) -> dict:
    """K4 forward and backward against their plain versions at the 768 x
    768 path's shapes, at a ragged N = 1000 and at N = 77 (less than one
    128-row tile); bf16 also against the kernel-order plain versions (one
    sweep, online softmax; backward from (out, lse)), which should agree
    more tightly, and per q/k/v slice by a normwise relative bound. Then
    numbers, not gated."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import kernel_path
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        tiled_attention,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_online_bwd_reference,
        tiled_attention_online_reference,
        tiled_attention_reference,
        tiled_forward,
    )

    N, C = 2304, 384
    bf16 = torch.bfloat16
    online, online_rel = {}, {}
    for B, n, dtype in ((SERVE_768_BATCH, N, bf16), (2, N, torch.float32), (2, 1000, bf16),
                        (2, 1000, torch.float32), (3, 77, bf16)):
        name = str(dtype).split(".")[-1]
        qkv = torch.randn(B, n, 3 * C, generator=g, device=dev).to(dtype)
        label = f"K4 forward qkv ({B}, {n}, {3 * C}) {name}"
        out = tiled_attention(qkv, 6)
        err = gate(torch, f"{label}, packed_attention's route {kernel_path(n, 64, dtype)}", out,
                   tiled_attention_reference(qkv, 6), phase=8)
        if dtype == bf16:
            ref, _ = tiled_attention_online_reference(qkv, 6)
            label = f"{label} against the kernel-order plain version"
            online[("fwd", B)] = gate(torch, label, out, ref, phase=8)
            online_rel[("fwd", B)] = rel_gate(torch, label, out, ref, 1, phase=8)
        if B == SERVE_768_BATCH:
            k4f_err = err
    for B, n, dtype in ((TRAIN_768_BATCH, N, bf16), (2, N, torch.float32), (2, 1000, bf16),
                        (2, 1000, torch.float32), (3, 77, bf16)):
        name = str(dtype).split(".")[-1]
        qkv = torch.randn(B, n, 3 * C, generator=g, device=dev).to(dtype)
        dout = torch.randn(B, n, C, generator=g, device=dev).to(dtype)
        label = f"K4 backward qkv ({B}, {n}, {3 * C}) {name}"
        out, lse = tiled_forward(qkv, 6, with_lse=True)
        got = tiled_attention_backward(qkv, dout, 6, out, lse)  # as the step calls it
        again = tiled_attention_backward(qkv, dout, 6, out, lse)
        err = gate(torch, f"{label}, packed_attention's route "
                   f"{kernel_path(n, 64, dtype, backward=True)}", got,
                   tiled_attention_bwd_reference(qkv, dout, 6), phase=8)
        check(torch.equal(got, again), f"K4 backward ({B}, {n}) {name} differs between runs")
        check(torch.equal(got, tiled_attention_backward(qkv, dout, 6)),
              f"K4 backward ({B}, {n}) {name}: recomputing out and lse changes the result")
        if dtype == bf16:
            ref = tiled_attention_online_bwd_reference(qkv, dout, 6)
            label = f"{label} against the kernel-order plain version"
            online[("bwd", B)] = gate(torch, label, got, ref, phase=8)
            online_rel[("bwd", B)] = rel_gate(torch, label, got, ref, 3, phase=8)
        if B == TRAIN_768_BATCH:
            k4b_err = err
    say("phase 8: K4 backward bit-identical across two runs, and with out and lse saved or "
        "recomputed, at every shape")
    del qkv, dout, got, again, out, lse

    qkv = torch.randn(SERVE_768_BATCH, N, 3 * C, generator=g, device=dev).to(bf16)
    k4f_ms, k4f_plain_ms = paired_ms(torch, lambda: tiled_attention(qkv, 6),
                                     lambda: tiled_attention_reference(qkv, 6), iters=5)
    k4f_lib_ms = sdpa_ms(torch, qkv, 6)
    k4f_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * SERVE_768_BATCH * N * N * C)
    say(f"phase 8 [{card}]: K4 forward qkv ({SERVE_768_BATCH}, {N}, {3 * C}) bf16: kernel "
        f"{k4f_ms:.4f} ms, plain {k4f_plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{k4f_lib_ms:.4f} ms, bound {k4f_bound[0]:.4f} ms ({k4f_bound[1]})")
    qkv = qkv[:TRAIN_768_BATCH].contiguous()
    dout = torch.randn(TRAIN_768_BATCH, N, C, generator=g, device=dev).to(bf16)
    out, lse = tiled_forward(qkv, 6, with_lse=True)
    k4b_ms, k4b_plain_ms = paired_ms(
        torch, lambda: tiled_attention_backward(qkv, dout, 6, out, lse),
        lambda: tiled_attention_bwd_reference(qkv, dout, 6), iters=5)
    k4b_recompute_ms = cuda_ms(torch, lambda: tiled_attention_backward(qkv, dout, 6), iters=10)
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.unflatten(-1, (3, 6, 64)).permute(2, 0, 3, 1, 4))
    ctx = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    do = dout.unflatten(-1, (6, 64)).transpose(1, 2)
    k4b_lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(ctx, (q, k, v), do,
                                                            retain_graph=True), iters=5)
    # qkv and dO in, dqkv out (the saved context and lse are this design's
    # reads, not the function's); five products of 2 N^2 d per (b, h): S,
    # dP, dQ, dK, dV.
    k4b_bound = bound_ms(nbytes(qkv, dout, qkv), 10 * TRAIN_768_BATCH * N * N * C)
    say(f"phase 8 [{card}]: K4 backward qkv ({TRAIN_768_BATCH}, {N}, {3 * C}) bf16, out and "
        f"lse saved: kernel {k4b_ms:.4f} ms (recomputing them: {k4b_recompute_ms:.4f} ms), "
        f"plain {k4b_plain_ms:.4f} ms, scaled_dot_product_attention backward "
        f"{k4b_lib_ms:.4f} ms, bound {k4b_bound[0]:.4f} ms ({k4b_bound[1]})")
    del qkv, dout, q, k, v, ctx, do, out, lse
    return dict(k4f_err=k4f_err, k4f_ms=k4f_ms, k4f_plain_ms=k4f_plain_ms,
                k4f_lib_ms=k4f_lib_ms, k4f_bound=k4f_bound, k4b_err=k4b_err, k4b_ms=k4b_ms,
                k4b_plain_ms=k4b_plain_ms, k4b_lib_ms=k4b_lib_ms, k4b_bound=k4b_bound,
                k4b_recompute_ms=k4b_recompute_ms,
                k4f_online_err=online[("fwd", SERVE_768_BATCH)],
                k4b_online_err=online[("bwd", TRAIN_768_BATCH)],
                k4f_online_rel=online_rel[("fwd", SERVE_768_BATCH)],
                k4b_online_rel=online_rel[("bwd", TRAIN_768_BATCH)])


def phase8_k2_long_rows(torch, card: str, g, K: int) -> dict:
    """K2 at 192 x 192-pixel rows (staged in shared memory) and at 256 x
    256-pixel ones (from 1024 x 1024 crops; read from device memory on each
    pass) against its plain version: a batch's rows, a ragged count and the
    adversarial rows; then timed."""
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
        sparsemax_reference,
        sparsemax_rows,
    )

    P, R = 192 * 192, SERVE_768_BATCH * K
    k2_err = k2_check(torch, k2_rows(torch, g, 17 * 3 + 5, P, "random"), "random", phase=8)
    times, extra = {}, {}
    for n, rows in [(P, r) for r in K2_ROWS] + [(256 * 256, "random"),
                                                (256 * 256, "all candidates")]:
        z = k2_rows(torch, g, R if n == P else R // 2, n, rows)
        err = k2_check(torch, z, rows, phase=8)
        label = rows if n == P else f"{rows}, ({R // 2}, {n})"
        if (n, rows) == (P, "random"):
            k2_err = max(k2_err, err)
            k2_ms, k2_plain_ms = paired_ms(torch, lambda: sparsemax_rows(z),
                                           lambda: sparsemax_reference(z), iters=5)
            k2_bound = bound_ms(2 * nbytes(z), 96 * z.numel(), "float32")
        else:
            times[label] = cuda_ms(torch, lambda: sparsemax_rows(z), iters=10)
            extra[label] = dict(max_abs_err=err, ms=times[label],
                                bound_ms=bound_ms(2 * nbytes(z), 96 * z.numel(), "float32")[0])
        del z
    say(f"phase 8 [{card}]: K2 ({R}, {P}) f32: kernel {k2_ms:.4f} ms on random rows ("
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"), plain {k2_plain_ms:.4f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    return dict(shape=[R, P], max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
                bound_ms=k2_bound[0], bound_by=k2_bound[1], other_rows=extra)


def k3_check(torch, card: str, codec, heatmaps, label: str, phase: int) -> dict:
    """K3 on served heatmaps against the plain decode, then timed."""
    from probpose_pytorch_tpu_torch.ops.heatmap import expected_value_decode
    from probpose_pytorch_tpu_torch.ops.kernels.decode import (
        band_radius,
        expected_value_decode_fused,
    )

    hm = heatmaps.float().contiguous()
    row_op, col_op = codec.probmap.conv_operators(hm.device)
    locs, vals = expected_value_decode_fused(hm, row_op, col_op)
    ref_locs, ref_vals = expected_value_decode(hm, row_op, col_op)
    torch.cuda.synchronize()
    px = (locs - ref_locs).abs().max().item()
    verr = (vals - ref_vals).abs().max().item()
    say(f"phase {phase}: K3 fused decode of {label} heatmaps {tuple(hm.shape)}: keypoint max "
        f"diff {px:.3e} px (tolerance {K3_PX_TOL:g}), value max diff {verr:.3e} "
        f"({K3_VAL_TOL:g}) against the plain decode")
    check(px <= K3_PX_TOL and verr <= K3_VAL_TOL, f"K3 on {label} heatmaps: {px} px, {verr}")
    ms, plain_ms = paired_ms(torch, lambda: expected_value_decode_fused(hm, row_op, col_op),
                             lambda: expected_value_decode(hm, row_op, col_op), iters=10)
    B, K, H, W = hm.shape
    # Heatmaps and operators in, (x, y, value) out. The function needs the
    # products over each keypoint's band only, 2 H W ((2 r_row + 1) + (2
    # r_col + 1)) a map, r from the operators (ops/kernels/decode.py); the
    # dense products, 2 H W (H + W) a map, give `dense_bound`.
    bands = (2 * band_radius(row_op) + 1) + (2 * band_radius(col_op) + 1)
    in_out = nbytes(hm, row_op, col_op) + 12 * B * K
    bound = bound_ms(in_out, 2 * B * H * W * float(bands.sum()), "float32")
    dense_bound = bound_ms(in_out, 2 * B * K * H * W * (H + W), "float32")
    say(f"phase {phase} [{card}]: K3 ({B}, {K}, {H}, {W}) f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (no single library call computes it), bound {bound[0]:.4f} ms "
        f"({bound[1]}; the dense products' {dense_bound[0]:.4f} ms)")
    return dict(err=px, val_err=verr, ms=ms, plain_ms=plain_ms, bound=bound,
                dense_bound=dense_bound)


def phase8_serving(torch, dev, card: str, profile: bool) -> dict:
    """The flagship model on 768 x 768 inputs served at a batch of 64."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
    from probpose_pytorch_tpu_torch.ops.kernels.attention import kernel_path

    cfg = config_768("bfloat16", SERVE_768_BATCH).model
    check(cfg.attn_impl == "fused" and cfg.heatmap_size == (192, 192), "768 config off")
    model = build_model(cfg, dev, seed=0)
    peak_heatmap_branch(torch, model)
    codec = make_codec(cfg)
    predictor = TopDownPredictor(model, codec, cfg.img_size, return_heatmaps=True)
    requests = [request(20 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    depth, n = len(model.backbone.blocks), len(requests)
    say(f"phase 8: 768 x 768 trunk, N = 2304, d = 64: forward via "
        f"{kernel_path(2304, 64, torch.bfloat16)} (bf16) / "
        f"{kernel_path(2304, 64, torch.float32)} (f32), backward via "
        f"{kernel_path(2304, 64, torch.bfloat16, backward=True)}")

    # The main path: a TopDownPredictor on 768 x 768 crops.
    reset_counts()
    answers = [predictor(frames, boxes) for frames, boxes in requests]
    torch.cuda.synchronize()
    counts = read_counts()
    check_answers(cfg, requests, answers, phase=8)
    say(f"phase 8: launches over {n} forwards: K4 forward {counts['k4f']} (expect "
        f"{depth * n}), K1 {counts['k1f']} (expect 0), K2 {counts['k2']} (expect {n})")
    check(counts["k4f"] == depth * n, "K4 did not run once per block")
    check(counts["k1f"] == counts["k4b"] == 0, "the 768 x 768 forward ran K1 or K4 backward")
    check(counts["k1s"] == 0, "the 768 x 768 forward ran the short forward")
    check(counts["k2"] == n, "K2 did not run once per forward")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(model.state_dict())
    pred32 = TopDownPredictor(model32, codec, cfg.img_size, return_heatmaps=True)
    for frames, boxes in requests:
        kern = pred32(frames, boxes)
        with plain_versions():
            plain = pred32(frames, boxes)
        sel = well_defined(torch, codec, plain["heatmaps"], dev)
        kerr = float(np.abs(kern["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
        perr = float(np.abs(kern["probabilities"] - plain["probabilities"]).max())
        say(f"phase 8: f32 kernel vs plain, {len(frames)} crops: keypoint max diff "
            f"{kerr:.3e} px over {int(sel.sum())}/{sel.size} well-defined keypoints "
            f"(tolerance {KPT_TOL_PX:g}), probability max diff {perr:.3e} (not gated)")
        check(sel.mean() > 0.5, "too few 768 x 768 keypoints with a well-defined argmax")
        check(kerr <= KPT_TOL_PX, f"f32 768 x 768 keypoints differ by {kerr} px")
    del model32, pred32, kern, plain

    k3 = k3_check(torch, card, codec, torch.from_numpy(answers[-1]["heatmaps"]).to(dev),
                  "the 768 x 768 path's", phase=8)
    del answers

    B = SERVE_768_BATCH
    frames, boxes = request(27, B)
    predictor.return_heatmaps = False
    f_dev = torch.from_numpy(frames).to(dev)
    b_dev = torch.from_numpy(boxes).to(dev)
    predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    dev_s = (time.perf_counter() - t0) / iters
    say(f"phase 8 [{card}]: 768 x 768 serving B={B}, frames resident on the card: "
        f"{dev_s * 1e3:.3f} ms/batch = {B / dev_s:.1f} crops/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if profile:
        profile_window(torch, card, f"3 768 x 768 serving batches of {B}",
                       lambda: predictor.predict(f_dev, b_dev))
    return dict(k3=k3)


def phase8_training(torch, dev, card: str, profile: bool) -> dict:
    """The flagship model on 768 x 768 inputs trained through Trainer at a
    batch of 32; returns the launch counts of Trainer.fit."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator

    cfg = config_768("bfloat16", TRAIN_768_BATCH)
    B = cfg.train_batch_size
    t0 = time.perf_counter()
    ds = SyntheticPoseDataset(B, IMG_768, cfg.model.num_keypoints, seed=2)
    batch = next(iter(batch_iterator(ds, B, num_workers=8)))
    say(f"phase 8: synthetic batch of {B} crops at 768 x 768 made in "
        f"{time.perf_counter() - t0:.2f} s")
    trainer = make_trainer(torch, cfg, dev)
    lr0 = float(trainer.tx.schedule(torch.zeros((), dtype=torch.int32, device=dev)))
    compare_f32_step(torch, dev, {k: v[:F32_768_BATCH] for k, v in batch.items()}, lr0,
                     config_768("float32", F32_768_BATCH), phase=8,
                     routed=("head.branches.",), floor=2**-23)

    # The main path: Trainer.fit on the fixed batch, bf16.
    depth, steps = len(trainer.model.backbone.blocks), TRAIN_768_STEPS
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(lambda: iter([batch]), max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 8: Trainer.fit, {steps} bf16 steps at 768 x 768, B={B} in {fit_s:.2f} s; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    say(f"phase 8: launches over {steps} steps: K4 forward {counts['k4f']}, K4 backward "
        f"{counts['k4b']} (expect {depth * steps} each), K4 backward's own forward "
        f"{counts['k4b_recomputes']} (expect 0: it reads the saved out and lse), K1 forward "
        f"{counts['k1f']}, K1 backward {counts['k1b']} (expect 0 each), K2 {counts['k2']} "
        f"(expect {steps})")
    check(len(losses) == steps, f"{len(losses)} steps logged")
    check(all(np.isfinite(losses)), "a bf16 768 x 768 training loss is not finite")
    check(losses[-1] < losses[0], "the 768 x 768 loss did not fall over the fixed batch")
    check(counts["k4f"] == counts["k4b"] == depth * steps, "K4 count off")
    check(counts["k4b_recomputes"] == 0, "K4 backward ran the forward instead of reading the "
          "saved out and lse")
    check(counts["k1f"] == counts["k1b"] == counts["k1s"] == 0, "the 768 x 768 trunk ran K1")
    check(counts["k2"] == steps, "K2 did not run once per step")

    db = trainer.device_batch(batch)
    for _ in range(2):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    say(f"phase 8 [{card}]: bf16 768 x 768 train step B={B}, batch on the card: "
        f"{step_s * 1e3:.3f} ms/step = {B / step_s:.1f} crops/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    stage_split(torch, card, trainer, db, "phase 8", "bf16 768 x 768 step")
    if profile:
        profile_window(torch, card, f"3 bf16 768 x 768 train steps at B={B}",
                       lambda: trainer.train_step(trainer.state, db))
    return counts


class _Tee(io.StringIO):
    """Standard output that is also kept."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text: str) -> int:
        self.out.write(text)
        return super().write(text)

    def flush(self) -> None:
        self.out.flush()


def recipe_cli_runs(torch, card: str) -> None:
    """Phase 9 (a): the training CLI on configs/flagship_coco_vits.json as
    shipped, twice in this process (`cli_runs`): RECIPE_STEPS steps, then a
    resume for RECIPE_STEPS more; the launch counters must show K1 forward
    and backward in every block and K2 once a forward."""
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    cfg_path = REPO / "configs/flagship_coco_vits.json"
    cfg = TrainConfig.load(cfg_path)
    say(f"phase 9: the flagship recipe (B = {cfg.train_batch_size}, {cfg.model.backbone}, "
        f"{cfg.model.compute_dtype}, augment {dataclasses.asdict(cfg.augment)})")
    runs = cli_runs(torch, card, "flagship recipe", cfg_path, RUN_DIR / "recipe",
                    ("--dataset-format", "synthetic"), phase=9)
    val_batches = 320 // cfg.val_batch_size  # the CLI's synthetic validation set
    for i, (_, counts, _) in enumerate(runs):
        # Run 1 validates at step 0 (val_every = 500); run 2 does not.
        forwards = RECIPE_STEPS + (val_batches if i == 0 else 0)
        check_attention_route(counts, 12 * forwards, 12 * RECIPE_STEPS, phase=9)
        say(f"phase 9: K2 launches {counts['k2']} (expect {forwards})")
        check(counts["k2"] == forwards, "K2 did not run once per forward")
    say("phase 9: the CLI resumed from step 3 and checkpointed at step 6")


def recipe_preamble_check(torch, dev, card: str) -> None:
    """Phase 9 (b): the augmented preamble with half-body and rotation on,
    B = AUG_BATCH, in crop and frame mode: the same draws on the card and
    on the CPU."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.ops.augment import draw_augment
    from probpose_pytorch_tpu_torch.train.config import TrainConfig
    from probpose_pytorch_tpu_torch.train.loop import _encode_targets, augment_batch, build_codecs

    cfg = TrainConfig.load(REPO / "configs/flagship_coco_vits.json")
    cfg = dataclasses.replace(cfg, augment=dataclasses.replace(
        cfg.augment, half_body_prob=0.3, rotation_deg=30.0))
    H, W = cfg.model.img_size
    K = cfg.model.num_keypoints
    enc, _ = build_codecs(cfg)
    rng = np.random.default_rng(9)
    crops = next(iter(batch_iterator(SyntheticPoseDataset(AUG_BATCH, (H, W), K, seed=9),
                                     AUG_BATCH, num_workers=4)))
    boxes = np.concatenate([rng.uniform(0, 200, (AUG_BATCH, 2)),
                            rng.uniform(120, 260, (AUG_BATCH, 2))], 1).astype(np.float32)
    frames = dict(frame=rng.integers(0, 256, (AUG_BATCH, 480, 640, 3), dtype=np.uint8),
                  box=boxes,
                  keypoints=(boxes[:, None, :2] + rng.random((AUG_BATCH, K, 2))
                             * boxes[:, None, 2:]).astype(np.float32),
                  keypoints_visible=np.ones((AUG_BATCH, K), np.float32),
                  keypoints_visibility=(rng.random((AUG_BATCH, K)) > 0.1).astype(np.float32))
    draws = draw_augment(cfg.seed, 7, AUG_BATCH, cfg.augment, "cpu")
    reboxed = int((draws.half_u < cfg.augment.half_body_prob).sum())
    check(reboxed > 0, "no sample drew half-body")
    for mode, batch, tol in (("crop", crops, AUG_CROP_TOL), ("frame", frames, AUG_FRAME_TOL)):
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        img_c, b_c = augment_batch(cfg, host, draws)
        img_g, b_g = augment_batch(cfg, {k: v.to(dev) for k, v in host.items()}, draws.to(dev))
        hm_c = _encode_targets(enc, b_c)["heatmaps"]
        hm_g = _encode_targets(enc, b_g)["heatmaps"]
        torch.cuda.synchronize()
        diff = (img_g.cpu() - img_c).abs()
        kerr = (b_g["keypoints"].cpu() - b_c["keypoints"]).abs().max().item()
        herr = (hm_g.cpu() - hm_c).abs().max().item()
        say(f"phase 9: augmented preamble, {mode} mode, B = {AUG_BATCH} (flip, "
            f"{'half-body on ' + str(reboxed) + ' draws, box jitter, ' if mode == 'frame' else ''}"
            f"rotation, colour), card against CPU with the same draws: crops max "
            f"{diff.max().item():.3e} (bound {tol:.3e}), mean {diff.mean().item():.3e}; "
            f"keypoints {kerr:.3e} px (bound {AUG_KPT_TOL_PX:g}); heatmaps {herr:.3e} "
            f"(bound {AUG_HEATMAP_TOL:g})")
        check(torch.isfinite(img_g).all().item(), f"{mode} crops are not finite")
        check(diff.max().item() <= tol, f"{mode} crops differ from the CPU's")
        check(kerr <= AUG_KPT_TOL_PX, f"{mode} keypoints differ from the CPU's")
        check(herr <= AUG_HEATMAP_TOL, f"{mode} heatmaps differ from the CPU's")


def recipe_times(torch, dev, card: str) -> None:
    """Phase 9 (c) and (d), not gated except the restore: the flagship's
    B = 256 frame-mode step with its augmentation against the same step
    without it, in turns; then a save and a restore of the flagship state,
    the restore compared bit for bit."""
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.config import TrainConfig
    from probpose_pytorch_tpu_torch.train.loop import make_train_step

    cfg = dataclasses.replace(train_config("bfloat16", TRAIN_BATCH), augment=TrainConfig.load(
        REPO / "configs/flagship_coco_vits.json").augment)
    trainer = make_trainer(torch, cfg, dev)
    plain_step = make_train_step(trainer.model, trainer.encode_codec, trainer.loss_fn,
                                 trainer.tx, dataclasses.replace(cfg, augment=None))
    rng = np.random.default_rng(10)
    K = cfg.model.num_keypoints
    boxes = np.concatenate([rng.uniform(0, 200, (TRAIN_BATCH, 2)),
                            rng.uniform(120, 260, (TRAIN_BATCH, 2))], 1).astype(np.float32)
    db = trainer.device_batch(dict(
        frame=rng.integers(0, 256, (TRAIN_BATCH, 480, 640, 3), dtype=np.uint8), box=boxes,
        keypoints=(boxes[:, None, :2] + rng.random((TRAIN_BATCH, K, 2))
                   * boxes[:, None, 2:]).astype(np.float32),
        keypoints_visible=np.ones((TRAIN_BATCH, K), np.float32),
        keypoints_visibility=np.ones((TRAIN_BATCH, K), np.float32)))
    aug_ms, plain_ms = yardstick_ms(torch, lambda: trainer.train_step(trainer.state, db),
                                    lambda: plain_step(trainer.state, db), iters=10, windows=5)
    say(f"phase 9 [{card}]: flagship bf16 step, B = {TRAIN_BATCH} frames of 480 x 640 on the "
        f"card: with the recipe's augmentation (flip, box jitter, colour) {aug_ms:.3f} ms, "
        f"without {plain_ms:.3f} ms (CUDA events, medians of 5 windows of 10 steps, in turns); "
        f"augmentation {aug_ms - plain_ms:.3f} ms a step")

    mgr = CheckpointManager(RUN_DIR / "checkpoint_times", keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(trainer.state.host_step, trainer.state)
    save_s = time.perf_counter() - t0
    size = (mgr.directory / str(trainer.state.host_step)).stat().st_size
    fresh = make_trainer(torch, cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore(fresh.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    a, b = trainer.state, fresh.state
    pairs = list(zip(a.params, b.params)) + list(zip(a.ema_params, b.ema_params))
    pairs += list(zip(trainer.model.buffers(), fresh.model.buffers()))
    pairs += list(zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu))
    pairs += [(getattr(a.opt_state, f), getattr(b.opt_state, f))
              for f in ("count", "schedule_count", "notfinite_count", "last_finite",
                        "total_notfinite")]
    pairs.append((a.step, b.step))
    same = all(x.device == y.device and torch.equal(x, y) for x, y in pairs)
    say(f"phase 9 [{card}]: flagship checkpoint, {size / 2**20:.1f} MiB, step "
        f"{a.host_step}: save {save_s:.3f} s, restore {restore_s:.3f} s (host clock); "
        f"{len(pairs)} tensors restored bit for bit on the card: {same}")
    check(same and b.host_step == a.host_step, "the restored state differs from the saved one")


def eval_well_defined(torch, predictor, frames, boxes) -> np.ndarray:
    """Keypoints well defined at every scale of `predictor`'s scale test:
    the OKS-convolved (flip-averaged) map of each scale has a top-2 margin
    above MARGIN. From the plain versions' maps."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, _scale_boxes
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions

    one = TopDownPredictor(predictor.model, predictor.codec, predictor.input_size,
                           flip_test=predictor.flip_test, return_heatmaps=True)
    dev = predictor.device
    ok = None
    for s in predictor.scale_test or (1.0,):
        b = _scale_boxes(torch.from_numpy(boxes), s).numpy()
        with plain_versions():
            hm = one(frames, b)["heatmaps"]
        sel = well_defined(torch, predictor.codec, hm, dev)
        ok = sel if ok is None else ok & sel
    return ok


def eval_runs(torch, card: str) -> dict:
    """Phase 10: the eval CLI on phase 9's checkpoint, three runs, gated as
    the module docstring says; returns the launches summed over the runs."""
    from probpose_pytorch_tpu_torch.data import (
        COCOPoseDataset,
        batch_iterator,
        generate_coco_synth,
    )
    from probpose_pytorch_tpu_torch.eval import evaluate_topdown
    from probpose_pytorch_tpu_torch.eval import run as eval_run
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    t_phase = time.perf_counter()
    recipe = RUN_DIR / "recipe"
    t0 = time.perf_counter()
    root = generate_coco_synth(RUN_DIR / "synth_coco", n_train_images=0, n_val_images=160,
                               frame_hw=(480, 480), seed=0)
    ann = root / "annotations" / "person_keypoints_val2017.json"
    images = root / "val2017"
    dataset = COCOPoseDataset(ann, images, (256, 192))
    n = len(dataset)
    batches = -(-n // EVAL_BATCH)
    say(f"phase 10: synthetic COCO val set, 160 frames of 480 x 480, {n} instances "
        f"({sum(len(v) for v in dataset.ignores_by_image.values())} ignore regions), written "
        f"in {time.perf_counter() - t0:.2f} s; {batches} batches of <= {EVAL_BATCH}")
    base = ["--checkpoint", str(recipe / "checkpoints"), "--config", str(recipe / "config.json"),
            "--annotations", str(ann), "--images", str(images),
            "--batch-size", str(EVAL_BATCH), "--device", "cuda"]
    preds_json = RUN_DIR / "eval_predictions.json"
    scales = ",".join(f"{s:g}" for s in EVAL_SCALES)
    runs = (("plain", [], 1),
            ("flip + calibration", ["--flip-test", "--calibration", "--per-joint",
                                    "--dump-predictions", str(preds_json)], 2),
            (f"scales {scales}", ["--scale-test", scales], len(EVAL_SCALES)))
    total: dict = {}
    lines, walls = [], []
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for label, extra, per_batch in runs:
        args = base + extra
        say(f"phase 10: python -m probpose_pytorch_tpu_torch.eval.run {' '.join(args)}")
        reset_counts()
        t0 = time.perf_counter()
        line = eval_run.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        forwards = batches * per_batch
        lines.append(line)
        walls.append(wall)
        say(f"phase 10 [{card}]: eval run '{label}': {wall:.2f} s wall (the whole CLI run: "
            f"checkpoint load, data, {forwards} model forwards, scoring) = {n / wall:.1f} "
            "crops/s")
        missing = [k for k in EVAL_KEYS + (EVAL_CAL_KEYS if "--calibration" in extra else ())
                   if k not in line]
        check(not missing, f"eval run '{label}': summary lacks {missing}")
        check(all(np.isfinite(v) for v in line.values()), f"eval run '{label}': not finite")
        unit = [k for k in EVAL_AP_KEYS + ("PCK@0.2", "AUC") if not 0.0 <= line[k] <= 1.0]
        check(not unit, f"eval run '{label}': {unit} outside [0, 1]")
        check(line["EPE"] >= 0.0, f"eval run '{label}': negative EPE")
        check_attention_route(counts, 12 * forwards, 0, phase=10)
        say(f"phase 10: K2 launches {counts['k2']} (expect {forwards})")
        check(counts["k2"] == forwards, "K2 did not run once per model forward")
        check(counts["k5f"] == counts["k6"] == counts["k3"] == 0, "eval ran K3, K5 or K6")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()

    say(f"phase 10: python -m probpose_pytorch_tpu_torch.eval.run --score-predictions "
        f"{preds_json} --annotations {ann} --images {images}")
    scored = eval_run.main(["--score-predictions", str(preds_json), "--annotations", str(ann),
                            "--images", str(images)])
    differ = {k: (scored[k], lines[1][k]) for k in EVAL_AP_KEYS if scored[k] != lines[1][k]}
    say(f"phase 10: re-scored predictions: {int(scored['n_results'])} results over "
        f"{int(scored['n_images'])} images; AP/AR keys equal to the run's: {not differ}")
    check(not differ, f"re-scored predictions differ from the run: {differ}")

    # The f32 predictor with flip and scale test, kernels against plain
    # versions, on the checkpoint's weights with the heatmap branch
    # redrawn at fan-in scale (6 steps leave the maps nearly flat, so
    # almost no argmax would be well defined).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = load_predictor(recipe / "checkpoints", recipe / "config.json", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg32 = dataclasses.replace(TrainConfig.load(recipe / "config.json").model,
                                compute_dtype="float32")
    model32 = build_model(cfg32, "cuda")
    model32.load_state_dict(pred.model.state_dict())
    peak_heatmap_branch(torch, model32)
    pred32 = TopDownPredictor(model32, pred.codec, pred.input_size, flip_test=True,
                              scale_test=EVAL_SCALES)
    crops = dataset.get_batch(range(EVAL_F32_CROPS))["image"]
    H, W = pred.input_size
    ident = np.tile(np.array([0, 0, W, H], np.float32), (len(crops), 1))
    kern = pred32(crops, ident)
    with plain_versions():
        plain = pred32(crops, ident)
    sel = eval_well_defined(torch, pred32, crops, ident)
    kerr = float(np.abs(kern["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
    perr = float(np.abs(kern["probabilities"] - plain["probabilities"]).max())
    say(f"phase 10: f32 predictor with flip and scales {scales}, {len(crops)} val crops, "
        f"kernels vs plain: keypoint max diff {kerr:.3e} px over {int(sel.sum())}/{sel.size} "
        f"keypoints well defined at every scale (tolerance {KPT_TOL_PX:g}), probability max "
        f"diff {perr:.3e} ({PROB_TOL:g})")
    check(sel.mean() > 0.5, "too few keypoints well defined at every scale")
    check(kerr <= KPT_TOL_PX, f"f32 TTA keypoints differ by {kerr} px")
    check(perr <= PROB_TOL, f"f32 TTA probabilities differ by {perr}")
    del model32, pred32

    # Not gated: the bf16 predictor's device time per batch of EVAL_BATCH
    # crops on the card, plain, with flip test and with the three scales.
    batch = dataset.get_batch(range(EVAL_BATCH))["image"]
    f_dev = torch.from_numpy(batch).cuda()
    b_dev = torch.from_numpy(np.tile(np.array([0, 0, W, H], np.float32),
                                     (EVAL_BATCH, 1))).cuda()
    times = {}
    for label, kw in (("plain", {}), ("flip", dict(flip_test=True)),
                      ("scales", dict(scale_test=EVAL_SCALES)),
                      ("flip + scales", dict(flip_test=True, scale_test=EVAL_SCALES))):
        p = TopDownPredictor(pred.model, pred.codec, pred.input_size, **kw)
        times[label] = cuda_ms(torch, lambda: p.predict(f_dev, b_dev), iters=10)
    say(f"phase 10 [{card}]: bf16 predictor, B = {EVAL_BATCH} crops on the card, device time "
        "per batch (CUDA events, mean of 10): "
        + ", ".join(f"{k} {v:.3f} ms ({EVAL_BATCH / v * 1e3:.1f} crops/s)"
                    for k, v in times.items()))
    # predict_stream (uploads and launches on a worker thread) against
    # __call__, batch for batch, on the card: the val batches four times
    # over, so that the worker thread's start is spread over 12 batches.
    stream_in = [(dataset.get_batch(range(i, min(i + EVAL_BATCH, n)))["image"],
                  np.tile(np.array([0, 0, W, H], np.float32), (min(EVAL_BATCH, n - i), 1)))
                 for i in range(0, n, EVAL_BATCH)] * 4
    t0 = time.perf_counter()
    called = [pred(*item) for item in stream_in]
    call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed = list(pred.predict_stream(iter(stream_in), depth=2))
    stream_s = time.perf_counter() - t0
    same = len(streamed) == len(called) and all(
        sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(streamed, called))
    say(f"phase 10 [{card}]: predict_stream over {len(stream_in)} val batches equal to "
        f"__call__ batch for batch: {same}; {stream_s:.3f} s streamed, {call_s:.3f} s called in "
        "turn (host clock, crops already decoded)")
    check(same, "predict_stream differs from __call__ on the card")

    # Where an eval run's wall goes (host clock, not gated): the predictor's
    # build and restore, the val crops' decode alone, and evaluate_topdown
    # (decode, forwards and scoring) with the plain predictor.
    t0 = time.perf_counter()
    for _ in batch_iterator(dataset, EVAL_BATCH, drop_last=False):
        pass
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate_topdown(pred, dataset, batch_size=EVAL_BATCH)
    eval_s = time.perf_counter() - t0
    say(f"phase 10 [{card}]: eval run split: load_predictor {load_s:.3f} s, decoding the "
        f"{n} val crops alone {data_s:.3f} s, evaluate_topdown {eval_s:.3f} s (its {batches} "
        f"plain forwards ~{batches * times['plain'] / 1e3:.3f} s of device time)")
    say(f"phase 10 [{card}]: eval CLI wall: plain {n / walls[0]:.1f} crops/s, with flip test "
        f"(and calibration, per-joint, dump) {n / walls[1]:.1f} crops/s, three scales "
        f"{n / walls[2]:.1f} crops/s; peak device memory over the three runs "
        f"{peak / 2**20:.1f} MiB")
    say(f"phase 10: summaries (AP near 0 is expected of a 6-step checkpoint; this phase checks "
        f"the path, not accuracy): " + " | ".join(
            f"{label}: AP {ln['AP']} AR {ln['AR']} EPE {ln['EPE']}"
            for (label, _, _), ln in zip(runs, lines)))
    say(f"phase 10: {time.perf_counter() - t_phase:.1f} s in all")
    return total


@contextlib.contextmanager
def fitted_trainers():
    """The Trainers whose `fit` runs inside the block (a CLI's), each with a
    copy of its parameters as `fit` found them: a fresh run's seed."""
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    seen = []
    fit = Trainer.fit

    def recording(self, *args, **kwargs):
        seen.append((self, [p.detach().clone() for p in self.state.params]))
        return fit(self, *args, **kwargs)

    Trainer.fit = recording
    try:
        yield seen
    finally:
        Trainer.fit = fit


def train_cli_run(torch, card: str, label: str, run: Path, config: Path, data_root: Path,
                  steps: int):
    """The training CLI on a shipped config, as a user runs it, from the
    current directory: returns (its Trainer, the seed parameters, the
    launch counts, its logged lines, its wall time in s)."""
    from probpose_pytorch_tpu_torch.train import cli

    args = [str(run), "--config", str(config), "--data-root", str(data_root),
            "--max-steps", str(steps), "--device", "cuda"]
    say(f"phase 11: python -m probpose_pytorch_tpu_torch.train.cli {' '.join(args)}")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fitted_trainers() as seen:
        cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    logged = [x for x in lines if "training/loss" in x]
    say(f"phase 11 [{card}]: {label}: {steps} steps through the CLI in {wall:.2f} s wall; "
        f"logged: {logged[-1] if logged else None}")
    check(len(seen) == 1, f"{label}: the CLI ran {len(seen)} fits")
    check(bool(logged) and all(np.isfinite(v) for x in logged for v in x.values()),
          f"{label}: a logged training value is not finite")
    check((run / "checkpoints" / str(steps)).is_file(), f"{label}: no checkpoints/{steps}")
    trainer, seed = seen[0]
    return trainer, seed, counts, logged, wall


def check_moved(torch, label: str, trainer, seed, labels: list[str]) -> None:
    """Frozen tensors bit-identical to their seed values (weight decay would
    move them); every trainable tensor moved, but those the recipe cannot
    move: a zero tensor of the visibility branch, whose loss weight is 0
    (its gradient is 0, and weight decay does not move a zero)."""
    frozen_kept, moved, idle, stuck = 0, 0, [], []
    for name, lab, p, s in zip(trainer.state.names, labels, trainer.state.params, seed):
        same = torch.equal(p, s)
        if lab == "frozen":
            check(same, f"{label}: frozen {name} moved")
            frozen_kept += 1
        elif not same:
            moved += 1
        elif name.startswith("head.branches.visibility.") and not s.any():
            idle.append(name)
        else:
            stuck.append(name)
    say(f"phase 11: {label}: {frozen_kept} frozen tensors bit-identical to the seed's; "
        f"{moved} trainable tensors moved; {len(idle)} zero visibility-branch tensors "
        f"(loss weight 0) could not")
    check(frozen_kept > 0, f"{label}: nothing frozen")
    check(not stuck, f"{label}: trainable tensors did not move: {stuck}")


def recipe_step_ms(torch, trainer, K: int) -> float:
    """Mean device time of the recipe's train step (its augmentation on) at
    its batch, crops on the card (CUDA events, FT_TIMED_STEPS steps)."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator

    B = trainer.cfg.train_batch_size
    ds = SyntheticPoseDataset(B, trainer.cfg.model.img_size, K, seed=11)
    db = trainer.device_batch(next(iter(batch_iterator(ds, B, num_workers=8))))
    return cuda_ms(torch, lambda: trainer.train_step(trainer.state, db), iters=FT_TIMED_STEPS,
                   warmup=1)


def eval_cli_run(torch, label: str, run: Path, ann: Path, images: Path, n_val: int,
                 flags: tuple[str, ...] = (), k2_per_forward: int = 1, phase: int = 11) -> dict:
    """The eval CLI on a run's checkpoint (with `flags`): the summary's keys
    finite, 12 short attention forwards and `k2_per_forward` K2 launches
    per forward (two forwards a batch with --flip-test)."""
    from probpose_pytorch_tpu_torch.eval import run as eval_run

    args = ["--checkpoint", str(run / "checkpoints"), "--annotations", str(ann),
            "--images", str(images), "--batch-size", str(EVAL_BATCH), "--device", "cuda",
            *flags]
    say(f"phase {phase}: python -m probpose_pytorch_tpu_torch.eval.run {' '.join(args)}")
    reset_counts()
    t0 = time.perf_counter()
    line = eval_run.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    forwards = -(-n_val // EVAL_BATCH) * (2 if "--flip-test" in flags else 1)
    check(all(k in line and np.isfinite(line[k]) for k in EVAL_KEYS),
          f"{label}: the eval summary lacks a key or is not finite")
    check_attention_route(counts, 12 * forwards, 0, phase=phase)
    check(counts["k2"] == k2_per_forward * forwards,
          f"{label}: K2 did not run {k2_per_forward} times a forward")
    if phase != 11:
        say(f"phase {phase}: {label}: {wall:.2f} s wall, {n_val / wall:.1f} crops/s; AP "
            f"{line['AP']} AR {line['AR']} EPE {line['EPE']}")
    return counts


def phase11_lora(torch, dev, card: str, root: Path, n_val: int) -> dict:
    """Phase 11 (a) and (b): the LoRA recipe, its merge and the eval CLI on
    the merged checkpoint."""
    from probpose_pytorch_tpu_torch.compat import merge_lora
    from probpose_pytorch_tpu_torch.data import COCOPoseDataset, SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.config import TrainConfig
    from probpose_pytorch_tpu_torch.train.loop import frozen_labels

    config = REPO / "configs/lora_finetune_vits.json"
    cfg = TrainConfig.load(config)
    run = Path("runs/lora")
    trainer, seed, counts, _, _ = train_cli_run(torch, card, "LoRA recipe", run, config, root,
                                                FT_STEPS)
    forwards = FT_STEPS + n_val // cfg.val_batch_size
    check_attention_route(counts, 12 * forwards, 12 * FT_STEPS, phase=11)
    say(f"phase 11: LoRA recipe: K2 launches {counts['k2']} (expect {forwards})")
    check(counts["k2"] == forwards, "K2 did not run once per forward")
    names = trainer.state.names
    labels = frozen_labels(cfg, names)
    check_moved(torch, "LoRA recipe", trainer, seed, labels)
    opt = trainer.state.opt_state
    lora_bytes = nbytes(*opt.mu, *opt.nu)
    full = CheckpointManager(RUN_DIR / "recipe" / "checkpoints").read(mmap=True)["opt_state"]
    full_bytes = nbytes(*full["mu"], *full["nu"])
    say(f"phase 11: LoRA recipe: Adam moments for {len(opt.mu)} of {len(names)} tensors, "
        f"{lora_bytes / 2**20:.2f} MiB, against the full flagship run's {full_bytes / 2**20:.2f} "
        f"MiB ({lora_bytes / full_bytes:.4f} of it)")
    K = cfg.model.num_keypoints
    step_ms = recipe_step_ms(torch, trainer, K)
    say(f"phase 11 [{card}]: LoRA recipe bf16 step, B = {cfg.train_batch_size} crops on the card "
        f"with its augmentation: {step_ms:.3f} ms (CUDA events, mean of {FT_TIMED_STEPS})")
    del trainer, seed, opt
    gc.collect()

    # One f32 LoRA-only step through the kernels against the plain versions.
    cfg32 = dataclasses.replace(
        cfg, augment=None, train_batch_size=F32_TRAIN_BATCH, log_every=1, resume=False,
        model=dataclasses.replace(cfg.model, compute_dtype="float32"), **fit_outputs("lora32"))
    ds = SyntheticPoseDataset(F32_TRAIN_BATCH, cfg.model.img_size, K, seed=0)
    compare_f32_step(torch, dev, next(iter(batch_iterator(ds, F32_TRAIN_BATCH, num_workers=8))),
                     cfg.optim.peak_lr, cfg32, phase=11)

    # The merge CLI, then the eval CLI on what it wrote.
    merged = Path("runs/lora_merged")
    args = ["--checkpoint", str(run / "checkpoints"), "--out", str(merged), "--device", "cuda"]
    say(f"phase 11: python -m probpose_pytorch_tpu_torch.compat.merge_lora {' '.join(args)}")
    t0 = time.perf_counter()
    merge_lora.main(args)
    merge_s = time.perf_counter() - t0
    mcfg = TrainConfig.load(merged / "config.json")
    check(mcfg.model.lora_rank == 0 and not mcfg.train_lora_only, "the merged config keeps LoRA")
    ann = root / "annotations" / "person_keypoints_val2017.json"
    images = root / "val2017"
    merged_counts = eval_cli_run(torch, "merged LoRA", merged, ann, images, n_val)

    # The merged f32 predictor against the unmerged one, the heatmap branch
    # redrawn alike on both (3 steps leave the maps nearly flat).
    val = COCOPoseDataset(ann, images, cfg.model.img_size)
    crops = val.get_batch(range(EVAL_F32_CROPS))["image"]
    H, W = cfg.model.img_size
    ident = np.tile(np.array([0, 0, W, H], np.float32), (len(crops), 1))
    outs = {}
    for label, model_cfg, ckpt in (("unmerged", cfg.model, run), ("merged", mcfg.model, merged)):
        payload = CheckpointManager(ckpt / "checkpoints").read()
        model = build_model(dataclasses.replace(model_cfg, compute_dtype="float32"), dev)
        model.load_state_dict({**payload["params"], **payload["buffers"]}, strict=True)
        peak_heatmap_branch(torch, model)
        codec = make_codec(model_cfg)
        outs[label] = TopDownPredictor(model, codec, (H, W), return_heatmaps=True)(crops, ident)
    sel = well_defined(torch, codec, outs["unmerged"]["heatmaps"], dev)
    kerr = float(np.abs(outs["merged"]["keypoints"] - outs["unmerged"]["keypoints"])[sel]
                 .max(initial=0.0))
    oerr = max(float(np.abs(outs["merged"][k] - outs["unmerged"][k]).max())
               for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors"))
    say(f"phase 11: f32 merged against unmerged predictor, {len(crops)} val crops: keypoints "
        f"{kerr:.3e} px over {int(sel.sum())}/{sel.size} well-defined keypoints, outputs "
        f"{oerr:.3e} (bound {MERGE_TOL:g} each)")
    check(sel.mean() > 0.5, "too few keypoints with a well-defined argmax")
    check(kerr <= MERGE_TOL and oerr <= MERGE_TOL, "the merged predictor differs")
    bf16 = []
    for c in (run, merged):
        pred = load_predictor(c / "checkpoints", device="cuda")
        pred.return_heatmaps = True
        bf16.append(pred(crops, ident))
    say("phase 11: bf16 merged against unmerged predictor on the checkpoints' own (nearly "
        "flat) maps, not gated: " + ", ".join(
            f"{k} max diff {float(np.abs(bf16[0][k] - bf16[1][k]).max()):.3e}"
            for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors")))
    say(f"phase 11 [{card}]: merge_lora CLI {merge_s:.2f} s wall")
    return dict(lora=counts, merged_eval=merged_counts)


def phase11_average(torch, card: str, n_val: int, root: Path) -> dict:
    """Phase 11 (c): train.average over phase 9's checkpoints 3 and 6, then
    the eval CLI on the average."""
    from probpose_pytorch_tpu_torch.train import average
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

    recipe = RUN_DIR / "recipe" / "checkpoints"
    check(CheckpointManager(recipe).all_steps() == [3, 6], "phase 9 left other checkpoints")
    out = Path("runs/avg")
    args = ["--checkpoint", str(recipe), "--last", "2", "--out", str(out), "--device", "cuda"]
    say(f"phase 11: python -m probpose_pytorch_tpu_torch.train.average {' '.join(args)}")
    t0 = time.perf_counter()
    average.main(args)
    avg_s = time.perf_counter() - t0
    got = CheckpointManager(out / "checkpoints").read()
    src = [CheckpointManager(recipe).read(s) for s in (3, 6)]
    same = all(torch.equal(got[key][k], v)
               for key in ("params", "buffers", "ema")
               for k, v in average.average_trees([p[key] for p in src]).items())
    say(f"phase 11: averaged checkpoint at step {got['step']}: params, EMA and BN statistics "
        f"the mean of steps 3 and 6 bit for bit: {same}")
    check(same and got["step"] == 6, "the averaged checkpoint is not the mean")
    counts = eval_cli_run(torch, "averaged", out, root / "annotations" /
                          "person_keypoints_val2017.json", root / "val2017", n_val)
    say(f"phase 11 [{card}]: average CLI {avg_s:.2f} s wall")
    return dict(avg_eval=counts)


def phase11_distill(torch, card: str, root: Path, n_val: int) -> dict:
    """Phase 11 (d): the ViT-L teacher's run (vitl_coco.json, the fewest
    micro-steps that apply one update), then the distillation recipe, whose
    relative ./runs/vitl paths find it."""
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    tcfg = TrainConfig.load(REPO / "configs/vitl_coco.json")
    steps = tcfg.optim.accum_steps
    trainer, _, tcounts, _, _ = train_cli_run(torch, card, "ViT-L teacher run", Path("runs/vitl"),
                                              REPO / "configs/vitl_coco.json", root, steps)
    del trainer
    payload = CheckpointManager("runs/vitl/checkpoints").read(mmap=True)
    check(int(payload["opt_state"]["gradient_step"]) == 1, "the teacher applied no update")
    say(f"phase 11: ViT-L teacher run launches: short forward {tcounts['k1s']}, backward "
        f"{tcounts['k4b']}, K2 {tcounts['k2']} (remat: two forwards a block a step)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = REPO / "configs/distill_vits_from_vitl.json"
    cfg = TrainConfig.load(config)
    trainer, _, counts, logged, _ = train_cli_run(torch, card, "distillation recipe",
                                                  Path("runs/vits_distilled"), config, root,
                                                  FT_STEPS)
    peak = torch.cuda.max_memory_allocated()
    teacher = trainer.teacher
    want = {**(payload["ema"] if cfg.distill.ema_teacher else payload["params"]),
            **payload["buffers"]}
    kept = all(torch.equal(v.cpu(), want[k]) for k, v in teacher.state_dict().items())
    say(f"phase 11: distillation: teacher ({tcfg.model.backbone}, {len(want)} tensors) in eval "
        f"mode: {not teacher.training}; its tensors those of the checkpoint's "
        f"{'EMA' if cfg.distill.ema_teacher else 'params'} bit for bit after the run: {kept}")
    check(kept and not teacher.training, "the teacher changed")
    terms = [(x["training/loss/distill_heatmap"], x["training/loss/distill_scalar"])
             for x in logged]
    say(f"phase 11: distillation terms logged (heatmap, scalar): {terms}")
    check(bool(np.isfinite(terms).all()), "a distillation term is not finite")
    forwards = n_val // cfg.val_batch_size
    check_attention_route(counts, (12 + 24) * FT_STEPS + 12 * forwards, 12 * FT_STEPS, phase=11)
    say(f"phase 11: distillation: K2 launches {counts['k2']} (expect {2 * FT_STEPS + forwards})")
    check(counts["k2"] == 2 * FT_STEPS + forwards, "K2 did not run once per model forward")
    step_ms = recipe_step_ms(torch, trainer, cfg.model.num_keypoints)
    say(f"phase 11 [{card}]: distillation bf16 step, B = {cfg.train_batch_size} crops on the "
        f"card with its augmentation and the ViT-L teacher's forward: {step_ms:.3f} ms (CUDA "
        f"events, mean of {FT_TIMED_STEPS}); peak device memory of the CLI run "
        f"{peak / 2**20:.1f} MiB")
    return dict(vitl=tcounts, distill=counts)


def phase11_radio(torch, dev, card: str, root: Path, n_val: int, g) -> dict:
    """Phase 11 (e): the frozen RADIO recipe from the seed's weights."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.train.config import TrainConfig
    from probpose_pytorch_tpu_torch.train.loop import frozen_labels

    config = REPO / "configs/radio_frozen_vitb.json"
    cfg = TrainConfig.load(config)
    trainer, seed, counts, _, _ = train_cli_run(torch, card, "frozen RADIO recipe",
                                                Path("runs/radio_frozen"), config, root, FT_STEPS)
    forwards = FT_STEPS + n_val // cfg.val_batch_size
    check_attention_route(counts, 12 * forwards, 0, phase=11)
    check(counts["k2"] == forwards, "K2 did not run once per forward")
    check_moved(torch, "frozen RADIO recipe", trainer, seed,
                frozen_labels(cfg, trainer.state.names))
    N = cfg.model.num_prefix_tokens + trainer.model.backbone.grid_size[0] * \
        trainer.model.backbone.grid_size[1]
    heads = trainer.model.backbone.num_heads
    qkv = torch.randn(cfg.train_batch_size, N, 3 * trainer.model.backbone.embed_dim, generator=g,
                      device=dev).to(torch.bfloat16)
    path = kernel_path(N, 64, torch.bfloat16)
    check(path == "sm90 short", f"N = {N} routes to {path}")
    err = gate(torch, f"K1 packed_attention qkv {tuple(qkv.shape)} bfloat16 via {path} (one "
               "prefix token)", packed_attention(qkv, heads),
               packed_attention_reference(qkv, heads), phase=11)
    step_ms = recipe_step_ms(torch, trainer, cfg.model.num_keypoints)
    say(f"phase 11 [{card}]: frozen RADIO bf16 step, B = {cfg.train_batch_size} crops on the card "
        f"with its augmentation: {step_ms:.3f} ms (CUDA events, mean of {FT_TIMED_STEPS})")
    return dict(radio=counts, radio_n193_err=err)


def phase11_finetuning(torch, dev, card: str, g) -> dict:
    """Phase 11: the fine-tuning recipes and the checkpoint tools through
    their CLIs, from a temporary working directory, on a synthetic
    COCO-format set; returns each run's launch counts."""
    from probpose_pytorch_tpu_torch.data import COCOPoseDataset, generate_coco_synth

    t_phase = time.perf_counter()
    work = RUN_DIR / "finetune"
    root = generate_coco_synth(work / "coco", n_train_images=FT_TRAIN_IMAGES,
                               n_val_images=FT_VAL_IMAGES, frame_hw=(480, 480), seed=1)
    n_val = len(COCOPoseDataset(root / "annotations" / "person_keypoints_val2017.json",
                                root / "val2017", (256, 192)))
    n_train = len(COCOPoseDataset(root / "annotations" / "person_keypoints_train2017.json",
                                  root / "train2017", (256, 192)))
    say(f"phase 11: synthetic COCO set, {n_train} train and {n_val} val instances "
        f"({FT_TRAIN_IMAGES} and {FT_VAL_IMAGES} frames of 480 x 480), written in "
        f"{time.perf_counter() - t_phase:.2f} s")
    check(n_train >= 128, "too few training instances for a batch of 128")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out = phase11_lora(torch, dev, card, root, n_val)
        gc.collect()
        out.update(phase11_average(torch, card, n_val, root))
        gc.collect()
        out.update(phase11_distill(torch, card, root, n_val))
        gc.collect()
        torch.cuda.empty_cache()
        out.update(phase11_radio(torch, dev, card, root, n_val, g))
    finally:
        os.chdir(cwd)
    say(f"phase 11: {time.perf_counter() - t_phase:.1f} s in all")
    return out


def camera_boxes(rng, n: int, hw: tuple[int, int] = FRAME_HW) -> np.ndarray:
    """n person boxes (x, y, w, h) on an (H, W) frame, some past its edges."""
    H, W = hw
    wh = rng.uniform([0.05 * H, 0.1 * H], [0.35 * H, 0.5 * H], (n, 2))
    margin = 0.03 * H
    xy = rng.uniform(-margin, np.stack([W - wh[:, 0], H - wh[:, 1]], axis=1) + margin)
    return np.concatenate([xy, wh], axis=1).astype(np.float32)


def frontend_buckets() -> tuple[int, ...]:
    """The buckets predict_frame and the server CLI take by default: the
    card's recorded ladder, else powers of two up to its serving batch."""
    from probpose_pytorch_tpu_torch.inference import tuned_bucket_ladder, tuned_serving_batch

    top = tuned_serving_batch()
    return tuned_bucket_ladder() or tuple(
        b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) if b < top) + (top,)


def counted(torch, total: dict, fn):
    """fn() with the launch counters set to 0 just before and read just
    after; the counts are added to `total`. Returns (fn's value, counts)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return out, counts


def check_dispatches(counts: dict, dispatches: int, dtype: str, label: str) -> None:
    """12 attention forwards and 1 K2 a dispatch: bf16 on the short wgmma
    forward (no CUDA-core launch), f32 on K1's CUDA cores; no K3, K5 or K6."""
    if dtype == "bfloat16":
        check_attention_route(counts, 12 * dispatches, 0, phase=12)
    else:
        say(f"phase 12: {label}: K1 CUDA-core forwards {counts['k1f']} (expect "
            f"{12 * dispatches})")
        check(counts["k1f"] == 12 * dispatches and counts["k1s"] == 0,
              f"{label}: the f32 trunk did not run K1's CUDA cores once per block")
    say(f"phase 12: {label}: K2 launches {counts['k2']} (expect {dispatches})")
    check(counts["k2"] == dispatches, f"{label}: K2 did not run once per dispatch")
    check(counts["k3"] == counts["k5f"] == counts["k6"] == 0, f"{label}: ran K3, K5 or K6")


FRAME_FIELDS = ("keypoints", "scores", "probabilities", "visibilities", "oks", "errors")


def check_fields(out: dict, n: int, K: int, label: str, extra=()) -> None:
    """JAX's keys for n poses, their shapes, all finite."""
    shapes = dict(keypoints=(n, K, 2), scores=(n, K), probabilities=(n, 1, K),
                  visibilities=(n, 1, K), oks=(n, 1, K), errors=(n, 1, K))
    check(sorted(out) == sorted(FRAME_FIELDS + tuple(extra)), f"{label}: keys {sorted(out)}")
    for k, shape in shapes.items():
        check(out[k].shape == shape, f"{label}: {k} shape {out[k].shape} != {shape}")
        check(np.isfinite(out[k]).all(), f"{label}: {k} not finite")


def frontend_predict_frame(torch, card: str, pred, pred32, K: int, total: dict) -> None:
    """Phase 12 (1, 2): predict_frame in bf16 at 1, 7, 64 and 300 boxes,
    OKS-NMS on duplicated boxes, then f32 through the kernels against the
    plain versions; times printed."""
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions

    dev = pred.device
    buckets = frontend_buckets()
    rng = np.random.default_rng(120)
    frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    # the frame as predict_frame pads it, on the card, for the device times
    f_dev = torch.from_numpy(np.pad(frame, ((0, -FRAME_HW[0] % 64), (0, -FRAME_HW[1] % 64),
                                            (0, 0)))[None]).to(dev)
    say(f"phase 12: predict_frame on a {FRAME_HW[0]} x {FRAME_HW[1]} frame (padded to a "
        f"multiple of {pred.frame_size_multiple}), buckets {buckets}")
    times = []
    for n in FRAME_BOX_COUNTS:
        boxes = camera_boxes(rng, n)
        out, counts = counted(torch, total, lambda: pred.predict_frame(frame, boxes))
        dispatches = -(-n // buckets[-1])
        check_fields(out, n, K, f"predict_frame of {n} boxes")
        check_dispatches(counts, dispatches, "bfloat16", f"predict_frame of {n} boxes, "
                         f"{dispatches} dispatches")
        t0 = time.perf_counter()
        for _ in range(5):
            pred.predict_frame(frame, boxes)
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        bucket = next((b for b in buckets if b >= n), buckets[-1])
        b_dev = torch.from_numpy(camera_boxes(rng, bucket)).to(dev)
        ids = torch.zeros(bucket, dtype=torch.int64, device=dev)
        dev_ms = cuda_ms(torch, lambda: pred.predict(f_dev, b_dev, ids), iters=5)
        times.append((n, dispatches, bucket, host_ms, dev_ms))
    for n, d, bucket, host_ms, dev_ms in times:
        say(f"phase 12 [{card}]: bf16 predict_frame of {n} boxes ({d} dispatch(es) at bucket "
            f"{bucket}): {host_ms:.3f} ms a call (host clock, mean of 5: upload, compute, "
            f"download), {dev_ms:.3f} ms device time of one dispatch at bucket {bucket} with "
            "the frame on the card (CUDA events, mean of 5)")

    # OKS-NMS: NMS_PAIRS boxes far apart, each given twice.
    H, W = FRAME_HW
    base = np.stack([[(i + 0.1) * W / NMS_PAIRS, (0.1 + 0.05 * i) * H, 0.8 * W / NMS_PAIRS,
                      0.45 * H] for i in range(NMS_PAIRS)])
    dup = np.concatenate([base, base]).astype(np.float32)
    raw, _ = counted(torch, total, lambda: pred.predict_frame(frame, dup))
    raw_scores = (raw["scores"] * raw["probabilities"][:, 0]).mean(axis=1)
    hard, counts = counted(torch, total, lambda: pred.predict_frame(frame, dup, nms="oks"))
    check_dispatches(counts, 1, "bfloat16", "predict_frame with nms='oks'")
    check_fields(hard, NMS_PAIRS, K, "nms='oks'", ("pose_scores", "keep"))
    check(sorted(hard["keep"] % NMS_PAIRS) == list(range(NMS_PAIRS)),
          f"nms='oks' did not keep one of each pair: keep {hard['keep']}")
    soft, _ = counted(torch, total, lambda: pred.predict_frame(frame, dup, nms="soft_oks"))
    check_fields(soft, 2 * NMS_PAIRS, K, "nms='soft_oks'", ("pose_scores", "keep"))
    decay = float(np.exp(-1 / 0.9))
    for i in range(NMS_PAIRS):
        pair = soft["pose_scores"][soft["keep"] % NMS_PAIRS == i]
        check(len(pair) == 2 and pair.min() <= raw_scores[i] * decay * (1 + 1e-5),
              f"soft_oks did not decay the duplicate of box {i}: {pair} vs {raw_scores[i]}")
    say(f"phase 12: OKS-NMS over {NMS_PAIRS} boxes given twice: 'oks' kept "
        f"{hard['keep'].tolist()}; 'soft_oks' kept all {2 * NMS_PAIRS}, each duplicate's "
        f"score at most exp(-1/0.9) = {decay:.4f} of its twin's")

    # f32 through the kernels against the plain versions.
    boxes = camera_boxes(rng, 64)
    kern, counts = counted(torch, total, lambda: pred32.predict_frame(frame, boxes))
    check_dispatches(counts, -(-64 // buckets[-1]), "float32", "f32 predict_frame")
    with plain_versions():
        plain = pred32.predict_frame(frame, boxes)
    sel = well_defined(torch, pred32.codec, plain["heatmaps"], dev)
    kerr = float(np.abs(kern["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
    perr = float(np.abs(kern["probabilities"] - plain["probabilities"]).max())
    say(f"phase 12: f32 predict_frame of 64 boxes, kernels vs plain: keypoint max diff "
        f"{kerr:.3e} px over {int(sel.sum())}/{sel.size} well-defined keypoints (tolerance "
        f"{KPT_TOL_PX:g}), probability max diff {perr:.3e} ({PROB_TOL:g})")
    check(sel.mean() > 0.5, "too few keypoints with a well-defined argmax")
    check(kerr <= KPT_TOL_PX, f"f32 predict_frame keypoints differ by {kerr} px")
    check(perr <= PROB_TOL, f"f32 predict_frame probabilities differ by {perr}")


def frontend_sweep(torch, card: str, pred) -> None:
    """Phase 12, not gated: one dispatch of a camera frame at 1, 2, ..., 512
    boxes (device time, CUDA events: the least of three windows of 10; and
    the host clock of the whole call, mean of 5),
    the crop stage's share and peak memory at bucket 256, and the serving
    record's entry for this card."""
    from probpose_pytorch_tpu_torch.inference import derive_bucket_ladder
    from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize

    dev = pred.device
    rng = np.random.default_rng(121)
    frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    f_dev = torch.from_numpy(np.pad(frame, ((0, -FRAME_HW[0] % 64), (0, -FRAME_HW[1] % 64),
                                            (0, 0)))[None]).to(dev)
    rows = []
    for B in SWEEP_BATCHES:
        boxes = camera_boxes(rng, B)
        ids = np.zeros(B, np.int64)
        b_dev, i_dev = torch.from_numpy(boxes).to(dev), torch.from_numpy(ids).to(dev)
        # small batches sit on the host's launch floor, whose jitter moves
        # one window by a few ms: the least of three windows
        ms = min(cuda_ms(torch, lambda: pred.predict(f_dev, b_dev, i_dev), iters=10)
                 for _ in range(3))
        t0 = time.perf_counter()
        for _ in range(5):
            pred(frame[None], boxes, ids)
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        rows.append(dict(batch=B, ms_per_batch=round(ms, 3),
                         crops_per_sec=round(B / ms * 1e3, 1), host_ms=round(host_ms, 3)))
        say(f"phase 12 [{card}]: bucket sweep, B = {B}: {ms:.3f} ms device time a dispatch "
            f"({B / ms * 1e3:.1f} crops/s), {host_ms:.3f} ms host clock a call")
    sweep = [r for r in rows if r["batch"] in THROUGHPUT_BATCHES]
    best = max(sweep, key=lambda r: r["crops_per_sec"])
    bucket_sweep = [{k: r[k] for k in ("batch", "ms_per_batch", "crops_per_sec")}
                    for r in rows if r["batch"] <= best["batch"]]
    ladder = derive_bucket_ladder(bucket_sweep)
    say(f"phase 12 [{card}]: derive_bucket_ladder over B <= {best['batch']} (the most crops/s "
        f"of B in {THROUGHPUT_BATCHES}): {ladder}")
    limit = card.rsplit(",", 1)[1].strip()
    entry = {torch.cuda.get_device_name(0): dict(power_limit=limit,
                        sweep=[{k: r[k] for k in ("batch", "ms_per_batch", "crops_per_sec")}
                               for r in sweep],
                        batch=best["batch"], crops_per_sec=best["crops_per_sec"],
                        bucket_sweep=bucket_sweep, bucket_ladder=list(ladder))}
    say("phase 12: serving record entry (probpose_pytorch_tpu_torch/configs/"
        f"autotune_serving.json): {json.dumps(entry)}")

    B = 256
    b_dev = torch.from_numpy(camera_boxes(rng, B)).to(dev)
    i_dev = torch.zeros(B, dtype=torch.int64, device=dev)
    crop_ms = cuda_ms(torch, lambda: crop_resize(f_dev.index_select(0, i_dev), b_dev,
                                                 pred.input_size), iters=5, warmup=1)
    all_ms = cuda_ms(torch, lambda: pred.predict(f_dev, b_dev, i_dev), iters=5, warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pred.predict(f_dev, b_dev, i_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    H, W = pred.input_size
    _, Hs, Ws, C = f_dev.shape
    flop = 2 * B * H * Hs * Ws * C + 2 * B * H * W * Ws * C  # rows, then columns
    say(f"phase 12 [{card}]: bucket {B} at {Hs} x {Ws} (indexed, one "
        f"frame): crop_resize {crop_ms:.3f} ms of the dispatch's {all_ms:.3f} ms "
        f"({crop_ms / all_ms:.3f}; its two f32 products {flop / 1e12:.3f} TFLOP), peak device "
        f"memory of the dispatch above what was allocated {peak / 2**30:.2f} GiB")
    del f_dev, b_dev, i_dev
    gc.collect()
    torch.cuda.empty_cache()


def post_json(url: str, body: bytes, timeout: float = 300.0) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_text(url: str, timeout: float = 60.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        check(resp.status == 200, f"GET {url}: {resp.status}")
        return resp.read().decode()


def predict_body(b64: str, shape, boxes: np.ndarray) -> bytes:
    """A /predict request body around an already base64-encoded frame."""
    return (f'{{"frame_b64": "{b64}", "shape": {list(shape)}, '
            f'"boxes": {json.dumps(boxes.tolist())}}}').encode()


def run_clients(url: str, bodies: list[list[bytes]]) -> tuple[list, float]:
    """One thread per list of bodies, each posting its bodies in turn;
    returns the replies in the same nesting and the wall time in s."""
    import threading

    replies = [[None] * len(b) for b in bodies]

    def client(c):
        for r, body in enumerate(bodies[c]):
            replies[c][r] = post_json(url, body)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    return replies, wall


def frontend_server(torch, card: str, pred, pred32, total: dict) -> None:
    """Phase 12 (3): PoseHTTPServer in this process over an f32 MicroBatcher
    at 1080 x 1920: SERVER_CLIENTS clients, every reply against the direct
    predictor; then, not gated, the bf16 server under LOAD_CLIENTS clients."""
    import base64

    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.serve import MicroBatcher, PoseHTTPServer

    buckets = frontend_buckets()
    rng = np.random.default_rng(122)
    H, W = FRAME_HW
    shapes = (FRAME_HW, (H * 2 // 3, W * 2 // 3), (H - 80, W - 20))  # padded to FRAME_HW
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in shapes]
    b64 = [base64.b64encode(f.tobytes()).decode() for f in frames]
    reqs = [[(i % len(frames), camera_boxes(rng, int(rng.integers(1, MAX_REQUEST_BOXES + 1)),
                                            frames[i % len(frames)].shape[:2]))
             for i in range(c, c + SERVER_REQUESTS)] for c in range(SERVER_CLIENTS)]
    serve32 = TopDownPredictor(pred32.model, pred32.codec, pred32.input_size)
    mb = MicroBatcher(serve32, buckets, FRAME_HW, max_wait_ms=5.0, indexed=True)
    srv = PoseHTTPServer(mb, host="127.0.0.1", port=0)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        (replies, wall), counts = counted(torch, total, lambda: run_clients(
            base + "/predict", [[predict_body(b64[f], frames[f].shape, b) for f, b in rc]
                                for rc in reqs]))
        stats = mb.stats_snapshot()
        check_dispatches(counts, stats["dispatches"], "float32",
                         f"f32 server, {stats['dispatches']} dispatches")
        worst, n_sel, n_all = 0.0, 0, 0
        for rc, rr in zip(reqs, replies):
            for (f, boxes), (status, out) in zip(rc, rr):
                check(status == 200, f"/predict answered {status}: {out}")
                H, W = frames[f].shape[:2]
                padded = np.pad(frames[f], ((0, FRAME_HW[0] - H), (0, FRAME_HW[1] - W), (0, 0)))
                direct = pred32(padded[None], boxes, np.zeros(len(boxes), np.int64))
                sel = well_defined(torch, pred32.codec, direct["heatmaps"], pred32.device)
                got = np.asarray(out["keypoints"], np.float32)
                check(got.shape == direct["keypoints"].shape, f"reply shape {got.shape}")
                worst = max(worst, float(np.abs(got - direct["keypoints"])[sel].max(initial=0)))
                n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.size
        say(f"phase 12: f32 server, {SERVER_CLIENTS} clients x {SERVER_REQUESTS} requests of "
            f"1-{MAX_REQUEST_BOXES} boxes on frames of {shapes}: all 200, "
            f"keypoints vs the direct predictor max diff {worst:.3e} px over {n_sel}/{n_all} "
            f"well-defined keypoints (tolerance {KPT_TOL_PX:g}); {stats['dispatches']} "
            f"dispatches, mean batch {stats.get('mean_batch')}, {wall:.2f} s")
        check(n_sel > n_all / 2, "too few keypoints with a well-defined argmax")
        check(worst <= KPT_TOL_PX, f"server keypoints differ by {worst} px")
        check(json.loads(get_text(base + "/healthz")) == {"ok": True}, "/healthz")
        check(json.loads(get_text(base + "/stats"))["requests"] == SERVER_CLIENTS *
              SERVER_REQUESTS, "/stats")
        check('pose_requests_total{model="default"}' in get_text(base + "/metrics"), "/metrics")
        say("phase 12: /healthz, /stats and /metrics answered")
    finally:
        srv.shutdown()

    # Not gated: the bf16 server under load.
    mb = MicroBatcher(pred, buckets, FRAME_HW, max_wait_ms=5.0, indexed=True)
    srv = PoseHTTPServer(mb, host="127.0.0.1", port=0)
    srv.start()
    try:
        bodies = []
        for c in range(LOAD_CLIENTS):
            mine = []
            for r in range(LOAD_REQUESTS):
                f = (c + r) % len(frames)
                n = int(rng.integers(1, MAX_REQUEST_BOXES + 1))
                mine.append(predict_body(b64[f], frames[f].shape,
                                         camera_boxes(rng, n, frames[f].shape[:2])))
            bodies.append(mine)
        (replies, wall), counts = counted(torch, total, lambda: run_clients(
            f"http://127.0.0.1:{srv.port}/predict", bodies))
        check(all(st == 200 for rr in replies for st, _ in rr), "a loaded request failed")
        stats = json.loads(get_text(f"http://127.0.0.1:{srv.port}/stats"))
        check_dispatches(counts, stats["dispatches"], "bfloat16", "bf16 server under load")
        say(f"phase 12 [{card}]: bf16 server, {LOAD_CLIENTS} clients x {LOAD_REQUESTS} requests "
            f"of 1-{MAX_REQUEST_BOXES} boxes, frames padded to {FRAME_HW[0]} x {FRAME_HW[1]}, "
            f"buckets {buckets}: {stats['crops']} crops in {wall:.2f} s = "
            f"{stats['crops'] / wall:.1f} crops/s ({stats['requests'] / wall:.1f} requests/s); "
            f"latency p50 {stats['latency_ms']['p50']} ms, p99 {stats['latency_ms']['p99']} ms "
            f"(/stats, submit to result); mean batch {stats['mean_batch']}, "
            f"{stats['dispatches']} dispatches")
    finally:
        srv.shutdown()


def frontend_server_cli(torch, dev, card: str, recipe: Path) -> None:
    """Phase 12 (4): python -m probpose_pytorch_tpu_torch.serve.server on
    phase 9's checkpoint as a user starts it: /healthz, one /predict, and
    exit 0 on SIGTERM within SERVER_EXIT_S."""
    import base64
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = [sys.executable, "-m", "probpose_pytorch_tpu_torch.serve.server", "--checkpoint",
            str(recipe / "checkpoints"), "--host", "127.0.0.1", "--port", str(port), "--warmup",
            "--device", dev.type]
    say(f"phase 12: {' '.join(args[1:])}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []
    try:
        while True:
            line = proc.stdout.readline()
            if not line or time.perf_counter() - t0 > 600:
                break
            lines.append(line)
            if line.startswith("serving "):
                break
        start_s = time.perf_counter() - t0
        check(bool(lines) and lines[-1].startswith("serving "),
              "the server CLI did not start:\n" + "".join(lines[-40:]))
        for line in lines:
            if not line.startswith("[warmup]"):
                say(f"  server: {line.rstrip()}")
        base = f"http://127.0.0.1:{port}"
        check(json.loads(get_text(base + "/healthz")) == {"ok": True}, "server CLI /healthz")
        rng = np.random.default_rng(123)
        frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
        boxes = camera_boxes(rng, 3)
        status, out = post_json(base + "/predict", predict_body(
            base64.b64encode(frame.tobytes()).decode(), frame.shape, boxes))
        check(status == 200 and np.asarray(out["keypoints"]).shape == (3, 17, 2),
              f"server CLI /predict: {status}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVER_EXIT_S)
        stop_s = time.perf_counter() - t1
        tail = proc.stdout.read()
        check(rc == 0, f"the server CLI exited {rc} on SIGTERM:\n{tail}")
        say(f"phase 12 [{card}]: server CLI up (checkpoint load, kernel library, warmup) in "
            f"{start_s:.2f} s; answered /healthz and /predict; exit 0 {stop_s:.2f} s after "
            f"SIGTERM ({tail.strip().splitlines()[-1] if tail.strip() else ''})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()


def frontend_inference_cli(torch, dev, card: str, recipe: Path, total: dict) -> None:
    """Phase 12 (5): the single-image CLI on a PNG this phase writes, against
    an in-process predictor on the whole-image box."""
    import PIL.Image

    from probpose_pytorch_tpu_torch import inference

    work = RUN_DIR / "frontend"
    work.mkdir(parents=True, exist_ok=True)
    image = np.random.default_rng(124).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    PIL.Image.fromarray(image).save(work / "image.png")
    args = ["--checkpoint", str(recipe / "checkpoints"), "--image", str(work / "image.png"),
            "--output", str(work / "infer"), "--device", dev.type]
    say(f"phase 12: python -m probpose_pytorch_tpu_torch.inference {' '.join(args)}")
    t0 = time.perf_counter()
    _, counts = counted(torch, total, lambda: inference.main(args))
    wall = time.perf_counter() - t0
    check_dispatches(counts, 1, "bfloat16", "the inference CLI")
    pngs = sorted((work / "infer").glob("heatmap_*.png"))
    check(len(pngs) == 17 and (work / "infer" / "output_image.png").is_file(),
          f"the inference CLI wrote {len(pngs)} heatmaps")
    check(np.asarray(PIL.Image.open(pngs[0])).shape == (64, 48, 4), "heatmap PNG shape")
    preds = json.loads((work / "infer" / "predictions.json").read_text())
    check(sorted(preds) == sorted(FRAME_FIELDS), f"predictions.json keys {sorted(preds)}")
    ref = inference.load_predictor(recipe / "checkpoints", device=dev)(
        image[None], np.array([[0, 0, 640, 480]], np.float32))
    err = float(np.abs(np.asarray(preds["keypoints"], np.float32) - ref["keypoints"]).max())
    say(f"phase 12 [{card}]: inference CLI in {wall:.2f} s wall: 17 heatmap PNGs, "
        f"output_image.png, predictions.json; keypoints vs the in-process predictor max diff "
        f"{err:.3e} px (tolerance {KPT_TOL_PX:g})")
    check(err <= KPT_TOL_PX, f"the inference CLI's keypoints differ by {err} px")


def video_input(n_frames: int, seed: int):
    """Frames of VIDEO_HW and per-frame boxes of VIDEO_PEOPLE people that
    drift across the frame, each present in a frame with probability 0.7."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, *VIDEO_HW, 3), dtype=np.uint8)
    start = camera_boxes(rng, VIDEO_PEOPLE, VIDEO_HW)
    step = rng.normal(0, 4, (VIDEO_PEOPLE, 2))
    boxes = []
    for i in range(n_frames):
        b = start.copy()
        b[:, :2] += i * step
        boxes.append(b[rng.random(VIDEO_PEOPLE) < 0.7])
    return frames, boxes


def frontend_video(torch, dev, card: str, recipe: Path, pred32, total: dict) -> None:
    """Phase 12 (6): run_video against run_video_stream in f32, then the
    video CLI in bf16, per frame and streamed."""
    from probpose_pytorch_tpu_torch import video
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor

    frames, boxes = video_input(VIDEO_F32_FRAMES, 125)
    serve32 = TopDownPredictor(pred32.model, pred32.codec, pred32.input_size)
    crops = sum(len(b) for b in boxes)
    per_frame, counts = counted(torch, total, lambda: list(
        video.run_video(serve32, frames, boxes, nms=None)))
    check_dispatches(counts, sum(len(b) > 0 for b in boxes), "float32", "f32 run_video")
    streamed, counts = counted(torch, total, lambda: list(video.run_video_stream(
        serve32, frames, boxes, nms=None, batch=VIDEO_F32_BATCH)))
    check_dispatches(counts, -(-crops // VIDEO_F32_BATCH), "float32", "f32 run_video_stream")
    check(len(per_frame) == len(streamed) == VIDEO_F32_FRAMES, "video record counts")
    kerr = serr = 0.0
    n_sel = n_all = 0
    stable: dict = {}  # track id -> keypoints well defined in all its frames so far
    for frame, a, b in zip(frames, per_frame, streamed):
        check(np.array_equal(a["track_ids"], b["track_ids"]),
              f"frame {a['frame']}: track ids {a['track_ids']} vs {b['track_ids']}")
        if not len(a["boxes"]):
            continue
        hm = pred32(frame[None], a["boxes"], np.zeros(len(a["boxes"]), np.int64))["heatmaps"]
        sel = well_defined(torch, pred32.codec, hm, dev)
        for j, tid in enumerate(a["track_ids"]):
            stable[tid] = stable.get(tid, np.ones(sel.shape[1], bool)) & sel[j]
        smooth_sel = np.stack([stable[t] for t in a["track_ids"]])
        kerr = max(kerr, float(np.abs(a["keypoints"] - b["keypoints"])[sel].max(initial=0)))
        serr = max(serr, float(np.abs(a["smoothed"] - b["smoothed"])[smooth_sel].max(initial=0)))
        check(np.abs(a["probabilities"] - b["probabilities"]).max() <= PROB_TOL,
              f"frame {a['frame']}: probabilities differ")
        n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.size
    say(f"phase 12: f32 run_video vs run_video_stream(batch={VIDEO_F32_BATCH}), "
        f"{VIDEO_F32_FRAMES} frames of {VIDEO_HW[0]} x {VIDEO_HW[1]}, {crops} boxes: track ids "
        f"equal; keypoints max diff {kerr:.3e} px over {n_sel}/{n_all} well-defined, smoothed "
        f"{serr:.3e} px over those well defined in every frame of their track (tolerance "
        f"{KPT_TOL_PX:g})")
    check(n_sel > n_all / 2, "too few keypoints with a well-defined argmax")
    check(kerr <= KPT_TOL_PX and serr <= KPT_TOL_PX, "stream mode differs from per-frame mode")

    frames, boxes = video_input(VIDEO_CLI_FRAMES, 126)
    work = RUN_DIR / "frontend"
    work.mkdir(parents=True, exist_ok=True)
    np.save(work / "frames.npy", frames)
    (work / "boxes.json").write_text(json.dumps([b.tolist() for b in boxes]))
    crops = sum(len(b) for b in boxes)
    fps = {}
    for label, extra, dispatches in (
            ("per frame", [], sum(len(b) > 0 for b in boxes)),
            (f"--stream-batch {VIDEO_CLI_BATCH}", ["--stream-batch", str(VIDEO_CLI_BATCH)],
             -(-crops // VIDEO_CLI_BATCH))):
        out = work / f"video_{len(extra)}"
        args = ["--checkpoint", str(recipe / "checkpoints"), "--frames",
                str(work / "frames.npy"), "--boxes", str(work / "boxes.json"), "--out", str(out),
                "--device", dev.type] + extra
        say(f"phase 12: python -m probpose_pytorch_tpu_torch.video {' '.join(args)}")
        t0 = time.perf_counter()
        _, counts = counted(torch, total, lambda: video.main(args))
        wall = time.perf_counter() - t0
        check_dispatches(counts, dispatches, "bfloat16", f"video CLI {label}")
        records = (out / "poses.jsonl").read_text().splitlines()
        check(len(records) == VIDEO_CLI_FRAMES, f"video CLI {label}: {len(records)} records")
        check(all(len(json.loads(r)["track_ids"]) <= len(b) for r, b in zip(records, boxes)),
              f"video CLI {label}: more poses than boxes")
        fps[label] = VIDEO_CLI_FRAMES / wall
    say(f"phase 12 [{card}]: video CLI, bf16, {VIDEO_CLI_FRAMES} frames of {VIDEO_HW[0]} x "
        f"{VIDEO_HW[1]} ({crops} boxes), whole CLI run (checkpoint load included): "
        + ", ".join(f"{k} {v:.2f} frames/s" for k, v in fps.items()))


def phase12_frontends(torch, dev, card: str) -> dict:
    """Phase 12: the serving front ends on phase 9's checkpoint (step 6),
    gated as the module docstring says; returns the launches of its runs
    whose counts it checks, summed."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    t_phase = time.perf_counter()
    recipe = RUN_DIR / "recipe"
    pred = load_predictor(recipe / "checkpoints", device=dev)
    cfg32 = dataclasses.replace(TrainConfig.load(recipe / "config.json").model,
                                compute_dtype="float32")
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(pred.model.state_dict())
    # 6 steps leave the maps nearly flat: the f32 comparisons redraw the
    # heatmap branch at fan-in scale, as phase 10 does
    peak_heatmap_branch(torch, model32)
    pred32 = TopDownPredictor(model32, pred.codec, pred.input_size, return_heatmaps=True)
    total: dict = {}
    frontend_predict_frame(torch, card, pred, pred32, cfg32.num_keypoints, total)
    frontend_sweep(torch, card, pred)
    frontend_server(torch, card, pred, pred32, total)
    frontend_server_cli(torch, dev, card, recipe)
    frontend_inference_cli(torch, dev, card, recipe, total)
    frontend_video(torch, dev, card, recipe, pred32, total)
    say(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all")
    return total


# ------------------------------------------------------------------ phase 13
# The SimCC family, the fieldsynth recipe, Lion and Adafactor, mixed data.
FS_TRAIN_FRAMES = 48
FS_VAL_FRAMES = 24
# Width and height halve into 10^6: the labels' 6 decimals hold whole pixels
# and their halves, so the COCO conversion keeps every value (phase 13 (b)).
FS_FRAME_WH = (500, 400)
FS_K = 20
FS_F32_BATCH = 4
OPT_BATCH = 64
OPT_STEPS = 3
SIMCC_FRAME_BOXES = (1, 64, 256)
MIXED_STEPS = 2


def cli_runs(torch, card: str, label: str, config: Path, run: Path, extra: tuple[str, ...],
             phase: int) -> list:
    """The training CLI on a config with `extra` arguments, as a user runs
    it: RECIPE_STEPS steps that leave checkpoints/3, then a resume to
    checkpoints/6. Returns, per run, (its Trainer, the launch counts, the
    wall time in s); the logged values must be finite."""
    from probpose_pytorch_tpu_torch.train import cli

    args = [str(run), "--config", str(config), "--max-steps", str(RECIPE_STEPS),
            "--device", "cuda", *extra]
    say(f"phase {phase}: python -m probpose_pytorch_tpu_torch.train.cli {' '.join(args)}")
    out = []
    for i, start in enumerate((0, RECIPE_STEPS)):
        end = start + RECIPE_STEPS
        reset_counts()
        torch.cuda.synchronize()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with fitted_trainers() as seen, contextlib.redirect_stdout(tee):
            cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        check(bool(lines) and all(np.isfinite(v) for x in lines for v in x.values()),
              f"{label}: a logged value is not finite")
        check((run / "checkpoints" / str(end)).is_file(), f"{label}: no checkpoints/{end}")
        check((f"[trainer] resumed from step {start}" in tee.getvalue()) == (i == 1),
              f"{label}: run {i + 1} did not {'resume' if i else 'start afresh'}")
        say(f"phase {phase} [{card}]: {label}: CLI run {i + 1}, steps {start} to {end}: "
            f"{wall:.2f} s wall; last line {lines[-1]}")
        out.append((seen[0][0], counts, wall))
    return out


def check_no_other_kernel(counts: dict, label: str) -> None:
    check(counts["k3"] == counts["k5f"] == counts["k5b"] == counts["k6"] == 0,
          f"{label}: ran K3, K5 or K6")


def simcc_well_defined(heatmaps: np.ndarray) -> np.ndarray:
    """SimCC keypoints whose two axis distributions (the marginals of the
    predictor's (B, K, Hb, Wb) outer product) both have a top-2 gap above
    MARGIN of their top value, a logit gap: only there is the argmax, and
    so the keypoint, stable. (An absolute gap would pass few: after a few
    steps each probability lies near 1 / the bin count.)"""
    ok = None
    for axis in (-2, -1):  # x, then y
        p = np.sort(heatmaps.sum(axis), axis=-1)
        sel = p[..., -1] - p[..., -2] > MARGIN * p[..., -1]
        ok = sel if ok is None else ok & sel
    return ok


def phase13_simcc(torch, dev, card: str, root: Path, n_val: int) -> dict:
    """Phase 13 (a): configs/simcc_coco_vits.json as shipped through the
    training CLI, its f32 step, the eval CLI, predict_frame, the f32
    predictor and the inference CLI on its checkpoint."""
    import PIL.Image

    from probpose_pytorch_tpu_torch import inference
    from probpose_pytorch_tpu_torch.data import COCOPoseDataset, SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    config = REPO / "configs/simcc_coco_vits.json"
    cfg = TrainConfig.load(config)
    check(cfg.model.head_type == "simcc", "the SimCC recipe has another head")
    K, B = cfg.model.num_keypoints, cfg.train_batch_size
    run = RUN_DIR / "phase13" / "simcc"
    launches = {}
    runs = cli_runs(torch, card, "SimCC recipe", config, run, ("--data-root", str(root)),
                    phase=13)
    for i, (_, counts, _) in enumerate(runs):
        forwards = RECIPE_STEPS + (n_val // cfg.val_batch_size if i == 0 else 0)
        check_attention_route(counts, 12 * forwards, 12 * RECIPE_STEPS, phase=13)
        say(f"phase 13: SimCC recipe run {i + 1}: K2 launches {counts['k2']} (expect 0)")
        check(counts["k2"] == 0, "the SimCC head ran K2")
        check_no_other_kernel(counts, "SimCC recipe")
        launches[f"simcc_cli_{i + 1}"] = counts
    trainer = runs[1][0]
    step_ms = recipe_step_ms(torch, trainer, K)
    say(f"phase 13 [{card}]: SimCC recipe bf16 step, B = {B} crops on the card with its "
        f"augmentation: {step_ms:.3f} ms = {B / step_ms * 1e3:.1f} crops/s (CUDA events, mean "
        f"of {FT_TIMED_STEPS})")
    del trainer, runs
    gc.collect()

    cfg32 = dataclasses.replace(
        cfg, augment=None, train_batch_size=F32_TRAIN_BATCH, log_every=1, resume=False,
        model=dataclasses.replace(cfg.model, compute_dtype="float32"), **fit_outputs("simcc32"))
    ds = SyntheticPoseDataset(F32_TRAIN_BATCH, cfg.model.img_size, K, seed=0)
    compare_f32_step(torch, dev, next(iter(batch_iterator(ds, F32_TRAIN_BATCH, num_workers=8))),
                     cfg.optim.peak_lr, cfg32, phase=13)

    ann, images = root / "annotations" / "person_keypoints_val2017.json", root / "val2017"
    for flags in ((), ("--flip-test",)):
        launches["simcc_eval" + "_flip" * bool(flags)] = eval_cli_run(
            torch, "SimCC eval CLI" + " with flip test" * bool(flags), run, ann, images, n_val,
            flags=flags, k2_per_forward=0, phase=13)

    pred = load_predictor(run / "checkpoints", device=dev)
    rng = np.random.default_rng(131)
    frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    buckets = frontend_buckets()
    total: dict = {}
    for n in SIMCC_FRAME_BOXES:
        boxes = camera_boxes(rng, n)
        out, counts = counted(torch, total, lambda: pred.predict_frame(frame, boxes))
        check_fields(out, n, K, f"SimCC predict_frame, {n} boxes")
        check_attention_route(counts, 12, 0, phase=13)
        check(counts["k2"] == 0, "SimCC predict_frame ran K2")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict_frame(frame, boxes)
            times.append((time.perf_counter() - t0) * 1e3)
        say(f"phase 13 [{card}]: SimCC predict_frame, {n} boxes on a {FRAME_HW[0]} x "
            f"{FRAME_HW[1]} frame (bucket {next(b for b in buckets if b >= n)}): "
            f"{float(np.median(times)):.3f} ms a call (median of 3, host clock)")
    launches["simcc_predict_frame"] = total

    cfg_m = TrainConfig.load(run / "config.json").model
    model32 = build_model(dataclasses.replace(cfg_m, compute_dtype="float32"), dev)
    model32.load_state_dict(pred.model.state_dict())
    pred32 = TopDownPredictor(model32, pred.codec, pred.input_size, return_heatmaps=True,
                              flip_test=True)
    val = COCOPoseDataset(ann, images, cfg_m.img_size)
    crops = val.get_batch(range(EVAL_F32_CROPS))["image"]
    H, W = cfg_m.img_size
    ident = np.tile(np.array([0, 0, W, H], np.float32), (len(crops), 1))
    kern = pred32(crops, ident)
    with plain_versions():
        plain = pred32(crops, ident)
    sel = simcc_well_defined(plain["heatmaps"])
    kerr = float(np.abs(kern["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
    perr = float(np.abs(kern["probabilities"] - plain["probabilities"]).max())
    say(f"phase 13: SimCC f32 predictor with flip test, kernels vs plain, {len(crops)} val "
        f"crops: keypoints {kerr:.3e} px over {int(sel.sum())}/{sel.size} well-defined "
        f"keypoints (tolerance {KPT_TOL_PX:g}), probabilities {perr:.3e} ({PROB_TOL:g})")
    check(sel.mean() > 0.5, "too few SimCC keypoints with a well-defined argmax")
    check(kerr <= KPT_TOL_PX and perr <= PROB_TOL, "the SimCC f32 predictor differs")
    del model32, pred32

    work = RUN_DIR / "phase13" / "infer"
    work.mkdir(parents=True, exist_ok=True)
    image = np.random.default_rng(132).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    PIL.Image.fromarray(image).save(work / "image.png")
    args = ["--checkpoint", str(run / "checkpoints"), "--image", str(work / "image.png"),
            "--output", str(work / "out"), "--device", "cuda"]
    say(f"phase 13: python -m probpose_pytorch_tpu_torch.inference {' '.join(args)}")
    _, counts = counted(torch, {}, lambda: inference.main(args))
    check_attention_route(counts, 12, 0, phase=13)
    check(counts["k2"] == 0, "the SimCC inference CLI ran K2")
    launches["simcc_inference_cli"] = counts
    pngs = sorted((work / "out").glob("heatmap_*.png"))
    Wb, Hb = pred.codec.label.bins
    check(len(pngs) == K and (work / "out" / "output_image.png").is_file(),
          f"the SimCC inference CLI wrote {len(pngs)} heatmaps")
    check(np.asarray(PIL.Image.open(pngs[0])).shape == (Hb, Wb, 4), "SimCC heatmap PNG shape")
    preds = json.loads((work / "out" / "predictions.json").read_text())
    ref = pred(image[None], np.array([[0, 0, 640, 480]], np.float32))
    err = float(np.abs(np.asarray(preds["keypoints"], np.float32) - ref["keypoints"]).max())
    say(f"phase 13: SimCC inference CLI: {len(pngs)} heatmap PNGs of {Hb} x {Wb} (the outer "
        f"product of the two axes' distributions), keypoints vs the in-process predictor "
        f"{err:.3e} px (tolerance {KPT_TOL_PX:g})")
    check(err <= KPT_TOL_PX, f"the SimCC inference CLI's keypoints differ by {err} px")
    return launches


def write_fieldsynth_yolo(root: Path, split: str, n_frames: int, seed: int) -> None:
    """A YOLO-pose split of FS_K-keypoint people on noise frames of
    FS_FRAME_WH: one or two square boxes of even side a frame, keypoints
    on whole pixels inside them (drawn as dots), flags 0 or 2."""
    import PIL.Image

    rng = np.random.default_rng(seed)
    W, H = FS_FRAME_WH
    (root / split / "images").mkdir(parents=True, exist_ok=True)
    (root / split / "labels").mkdir(parents=True, exist_ok=True)
    for i in range(n_frames):
        img = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 3))):
            side = 2 * int(rng.integers(60, 150))
            x0, y0 = int(rng.integers(0, W - side)), int(rng.integers(0, H - side))
            xs = rng.integers(x0, x0 + side, FS_K)
            ys = rng.integers(y0, y0 + side, FS_K)
            v = np.where(rng.random(FS_K) < 0.85, 2, 0)
            for x, y, f in zip(xs, ys, v):
                if f:
                    img[max(y - 3, 0):y + 4, max(x - 3, 0):x + 4] = rng.integers(100, 256, 3)
            row = ["0"] + [f"{c:.6f}" for c in ((x0 + side / 2) / W, (y0 + side / 2) / H,
                                               side / W, side / H)]
            for x, y, f in zip(xs, ys, v):
                row += [f"{x / W:.6f}", f"{y / H:.6f}", str(int(f))]
            rows.append(" ".join(row))
        PIL.Image.fromarray(img).save(root / split / "images" / f"{i:04d}.png")
        (root / split / "labels" / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")


def check_fieldsynth_launches(counts: dict, forwards: int, backwards: int, label: str) -> None:
    """vit-s-timm at 384 x 384 in bf16 (N = 576, d = 32): 12 tiled wgmma
    forwards a forward, 12 wgmma backwards from the saved (out, lse) a
    step, no short forward or CUDA-core kernel, 1 K2 a forward."""
    say(f"phase 13: {label}: K4 forward {counts['k4f']} (expect {12 * forwards}), backward "
        f"{counts['k4b']} (expect {12 * backwards}) with {counts['k4b_recomputes']} forwards "
        f"of its own (expect 0), K2 {counts['k2']} (expect {forwards}); short forward "
        f"{counts['k1s']}, K1 CUDA cores {counts['k1f']} / {counts['k1b']} (expect 0 each)")
    check(counts["k4f"] == 12 * forwards and counts["k4b"] == 12 * backwards,
          f"{label}: K4 did not run once per block")
    check(counts["k4b_recomputes"] == 0, f"{label}: the backward ran a forward of its own")
    check(counts["k1s"] == counts["k1f"] == counts["k1b"] == 0, f"{label}: ran K1")
    check(counts["k2"] == forwards, f"{label}: K2 did not run once per forward")
    check_no_other_kernel(counts, label)


def phase13_fieldsynth_kernels(torch, dev, card: str, g) -> dict:
    """Phase 13 (b): K4 forward and backward at the fieldsynth step's
    (32, 576, 1152), d = 32, and K2 at its (640, 9216) rows, against their
    plain versions, then timed against the library as phase 8 does."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import kernel_path
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        tiled_attention,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_online_bwd_reference,
        tiled_attention_online_reference,
        tiled_attention_reference,
        tiled_forward,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
        sparsemax_reference,
        sparsemax_rows,
    )

    B, N, heads, d = 32, 576, 12, 32
    C = heads * d
    bf16 = torch.bfloat16
    routes = (kernel_path(N, d, bf16), kernel_path(N, d, bf16, backward=True))
    say(f"phase 13: attention_route at N = {N}, d = {d}, bf16: forward {routes[0]!r}, "
        f"backward {routes[1]!r}")
    check(routes == ("sm90 tiled", "sm90 tiled"), f"fieldsynth attention routes {routes}")
    qkv = torch.randn(B, N, 3 * C, generator=g, device=dev).to(bf16)
    dout = torch.randn(B, N, C, generator=g, device=dev).to(bf16)
    label = f"K4 forward qkv ({B}, {N}, {3 * C}) bf16, d = {d}"
    out, lse = tiled_forward(qkv, heads, with_lse=True)
    fwd_err = gate(torch, label, tiled_attention(qkv, heads),
                   tiled_attention_reference(qkv, heads), phase=13)
    ref, _ = tiled_attention_online_reference(qkv, heads)
    rel_gate(torch, f"{label} against the kernel-order plain version", out, ref, 1, phase=13)
    label = f"K4 backward qkv ({B}, {N}, {3 * C}) bf16, d = {d}"
    got = tiled_attention_backward(qkv, dout, heads, out, lse)
    bwd_err = gate(torch, label, got, tiled_attention_bwd_reference(qkv, dout, heads),
                   phase=13)
    check(torch.equal(got, tiled_attention_backward(qkv, dout, heads, out, lse)),
          "K4 backward at N = 576 differs between runs")
    rel_gate(torch, f"{label} against the kernel-order plain version", got,
             tiled_attention_online_bwd_reference(qkv, dout, heads), 3, phase=13)
    fwd_ms, fwd_plain = paired_ms(torch, lambda: tiled_attention(qkv, heads),
                                  lambda: tiled_attention_reference(qkv, heads), iters=5)
    _, fwd_lib = yardstick_ms(torch, lambda: tiled_attention(qkv, heads),
                              sdpa_fwd_fn(torch, qkv, heads))
    bwd_ms, bwd_plain = paired_ms(
        torch, lambda: tiled_attention_backward(qkv, dout, heads, out, lse),
        lambda: tiled_attention_bwd_reference(qkv, dout, heads), iters=5)
    _, bwd_lib = yardstick_ms(torch, lambda: tiled_attention_backward(qkv, dout, heads, out, lse),
                              sdpa_bwd_fn(torch, qkv, dout, heads))
    fwd_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * C)
    bwd_bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * B * N * N * C)
    say(f"phase 13 [{card}]: K4 at qkv ({B}, {N}, {3 * C}) bf16, d = {d}: forward {fwd_ms:.4f} "
        f"ms (plain {fwd_plain:.4f}, scaled_dot_product_attention {fwd_lib:.4f}, bound "
        f"{fwd_bound[0]:.4f} {fwd_bound[1]}); backward from the saved out and lse {bwd_ms:.4f} "
        f"ms (plain {bwd_plain:.4f}, scaled_dot_product_attention backward {bwd_lib:.4f}, "
        f"bound {bwd_bound[0]:.4f} {bwd_bound[1]})")
    del qkv, dout, out, lse, got, ref
    z = k2_rows(torch, g, B * FS_K, 96 * 96, "random")
    k2_err = k2_check(torch, z, "random, the fieldsynth step's rows", phase=13)
    k2_ms, k2_plain = paired_ms(torch, lambda: sparsemax_rows(z),
                                lambda: sparsemax_reference(z), iters=10)
    k2_bound = bound_ms(2 * nbytes(z), 96 * z.numel(), "float32")
    say(f"phase 13 [{card}]: K2 ({B * FS_K}, {96 * 96}) f32: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain:.4f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    shape = lambda err, ms, plain, bound, lib, dims: dict(
        shape=dims, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
        bound_by=bound[1], library_ms=lib)
    return dict(k4f=shape(fwd_err, fwd_ms, fwd_plain, fwd_bound, fwd_lib, [B, N, 3 * C]),
                k4b=shape(bwd_err, bwd_ms, bwd_plain, bwd_bound, bwd_lib, [B, N, 3 * C]),
                k2=shape(k2_err, k2_ms, k2_plain, k2_bound, None, [B * FS_K, 96 * 96]))


def phase13_fieldsynth(torch, dev, card: str, g) -> tuple[dict, dict]:
    """Phase 13 (b): configs/reference_parity_fieldsynth.json as shipped on
    a 20-keypoint YOLO set through the training CLI, Trainer.validate on
    its `valid` split, its f32 step, its kernels at their shapes, and the
    set's COCO conversion loaded back."""
    from probpose_pytorch_tpu_torch.data import (
        COCOPoseDataset,
        SyntheticPoseDataset,
        YOLOPoseDataset,
        batch_iterator,
    )
    from probpose_pytorch_tpu_torch.data.convert_format import main as convert_main
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    config = REPO / "configs/reference_parity_fieldsynth.json"
    cfg = TrainConfig.load(config)
    check(cfg.augment is None and cfg.optim.ema_decay is None
          and cfg.optim.max_nonfinite_skips == 0 and cfg.model.num_keypoints == FS_K,
          "the fieldsynth recipe's values changed")
    root = RUN_DIR / "phase13" / "field"
    t0 = time.perf_counter()
    write_fieldsynth_yolo(root, "train", FS_TRAIN_FRAMES, seed=13)
    write_fieldsynth_yolo(root, "valid", FS_VAL_FRAMES, seed=14)
    H, W = cfg.model.img_size
    val_ds = YOLOPoseDataset(root, "valid", (H, W))
    n_train = len(YOLOPoseDataset(root, "train", (H, W)))
    say(f"phase 13: YOLO set of {FS_K}-keypoint people, {n_train} train and {len(val_ds)} valid "
        f"instances on {FS_FRAME_WH[0]} x {FS_FRAME_WH[1]} frames, written in "
        f"{time.perf_counter() - t0:.2f} s")
    check(n_train >= cfg.train_batch_size, "too few fieldsynth training instances")
    launches = {}
    runs = cli_runs(torch, card, "fieldsynth recipe", config, RUN_DIR / "phase13" / "fieldrun",
                    ("--data-root", str(root)), phase=13)
    val_forwards = len(val_ds) // cfg.val_batch_size
    for i, (_, counts, _) in enumerate(runs):
        check_fieldsynth_launches(counts, RECIPE_STEPS + (val_forwards if i == 0 else 0),
                                  RECIPE_STEPS, f"fieldsynth CLI run {i + 1}")
        launches[f"fieldsynth_cli_{i + 1}"] = counts
    trainer = runs[1][0]
    reset_counts()
    t0 = time.perf_counter()
    val = trainer.validate(lambda: batch_iterator(val_ds, cfg.val_batch_size, num_workers=8),
                           trainer.state.host_step)
    torch.cuda.synchronize()
    counts = read_counts()
    check(val is not None and all(np.isfinite(v) for v in val.values()) and "acc/kpt" in val,
          "fieldsynth validation is missing or not finite")
    check_fieldsynth_launches(counts, val_forwards, 0, "fieldsynth Trainer.validate")
    launches["fieldsynth_validate"] = counts
    say(f"phase 13 [{card}]: fieldsynth Trainer.validate on the valid split, {val_forwards} "
        f"batches of {cfg.val_batch_size}: {time.perf_counter() - t0:.2f} s; loss "
        f"{val['loss']:.6g}, acc/kpt {val['acc/kpt']:.4f}")
    step_ms = recipe_step_ms(torch, trainer, FS_K)
    B = cfg.train_batch_size
    say(f"phase 13 [{card}]: fieldsynth recipe bf16 step, B = {B} crops of {H} x {W} on the "
        f"card: {step_ms:.3f} ms = {B / step_ms * 1e3:.1f} crops/s (CUDA events, mean of "
        f"{FT_TIMED_STEPS})")
    del trainer, runs
    gc.collect()

    cfg32 = dataclasses.replace(
        cfg, train_batch_size=FS_F32_BATCH, log_every=1, resume=False,
        model=dataclasses.replace(cfg.model, compute_dtype="float32"), **fit_outputs("field32"))
    ds = SyntheticPoseDataset(FS_F32_BATCH, (H, W), FS_K, seed=0)
    # f32 at N = 576 runs K1's or K4's CUDA cores, whose sums run in another
    # order than the plain path's: the scalar branches' max-pools route, as
    # in phases 7 and 8.
    compare_f32_step(torch, dev, next(iter(batch_iterator(ds, FS_F32_BATCH, num_workers=8))),
                     cfg.optim.peak_lr, cfg32, phase=13, routed=("head.branches.",),
                     floor=2**-23)
    gc.collect()
    shapes = phase13_fieldsynth_kernels(torch, dev, card, g)

    ann = root / "valid_coco.json"
    args = ["yolo2coco", "--root", str(root), "--split", "valid", "--out", str(ann)]
    say(f"phase 13: python -m probpose_pytorch_tpu_torch.data.convert_format {' '.join(args)}")
    convert_main(args)
    coco = COCOPoseDataset(ann, root / "valid" / "images", (H, W), bbox_scale=1.0,
                           resample="lanczos")
    check(len(coco) == len(val_ds), f"{len(coco)} converted instances, {len(val_ds)} YOLO ones")
    for i in range(len(val_ds)):
        a, b = coco[i], val_ds[i]
        check(all(np.array_equal(a[k], b[k]) for k in b),
              f"converted sample {i} differs from the YOLO loader's")
    say(f"phase 13: COCOPoseDataset on the yolo2coco output (the YOLO loader's crop: the box as "
        f"it is, Lanczos) gives YOLOPoseDataset's {len(val_ds)} samples bit for bit")
    return launches, shapes


def state_bytes(tree) -> int:
    """Bytes of every tensor in an optimizer state (dataclasses, lists)."""
    if dataclasses.is_dataclass(tree):
        return sum(state_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(t) for t in tree)
    return nbytes(tree)


def phase13_optimizers(torch, dev, card: str, root: Path, n_val: int) -> dict:
    """Phase 13 (c): the flagship with AdamW, Lion, then Adafactor on the
    cosine schedule (OPT_STEPS bf16 steps at OPT_BATCH after an untimed
    first, timed in turn; for Lion and Adafactor one f32 step, kernels
    against plain), and the training CLI on a mixed set."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.data.convert_format import coco_to_yolo
    from probpose_pytorch_tpu_torch.train import cli
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    adam = CheckpointManager(RUN_DIR / "recipe" / "checkpoints").read(mmap=True)["opt_state"]
    adam_bytes = nbytes(*adam["mu"], *adam["nu"])
    launches = {}
    for family in ("adamw", "lion", "adafactor"):
        pick = lambda cfg: dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, optimizer=family, schedule="cosine"))
        cfg = pick(train_config("bfloat16", OPT_BATCH))
        trainer = make_trainer(torch, cfg, dev)
        ds = SyntheticPoseDataset(OPT_BATCH, cfg.model.img_size, cfg.model.num_keypoints, seed=5)
        db = trainer.device_batch(next(iter(batch_iterator(ds, OPT_BATCH, num_workers=8))))
        losses = [trainer.train_step(trainer.state, db)[1]["loss"]]  # the first step, untimed
        reset_counts()
        ms = cuda_ms(torch, lambda: losses.append(trainer.train_step(trainer.state, db)[1]["loss"]),
                     iters=OPT_STEPS, warmup=0)
        counts = read_counts()
        check_attention_route(counts, 12 * OPT_STEPS, 12 * OPT_STEPS, phase=13)
        check(counts["k2"] == OPT_STEPS, f"{family}: K2 did not run once per step")
        launches[f"{family}_steps"] = counts
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{family}: a loss is not finite")
        opt_bytes = state_bytes(trainer.state.opt_state)
        say(f"phase 13 [{card}]: flagship with {family} and the cosine schedule, B = "
            f"{OPT_BATCH}, bf16: {ms:.3f} ms a step (CUDA events, mean of steps 2 to "
            f"{OPT_STEPS + 1}); losses {', '.join(f'{x:.6g}' for x in losses)}; optimizer state "
            f"{opt_bytes / 2**20:.2f} MiB (AdamW's in phase 9's checkpoint: "
            f"{adam_bytes / 2**20:.2f} MiB)")
        del trainer, db
        gc.collect()
        if family == "adamw":
            continue  # its f32 step is phase 5's
        cfg32 = pick(train_config("float32", F32_TRAIN_BATCH))
        cfg32 = dataclasses.replace(cfg32, **fit_outputs(f"{family}32"))
        ds = SyntheticPoseDataset(F32_TRAIN_BATCH, cfg32.model.img_size,
                                  cfg32.model.num_keypoints, seed=0)
        compare_f32_step(torch, dev, next(iter(batch_iterator(ds, F32_TRAIN_BATCH,
                                                              num_workers=8))),
                         cfg32.optim.peak_lr, cfg32, phase=13)
        gc.collect()

    yolo = RUN_DIR / "phase13" / "yolo_copy"
    for split, src in (("train", "train2017"), ("valid", "val2017")):
        coco_to_yolo(root / "annotations" / f"person_keypoints_{src}.json", root / src, yolo,
                     split)
    cfg = TrainConfig.load(REPO / "configs/flagship_coco_vits.json")
    cfg = dataclasses.replace(cfg, dataset_format="mixed", mixed_datasets=(
        {"root": str(root), "format": "coco", "repeat": 1},
        {"root": str(yolo), "format": "yolo", "repeat": 2}))
    config = RUN_DIR / "phase13" / "mixed.json"
    cfg.save(config)
    run = RUN_DIR / "phase13" / "mixed"
    args = [str(run), "--config", str(config), "--max-steps", str(MIXED_STEPS), "--device",
            "cuda"]
    say(f"phase 13: python -m probpose_pytorch_tpu_torch.train.cli {' '.join(args)} "
        f"(dataset_format mixed: {cfg.mixed_datasets})")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    forwards = MIXED_STEPS + n_val // cfg.val_batch_size
    check_attention_route(counts, 12 * forwards, 12 * MIXED_STEPS, phase=13)
    check(counts["k2"] == forwards, "mixed: K2 did not run once per forward")
    launches["mixed_cli"] = counts
    train, _ = cli.build_datasets(TrainConfig.load(run / "config.json"))
    sizes = [len(ds) for ds in train.datasets]
    check(len(train) == sizes[0] + 2 * sizes[1], "the mixed set is not weighted 1 : 2")
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    check(all(np.isfinite(v) for x in lines for v in x.values()), "mixed: a value not finite")
    check((run / "checkpoints" / str(MIXED_STEPS)).is_file(), "mixed: no checkpoint")
    say(f"phase 13 [{card}]: mixed CLI, {MIXED_STEPS} steps over {sizes[0]} COCO and "
        f"{sizes[1]} YOLO instances (repeats 1 and 2, {len(train)} an epoch): {wall:.2f} s wall")
    return launches


def phase13(torch, dev, card: str, g) -> tuple[dict, dict]:
    """Phase 13: the SimCC recipe, the fieldsynth recipe, Lion and Adafactor
    and mixed data, on phase 11's synthetic COCO-format set; returns each
    run's launch counts and the fieldsynth kernels' numbers at its shapes."""
    from probpose_pytorch_tpu_torch.data import COCOPoseDataset

    t_phase = time.perf_counter()
    root = RUN_DIR / "finetune" / "coco"
    n_val = len(COCOPoseDataset(root / "annotations" / "person_keypoints_val2017.json",
                                root / "val2017", (256, 192)))
    launches = phase13_simcc(torch, dev, card, root, n_val)
    gc.collect()
    torch.cuda.empty_cache()
    field, shapes = phase13_fieldsynth(torch, dev, card, g)
    launches.update(field)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase13_optimizers(torch, dev, card, root, n_val))
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all")
    return launches, shapes


# ------------------------------------------------------------------ phase 14
# The detector and bottom-up family: the detect CLI, eval, standalone and
# fused serving, the server, the video CLI, a conv-trunk pose model, doctor.
DET_TRAIN_FRAMES = 32
DET_VAL_FRAMES = 16
DET_FRAME_HW = (480, 480)
DET_IMG = 512
DET_BATCH = 16
DET_STEPS = 3
DET_PRESET = "conv-s"
# The f32 DetectorTrainer step card vs CPU runs at this input (its CPU half
# costs seconds a step at 512).
DET_F32_IMG = 256
FUSED_PEOPLE = 8
FUSED_FRAMES = 4  # frames a dispatch in the two-stage vs fused timing
DET_VIDEO_FRAMES = 6
# Card vs CPU: an f32 forward of the same weights, normwise relative error.
DET_FWD_REL_TOL = 1e-5


def det_cli_run(torch, card: str, label: str, root: Path, out: Path, extra=()) -> tuple:
    """`python -m probpose_pytorch_tpu_torch.detect.train` (on the card, its
    default) at DET_PRESET, DET_IMG, DET_BATCH for DET_STEPS steps: finite
    losses, detector.json and checkpoints/DET_STEPS. Returns (logged terms,
    wall s)."""
    from probpose_pytorch_tpu_torch.detect import train as detect_train

    args = ["--data-root", str(root), "--out", str(out), "--steps", str(DET_STEPS),
            "--batch-size", str(DET_BATCH), "--img-size", str(DET_IMG), "--preset", DET_PRESET,
            "--log-every", "1", "--num-workers", "4", *extra]
    say(f"phase 14: python -m probpose_pytorch_tpu_torch.detect.train {' '.join(args)}")
    t0 = time.perf_counter()
    logged = detect_train.main(args)
    wall = time.perf_counter() - t0
    check(len(logged) == DET_STEPS and all(np.isfinite(v) for t in logged for v in t.values()),
          f"{label}: a loss is not finite: {logged}")
    check((out / "detector.json").is_file() and (out / "checkpoints" / str(DET_STEPS)).is_file(),
          f"{label}: no detector.json or checkpoints/{DET_STEPS}")
    say(f"phase 14 [{card}]: {label} CLI: {DET_STEPS} steps in {wall:.2f} s wall (build, data "
        f"and checkpoint included); last terms {logged[-1]}")
    return logged, wall


def check_restored(torch, label: str, model, ckpt: Path) -> None:
    """The loaded model holds the checkpoint's tensors bit for bit."""
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    named = {**saved["params"], **saved["buffers"]}
    bad = [k for k, v in model.state_dict().items() if not torch.equal(v.cpu(), named[k])]
    check(not bad, f"{label}: restored tensors differ: {bad[:3]}")


def det_f32_model(torch, state: dict, dev, **kw):
    """An f32 PersonDetector of DET_PRESET with `state`, in eval mode."""
    from probpose_pytorch_tpu_torch.detect.model import PersonDetector

    model = PersonDetector(img_size=(DET_IMG, DET_IMG), preset=DET_PRESET, dtype=torch.float32,
                           **kw)
    model.load_state_dict(state)
    return model.to(dev).eval()


def phase14_card_vs_cpu(torch, dev, card: str, bu_model) -> None:
    """Phase 14 (3, 4): the f32 bottom-up model (every head) on the card
    against the CPU, TF32 off; decode_boxes and decode_poses on the same
    maps, card against CPU; an f32 DetectorTrainer step, card against CPU."""
    from probpose_pytorch_tpu_torch.detect import DetectorTrainer
    from probpose_pytorch_tpu_torch.detect.codec import decode_boxes, decode_poses

    state = {k: v.cpu() for k, v in bu_model.state_dict().items()}
    kw = dict(num_keypoints=17, kpt_heatmaps=True)
    card_m, cpu_m = det_f32_model(torch, state, dev, **kw), det_f32_model(torch, state, "cpu", **kw)
    x = torch.rand(1, DET_IMG, DET_IMG, 3, generator=torch.Generator().manual_seed(140))
    with torch.no_grad():
        ref, out = cpu_m(x), card_m(x.to(dev))
    rels = {k: ((out[k].cpu() - ref[k]).norm() / ref[k].norm()).item() for k in ref}
    say(f"phase 14: f32 {DET_PRESET} bottom-up forward at {DET_IMG}^2, card vs CPU, normwise "
        f"relative error per map: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + f" (tolerance {DET_FWD_REL_TOL:g})")
    check(max(rels.values()) <= DET_FWD_REL_TOL, f"f32 detector forward card vs CPU: {rels}")
    maps = {k: v.cpu() for k, v in ref.items()}
    on = {k: v.to(dev) for k, v in maps.items()}
    # The peaks' cells decide boxes and poses: equal. Scores are sigmoids,
    # whose CUDA and CPU versions may differ by an ulp: within two.
    box_args = ("center", "size", "offset")

    def pose_args(m):
        return dict(center_logits=m["center"], size=m["size"], offset=m["offset"],
                    kpts=m["kpts"], kpt_heat=m["kpt_heat"], kpt_offset=m["kpt_offset"])

    outs = {"decode_boxes": (decode_boxes(*(on[k] for k in box_args), k=64),
                             decode_boxes(*(maps[k] for k in box_args), k=64), ("boxes",)),
            "decode_poses": (decode_poses(**pose_args(on), k=32),
                             decode_poses(**pose_args(maps), k=32), ("boxes", "", "poses"))}
    serr = 0.0
    for fn, (got, want, exact) in outs.items():
        for i, (o, r) in enumerate(zip(got, want)):
            if i < len(exact) and exact[i]:
                check(torch.equal(o.cpu(), r), f"{fn} {exact[i]} on the card differ from the CPU's")
            else:
                rel = ((o.cpu() - r).abs() / r.abs().clamp_min(1e-30)).max().item()
                serr = max(serr, rel)
                check(rel <= 2.4e-7, f"{fn} scores differ by {rel:.2e} relative")
    say(f"phase 14: decode_boxes (k = 64) and decode_poses (k = 32, snap) on the card: boxes "
        f"and poses equal to the CPU's; scores within {serr:.1e} relative (2 ulps: 2.4e-7)")

    # One f32 step each side from the same weights (card_m's), B = 2.
    rng = np.random.default_rng(141)
    H = W = DET_F32_IMG + 64
    boxes = np.concatenate([rng.uniform(0, 0.6 * W, (2, 4, 2)),
                            rng.uniform(30, 0.4 * W, (2, 4, 2))], -1).astype(np.float32)
    kp = boxes[..., None, :2] + rng.uniform(0, 1, (2, 4, 17, 2)) * boxes[..., None, 2:]
    batch = dict(frame=rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8), boxes=boxes,
                 box_mask=np.ones((2, 4), np.float32),
                 ignore_boxes=np.zeros((2, 2, 4), np.float32), ignore_mask=np.zeros((2, 2),
                                                                                    np.float32),
                 keypoints=np.concatenate([kp, np.full((2, 4, 17, 1), 2.0)], -1).astype(
                     np.float32))
    trainers = [DetectorTrainer.create(img_size=(DET_F32_IMG, DET_F32_IMG), preset=DET_PRESET,
                                       total_steps=40, num_keypoints=17, kpt_heatmaps=True,
                                       dtype=torch.float32, device=d) for d in (dev, "cpu")]
    for t in trainers:
        t.model.load_state_dict(state)
    terms = [t.train_step(batch) for t in trainers]
    rel = {k: abs(terms[0][k].item() - terms[1][k].item()) / abs(terms[1][k].item())
           for k in terms[1]}
    lr0 = float(trainers[1].tx.schedule(torch.tensor(0)))
    sd_card = trainers[0].model.state_dict()
    pdiff = max((sd_card[n].cpu() - v).abs().max().item()
                for n, v in trainers[1].model.state_dict().items()
                if v.is_floating_point() and "running" not in n)
    sdiff = max((sd_card[n].cpu() - v).abs().max().item() / max(1.0, v.abs().max().item())
                for n, v in trainers[1].model.state_dict().items() if "running" in n)
    say(f"phase 14: f32 DetectorTrainer step ({DET_PRESET}, {DET_F32_IMG}^2, B = 2, 17 joints "
        f"with heat heads), card vs CPU: loss terms relative "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (tolerance 1e-4); params max diff {pdiff:.2e} (Adam's bound 2 lr = {2 * lr0:.2e}); "
        f"BN statistics {sdiff:.2e} of their scale (1e-4)")
    check(max(rel.values()) <= 1e-4, f"f32 detector step loss terms: {rel}")
    check(pdiff <= 2 * lr0 * 1.01, f"f32 detector step params differ by {pdiff}")
    check(sdiff <= 1e-4, f"f32 detector step BN statistics differ by {sdiff}")


def phase14_eval(torch, card: str, root: Path, det_run: Path, bu_run: Path) -> dict:
    """Phase 14 (5): the eval CLI with --detector (phase 9's checkpoint,
    threshold 0) and with --bottomup; JAX's keys, AP/AR finite in [0, 1];
    12 short K1 forwards and 1 K2 a pose forward, none with --bottomup."""
    from probpose_pytorch_tpu_torch.eval import run as eval_run

    ann, images = root / "annotations" / "person_keypoints_val2017.json", root / "val2017"
    raw = json.loads(ann.read_text())
    n_images = len({a["image_id"] for a in raw["annotations"]})
    keys = set(EVAL_AP_KEYS) | {"det_ap50", "det_recall50"}
    out = {}
    for label, args, extra_keys in (
            ("eval_detector", ["--checkpoint", str(RUN_DIR / "recipe" / "checkpoints"),
                               "--detector", str(det_run), "--detector-threshold", "0"],
             {"det_per_image"}),
            ("eval_bottomup", ["--bottomup", str(bu_run), "--detector-threshold", "0"], set())):
        argv = args + ["--annotations", str(ann), "--images", str(images)]
        say(f"phase 14: python -m probpose_pytorch_tpu_torch.eval.run {' '.join(argv)}")
        reset_counts()
        t0 = time.perf_counter()
        line = eval_run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(set(line) == keys | extra_keys, f"{label}: keys {sorted(line)}")
        check(all(np.isfinite(line[k]) and 0.0 <= line[k] <= 1.0
                  for k in keys if not k.startswith("det_per")), f"{label}: {line}")
        if label == "eval_detector":
            dispatches = n_images * -(-64 // frontend_buckets()[-1])
            say(f"phase 14: {label}: {dispatches} pose forwards ({n_images} images, 64 "
                f"detections each at threshold 0)")
            check_attention_route(counts, 12 * dispatches, 0, phase=14)
            check(counts["k2"] == dispatches, f"{label}: K2 {counts['k2']} != {dispatches}")
        else:
            check(all(v == 0 for v in counts.values()),
                  f"{label}: the single-stage model launched a kernel: {counts}")
        check_no_other_kernel(counts, label)
        say(f"phase 14 [{card}]: {label}: {wall:.2f} s wall; launches {counts}; line {line}")
        out[label] = counts
    return out


def phase14_standalone(torch, dev, card: str, det_run: Path) -> dict:
    """Phase 14 (6): TopDownPredictor(detector=).predict_frame(frame) and
    FusedTwoStagePredictor at FUSED_PEOPLE slots on 1080 x 1920 frames:
    in f32 each fused slot against the two-stage pose for its box and the
    kernels against the plain versions, within KPT_TOL_PX on well-defined
    keypoints; the fused device path under set_sync_debug_mode("error");
    bf16 launches; then two-stage against fused frames/s, in turns."""
    from probpose_pytorch_tpu_torch.detect import (
        DetectorPredictor,
        FusedTwoStagePredictor,
        load_detector,
    )
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    recipe = RUN_DIR / "recipe"
    det = load_detector(det_run / "checkpoints", score_threshold=0.0, max_detections=64)
    pose = load_predictor(recipe / "checkpoints", device=dev)
    det32 = DetectorPredictor(det_f32_model(torch, {k: v.cpu() for k, v in
                                                   det.model.state_dict().items()}, dev),
                              score_threshold=0.0, max_detections=64)
    cfg32 = dataclasses.replace(TrainConfig.load(recipe / "config.json").model,
                                compute_dtype="float32")
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(pose.model.state_dict())
    peak_heatmap_branch(torch, model32)
    pose32 = TopDownPredictor(model32, pose.codec, pose.input_size)
    heat32 = TopDownPredictor(model32, pose.codec, pose.input_size, return_heatmaps=True,
                              detector=det32)
    rng = np.random.default_rng(142)
    frames = rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    fused32 = FusedTwoStagePredictor(det32, pose32, max_people=FUSED_PEOPLE, score_threshold=0.0)
    out = fused32(frames)
    kerr = 0.0
    n_sel = n_all = 0
    for b in range(len(frames)):
        two = heat32.predict_frame(frames[b], detector_threshold=0.0)
        check(len(two["boxes"]) == 64, f"two-stage kept {len(two['boxes'])} of 64 boxes")
        berr = float(np.abs(out["boxes"][b] - two["boxes"][:FUSED_PEOPLE]).max())
        check(berr <= 1e-3, f"fused crop boxes differ from the two-stage ones by {berr} px")
        sel = well_defined(torch, pose.codec, two["heatmaps"][:FUSED_PEOPLE], dev)
        kerr = max(kerr, float(np.abs(out["keypoints"][b] - two["keypoints"][:FUSED_PEOPLE])
                               [sel].max(initial=0.0)))
        n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.size
    with plain_versions():
        plain = fused32(frames)
    ids = np.repeat(np.arange(len(frames)), FUSED_PEOPLE)
    hm = heat32(frames, out["boxes"].reshape(-1, 4), ids)["heatmaps"]
    sel = well_defined(torch, pose.codec, hm, dev).reshape(len(frames), FUSED_PEOPLE, -1)
    perr = float(np.abs(out["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
    say(f"phase 14: f32 fused ({FUSED_PEOPLE} slots) vs two-stage predict_frame on "
        f"{len(frames)} frames of {FRAME_HW[0]} x {FRAME_HW[1]}: keypoints max diff {kerr:.3e} px "
        f"over {n_sel}/{n_all} well-defined; fused kernels vs plain {perr:.3e} px over "
        f"{int(sel.sum())}/{sel.size} (tolerance {KPT_TOL_PX:g})")
    check(n_sel > n_all / 2 and sel.mean() > 0.5, "too few keypoints with a well-defined argmax")
    check(kerr <= KPT_TOL_PX, f"fused keypoints differ from the two-stage ones by {kerr} px")
    check(perr <= KPT_TOL_PX, f"fused kernels differ from plain by {perr} px")

    # bf16: launches, the sync check, and times in turns.
    fused = FusedTwoStagePredictor(det, pose, max_people=FUSED_PEOPLE, score_threshold=0.0)
    pose.detector = det
    batch = rng.integers(0, 256, (FUSED_FRAMES, *FRAME_HW, 3), dtype=np.uint8)
    f_dev = torch.from_numpy(batch).to(dev)
    fused.predict(f_dev)  # warm: builds the codec's constants on the card
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = fused.predict(f_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = read_counts()
    check(res["keypoints"].shape == (FUSED_FRAMES, FUSED_PEOPLE, 17, 2)
          and bool(torch.isfinite(res["keypoints"]).all()), "fused bf16 outputs")
    say(f"phase 14: the fused device path ({FUSED_FRAMES} frames) ran under "
        f"set_sync_debug_mode('error'): no host synchronisation between its stages")
    check_attention_route(counts, 12, 0, phase=14)
    check(counts["k2"] == 1, f"fused: K2 {counts['k2']} != 1")
    launches = {"fused": counts}
    two_counts = {}
    _, two_counts = counted(torch, {}, lambda: pose.predict_frame(batch[0],
                                                                  detector_threshold=0.0))
    check_attention_route(two_counts, 12, 0, phase=14)
    check(two_counts["k2"] == 1, "two-stage: K2 did not run once")
    launches["two_stage"] = two_counts

    def two_stage():
        for f in batch:
            boxes = pose.predict_frame(f, detector_threshold=0.0)["boxes"]
            check(len(boxes) == 64, "two-stage boxes")
    run_fused = lambda: fused(batch)  # noqa: E731
    times = {}
    for name, fn in (("two-stage", two_stage), ("fused", run_fused), ("fused", run_fused),
                     ("two-stage", two_stage)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(3 * FUSED_FRAMES / (time.perf_counter() - t0))
    say(f"phase 14 [{card}]: bf16 at {FRAME_HW[0]} x {FRAME_HW[1]}, from host numpy: two-stage "
        f"predict_frame (64 detections a frame, one pose dispatch each) "
        f"{np.mean(times['two-stage']):.2f} frames/s, fused ({FUSED_PEOPLE} slots, "
        f"{FUSED_FRAMES} frames a dispatch) {np.mean(times['fused']):.2f} frames/s (host clock, "
        f"3 calls, two-stage, fused, fused, two-stage: {times})")
    return launches


def phase14_server(torch, dev, det_run: Path, bu_run: Path) -> None:
    """Phase 14 (7): PoseHTTPServer in this process with a detector, a
    bottom-up and a fused model: requests without boxes answered with the
    right shapes, fused rows with det_scores."""
    import base64

    from probpose_pytorch_tpu_torch.detect import (
        FusedTwoStagePredictor,
        load_bottomup,
        load_detector,
    )
    from probpose_pytorch_tpu_torch.inference import load_predictor
    from probpose_pytorch_tpu_torch.serve import MicroBatcher, PoseHTTPServer
    from probpose_pytorch_tpu_torch.serve.server import BottomUpRunner, FusedRunner

    det = load_detector(det_run / "checkpoints", score_threshold=0.0)
    pose = load_predictor(RUN_DIR / "recipe" / "checkpoints", device=dev)
    bu = load_bottomup(bu_run, score_threshold=0.0)
    fused = FusedTwoStagePredictor(det, load_predictor(RUN_DIR / "recipe" / "checkpoints",
                                                       device=dev),
                                   max_people=FUSED_PEOPLE, score_threshold=0.0)
    batchers = {"pose": MicroBatcher(pose, frontend_buckets(), FRAME_HW, indexed=True),
                "bu": MicroBatcher(BottomUpRunner(bu), (1, 2, 4, 8), FRAME_HW),
                "fused": MicroBatcher(FusedRunner(fused), (1, 2, 4), FRAME_HW)}
    srv = PoseHTTPServer(batchers, host="127.0.0.1", port=0, detector=det)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/predict"
        frame = np.random.default_rng(143).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
        b64 = base64.b64encode(frame.tobytes()).decode()
        shapes = {}
        for model, K in (("pose", 17), ("bu", 17), ("fused", 17)):
            body = json.dumps({"frame_b64": b64, "shape": list(frame.shape),
                               "model": model}).encode()
            status, out = post_json(url, body)
            check(status == 200, f"server {model}: {status} {out}")
            n = len(out["keypoints"])
            want = {"pose": 64, "bu": 32, "fused": FUSED_PEOPLE}[model]
            check(n == want and np.asarray(out["keypoints"]).shape == (n, K, 2)
                  and np.isfinite(np.asarray(out["keypoints"], np.float32)).all(),
                  f"server {model}: keypoints {np.asarray(out['keypoints']).shape}")
            check(len(out["boxes"]) == n, f"server {model}: boxes")
            if model == "fused":
                check(len(out["det_scores"]) == n, "server fused: no det_scores")
            shapes[model] = sorted(out)
        say(f"phase 14: the server in process answered whole-frame requests: top-down with the "
            f"detector 64 poses, bottom-up 32, fused {FUSED_PEOPLE} with det_scores; keys "
            f"{shapes}")
    finally:
        srv.shutdown()


def phase14_video(torch, dev, card: str, det_run: Path, bu_run: Path) -> None:
    """Phase 14 (8): the video CLI with --detector (per frame), --detector
    --fused, and --bottomup on a short clip: a record per frame of the
    right shape."""
    from probpose_pytorch_tpu_torch import video

    work = RUN_DIR / "phase14_video"
    work.mkdir(parents=True, exist_ok=True)
    frames, _ = video_input(DET_VIDEO_FRAMES, 144)
    np.save(work / "frames.npy", frames)
    ckpt = str(RUN_DIR / "recipe" / "checkpoints")
    for label, args, n in (
            ("--detector", ["--checkpoint", ckpt, "--detector", str(det_run / "checkpoints")], 64),
            ("--detector --fused", ["--checkpoint", ckpt, "--detector",
                                    str(det_run / "checkpoints"), "--fused", "--max-people",
                                    str(FUSED_PEOPLE)], FUSED_PEOPLE),
            ("--bottomup", ["--bottomup", str(bu_run)], 32)):
        out = work / label.replace(" ", "").replace("-", "_")
        argv = args + ["--frames", str(work / "frames.npy"), "--detector-threshold", "0",
                       "--nms", "none", "--out", str(out)]
        say(f"phase 14: python -m probpose_pytorch_tpu_torch.video {' '.join(argv)}")
        t0 = time.perf_counter()
        video.main(argv)
        wall = time.perf_counter() - t0
        recs = [json.loads(x) for x in (out / "poses.jsonl").read_text().splitlines()]
        check(len(recs) == DET_VIDEO_FRAMES, f"video {label}: {len(recs)} records")
        for r in recs:
            k = np.asarray(r["keypoints"], np.float32)
            check(k.shape == (n, 17, 2) and np.isfinite(k).all()
                  and np.asarray(r["boxes"]).shape == (n, 4), f"video {label}: {k.shape}")
        say(f"phase 14 [{card}]: video CLI {label}: {DET_VIDEO_FRAMES} frames of {VIDEO_HW[0]} x "
            f"{VIDEO_HW[1]}, {n} poses a frame, {wall:.2f} s wall (loads included)")


def phase14_conv_pose(torch, dev, card: str) -> dict:
    """Phase 14 (9): the flagship's ProbMap model on a conv-s trunk answers
    requests of REQUEST_SIZES crops with 0 K1 and 1 K2 a forward; its f32
    kernel path equals the plain one within KPT_TOL_PX."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
    from probpose_pytorch_tpu_torch.ops.kernels import plain_versions

    block = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())["model"]
    cfg = ModelConfig(**dict(block, backbone="conv-s"))
    model = build_model(cfg, dev, seed=14)
    codec = make_codec(cfg)
    pred = TopDownPredictor(model, codec, cfg.img_size, return_heatmaps=True)
    requests = [request(140 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    answers, counts = counted(torch, {}, lambda: [pred(f, b) for f, b in requests])
    check_answers(cfg, requests, answers, phase=14)
    say(f"phase 14: conv-s pose model, {len(requests)} forwards: launches {counts}")
    check(counts["k2"] == len(requests), "conv-s pose: K2 did not run once a forward")
    check(all(v == 0 for k, v in counts.items() if k != "k2"), f"conv-s pose ran {counts}")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(model.state_dict())
    peak_heatmap_branch(torch, model32)
    pred32 = TopDownPredictor(model32, codec, cfg.img_size, return_heatmaps=True)
    frames, boxes = requests[-1]
    kern = pred32(frames, boxes)
    with plain_versions():
        plain = pred32(frames, boxes)
    sel = well_defined(torch, codec, plain["heatmaps"], dev)
    kerr = float(np.abs(kern["keypoints"] - plain["keypoints"])[sel].max(initial=0.0))
    say(f"phase 14: f32 conv-s pose model, kernels vs plain, {len(frames)} crops: keypoint max "
        f"diff {kerr:.3e} px over {int(sel.sum())}/{sel.size} well-defined (tolerance "
        f"{KPT_TOL_PX:g})")
    check(sel.mean() > 0.5, "too few keypoints with a well-defined argmax")
    check(kerr <= KPT_TOL_PX, f"f32 conv-s keypoints differ by {kerr} px")
    f_dev, b_dev = (torch.from_numpy(a).to(dev) for a in request(149, SERVE_BATCH))
    pred.return_heatmaps = False
    ms = cuda_ms(torch, lambda: pred.predict(f_dev, b_dev), iters=10)
    say(f"phase 14 [{card}]: conv-s pose model serving B = {SERVE_BATCH}, frames on the card: "
        f"{ms:.3f} ms a batch = {SERVE_BATCH / ms * 1e3:.1f} crops/s (CUDA events, mean of 10)")
    return counts


def phase14_times(torch, dev, card: str, root: Path, det_run: Path, bu_run: Path) -> None:
    """Phase 14, not gated: the detector's and the bottom-up model's bf16
    step at B = DET_BATCH, DET_IMG^2 (host clock, the batch decoded
    beforehand), their serving frames/s, and peak memory."""
    from probpose_pytorch_tpu_torch.data.pipeline import batch_iterator
    from probpose_pytorch_tpu_torch.detect import (
        DetectorTrainer,
        FrameDetectionDataset,
        load_bottomup,
        load_detector,
    )

    ann, images = root / "annotations" / "person_keypoints_train2017.json", root / "train2017"
    for label, K in (("detector", 0), ("bottom-up", 17)):
        ds = FrameDetectionDataset(ann, images, num_keypoints=K)
        batch = next(batch_iterator(ds, DET_BATCH, num_workers=4))
        trainer = DetectorTrainer.create(img_size=(DET_IMG, DET_IMG), preset=DET_PRESET,
                                         num_keypoints=K, kpt_heatmaps=bool(K))
        trainer.train_step(batch)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        say(f"phase 14 [{card}]: bf16 {label} step ({DET_PRESET}, {DET_IMG}^2, B = {DET_BATCH}, "
            f"frames {DET_FRAME_HW[0]} x {DET_FRAME_HW[1]} resized on the card): {ms:.3f} ms a "
            f"step = {DET_BATCH / ms * 1e3:.1f} frames/s (host clock, mean of 5); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del trainer
    frames = torch.from_numpy(np.random.default_rng(145).integers(
        0, 256, (DET_BATCH, *DET_FRAME_HW, 3), dtype=np.uint8)).to(dev)
    for label, pred in (("detector", load_detector(det_run / "checkpoints")),
                        ("bottom-up", load_bottomup(bu_run))):
        ms = cuda_ms(torch, lambda: pred.predict(frames), iters=10)
        say(f"phase 14 [{card}]: bf16 {label} serving B = {DET_BATCH} frames of "
            f"{DET_FRAME_HW[0]} x {DET_FRAME_HW[1]} on the card (resize, forward, decode): "
            f"{ms:.3f} ms = {DET_BATCH / ms * 1e3:.1f} frames/s (CUDA events, mean of 10)")


def phase14_doctor(card: str) -> None:
    """Phase 14 (10): `python -m probpose_pytorch_tpu_torch.doctor` exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "probpose_pytorch_tpu_torch.doctor"],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    for line in proc.stdout.strip().splitlines():
        say(f"  doctor: {line}")
    check(proc.returncode == 0, f"doctor exited {proc.returncode}: {proc.stderr[-2000:]}")
    say(f"phase 14 [{card}]: doctor exit 0 in {time.perf_counter() - t0:.1f} s")


def phase14(torch, dev, card: str) -> dict:
    """Phase 14: the detector and bottom-up family on a generate_coco_synth
    set the phase writes and phase 9's checkpoint; returns its runs'
    launch counts."""
    from probpose_pytorch_tpu_torch.data import generate_coco_synth
    from probpose_pytorch_tpu_torch.detect import load_bottomup, load_detector

    t_phase = time.perf_counter()
    work = RUN_DIR / "phase14"
    root = generate_coco_synth(work / "coco", DET_TRAIN_FRAMES, DET_VAL_FRAMES, DET_FRAME_HW,
                               seed=14)
    det_run, bu_run = work / "detector", work / "bottomup"
    det_cli_run(torch, card, "detector", root, det_run)
    det = load_detector(det_run / "checkpoints")
    check_restored(torch, "load_detector", det.model, det_run / "checkpoints" / str(DET_STEPS))
    det_cli_run(torch, card, "bottom-up", root, bu_run, ("--keypoints", "17", "--kpt-heatmaps"))
    bu = load_bottomup(bu_run)
    check_restored(torch, "load_bottomup", bu.model, bu_run / "checkpoints" / str(DET_STEPS))
    check(bu.model.kpt_heatmaps and bu.model.num_keypoints == 17, "load_bottomup's heads")
    say("phase 14: load_detector and load_bottomup restored the CLI's checkpoints bit for bit")
    phase14_card_vs_cpu(torch, dev, card, bu.model)
    del det, bu
    launches = phase14_eval(torch, card, root, det_run, bu_run)
    launches.update(phase14_standalone(torch, dev, card, det_run))
    gc.collect()
    torch.cuda.empty_cache()
    phase14_server(torch, dev, det_run, bu_run)
    phase14_video(torch, dev, card, det_run, bu_run)
    launches["conv_pose"] = phase14_conv_pose(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase14_times(torch, dev, card, root, det_run, bu_run)
    phase14_doctor(card)
    say(f"phase 14: {time.perf_counter() - t_phase:.1f} s in all")
    return launches


BUNDLE_HW = (1088, 1920)
BUNDLE_BUCKETS = (1, 64)
BUNDLE_SMALL_BUCKET = 8  # the ViT-B and 768 x 768 bundles'
BUNDLE_FRAME_BOXES = (1, 64, 256)
BUNDLE_EVAL_BATCH = 64
BUNDLE_EVAL_SAMPLES = 320  # whole batches: the live run's batches equal the bundle's
BUNDLE_SERVER_CLIENTS = 8
BUNDLE_SERVER_REQUESTS = 4
PLANE_RECORDS = 256
PLANE_STEPS = 2
PLANE_BATCH = 16
COUNTER_KEYS = ("k1f", "k1b", "k1s", "k2", "k3", "k4f", "k4b", "k5f", "k5b", "k6")

# The fresh process that serves each bundle: it imports the bundle module
# and the kernels' counters only, serves, and reports the launches of each
# call, the load times, the outputs (an npz per bundle) and which of the
# port's model, training, codec and predictor modules it holds afterwards.
BUNDLE_CHILD = r"""
import json, sys, time
from pathlib import Path
import numpy as np
import torch
from probpose_pytorch_tpu_torch.serve.export import (
    BottomUpBundle, DetectorBundle, FusedBundle, ServingBundle)
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    fused_attention, packed_attention, packed_attention_backward)
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    short_forward, tiled_attention, tiled_attention_backward)
from probpose_pytorch_tpu_torch.ops.kernels.decode import expected_value_decode_fused
from probpose_pytorch_tpu_torch.ops.kernels.mlp import fused_ln_mlp, fused_ln_mlp_backward
from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_rows

W = dict(k1f=packed_attention, k1b=packed_attention_backward, k1s=short_forward,
         k2=sparsemax_rows, k3=expected_value_decode_fused, k4f=tiled_attention,
         k4b=tiled_attention_backward, k5f=fused_ln_mlp, k5b=fused_ln_mlp_backward,
         k6=fused_attention)
# as the parent process: float32 products and convolutions without TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work = Path(sys.argv[1])
inp = np.load(work / "inputs.npz")
frame = inp["frame"]

def counted(fn):
    for w in W.values():
        w.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {k: w.launches for k, w in W.items()}

jobs = {
    "pose_1": (ServingBundle, "pose", lambda b: b.predict_frame(frame, inp["boxes1"])),
    "pose_64": (ServingBundle, "pose", lambda b: b.predict_frame(frame, inp["boxes64"])),
    "detector": (DetectorBundle, "detector",
                 lambda b: dict(zip(("boxes", "scores"), b.detect_frame(frame, 0.0)))),
    "bottomup": (BottomUpBundle, "bottomup", lambda b: b.predict_frame(frame, 0.0)),
    "fused": (FusedBundle, "fused", lambda b: b.predict_frame(frame, 0.0)),
    "vitb": (ServingBundle, "vitb", lambda b: b.predict_frame(frame, inp["boxes8"])),
    "768": (ServingBundle, "768", lambda b: b.predict_frame(frame, inp["boxes8"])),
}
loaded = {}
for name, (cls, directory, call) in jobs.items():
    if directory not in loaded:
        t0 = time.perf_counter()
        loaded[directory] = cls.load(work / directory, device=sys.argv[2])
        load_s = time.perf_counter() - t0
    else:
        load_s = 0.0
    call(loaded[directory])  # the first call reads the program
    t0 = time.perf_counter()
    out, counts = counted(lambda: call(loaded[directory]))
    np.savez(work / f"child_{name}.npz", **out)
    print(json.dumps(dict(bundle=name, load_s=load_s, call_s=time.perf_counter() - t0,
                          counts=counts)), flush=True)
banned = ("models", "train", "detect.model", "codec", "codec_simcc", "inference")
held = sorted(m for m in sys.modules if m.startswith("probpose_pytorch_tpu_torch.")
              and m.split(".", 1)[1].startswith(banned))
print(json.dumps(dict(modules=held)), flush=True)

# Then the live predictors on the same calls, in this process, so that both
# sides run under the same library state (cuDNN picks its algorithms by the
# memory free at the call).
sys.path.insert(0, str(Path.cwd()))
from chip_smoke import peak_heatmap_branch, make_codec
from probpose_pytorch_tpu_torch.detect import (
    FusedTwoStagePredictor, load_bottomup, load_detector)
from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
from probpose_pytorch_tpu_torch.models.model import build_model
from probpose_pytorch_tpu_torch.train.config import TrainConfig

dev = torch.device(sys.argv[2])
runs = json.loads((work / "runs.json").read_text())
pose = load_predictor(runs["recipe"], device=dev)
det = load_detector(runs["detector"], score_threshold=0.0, device=dev)
bu = load_bottomup(runs["bottomup"], score_threshold=0.0, device=dev)
fused = FusedTwoStagePredictor(
    load_detector(runs["detector"], score_threshold=0.0, max_detections=runs["people"],
                  device=dev), pose, max_people=runs["people"], score_threshold=0.0)
small = {}
for name in ("vitb", "768"):
    cfg = TrainConfig.load(work / f"{name}.json").model
    model = build_model(cfg, dev, seed=0)
    peak_heatmap_branch(torch, model)
    small[name] = TopDownPredictor(model, make_codec(cfg), cfg.img_size)
buckets = tuple(runs["buckets"])
live = {
    "pose_1": lambda: pose.predict_frame(frame, inp["boxes1"], buckets=buckets),
    "pose_64": lambda: pose.predict_frame(frame, inp["boxes64"], buckets=buckets),
    "detector": lambda: dict(zip(("boxes", "scores"), det.detect_frame(frame, 0.0))),
    "bottomup": lambda: bu.predict_frame(frame, 0.0),
    "fused": lambda: fused.predict_frame(frame, 0.0),
    "vitb": lambda: small["vitb"].predict_frame(frame, inp["boxes8"],
                                                buckets=(runs["small_bucket"],)),
    "768": lambda: small["768"].predict_frame(frame, inp["boxes8"],
                                              buckets=(runs["small_bucket"],)),
}
for name, fn in live.items():
    np.savez(work / f"live_{name}.npz", **fn())
print(json.dumps(dict(live="done")), flush=True)
"""


def bundle_graph_ops(path: Path) -> dict:
    """The `probpose::` ops of a saved program's graph, by name: count."""
    import gzip

    import torch

    from probpose_pytorch_tpu_torch.ops.kernels import register_ops

    register_ops()
    graph = str(torch.export.load(io.BytesIO(gzip.decompress(path.read_bytes()))).graph)
    names = ("short_attention_fwd", "tiled_attention_fwd", "packed_attention_fwd",
             "flat_attention_fwd", "fused_ln_mlp_fwd", "sparsemax_rows")
    return {n: graph.count(f"probpose.{n}") for n in names if f"probpose.{n}" in graph}


def phase15_export(torch, dev, card: str, work: Path, det_run: Path, bu_run: Path) -> None:
    """Phase 15 (1): every bundle kind through the export CLI on the card
    (and the ViT-B and 768 x 768 models of phases 6 and 8 through
    export_predictor_bundle); each program's graph holds the ops it should.
    The ViT-B and 768 x 768 configs go to `work` for the serving process."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.serve import export

    recipe = RUN_DIR / "recipe" / "checkpoints"
    H, W = BUNDLE_HW
    frame = f"{H},{W}"
    runs = (
        ("pose", ["--checkpoint", str(recipe), "--buckets", ",".join(map(str, BUNDLE_BUCKETS)),
                  "--frame-size", frame]),
        ("eval", ["--checkpoint", str(recipe), "--buckets", str(BUNDLE_EVAL_BATCH),
                  "--frame-size", "256,192", "--no-indexed"]),
        ("detector", ["--detector-checkpoint", str(det_run), "--frame-size", frame]),
        ("bottomup", ["--bottomup-checkpoint", str(bu_run), "--frame-size", frame]),
        ("fused", ["--checkpoint", str(recipe), "--fused-detector", str(det_run),
                   "--frame-size", frame, "--max-people", str(FUSED_PEOPLE)]),
    )
    for name, args in runs:
        argv = args + ["--out", str(work / name), "--device", dev.type]
        say(f"phase 15: python -m probpose_pytorch_tpu_torch.serve.export {' '.join(argv)}")
        t0 = time.perf_counter()
        export.main(argv)
        wall = time.perf_counter() - t0
        programs = sorted((work / name).glob("*.pt2.gz"))
        size = sum(p.stat().st_size for p in (work / name).iterdir())
        say(f"phase 15 [{card}]: {name} bundle: {len(programs)} programs in {wall:.2f} s "
            f"(the CLI's checkpoint load included) = {wall / len(programs):.2f} s a program; "
            f"{size / 2**20:.2f} MiB on disk (params.pt "
            f"{(work / name / 'params.pt').stat().st_size / 2**20:.2f} MiB)")
    for name, train_cfg in (("vitb", vitb_train_config("bfloat16")),
                            ("768", config_768("bfloat16", BUNDLE_SMALL_BUCKET))):
        train_cfg.save(work / f"{name}.json")
        cfg = train_cfg.model
        model = build_model(cfg, dev, seed=0)
        peak_heatmap_branch(torch, model)
        t0 = time.perf_counter()
        export.export_predictor_bundle(TopDownPredictor(model, make_codec(cfg), cfg.img_size),
                                       work / name, (BUNDLE_SMALL_BUCKET,), BUNDLE_HW,
                                       indexed=False)
        size = sum(p.stat().st_size for p in (work / name).iterdir())
        say(f"phase 15 [{card}]: {name} bundle ({cfg.backbone} at {cfg.img_size}, "
            f"mlp_impl {cfg.mlp_impl!r}): 1 program in {time.perf_counter() - t0:.2f} s; "
            f"{size / 2**20:.2f} MiB on disk")
    want = {"pose": {"short_attention_fwd": 12, "sparsemax_rows": 1},
            "eval": {"short_attention_fwd": 12, "sparsemax_rows": 1},
            "fused": {"short_attention_fwd": 12, "sparsemax_rows": 1},
            "vitb": {"short_attention_fwd": 12, "fused_ln_mlp_fwd": 12, "sparsemax_rows": 1},
            "768": {"tiled_attention_fwd": 12, "sparsemax_rows": 1},
            "detector": {}, "bottomup": {}}
    for name, ops in want.items():
        for program in sorted((work / name).glob("*.pt2.gz")):
            got = bundle_graph_ops(program)
            say(f"phase 15: {name}/{program.name}: probpose ops {got}")
            check(got == ops, f"{name}/{program.name}: ops {got}, expected {ops}")


def phase15_serve_alone(torch, dev, card: str, work: Path, det_run: Path,
                        bu_run: Path) -> dict:
    """Phase 15 (2-4): each bundle served by a fresh process that imports no
    model code: 12 short K1 forwards and 1 K2 a pose program call; after
    its modules are checked, the same process runs the live predictors on
    the same calls, and their outputs are held to the bundles'."""
    rng = np.random.default_rng(150)
    frame = rng.integers(0, 256, (*BUNDLE_HW, 3), dtype=np.uint8)
    np.savez(work / "inputs.npz", frame=frame, boxes1=camera_boxes(rng, 1, BUNDLE_HW),
             boxes64=camera_boxes(rng, 64, BUNDLE_HW),
             boxes8=camera_boxes(rng, BUNDLE_SMALL_BUCKET, BUNDLE_HW))
    (work / "runs.json").write_text(json.dumps(dict(
        recipe=str(RUN_DIR / "recipe" / "checkpoints"), detector=str(det_run / "checkpoints"),
        bottomup=str(bu_run), people=FUSED_PEOPLE, buckets=list(BUNDLE_BUCKETS),
        small_bucket=BUNDLE_SMALL_BUCKET)))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", BUNDLE_CHILD, str(work), dev.type], cwd=REPO,
                          capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    check(proc.returncode == 0, f"the bundle process failed:\n{proc.stderr[-4000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    say(f"phase 15: the fresh process served {len(lines) - 2} bundle calls, then the live "
        f"predictors' same calls, in {time.perf_counter() - t0:.2f} s wall (start, kernel "
        "library, loads)")
    held = lines[-2]["modules"]
    check(held == [], f"the bundle process imported model code: {held}")
    check(lines[-1] == {"live": "done"}, "the bundle process did not run the live predictors")
    say("phase 15: after serving, the fresh process held none of the port's models, train, "
        "detect.model, codec or inference modules")
    expect = {"pose_1": dict(k1s=12, k2=1), "pose_64": dict(k1s=12, k2=1), "detector": {},
              "bottomup": {}, "fused": dict(k1s=12, k2=1), "vitb": dict(k1s=12, k5f=12, k2=1),
              "768": dict(k4f=12, k2=1)}
    launches = {}
    for c in lines[:-2]:
        name = c["bundle"]
        want = {k: expect[name].get(k, 0) for k in COUNTER_KEYS}
        say(f"phase 15: bundle {name}: launches {c['counts']}, load {c['load_s']:.3f} s, "
            f"call {c['call_s'] * 1e3:.2f} ms (fresh process)")
        check(c["counts"] == want, f"bundle {name}: launches {c['counts']}, expected {want}")
        launches[name] = c["counts"]
        got = dict(np.load(work / f"child_{name}.npz"))
        ref = dict(np.load(work / f"live_{name}.npz"))
        check(sorted(got) == sorted(ref), f"bundle {name}: keys {sorted(got)} vs {sorted(ref)}")
        gaps = {}
        for k in ref:
            check(got[k].shape == ref[k].shape, f"bundle {name}: {k} {got[k].shape}")
            gaps[k] = float(np.abs(got[k].astype(np.float64) - ref[k]).max(initial=0.0))
        kgap = gaps.get("keypoints", 0.0)
        fgap = max((v for k, v in gaps.items() if k not in ("keypoints", "boxes")), default=0.0)
        say(f"phase 15: bundle {name} vs the live predictor on the same frame: keypoints max gap "
            f"{kgap:.3e} px (gate {KPT_TOL_PX:g}), other fields {fgap:.3e} ({PROB_TOL:g}), "
            f"boxes {gaps.get('boxes', 0.0):.3e} px")
        check(kgap <= KPT_TOL_PX and gaps.get("boxes", 0.0) <= KPT_TOL_PX,
              f"bundle {name}: keypoints or boxes differ from live by {gaps}")
        check(fgap <= PROB_TOL, f"bundle {name}: fields differ from live by {gaps}")
    check(len(launches) == len(expect), f"bundle calls {sorted(launches)}")
    return launches


def phase15_frontends(torch, dev, card: str, work: Path) -> dict:
    """Phase 15 (5-8): the pose bundle's dispatch under
    set_sync_debug_mode("error"), predict_frame against the live predictor
    in turns; the eval, server and video CLIs with --bundle."""
    import base64
    import signal
    import socket

    from probpose_pytorch_tpu_torch import video
    from probpose_pytorch_tpu_torch.eval import run as eval_run
    from probpose_pytorch_tpu_torch.inference import load_predictor
    from probpose_pytorch_tpu_torch.serve.export import ServingBundle

    recipe = RUN_DIR / "recipe"
    bundle = ServingBundle.load(work / "pose", device=dev)
    pose = load_predictor(recipe / "checkpoints", device=dev)
    rng = np.random.default_rng(151)
    frame = rng.integers(0, 256, (*BUNDLE_HW, 3), dtype=np.uint8)
    top = BUNDLE_BUCKETS[-1]
    boxes = camera_boxes(rng, top, BUNDLE_HW)
    bundle.predict_frame(frame, boxes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev_out = bundle.dispatch(frame[None], boxes, np.zeros(top, np.int64))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(dev_out["keypoints"].device.type == dev.type
          and dev_out["keypoints"].shape == (top, 17, 2), "bundle dispatch outputs")
    say(f"phase 15: the pose bundle's dispatch ({top} crops, indexed) ran under "
        "set_sync_debug_mode('error'): no host synchronisation")
    times = {}
    for n in BUNDLE_FRAME_BOXES:
        b = camera_boxes(rng, n, BUNDLE_HW)
        fns = {"live": lambda: pose.predict_frame(frame, b, buckets=BUNDLE_BUCKETS),
               "bundle": lambda: bundle.predict_frame(frame, b)}
        for name in ("live", "bundle", "bundle", "live"):
            fns[name]()
            t0 = time.perf_counter()
            for _ in range(5):
                fns[name]()
            times.setdefault(n, {}).setdefault(name, []).append(
                (time.perf_counter() - t0) / 5 * 1e3)
    say(f"phase 15 [{card}]: predict_frame on a {BUNDLE_HW[0]} x {BUNDLE_HW[1]} frame, bf16, "
        f"buckets {BUNDLE_BUCKETS}, ms a call (host clock, 5 calls, live, bundle, bundle, live): "
        + "; ".join(f"{n} boxes: live {np.mean(t['live']):.3f}, bundle {np.mean(t['bundle']):.3f}"
                    for n, t in times.items()))

    # the eval CLI: --bundle against --checkpoint on phase 10's set
    root = RUN_DIR / "synth_coco"
    ann = root / "annotations" / "person_keypoints_val2017.json"
    base = ["--annotations", str(ann), "--images", str(root / "val2017"), "--batch-size",
            str(BUNDLE_EVAL_BATCH), "--max-samples", str(BUNDLE_EVAL_SAMPLES),
            "--device", dev.type]
    lines, launches = {}, {}
    for name, args in (("bundle", ["--bundle", str(work / "eval")]),
                       ("live", ["--checkpoint", str(recipe / "checkpoints")])):
        t0 = time.perf_counter()
        (line, counts) = counted(torch, {}, lambda: eval_run.main(base + args))
        lines[name] = line
        launches[name] = counts
        say(f"phase 15 [{card}]: eval CLI {args[0]}: {time.perf_counter() - t0:.2f} s wall; AP "
            f"{line['AP']}, EPE {line['EPE']}")
    batches = BUNDLE_EVAL_SAMPLES // BUNDLE_EVAL_BATCH
    check_attention_route(launches["bundle"], 12 * batches, 0, phase=15)
    check(launches["bundle"]["k2"] == batches, "eval --bundle: K2 not once a batch")
    check(lines["bundle"] == lines["live"],
          f"eval --bundle summary {lines['bundle']} != live {lines['live']}")
    say("phase 15: the eval CLI's summary with --bundle equals the live checkpoint's")

    # the server CLI with --bundle
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = [sys.executable, "-m", "probpose_pytorch_tpu_torch.serve.server", "--bundle",
            str(work / "pose"), "--host", "127.0.0.1", "--port", str(port), "--warmup",
            "--device", dev.type]
    say(f"phase 15: {' '.join(args[1:])}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out_lines = []
        while True:
            line = proc.stdout.readline()
            if not line or time.perf_counter() - t0 > 600:
                break
            out_lines.append(line)
            if line.startswith("serving "):
                break
        check(bool(out_lines) and out_lines[-1].startswith("serving "),
              "the server CLI did not start:\n" + "".join(out_lines[-40:]))
        start_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        b64 = base64.b64encode(frame.tobytes()).decode()
        bodies = [[predict_body(b64, frame.shape, camera_boxes(rng, int(rng.integers(
            1, MAX_REQUEST_BOXES + 1)), BUNDLE_HW)) for _ in range(BUNDLE_SERVER_REQUESTS)]
            for _ in range(BUNDLE_SERVER_CLIENTS)]
        replies, wall = run_clients(url + "/predict", bodies)
        crops = 0
        for reply_list in replies:
            for status, out in reply_list:
                check(status == 200, f"server --bundle /predict: {status} {out}")
                k = np.asarray(out["keypoints"], np.float32)
                check(k.shape[1:] == (17, 2) and np.isfinite(k).all(), "server --bundle reply")
                crops += len(k)
        stats = json.loads(get_text(url + "/stats"))
        check(stats["crops"] == crops, f"server --bundle /stats: {stats}")
        lat = dict(stats["latency_ms"], mean_batch=stats["mean_batch"])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVER_EXIT_S)
        check(rc == 0, f"the server CLI exited {rc} on SIGTERM")
        say(f"phase 15 [{card}]: server CLI --bundle up in {start_s:.2f} s (load, warmup); "
            f"{BUNDLE_SERVER_CLIENTS} clients x {BUNDLE_SERVER_REQUESTS} requests of 1-"
            f"{MAX_REQUEST_BOXES} boxes on {BUNDLE_HW[0]} x {BUNDLE_HW[1]} frames: {crops} crops "
            f"in {wall:.2f} s = {crops / wall:.1f} crops/s; latency {lat}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()

    # the video CLI with --bundle, in stream mode
    frames, vboxes = video_input(VIDEO_CLI_FRAMES, 152)
    vwork = work / "video"
    vwork.mkdir(parents=True, exist_ok=True)
    np.save(vwork / "frames.npy", frames)
    (vwork / "boxes.json").write_text(json.dumps([b.tolist() for b in vboxes]))
    n_crops = sum(len(b) for b in vboxes)
    args = ["--bundle", str(work / "pose"), "--frames", str(vwork / "frames.npy"), "--boxes",
            str(vwork / "boxes.json"), "--out", str(vwork / "out"), "--stream-batch",
            str(BUNDLE_BUCKETS[-1]), "--device", dev.type]
    say(f"phase 15: python -m probpose_pytorch_tpu_torch.video {' '.join(args)}")
    t0 = time.perf_counter()
    _, counts = counted(torch, {}, lambda: video.main(args))
    wall = time.perf_counter() - t0
    dispatches = -(-n_crops // BUNDLE_BUCKETS[-1])
    check_attention_route(counts, 12 * dispatches, 0, phase=15)
    check(counts["k2"] == dispatches, "video --bundle: K2 not once a dispatch")
    records = (vwork / "out" / "poses.jsonl").read_text().splitlines()
    check(len(records) == VIDEO_CLI_FRAMES, f"video --bundle: {len(records)} records")
    say(f"phase 15 [{card}]: video CLI --bundle --stream-batch {BUNDLE_BUCKETS[-1]}: "
        f"{VIDEO_CLI_FRAMES} frames of {VIDEO_HW[0]} x {VIDEO_HW[1]} ({n_crops} boxes) in "
        f"{wall:.2f} s wall (bundle load included) = {VIDEO_CLI_FRAMES / wall:.2f} frames/s")
    launches["eval"] = launches.pop("bundle")
    del launches["live"]
    launches["video"] = counts
    return launches


def phase15_dataplane(torch, dev, card: str, work: Path) -> None:
    """Phase 15 (9-12): the native data plane: its build, crop_resize_batch
    against crop_resize "bilinear_gather" on the card, the JPEG half against
    PIL's decode where it is built, native crops/s against the PIL path on
    the same records, and the training CLI with resample="native"."""
    import PIL.Image

    from probpose_pytorch_tpu_torch import native
    from probpose_pytorch_tpu_torch.data import COCOPoseDataset
    from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize
    from probpose_pytorch_tpu_torch.train import cli

    t0 = time.perf_counter()
    check(native.native_available(), f"no native data plane: {native.build_report()}")
    report = native.build_report()
    say(f"phase 15: native data plane in {time.perf_counter() - t0:.2f} s: {report}")
    say(f"phase 15: data plane halves: crop-resize built; JPEG "
        f"{'built (libjpeg linked)' if report['jpeg'] else 'NOT built: ' + report['jpeg_missing']}")
    rng = np.random.default_rng(153)
    frames = rng.integers(0, 256, (8, 480, 640, 3), dtype=np.uint8)
    boxes = camera_boxes(rng, 8, (480, 640))
    crops = native.crop_resize_batch(frames, boxes, (256, 192))
    dev_crops = crop_resize(torch.from_numpy(frames).to(dev).float(),
                            torch.from_numpy(boxes).to(dev), (256, 192), "bilinear_gather")
    want = dev_crops.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    gap = int(np.abs(crops.astype(int) - want.astype(int)).max())
    say(f"phase 15: crop_resize_batch vs crop_resize(..., 'bilinear_gather') on the card, 8 "
        f"crops of 256 x 192 from 480 x 640 frames: max gap {gap} uint8 levels (gate 1)")
    check(gap <= 1, f"native crops differ from the card's by {gap} levels")

    # the records: phase 11's synthetic COCO set; without the JPEG half, a
    # PNG copy of it (the plane crops PIL-decoded PNGs, as JAX's loaders do)
    root = RUN_DIR / "finetune" / "coco"
    if report["jpeg"]:
        data = root
        bufs = [(root / "val2017" / p).read_bytes()
                for p in sorted(os.listdir(root / "val2017"))[:4]]
        got, failed = native.decode_crop_resize_batch(bufs, boxes[:4], (256, 192))
        check(failed == 0, f"{failed} JPEG decodes failed")
        pil = np.stack([np.asarray(PIL.Image.open(io.BytesIO(b)).convert("RGB")) for b in bufs])
        ref = native.crop_resize_batch(pil, boxes[:4], (256, 192))
        dgap = int(np.abs(got.astype(int) - ref.astype(int)).max())
        say(f"phase 15: decode_crop_resize_batch on 4 JPEGs of the set vs PIL's decode + the "
            f"native crop: max gap {dgap} levels (gate 2, IDCT variants)")
        check(dgap <= 2, f"native JPEG decode differs from PIL's by {dgap}")
    else:
        data = work / "coco_png"
        for split in ("train2017", "val2017"):
            (data / split).mkdir(parents=True, exist_ok=True)
            for p in sorted((root / split).iterdir()):
                PIL.Image.open(p).save(data / split / (p.stem + ".png"))
        (data / "annotations").mkdir(parents=True, exist_ok=True)
        for ann in (root / "annotations").iterdir():
            raw = json.loads(ann.read_text())
            for im in raw["images"]:
                im["file_name"] = Path(im["file_name"]).stem + ".png"
            (data / "annotations" / ann.name).write_text(json.dumps(raw))
        say("phase 15: without the JPEG half the records are a PNG copy of the set")
    ann = data / "annotations" / "person_keypoints_train2017.json"
    ds = {r: COCOPoseDataset(ann, data / "train2017", (256, 192), resample=r)
          for r in ("native", "bilinear")}
    n = min(PLANE_RECORDS, len(ds["native"]))
    rates = {}
    for r in ("bilinear", "native", "native", "bilinear"):
        t0 = time.perf_counter()
        b = ds[r].get_batch(range(n))
        rates.setdefault(r, []).append(n / (time.perf_counter() - t0))
        check(b["image"].shape == (n, 256, 192, 3), f"{r} batch shape")
    say(f"phase 15 [{card}]: COCO get_batch of {n} records (480 x 480 frames -> 256 x 192): "
        f"native {np.mean(rates['native']):.1f} crops/s, PIL bilinear "
        f"{np.mean(rates['bilinear']):.1f} crops/s (host clock, in turns: {rates})")

    cfg = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())
    cfg.update(resample="native", train_batch_size=PLANE_BATCH, val_batch_size=PLANE_BATCH,
               log_every=1, val_every=10_000)
    (work / "native.json").write_text(json.dumps(cfg))
    run = work / "native_run"
    args = [str(run), "--config", str(work / "native.json"), "--data-root", str(data),
            "--dataset-format", "coco", "--max-steps", str(PLANE_STEPS), "--device", dev.type]
    say(f"phase 15: python -m probpose_pytorch_tpu_torch.train.cli {' '.join(args)}")
    t0 = time.perf_counter()
    (_, counts) = counted(torch, {}, lambda: cli.main(args))
    wall = time.perf_counter() - t0
    check((run / "checkpoints" / str(PLANE_STEPS)).is_file(), "native train CLI checkpoint")
    losses = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    check(losses and all(np.isfinite(v) for x in losses for v in x.values()
                         if isinstance(v, float)), f"native train CLI: {losses[-1:]}")
    say(f"phase 15 [{card}]: training CLI with resample='native', B = {PLANE_BATCH}: "
        f"{PLANE_STEPS} steps in {wall:.2f} s wall (build, data and checkpoint included); "
        f"K1 short forwards {counts['k1s']}, K2 {counts['k2']}")


def phase15(torch, dev, card: str) -> dict:
    """Phase 15: the serving bundles exported, served without model code and
    held to the live predictors, through the CLIs; then the native data
    plane. Returns the bundles' launch counts."""
    t_phase = time.perf_counter()
    work = RUN_DIR / "phase15"
    work.mkdir(parents=True, exist_ok=True)
    det_run, bu_run = RUN_DIR / "phase14" / "detector", RUN_DIR / "phase14" / "bottomup"
    phase15_export(torch, dev, card, work, det_run, bu_run)
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase15_serve_alone(torch, dev, card, work, det_run, bu_run)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase15_frontends(torch, dev, card, work))
    gc.collect()
    torch.cuda.empty_cache()
    phase15_dataplane(torch, dev, card, work)
    say(f"phase 15: {time.perf_counter() - t_phase:.1f} s in all")
    return launches


def kernel_entry(name: str, route: str, source: str, replaces: str, launches: int,
                 err: float, ms: float, plain_ms: float, bound: tuple[float, str],
                 library_ms: float | None = None, **extra) -> dict:
    """One kernel of the JSON line: its launches on a main path, its error
    against its plain version and its times there."""
    pkg, jax_pkg = "probpose_pytorch_tpu_torch/", "probpose_pytorch_tpu/ops/pallas/"
    return dict(name=name, route=route, source=pkg + source, replaces=jax_pkg + replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms, **extra)


# (label, B, N, heads, d): the phases' attention calls, and that of
# configs/reference_parity_fieldsynth.json (N = 576, d = 32)
ATTENTION_SHAPES = (
    ("flagship serving", SERVE_BATCH, 192, 6, 64),
    ("flagship step", TRAIN_BATCH, 192, 6, 64),
    ("vit-b serving", VITB_SERVE_BATCH, 192, 12, 64),
    ("vit-b step", 64, 192, 12, 64),
    ("fieldsynth", 32, 576, 12, 32),
    ("768 serving", SERVE_768_BATCH, 2304, 6, 64),
    ("768 step", TRAIN_768_BATCH, 2304, 6, 64),
)


def attention_times(torch, card: str) -> None:
    """packed_attention's forward, and its backward alone through autograd
    (reading what the forward saved), against the library's on the same
    q, k, v and dO, at ATTENTION_SHAPES in bf16; printed, not gated. Uses
    only the package's public attention call, so any commit of the port
    can be timed."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import packed_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    for label, B, N, heads, d in ATTENTION_SHAPES:
        C = heads * d
        qkv = torch.randn(B, N, 3 * C, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(B, N, C, generator=g, device=dev).to(torch.bfloat16)
        x = qkv.clone().requires_grad_(True)
        y = packed_attention(x, heads)
        with torch.no_grad():
            fwd_ms, fwd_lib = yardstick_ms(torch, lambda: packed_attention(qkv, heads),
                                           sdpa_fwd_fn(torch, qkv, heads))
        bwd_ms, bwd_lib = yardstick_ms(
            torch, lambda: torch.autograd.grad(y, x, dout, retain_graph=True),
            sdpa_bwd_fn(torch, qkv, dout, heads))
        fwd_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * C)
        # qkv and dO in, dqkv out
        bwd_bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * B * N * N * C)
        say(json.dumps(dict(attention=label, card=card, qkv=[B, N, 3 * C], heads=heads,
                            fwd_ms=fwd_ms, fwd_sdpa_ms=fwd_lib, fwd_bound_ms=fwd_bound[0],
                            bwd_ms=bwd_ms, bwd_sdpa_ms=bwd_lib, bwd_bound_ms=bwd_bound[0])))
        del qkv, dout, x, y


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this smoke "
                         "run needs an NVIDIA GPU")
    if "--attention-times" in sys.argv[1:]:
        attention_times(torch, card_line())
        return
    global RUN_DIR
    RUN_DIR = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run(torch)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)


def run(torch) -> None:
    """Phases 0 to 15, then the kernels line and the result line."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
    from probpose_pytorch_tpu_torch.ops.kernels import _build, plain_versions
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import tiled_forward
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
    ptxas = ptxas_kernels(report.get("ptxas", ""))
    say(f"phase 0: registers and spill bytes (bf16 attention at d = 64, K5 at ViT-B widths, "
        f"K2, K3): {ptxas}")
    check(set(ptxas) == set(PTXAS_NAMES.values()), "a kernel is missing from nvcc's report")
    check(all(ptxas[k]["spill_bytes"] == 0 for k in ptxas if k[:2] in ("K2", "K3")),
          "K2 or K3 spills registers")

    # ---------------------------------------------------------------- phase 1
    g = torch.Generator(device=dev).manual_seed(0)
    # The flagship's shapes, a ragged batch, and the short forward's other
    # widths and key counts (keys padded to 64 and 256).
    for B, N, heads, d, dtype in ((64, 192, 6, 64, torch.bfloat16),
                                  (64, 192, 6, 64, torch.float32),
                                  (3, 192, 6, 64, torch.bfloat16),
                                  (5, 77, 4, 32, torch.bfloat16),
                                  (5, 200, 2, 128, torch.bfloat16),
                                  (5, 256, 2, 64, torch.bfloat16)):
        qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=dev).to(dtype)
        gate(torch, f"K1 packed_attention qkv {tuple(qkv.shape)} {str(dtype).split('.')[-1]} "
             f"via {kernel_path(N, d, dtype)}",
             packed_attention(qkv, heads), packed_attention_reference(qkv, heads), phase=1)

    # K2 at the flagship's rows, a ragged R and N (no float4 loads), and the
    # adversarial rows.
    for R, N, rows in ((64 * 17, 3072, "random"), (17 * 3 + 5, 3072, "random"),
                       (17 * 3 + 5, 3071, "random"), (17 * 3 + 5, 3072, "all candidates"),
                       (17 * 3 + 5, 3072, "ties")):
        k2_check(torch, k2_rows(torch, g, R, N, rows), rows, phase=1)

    # ---------------------------------------------------------------- phase 2
    block = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())["model"]
    cfg = ModelConfig(**block)
    check(cfg.attn_impl == "fused", "flagship config does not select kernel K1")
    model = build_model(cfg, dev, seed=0)
    peak_heatmap_branch(torch, model)
    codec = make_codec(cfg)
    predictor = TopDownPredictor(model, codec, cfg.img_size, return_heatmaps=True)
    requests = [request(i, B) for i, B in enumerate(REQUEST_SIZES)]
    K = cfg.num_keypoints
    W, H = cfg.heatmap_size

    reset_counts()
    answers = [predictor(frames, boxes) for frames, boxes in requests]
    torch.cuda.synchronize()
    counts = read_counts()
    depth = len(model.backbone.blocks)
    check_answers(cfg, requests, answers, phase=2)
    say(f"phase 2: launches over {len(requests)} forwards: K2 {counts['k2']} "
        f"(expect {len(requests)})")
    check_attention_route(counts, depth * len(requests), 0, phase=2)
    check(counts["k2"] == len(requests), "K2 did not run once per forward")
    check(counts["k5f"] == counts["k6"] == 0, "the flagship ran K5 or K6")

    with plain_versions():
        plain_bf16 = [predictor(f, b) for f, b in requests]
    hm_diff = max(float(np.abs(a["heatmaps"] - p["heatmaps"]).max())
                  for a, p in zip(answers, plain_bf16))
    say(f"phase 2: bf16 kernel-vs-plain heatmap max abs diff {hm_diff:.3e} (not gated)")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(model.state_dict())
    pred32 = TopDownPredictor(model32, codec, cfg.img_size, return_heatmaps=True)
    for frames, boxes in requests:
        kern = pred32(frames, boxes)
        with plain_versions():
            plain = pred32(frames, boxes)
        sel = well_defined(torch, codec, plain["heatmaps"], dev)
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
                       f"via {kernel_path(192, 64, torch.bfloat16)}",
                       packed_attention(qkv, 6), packed_attention_reference(qkv, 6), phase=3)
    _, k1_plain_ms = paired_ms(
        torch, lambda: packed_attention(qkv, 6),
        lambda: packed_attention_reference(qkv, 6), iters=20)
    k1_ms, k1_lib_ms = yardstick_ms(torch, lambda: packed_attention(qkv, 6),
                                    sdpa_fwd_fn(torch, qkv, 6))
    k1_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * SERVE_BATCH * 6 * 192**2 * 64)
    k2_adversarial = {}
    for rows in K2_ROWS:
        z = k2_rows(torch, g, SERVE_BATCH * K, H * W, rows)
        err = k2_check(torch, z, rows, phase=3)
        if rows == "random":
            k2_err_main = err
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: sparsemax_rows(z), lambda: sparsemax_reference(z), iters=20)
        else:
            k2_adversarial[rows] = dict(max_abs_err=err,
                                        ms=cuda_ms(torch, lambda: sparsemax_rows(z), iters=20))
    # K2 reads and writes each f32 element once; per element it does ~96
    # operations: 30 bisection steps of a subtract, a max and a sum, then
    # the row max, the support, its sum and the output.
    k2_bound = bound_ms(2 * nbytes(z), 96 * z.numel(), "float32")
    say(f"phase 3 [{card}]: K1 qkv ({SERVE_BATCH}, 192, 1152) bf16 via "
        f"{kernel_path(192, 64, torch.bfloat16)}: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms, scaled_dot_product_attention {k1_lib_ms:.4f} ms (medians of 3 "
        f"windows of 50, in turns), bound {k1_bound[0]:.4f} ms ({k1_bound[1]})")
    # The other wgmma route for this shape, K4's tiled forward (128-row
    # blocks, online softmax over 128-key tiles), in turns with the short
    # forward: the route keeps the faster.
    k1_tiled_ms, k1_short_ms = paired_ms(torch, lambda: tiled_forward(qkv, 6),
                                         lambda: packed_attention(qkv, 6), iters=50)
    say(f"phase 3 [{card}]: K1 qkv ({SERVE_BATCH}, 192, 1152) bf16 on K4's tiled forward "
        f"{k1_tiled_ms:.4f} ms against the short forward's {k1_short_ms:.4f} ms (in turns)")
    say(f"phase 3 [{card}]: K2 ({SERVE_BATCH * K}, {H * W}) f32: kernel "
        f"{k2_ms:.4f} ms on random rows ("
        + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in k2_adversarial.items())
        + f"), plain {k2_plain_ms:.4f} ms (no library call computes sparsemax), "
        f"bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    del qkv, z

    frames, boxes = request(7, SERVE_BATCH)
    predictor.return_heatmaps = False
    f_dev = torch.from_numpy(frames).to(dev)
    b_dev = torch.from_numpy(boxes).to(dev)
    predictor.predict(f_dev, b_dev)
    torch.cuda.synchronize()
    gc.collect()  # drop earlier checks' objects held by reference cycles
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
    predictor.return_heatmaps = True
    served = predictor.predict(f_dev, b_dev)["heatmaps"]
    k3_flagship = k3_check(torch, card, codec, served, "phase 3's served", phase=3)
    del served

    # ---------------------------------------------------------------- phase 4
    phase4_k1_backward(torch, dev, g)

    # ---------------------------------------------------------------- phase 5
    profile = "--profile" in sys.argv[1:]
    train = phase5_training(torch, dev, card, profile)

    # ---------------------------------------------------------------- phase 6
    serve_b = phase6_vitb_serving(torch, dev, card, g, profile)

    # ---------------------------------------------------------------- phase 7
    train_b = phase7_vitb_training(torch, dev, card, profile)

    # ---------------------------------------------------------------- phase 8
    k4 = phase8_k4_kernels(torch, dev, card, g)
    k2_long = phase8_k2_long_rows(torch, card, g, K)
    serve_768 = phase8_serving(torch, dev, card, profile)
    train_768 = phase8_training(torch, dev, card, profile)
    k3 = serve_768["k3"]

    # ---------------------------------------------------------------- phase 9
    gc.collect()
    recipe_cli_runs(torch, card)
    recipe_preamble_check(torch, dev, card)
    recipe_times(torch, dev, card)

    # --------------------------------------------------------------- phase 10
    gc.collect()
    evals = eval_runs(torch, card)

    # --------------------------------------------------------------- phase 11
    gc.collect()
    finetune = phase11_finetuning(torch, dev, card, g)
    n193_err = finetune.pop("radio_n193_err")

    # --------------------------------------------------------------- phase 12
    gc.collect()
    torch.cuda.empty_cache()
    frontend = phase12_frontends(torch, dev, card)

    # --------------------------------------------------------------- phase 13
    gc.collect()
    torch.cuda.empty_cache()
    recipes13, fieldsynth = phase13(torch, dev, card, g)

    # --------------------------------------------------------------- phase 14
    gc.collect()
    torch.cuda.empty_cache()
    detectors14 = phase14(torch, dev, card)

    # --------------------------------------------------------------- phase 15
    gc.collect()
    torch.cuda.empty_cache()
    bundles15 = phase15(torch, dev, card)

    mlp_cu = "csrc/fused_mlp_sm90.cu"
    tiled_cu = "csrc/tiled_attention_sm90.cu"
    kernels = [
        # K1's bf16 shapes run the wgmma kernels (f32 keeps K1's CUDA
        # cores in csrc/packed_attention.cu): the short forward, and
        # K4's backward fed the forward's saved out and lse.
        kernel_entry("K1 packed_attention forward", "cuda", tiled_cu, "attention_kernel.py:120",
                     train["k1s"], k1_err_main, k1_ms, k1_plain_ms, k1_bound, k1_lib_ms,
                     design="wgmma+TMA, sm90 short", tiled_route_ms=k1_tiled_ms,
                     n193_err=n193_err),
        kernel_entry("K1 packed_attention backward", "cuda", tiled_cu, "attention_kernel.py:146",
                     train["k4b"], train["k1b_err"], train["k1b_ms"], train["k1b_plain_ms"],
                     train["k1b_bound"], train["k1b_lib_ms"], design="wgmma+TMA, sm90 tiled",
                     online_err=train["k1b_online_err"]),
        # K2: one warp a row up to 3,072 pixels, one block a row beyond
        # (staged in shared memory where it fits); `long_rows` holds the
        # 768 x 768 path's rows, with the adversarial and 65,536-pixel ones.
        kernel_entry("K2 sparsemax", "cuda", "csrc/sparsemax.cu",
                     "sparsemax_kernel.py:29", train["k2"], k2_err_main, k2_ms, k2_plain_ms,
                     k2_bound, design="candidate filter; warp a row, block a row staged by "
                     "cp.async.bulk", redesigned_in="PR 8", other_rows=k2_adversarial,
                     long_rows=k2_long, fieldsynth_rows=fieldsynth["k2"]),
        # No serving or training path calls K3, as in the JAX package: its
        # launches on the main paths are 0; its numbers are from the 768 x
        # 768 path's served heatmaps (and phase 3's, under "maps_64x48").
        # bound_ms counts the band products; dense_bound_ms the dense ones.
        kernel_entry("K3 expected_value_decode_fused", "cuda", "csrc/decode.cu",
                     "decode_kernel.py:40", 0, k3["err"], k3["ms"], k3["plain_ms"],
                     k3["bound"], entry_point_only=True, value_err=k3["val_err"],
                     design="band products, strips staged by cp.async.bulk",
                     redesigned_in="PR 8", dense_bound_ms=k3["dense_bound"][0],
                     maps_64x48=dict(max_abs_err=k3_flagship["err"], ms=k3_flagship["ms"],
                                     plain_ms=k3_flagship["plain_ms"],
                                     bound_ms=k3_flagship["bound"][0],
                                     dense_bound_ms=k3_flagship["dense_bound"][0])),
        kernel_entry("K4 tiled_attention forward", "cuda", tiled_cu, "attention_tiled.py:119",
                     train_768["k4f"], k4["k4f_err"], k4["k4f_ms"], k4["k4f_plain_ms"],
                     k4["k4f_bound"], k4["k4f_lib_ms"], design="wgmma+TMA",
                     redesigned_in="PR 5", online_err=k4["k4f_online_err"],
                     online_rel_err=k4["k4f_online_rel"], fieldsynth=fieldsynth["k4f"]),
        kernel_entry("K4 tiled_attention backward", "cuda", tiled_cu, "attention_tiled.py:147",
                     train_768["k4b"], k4["k4b_err"], k4["k4b_ms"], k4["k4b_plain_ms"],
                     k4["k4b_bound"], k4["k4b_lib_ms"], design="wgmma+TMA",
                     redesigned_in="PR 5", recompute_ms=k4["k4b_recompute_ms"],
                     online_err=k4["k4b_online_err"], online_rel_err=k4["k4b_online_rel"],
                     fieldsynth=fieldsynth["k4b"]),
        # K5's bf16 path runs csrc/fused_mlp_sm90.cu (f32: csrc/fused_mlp.cu);
        # the library call is the same half-block on cuBLAS (dense_half_block).
        # The forward's numbers are at serving's 49,152 rows; `step_rows`
        # holds them at the remat step's 12,288, 24 launches a step.
        kernel_entry("K5 fused_ln_mlp forward", "cuda", mlp_cu, "mlp_kernel.py:49",
                     train_b["k5f"], serve_b["k5f_err"], serve_b["k5f_ms"],
                     serve_b["k5f_plain_ms"], serve_b["k5f_bound"], serve_b["k5f_lib_ms"],
                     design="wgmma+TMA", step_rows=train_b["k5f_step"]),
        kernel_entry("K5 fused_ln_mlp backward", "cuda", mlp_cu, "mlp_kernel.py:57",
                     train_b["k5b"], train_b["k5b_err"], train_b["k5b_ms"],
                     train_b["k5b_plain_ms"], train_b["k5b_bound"], train_b["k5b_lib_ms"],
                     design="wgmma+TMA", twin_err=train_b["k5b_twin_err"]),
        # K6's bf16 views run the short forward too (one tensor map per
        # view), so K6 and K1 give the same bits; other shapes run K1's
        # CUDA-core body in csrc/packed_attention.cu.
        kernel_entry("K6 fused_attention", "cuda", tiled_cu, "attention_kernel.py:32",
                     serve_b["k6"], serve_b["k6_err"], serve_b["k6_ms"], serve_b["k6_plain_ms"],
                     serve_b["k6_bound"], serve_b["k6_lib_ms"],
                     design="wgmma+TMA, sm90 short"),
    ]
    # Phase 10's launches (the three eval runs) beside each kernel's.
    eval_counter = {"K1 packed_attention forward": "k1s", "K1 packed_attention backward": "k4b",
                    "K2 sparsemax": "k2", "K3 expected_value_decode_fused": "k3",
                    "K4 tiled_attention forward": "k4f", "K4 tiled_attention backward": "k4b",
                    "K5 fused_ln_mlp forward": "k5f", "K5 fused_ln_mlp backward": "k5b",
                    "K6 fused_attention": "k6"}
    for entry in kernels:
        entry["eval_launches"] = evals[eval_counter[entry["name"]]]
        entry["finetune_launches"] = {run: c[eval_counter[entry["name"]]]
                                      for run, c in finetune.items()}
        entry["frontend_launches"] = frontend.get(eval_counter[entry["name"]], 0)
        entry["phase13_launches"] = {run: c[eval_counter[entry["name"]]]
                                     for run, c in recipes13.items()}
        entry["phase14_launches"] = {run: c[eval_counter[entry["name"]]]
                                     for run, c in detectors14.items()}
        entry["phase15_launches"] = {run: c[eval_counter[entry["name"]]]
                                     for run, c in bundles15.items()}
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
