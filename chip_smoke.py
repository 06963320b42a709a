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
           memory at bucket 256, the bf16 server under 32 clients x 8
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

  phase 16 int8 serving, the scale-and-translate crops and the head
           options, on phase 9's checkpoint (heads peaked) and a ViT-B at
           configs/vitb_coco.json width: load_predictor(quantize="int8")
           and "int8_wo" on the card and the CPU from the same weights,
           their int8 codes and float32 scales equal, the activation codes
           and int32 products of block 0's four layers equal, 1 K2 and no
           other kernel a forward, each stage of the trunk (embedding,
           every block's update, final norm) on the card against the CPU
           fed the card's input within 1e-2 normwise, heatmaps correlated
           above 0.95 against the bf16 predictor (JAX's bar) and above 0.9
           card against CPU with 0.6 of the well-defined keypoints within
           KPT_TOL_PX (12 random blocks amplify the stages' rare
           differences); the same at ViT-B; predict_frame with preprocess_method "linear",
           "cubic" and "lanczos3" at 1, 64 and 256 boxes on a 1088 x 1920
           frame (12 short K1 + 1 K2 a call), their crops of 8 boxes (4
           partly off the frame) card against CPU within 1e-5; the
           flagship geometry with deconv_kernel_sizes (2, 3) and the einsum
           attention with a bf16 softmax, float32 compute card against CPU
           within KPT_TOL_PX and PROB_TOL (bf16 compute served, printed);
           the int8 predictor exported as a bundle (buckets 1 and 64,
           indexed), 48 aten._int_mm and 1 probpose::sparsemax_rows a
           program, served by a fresh process without model code (1 K2 a
           call) equal to the live int8 predictor there. Then, not gated:
           int8, int8_wo and bf16 ms per batch at B = 1 and 256 (ViT-S,
           ViT-B), torch._int_mm against the bf16 product at the fc1
           shapes, each crop method's time and peak memory at 256 boxes
           against bilinear_matmul's, and the phase's wall time

  phase 17 scale-out, part 1. 17a, one card: the flagship's weights
           converted to head-major by compat.qkv_to_head_major and served
           at B = 256 with attn_impl="fused_tp" (12 short K1 forwards read
           the head-major layout, 1 K2), its heatmaps against the
           qkv-major run of the same weights within K1's bf16 bound (they
           are equal: only addresses move); one bf16 fused_tp step at B =
           256 (12 short K1 forwards, 12 K4 backwards from the saved out
           and lse); at 768 x 768 a fused_tp forward at B = 64 (12 K4
           forwards) and a step at B = 32 (12 K4 each way); K1 forward and
           backward at (256, 192, 1152) and K4 forward at (64, 2304, 1152)
           and backward at (32, 2304, ·), head-major, against their plain
           head-major versions and bit for bit against the qkv-major
           kernels on the same numbers, timed in turns against the
           qkv-major kernels (backwards from the saved out and lse), the
           plain versions and SDPA on the head-major q, k, v views. 17b: two ranks of a
           torch.distributed world spawned from this script
           (`--phase17-rank`), each on cuda:(rank % device count); the
           backend follows parallel/distributed.py's rule (gloo with both
           ranks on one card: NCCL refuses two ranks on one GPU; gloo's
           all-gathers of CUDA tensors go through host memory); an f32
           step each of DDP (data = 2, global B = 256) and TP (model = 2,
           fused_tp), two ZeRO-1 steps, and the data-parallel predictor at
           B = 256, against the single process on the same card (losses to
           1e-4, Adam's first moment per leaf to P17_MU_RTOL of its
           largest entry, the max-routed scalar branches' normwise to
           P17_ROUTED_RTOL, parameters to 1e-5 except where the gradient
           is within the moment tolerance of zero and in the scalar
           branches, there Adam's bound of 2 lr a step, keypoints within
           KPT_TOL_PX); the backend, each rank's card, each step's ms and
           the phase's seconds printed

  phase 18 pipeline parallelism (scale-out, part 2): a world of 4 ranks
           and one of 2 spawned from this script (`--phase18-rank`) when
           phase 15 starts, running beside the host-bound phases 15 and 16
           (so their step ms are upper bounds; `build/chip18.py`-style runs
           of phase18 alone time them), each rank on cuda:(rank % device
           count), gloo where ranks share a card (the pipe's sends staged
           through host memory); at phase 18's place one process's
           references, the timed ones alone on the card. 18a: the bf16
           flagship served through the GPipe forward at B = 256 on pipe =
           2 (6 blocks a stage, 24 short K1 forwards of (64, 192, 1152)
           and 1 K2 a rank), its heatmaps within K1's bf16 bound and its
           keypoints within KPT_TOL_PX of one process's. 18b: f32 steps at
           B = 256 against one process at phase 17's gates (the GPipe
           and pipe x model references are phase 17's single-process
           steps): GPipe on pipe = 2 (24 K1 each way a rank), 1F1B with
           the fused MLP on pipe = 2 against one process stepping the same
           8 microbatches in turn (stage 0: 96 K1 and K5 forwards, a
           forward slot and a recompute each, 48 backwards), and pipe 2 x
           model 2 with "fused_tp" in the world of 4, which runs while
           the untimed references are made (K1 head-major in the stages).
           18c: configs/vitl_coco.json (ViT-L, bf16, remat, B = 32)
           stepped with GPipe, then 1F1B, on pipe = 2 (K1 counted a block a
           slot): each rank's step ms and peak memory against one
           process's

  phase 19 the shapes the JAX package's kernels take that the port once
           refused (faults 9-12), then vit-h's d = 80 attention on the
           wgmma kernels: K4's CUDA-core kernels at d in {16, 48, 96, 112,
           160, 256} in f32 and {20, 44, 100, 108, 156, 252} in bf16 (no
           multiples of 8: the widths bf16 keeps on the CUDA cores) past
           K1's shared memory, forward and backward against the plain
           versions (the backward twice bit for bit), one head-major case;
           packed_attention timed at bf16 d = 48 (the wgmma route since
           phase 20's redesign); K5's
           CUDA-core kernels at (C, hidden) in {(64, 128), (200, 600),
           (576, 2304), (1536, 6144)} in f32 and at each plus 4 (no
           multiples of 8: the widths bf16 keeps on the CUDA cores since
           phase 21's redesign) in bf16, forward and the seven cotangents
           (bf16 also against the kernel-order twin); a
           batch of 70,000 through K1, K4 and K6; int8 at M = 5, K = 60
           card == CPU; the d = 80 short forward at (64, 192, 3840), the
           tiled forward at (8, 2304, 3840) and the backward from the saved
           out and lse against both plain orders, twice bit for bit, timed
           against the plain versions, SDPA and the CUDA-core kernels they
           replace; vit-nano with mlp_impl="fused" served (2 K5 a forward,
           on its wgmma kernels since phase 21's redesign) and stepped 3
           times (2 K5 each way a step); vit-h (1280 wide,
           16 heads of 80, bf16, attn_impl="fused", depth cut from 32 to 4
           for time: phase 20 runs ViT-g at full depth) served at 256 x 192
           (4 short forwards, 1 K2 a forward, no CUDA-core attention),
           trained by Trainer.fit with remat for 5 steps at B = 32 (8 short
           forwards, 4 backwards from the saved out and lse a step; losses
           finite and falling; the final save skipped), its f32 step at
           depth 2 held to the plain step (phase 5's gates), and served at
           768 x 768 at depth 4 (a K4 wgmma forward a block)
  phase 20 fault 13 closed and bf16 attention at every head width that is a
           multiple of 8 on the wgmma kernels: phase 0 holds every padded
           width's kernels (16 to 256) to no spills; bf16 at d in {16, 24,
           48, 72, 88, 96, 104, 112, 160, 192, 256}, both qkv layouts, at
           (8, 192) (the short forward) and (1, 2304) (the tiled one): the
           route, each forward against the TPU-order plain version (and
           the kernel order) with its lse, the backward from the saved out
           and lse against both orders, forward and backward twice bit for
           bit; K6 at d = 88 against its plain version and K1's bits; K4's
           CUDA cores at d in {272, 320, 512, 1024}, N in {192, 1024}, f32
           and bf16, against the plain versions (fault 13: once no kernel),
           timed at d = 512; the wgmma kernels timed at d = 48 (8, 1024,
           1152) and ViT-g's d = 88 at (64, 192, 4224) and (8, 2304, 4224)
           against the CUDA-core kernels they replace, SDPA and the plain
           versions (and d = 48 at (64, 192, 1152), K1's CUDA cores
           before); ViT-g/14 (1408 wide, depth 40, 16 heads of 88, MLP
           6,144, bf16, attn_impl="fused", remat) under the ProbMap head,
           composed as JAX's build_model composes a trunk (no preset in
           either package): served at 256 x 192 up to B = 64 (40 short
           forwards and 1 K2 a forward, no CUDA-core attention), trained by
           Trainer.fit for 3 steps at B = 32 (80 short forwards, 40
           backwards from the saved out and lse a step; its ~16 GB state
           kept in memory), ms a step and peak memory, its f32 step at
           depth 2 held to the plain step, and served at 768 x 768 at
           depth 4 (a tiled wgmma forward a block at d = 88)
  phase 21 bf16 K5 (fused LayerNorm + MLP) on the wgmma kernels at every
           width that is a multiple of 8: phase 0 holds every kernel of
           csrc/fused_mlp_sm90.cu to no spills (k5_ptxas); ViT-g's (1408,
           6144) at 12,288 and 6,144 rows, both GELU forms, the forward
           within K1's bound of the plain version, the seven cotangents
           within phase 7's bound of the plain backward and two ulps of
           the kernel-order twin, twice bit for bit, the scratch as the
           library counts it; the bits at the four preset widths (C in
           {384, 768, 1024, 1280}, two hidden widths each, 393 and 4,105
           rows, both forms) against the parent commit's
           (P21_PARENT_DIGESTS, scripts/k5_bits.py); K5 at (12288, 1408),
           (6144, 1408) and (12288, 1536), hidden 6,144, timed against the
           CUDA-core kernels it replaces (held to the plain versions
           first), the dense half-block on cuBLAS and the plain versions;
           ViT-g with mlp_impl="fused" served at full depth up to B = 64
           (40 K5 forwards a forward) and trained by Trainer.fit for 3
           remat steps at B = 32 (80 K5 forwards and 40 backwards a step),
           ms a batch, ms a step and peak memory (under 80 GiB)

`--attention-times` runs no phase: it times packed_attention's forward and
its backward through autograd at the phases' attention shapes against
scaled_dot_product_attention (medians of three windows of 50, in turns),
one JSON line per shape, and K2's loop at phase 3's rows, with the package
beside this script. It uses only packed_attention and sparsemax_rows, so a
copy of this script in another commit's checkout times that commit on the
same card.

`--serving-times` runs no phase either: it times the flagship bf16
predictor end to end (predict_frame at 1, 64 and 256 boxes of a 1080 x
1920 frame, a call on 64 crops) on the host clock, with the device's busy
time and idle share from torch.profiler, one JSON line each. It uses only
build_model and TopDownPredictor, so it too times another commit's
checkout.

`--profile` adds torch.profiler tables of three bf16 flagship training steps,
three ViT-B serving batches, three ViT-B training steps, and three 768 x 768
serving batches and training steps.

Every failure ends the run with a non-zero exit and no result line. The
last three lines are the card's name and power limit, a JSON summary of
the kernels (launches on the main paths and, as `eval_launches`, in phase
10's three eval runs, as `finetune_launches`, in each of phase 11's runs,
as `frontend_launches`, summed over phase 12's runs, as
`phase13_launches`, in each of phase 13's runs, as `phase14_launches`,
in each of phase 14's counted runs, as `phase15_launches`, in each
bundle call and bundle CLI run of phase 15, as `phase16_launches`, in
each counted run of phase 16, and as `phase17_launches`, in each of
phase 17's runs (rank 0's for 17b); the head-major entries are K1's and
K4's numbers on that layout; K4's entries carry its
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
LOAD_REQUESTS = 8
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
    model = build_model(cfg, device=dev, seed=0)
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
    model6 = build_model(dataclasses.replace(cfg, attn_impl="pallas"), device=dev)
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
    model = build_model(cfg, device=dev, seed=0)
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
    model32 = build_model(cfg32, device=dev)
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
                                    lambda: plain_step(trainer.state, db), iters=10, windows=3)
    say(f"phase 9 [{card}]: flagship bf16 step, B = {TRAIN_BATCH} frames of 480 x 640 on the "
        f"card: with the recipe's augmentation (flip, box jitter, colour) {aug_ms:.3f} ms, "
        f"without {plain_ms:.3f} ms (CUDA events, medians of 3 windows of 10 steps, in turns); "
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
    model32 = build_model(cfg32, device="cuda")
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
        model = build_model(dataclasses.replace(model_cfg, compute_dtype="float32"), device=dev)
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
                                                 pred.input_size, "bilinear_matmul"),
                      iters=5, warmup=1)
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
    model32 = build_model(cfg32, device=dev)
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
    model32 = build_model(dataclasses.replace(cfg_m, compute_dtype="float32"), device=dev)
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
    model32 = build_model(cfg32, device=dev)
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
    model = build_model(cfg, device=dev, seed=14)
    codec = make_codec(cfg)
    pred = TopDownPredictor(model, codec, cfg.img_size, return_heatmaps=True)
    requests = [request(140 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    answers, counts = counted(torch, {}, lambda: [pred(f, b) for f, b in requests])
    check_answers(cfg, requests, answers, phase=14)
    say(f"phase 14: conv-s pose model, {len(requests)} forwards: launches {counts}")
    check(counts["k2"] == len(requests), "conv-s pose: K2 did not run once a forward")
    check(all(v == 0 for k, v in counts.items() if k != "k2"), f"conv-s pose ran {counts}")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, device=dev)
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


def phase14_doctor_start() -> tuple:
    """Phase 14 (10): `python -m probpose_pytorch_tpu_torch.doctor`, started
    beside the phase's other work (a host-bound process of ~30 s)."""
    proc = subprocess.Popen([sys.executable, "-m", "probpose_pytorch_tpu_torch.doctor"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    STARTED.append(proc)
    return proc, time.perf_counter()


def phase14_doctor_end(card: str, handle: tuple) -> None:
    """The doctor started by phase14_doctor_start exits 0."""
    proc, t0 = handle
    out, err = proc.communicate(timeout=300)
    for line in out.strip().splitlines():
        say(f"  doctor: {line}")
    check(proc.returncode == 0, f"doctor exited {proc.returncode}: {err[-2000:]}")
    say(f"phase 14 [{card}]: doctor exit 0, {time.perf_counter() - t0:.1f} s after its start")


def phase14(torch, dev, card: str) -> dict:
    """Phase 14: the detector and bottom-up family on a generate_coco_synth
    set the phase writes and phase 9's checkpoint; returns its runs'
    launch counts."""
    from probpose_pytorch_tpu_torch.data import generate_coco_synth
    from probpose_pytorch_tpu_torch.detect import load_bottomup, load_detector

    t_phase = time.perf_counter()
    doctor = phase14_doctor_start()
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
    phase14_doctor_end(card, doctor)
    phase14_times(torch, dev, card, root, det_run, bu_run)
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
    model = build_model(cfg, device=dev, seed=0)
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


def bundle_graph(path: Path) -> str:
    """A saved program's graph as text."""
    import gzip

    import torch

    from probpose_pytorch_tpu_torch.ops.kernels import register_ops

    register_ops()
    return str(torch.export.load(io.BytesIO(gzip.decompress(path.read_bytes()))).graph)


def bundle_graph_ops(path: Path, graph: str | None = None) -> dict:
    """The `probpose::` ops of a saved program's graph (or of its text,
    `graph`), by name: count."""
    graph = bundle_graph(path) if graph is None else graph
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
        model = build_model(cfg, device=dev, seed=0)
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


def phase15_serve_alone_start(torch, dev, work: Path, det_run: Path, bu_run: Path) -> tuple:
    """Phase 15 (2-4): each bundle served by a fresh process that imports no
    model code, started beside the phase's front ends and data plane (its
    ~60 s are host-bound loads); phase15_serve_alone_end checks it."""
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
    logs = [open(work / f"child_{k}.txt", "w") for k in ("out", "err")]
    proc = subprocess.Popen([sys.executable, "-c", BUNDLE_CHILD, str(work), dev.type], cwd=REPO,
                            stdout=logs[0], stderr=logs[1], text=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    STARTED.append(proc)
    return proc, logs, time.perf_counter()


def phase15_serve_alone_end(work: Path, handle: tuple) -> dict:
    """The fresh process of phase15_serve_alone_start: 12 short K1 forwards
    and 1 K2 a pose program call; after its modules are checked, the same
    process runs the live predictors on the same calls, and their outputs
    are held to the bundles'. Its call times shared the card with the front
    ends."""
    proc, logs, t0 = handle
    proc.wait(timeout=900)
    for f in logs:
        f.close()
    out, err = ((work / f"child_{k}.txt").read_text() for k in ("out", "err"))
    check(proc.returncode == 0, f"the bundle process failed:\n{err[-4000:]}")
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    say(f"phase 15: the fresh process served {len(lines) - 2} bundle calls, then the live "
        f"predictors' same calls, in {time.perf_counter() - t0:.2f} s wall (start, kernel "
        "library, loads; beside the front ends)")
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
    alone = phase15_serve_alone_start(torch, dev, work, det_run, bu_run)
    launches = phase15_frontends(torch, dev, card, work)
    gc.collect()
    torch.cuda.empty_cache()
    phase15_dataplane(torch, dev, card, work)
    launches.update(phase15_serve_alone_end(work, alone))
    say(f"phase 15: {time.perf_counter() - t_phase:.1f} s in all")
    return launches


# Phase 16: int8 serving, the scale-and-translate crop methods, the head
# options no config uses.
Q_MODES = ("int8", "int8_wo")
Q_CPU_CROPS = 32  # crops served on the card and on the CPU side by side
Q_TIMED_BATCHES = (1, 256)
Q_CORR = 0.95  # JAX's tests/test_quant.py bar for int8 heatmaps against float ones
# Each stage of a quantised trunk (embedding, every block's update, the
# final norm) on the card against the same stage on the CPU fed the card's
# input: normwise relative error. Only rare elements differ there (a
# LayerNorm row one ulp apart flips a dynamic int8 code; bf16 sums in
# another order round the other way).
Q_STAGE_TOL = 1e-2
# End to end, card against CPU, heads peaked: 12 random blocks amplify
# those rare differences (the bf16 float trunk alone correlates 0.990686
# on an H100), so the bars are the amplified ones, set below the H100's
# readings (0.956659-0.991752, and 0.748-0.876 of the well-defined
# keypoints within KPT_TOL_PX); a wrong product or code breaks a stage
# above.
Q_CARD_CORR = 0.9
Q_KPT_SHARE = 0.6
Q_PRODUCTS = 4  # int8 products a block: qkv, proj, fc1, fc2
CROP_METHODS = ("linear", "cubic", "lanczos3")
CROP_TOL = 1e-5
CROP_SAMPLE = 8
CROP_BUCKETS = (1, 64, 256)

# The fresh process that serves the int8 bundle: it reports each call's
# launches, saves the outputs, lists the port's model modules it holds,
# then runs the live int8 predictor on the same calls in the same process.
Q_CHILD = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
from probpose_pytorch_tpu_torch.serve.export import ServingBundle
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
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work, recipe, dev = Path(sys.argv[1]), sys.argv[2], sys.argv[3]
inp = np.load(work / "q_inputs.npz")
bundle = ServingBundle.load(work / "int8", device=dev)
calls = {n: inp[f"boxes{n}"] for n in (1, 64)}
for n, boxes in calls.items():
    bundle.predict_frame(inp["frame"], boxes)  # the first call reads the program
    for w in W.values():
        w.launches = 0
    out = bundle.predict_frame(inp["frame"], boxes)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    np.savez(work / f"q_child_{n}.npz", **out)
    print(json.dumps(dict(call=n, counts={k: w.launches for k, w in W.items()})), flush=True)
banned = ("models", "train", "detect.model", "codec", "codec_simcc", "inference")
print(json.dumps(dict(modules=sorted(m for m in sys.modules
                                     if m.startswith("probpose_pytorch_tpu_torch.")
                                     and m.split(".", 1)[1].startswith(banned)))), flush=True)
from probpose_pytorch_tpu_torch.inference import load_predictor
live = load_predictor(recipe, quantize="int8", device=dev)
for n, boxes in calls.items():
    np.savez(work / f"q_live_{n}.npz", **live.predict_frame(inp["frame"], boxes,
                                                            buckets=tuple(bundle.buckets)))
print(json.dumps(dict(live="done")), flush=True)
"""


def check_quantized_launches(counts: dict, forwards: int, label: str) -> None:
    """The int8 trunk launches no kernel (its attention is plain, its
    products torch._int_mm); the ProbMap head K2 once a forward."""
    say(f"phase 16: {label}: K2 launches {counts['k2']} (expect {forwards}), attention, "
        f"K3, K5 and K6 {sum(counts[k] for k in COUNTER_KEYS if k != 'k2')} (expect 0)")
    check(counts["k2"] == forwards, f"{label}: K2 did not run once per forward")
    check(all(counts[k] == 0 for k in COUNTER_KEYS if k != "k2"),
          f"{label}: ran a kernel besides K2: {counts}")


def map_agreement(torch, codec, a: dict, b: dict) -> tuple[float, float, np.ndarray]:
    """(heatmap correlation, share of keypoints well defined in b's maps,
    keypoint gaps there in px) of two answers on the same crops."""
    sel = well_defined(torch, codec, b["heatmaps"], "cpu")
    gap = np.abs(a["keypoints"] - b["keypoints"]).max(-1)[sel]
    corr = float(np.corrcoef(a["heatmaps"].ravel(), b["heatmaps"].ravel())[0, 1])
    return corr, float(sel.mean()), gap


def phase16_products(torch, dev, card: str, label: str, qvit) -> None:
    """The int8 products of a quantised trunk on the card: its codes and
    scales equal those quantised on the CPU from the same float32 weights
    (checked by the caller); here the activation codes of the same float32
    rows and the int32 products of block 0's four layers, card against
    CPU, equal."""
    from probpose_pytorch_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(165)
    state = qvit.state()
    for layer in ("attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2"):
        w_q = state[f"blocks.0.{layer}.weight_q"]
        x = torch.randn(Q_CPU_CROPS * 192, w_q.shape[1], generator=g) * 3
        xq, xs = quant.dynamic_quantize_rows(x)
        xqd, xsd = quant.dynamic_quantize_rows(x.to(dev))
        check(torch.equal(xqd.cpu(), xq) and torch.equal(xsd.cpu(), xs),
              f"{label} {layer}: activation codes differ card against CPU")
        acc = torch._int_mm(xqd, w_q.t())
        check(torch.equal(acc.cpu(), torch._int_mm(xq, w_q.cpu().t())),
              f"{label} {layer}: int32 products differ card against CPU")
    say(f"phase 16: {label}: activation codes and the int32 products of block 0's qkv, proj, "
        f"fc1 and fc2 at {Q_CPU_CROPS * 192} rows equal card against CPU")


def phase16_stages(torch, dev, label: str, card_pred, cpu_pred) -> None:
    """Each stage of the quantised trunk on the card against the same
    stage on the CPU, fed the card's input: the embedding, every block's
    update of the residual stream, the final norm; normwise within
    Q_STAGE_TOL. This is where a wrong product, code or scale shows, free
    of the trunk's amplification."""
    from probpose_pytorch_tpu_torch.models import vit_int8

    cq, pq = card_pred.model.backbone, cpu_pred.model.backbone
    cs, ps = cq.state(), pq.state()
    H, W = card_pred.input_size
    g = torch.Generator().manual_seed(169)
    images = torch.rand(Q_CPU_CROPS, H, W, 3, generator=g)

    def rel(got, want):
        got, want = got.cpu().float(), want.float()
        return float((got - want).norm() / want.norm())

    x = vit_int8.embed_int8(cs, images.to(dev), cq.patch_size)
    errs = [rel(x, vit_int8.embed_int8(ps, images, pq.patch_size))]
    for i in range(cq.depth):
        y = vit_int8.block_int8(cs, i, x, cq.num_heads, cq.weight_only)
        x_cpu = x.cpu()
        ref = vit_int8.block_int8(ps, i, x_cpu, pq.num_heads, pq.weight_only)
        errs.append(rel(y.float() - x.float(), ref.float() - x_cpu.float()))
        x = y
    errs.append(rel(vit_int8.layernorm(x, cs["norm.weight"], cs["norm.bias"]),
                    vit_int8.layernorm(x.cpu(), ps["norm.weight"], ps["norm.bias"])))
    say(f"phase 16: {label}, each stage card against CPU on the card's input ({Q_CPU_CROPS} "
        f"images), normwise: embedding {errs[0]:.3e}, block updates "
        + " ".join(f"{e:.2e}" for e in errs[1:-1]) + f", final norm {errs[-1]:.3e} "
        f"(gate {Q_STAGE_TOL:g})")
    check(max(errs) <= Q_STAGE_TOL, f"{label}: a quantised stage differs card against CPU: "
          f"{max(errs):.3e}")


def phase16_quantized(torch, dev, card: str, label: str, card_pred, cpu_pred, float_pred,
                      frames, boxes) -> dict:
    """One quantised predictor on the card against the same on the CPU and
    against the float predictor on the card; returns its launches. As
    loaded, its heatmaps are held to the float predictor's (JAX's bar, on
    an untrained head's diffuse maps as JAX's test has them); then both
    quantised predictors' heatmap branches are redrawn peaked, the same on
    both devices, and their keypoints compared where well defined."""
    bufs = dict(cpu_pred.model.backbone.named_buffers())
    same = all(torch.equal(t.cpu(), bufs[k]) for k, t in card_pred.model.backbone.named_buffers())
    say(f"phase 16: {label}: {len(bufs)} quantised trunk tensors (int8 codes, float32 scales) "
        f"{'equal' if same else 'DIFFER'} card against CPU")
    check(same, f"{label}: the quantised weights differ card against CPU")
    phase16_products(torch, dev, card, label, card_pred.model.backbone)
    phase16_stages(torch, dev, label, card_pred, cpu_pred)
    for p in (card_pred, cpu_pred, float_pred):
        p.return_heatmaps = True
    out, counts = counted(torch, {}, lambda: card_pred(frames, boxes))
    check_quantized_launches(counts, 1, label)
    for k, v in out.items():
        check(np.isfinite(v).all(), f"{label}: {k} not finite")
    fref = float_pred(frames, boxes)["heatmaps"]
    fcorr = float(np.corrcoef(out["heatmaps"].ravel(), fref.ravel())[0, 1])
    say(f"phase 16 [{card}]: {label} against the bf16 predictor on the card, {len(frames)} "
        f"crops: heatmap correlation {fcorr:.6f} (gate {Q_CORR}, JAX's "
        "test_int8_predictor_tracks_f32)")
    check(fcorr > Q_CORR, f"{label}: int8 heatmaps track the bf16 ones at {fcorr}")
    for p in (card_pred, cpu_pred):
        peak_heatmap_branch(torch, p.model)
    corr, share, gap = map_agreement(torch, cpu_pred.codec, card_pred(frames, boxes),
                                     cpu_pred(frames, boxes))
    within = float((gap <= KPT_TOL_PX).mean()) if gap.size else 0.0
    say(f"phase 16 [{card}]: {label}, heads peaked, card against CPU: heatmap correlation "
        f"{corr:.6f} (gate {Q_CARD_CORR}); of the {share:.3f} well defined keypoints "
        f"{within:.3f} within {KPT_TOL_PX:g} px (gate {Q_KPT_SHARE}: the rest jump, as the "
        "stages' rare differences are amplified by 12 random blocks), gaps median "
        f"{np.median(gap) if gap.size else 0.0:.3e} px, 90 % "
        f"{np.quantile(gap, 0.9) if gap.size else 0.0:.3e}, max {gap.max(initial=0.0):.3e}")
    check(corr > Q_CARD_CORR, f"{label}: heatmaps correlate {corr} card against CPU")
    check(share > 0.5 and within >= Q_KPT_SHARE,
          f"{label}: {within} of the well-defined keypoints agree card against CPU")
    for p in (card_pred, cpu_pred, float_pred):
        p.return_heatmaps = False
    return counts


def phase16_int8(torch, dev, card: str) -> dict:
    """Phase 16 (1): int8 and int8_wo through load_predictor on phase 9's
    checkpoint, and on a ViT-B predictor at configs/vitb_coco.json width
    (random weights); then their times against bf16 and torch._int_mm's
    against the bf16 product. Returns the launches by run."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.models.model import build_model

    recipe = RUN_DIR / "recipe" / "checkpoints"
    frames, boxes = request(160, Q_CPU_CROPS)
    cfg = vitb_train_config("bfloat16").model

    def vitb(d, mode=None):
        return TopDownPredictor(build_model(cfg, device=d, seed=0), make_codec(cfg),
                                cfg.img_size, quantize=mode)

    launches, preds = {}, {"vit-s": {}, "vit-b": {}}
    for mode in Q_MODES:
        float_pred = load_predictor(recipe, device=dev)
        preds["vit-s"][mode] = load_predictor(recipe, quantize=mode, device=dev)
        launches[f"vit-s {mode}"] = phase16_quantized(
            torch, dev, card, f"flagship checkpoint {mode}", preds["vit-s"][mode],
            load_predictor(recipe, quantize=mode, device="cpu"), float_pred, frames, boxes)
        float_pred = vitb(dev)
        preds["vit-b"][mode] = TopDownPredictor(float_pred.model, float_pred.codec,
                                                cfg.img_size, quantize=mode)
        launches[f"vit-b {mode}"] = phase16_quantized(
            torch, dev, card, f"ViT-B {mode}", preds["vit-b"][mode], vitb("cpu", mode),
            float_pred, frames, boxes)
    preds["vit-s"][None] = load_predictor(recipe, device=dev)
    preds["vit-b"][None] = vitb(dev)
    for name, by_mode in preds.items():
        for B in Q_TIMED_BATCHES:
            f, b = request(166, B)
            f_dev, b_dev = torch.from_numpy(f).to(dev), torch.from_numpy(b).to(dev)
            ms = {str(m): cuda_ms(torch, lambda p=p: p.predict(f_dev, b_dev), iters=5, warmup=2)
                  for m, p in by_mode.items()}
            say(f"phase 16 [{card}]: {name} ms per batch of {B} (frames on the card, CUDA "
                f"events, mean of 5): bf16 {ms['None']:.3f}, int8 {ms['int8']:.3f}, int8_wo "
                f"{ms['int8_wo']:.3f}")
    for name, (C, hidden) in (("vit-s", (384, 1536)), ("vit-b", (768, 3072))):
        M = Q_TIMED_BATCHES[-1] * 192
        g = torch.Generator(device=dev).manual_seed(167)
        a = torch.randint(-127, 128, (M, C), dtype=torch.int8, device=dev, generator=g)
        w = torch.randint(-127, 128, (hidden, C), dtype=torch.int8, device=dev, generator=g)
        ab, wb = a.bfloat16(), w.bfloat16()
        int_ms, bf_ms = paired_ms(torch, lambda: torch._int_mm(a, w.t()), lambda: ab @ wb.t(),
                                  iters=20)
        ops = 2 * M * C * hidden
        say(f"phase 16 [{card}]: {name} fc1 ({M}, {C}) x ({C}, {hidden}): torch._int_mm "
            f"{int_ms:.4f} ms against the bf16 cuBLAS product's {bf_ms:.4f} ms (in turns); "
            f"{ops / int_ms / 1e9:.1f} and {ops / bf_ms / 1e9:.1f} TOP/s")
        del a, w, ab, wb
    del preds
    return launches


def phase16_crops(torch, dev, card: str) -> dict:
    """Phase 16 (2): predict_frame with each scale-and-translate method on
    phase 9's checkpoint at 1088 x 1920 and 1, 64 and 256 boxes; crops of
    a sample of boxes, half of them partly off the frame, card against
    CPU; each method's crop time and peak memory at 256 boxes against
    bilinear_matmul's. Returns the launches by run."""
    from probpose_pytorch_tpu_torch.inference import load_predictor
    from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize

    pred = load_predictor(RUN_DIR / "recipe" / "checkpoints", device=dev)
    K = len(pred.codec.probmap.sigmas_array)
    H, W = BUNDLE_HW
    rng = np.random.default_rng(168)
    frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    box_sets = {n: camera_boxes(rng, n, BUNDLE_HW) for n in CROP_BUCKETS}
    launches = {}
    for method in CROP_METHODS:
        p = dataclasses.replace(pred, preprocess_method=method)
        for n, bx in box_sets.items():
            out, counts = counted(torch, {}, lambda: p.predict_frame(frame, bx,
                                                                     buckets=CROP_BUCKETS))
            check_fields(out, n, K, f"{method} at {n} boxes")
            check_attention_route(counts, 12, 0, phase=16)
            check(counts["k2"] == 1, f"{method} at {n} boxes: K2 did not run once")
            launches[f"crop {method} {n}"] = counts
        say(f"phase 16: predict_frame with preprocess_method {method!r} at {CROP_BUCKETS} boxes "
            f"on a {H} x {W} frame: all fields finite, 12 short K1 forwards and 1 K2 a call")
    bx = box_sets[CROP_BUCKETS[-1]]
    off = (bx[:, 0] < 0) | (bx[:, 1] < 0) | (bx[:, 0] + bx[:, 2] > W) | (bx[:, 1] + bx[:, 3] > H)
    pick = np.concatenate([np.flatnonzero(off)[:CROP_SAMPLE // 2],
                           np.flatnonzero(~off)[:CROP_SAMPLE // 2]])
    check(off[pick].sum() == CROP_SAMPLE // 2, "too few boxes partly off the frame")
    frames_cpu = torch.from_numpy(frame)[None].expand(len(pick), -1, -1, -1)
    f_dev = torch.from_numpy(frame).to(dev)[None]
    for method in CROP_METHODS:
        ids = torch.zeros(len(pick), dtype=torch.int64, device=dev)
        got = crop_resize(f_dev.index_select(0, ids), torch.from_numpy(bx[pick]).to(dev),
                          pred.input_size, method).cpu()
        want = crop_resize(frames_cpu, torch.from_numpy(bx[pick]), pred.input_size, method)
        gap = float((got - want).abs().max())
        say(f"phase 16: {method} crops of {len(pick)} boxes ({CROP_SAMPLE // 2} partly off the "
            f"frame) card against CPU: max gap {gap:.3e} (gate {CROP_TOL:g})")
        check(gap <= CROP_TOL, f"{method}: card crops differ from the CPU's by {gap}")
    b_dev = torch.from_numpy(bx).to(dev)
    i_dev = torch.zeros(len(bx), dtype=torch.int64, device=dev)
    for method in CROP_METHODS + ("bilinear_matmul",):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda m=method: crop_resize(f_dev.index_select(0, i_dev), b_dev,
                                                         pred.input_size, m),
                     iters=3, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        say(f"phase 16 [{card}]: crop_resize {method!r} of {len(bx)} boxes from one {H} x {W} "
            f"frame (the indexed dispatch's gather included): {ms:.3f} ms, peak {peak:.2f} GiB "
            "above the inputs")
    return launches


def phase16_head_options(torch, dev, card: str) -> dict:
    """Phase 16 (3): the flagship geometry with deconv_kernel_sizes (2, 3)
    and the einsum attention with a bf16 softmax, served on the card and
    the CPU from the same weights: float32 compute against the CPU within
    KPT_TOL_PX and PROB_TOL; bf16 compute served. Returns the launches."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model

    block = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())["model"]
    frames, boxes = request(169, Q_CPU_CROPS)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(**{**block, "deconv_kernel_sizes": (2, 3), "attn_impl": "einsum",
                             "softmax_dtype": "bfloat16", "compute_dtype": dtype})
        on_card, on_cpu = (TopDownPredictor(build_model(cfg, device=d, seed=16), make_codec(cfg),
                                            cfg.img_size, return_heatmaps=True)
                           for d in (dev, torch.device("cpu")))
        for p in (on_card, on_cpu):
            peak_heatmap_branch(torch, p.model)
        out, counts = counted(torch, {}, lambda: on_card(frames, boxes))
        label = f"deconv (2, 3) + einsum bf16-softmax trunk, {dtype} compute"
        check_quantized_launches(counts, 1, label)
        launches[f"head options {dtype}"] = counts
        ref = on_cpu(frames, boxes)
        corr, share, gap = map_agreement(torch, on_cpu.codec, out, ref)
        fgap = max(float(np.abs(out[k] - ref[k]).max())
                   for k in ("probabilities", "visibilities", "oks", "errors"))
        say(f"phase 16 [{card}]: {label}, card against CPU on {len(frames)} crops: heatmaps "
            f"{out['heatmaps'].shape[-2:]}, correlation {corr:.6f}, keypoint max gap "
            f"{gap.max(initial=0.0):.3e} px over the {share:.3f} well defined, other fields "
            f"{fgap:.3e}" + (f" (gates {KPT_TOL_PX:g}, {PROB_TOL:g})" if dtype == "float32"
                              else " (bf16 trunk: printed, not gated)"))
        check(out["heatmaps"].shape[-2:] == (64, 48), f"{label}: heatmap shape")
        if dtype == "float32":
            check(share > 0.5 and gap.max(initial=0.0) <= KPT_TOL_PX and fgap <= PROB_TOL,
                  f"{label}: card and CPU differ (keypoints {gap.max(initial=0.0)}, fields {fgap})")
    return launches


def phase16_bundle(torch, dev, card: str, work: Path) -> dict:
    """Phase 16 (4): the int8 predictor of phase 9's checkpoint exported as
    a bundle (buckets 1 and 64, indexed); every program holds 48
    aten._int_mm and one probpose::sparsemax_rows; a fresh process with no
    model code serves it with 1 K2 and no other kernel a call and equals
    the live int8 predictor there at 0 px. Returns the launches by call."""

    from probpose_pytorch_tpu_torch.inference import load_predictor
    from probpose_pytorch_tpu_torch.serve.export import export_predictor_bundle

    recipe = RUN_DIR / "recipe" / "checkpoints"
    pred = load_predictor(recipe, quantize="int8", device=dev)
    t0 = time.perf_counter()
    export_predictor_bundle(pred, work / "int8", BUNDLE_BUCKETS, BUNDLE_HW)
    programs = sorted((work / "int8").glob("*.pt2.gz"))
    say(f"phase 16 [{card}]: int8 bundle: {len(programs)} programs in "
        f"{time.perf_counter() - t0:.2f} s, params.pt "
        f"{(work / 'int8' / 'params.pt').stat().st_size / 2**20:.2f} MiB")
    for program in programs:
        graph = bundle_graph(program)
        ops, int_mm = bundle_graph_ops(program, graph), graph.count("aten._int_mm")
        say(f"phase 16: int8/{program.name}: aten._int_mm {int_mm}, probpose ops {ops}")
        check(int_mm == 12 * Q_PRODUCTS and ops == {"sparsemax_rows": 1},
              f"int8/{program.name}: {int_mm} int8 products, ops {ops}")
    del pred
    rng = np.random.default_rng(170)
    frame = rng.integers(0, 256, (*BUNDLE_HW, 3), dtype=np.uint8)
    np.savez(work / "q_inputs.npz", frame=frame, boxes1=camera_boxes(rng, 1, BUNDLE_HW),
             boxes64=camera_boxes(rng, 64, BUNDLE_HW))
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", Q_CHILD, str(work), str(recipe), dev.type],
                          cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    check(proc.returncode == 0, f"the int8 bundle process failed:\n{proc.stderr[-4000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    check(lines[-2] == {"modules": []}, f"the int8 bundle process imported model code: {lines[-2]}")
    check(lines[-1] == {"live": "done"}, "the int8 bundle process did not run the live predictor")
    launches = {}
    for c in lines[:-2]:
        n = c["call"]
        check_quantized_launches(c["counts"], 1, f"int8 bundle at {n} boxes (fresh process)")
        launches[f"int8 bundle {n}"] = c["counts"]
        got, ref = dict(np.load(work / f"q_child_{n}.npz")), dict(np.load(work / f"q_live_{n}.npz"))
        check(sorted(got) == sorted(ref), f"int8 bundle at {n}: keys {sorted(got)}")
        gap = max(float(np.abs(got[k].astype(np.float64) - ref[k]).max()) for k in ref)
        say(f"phase 16: int8 bundle at {n} boxes against the live int8 predictor in the same "
            f"fresh process: max gap {gap:.3e} over every field (gate 0)")
        check(gap == 0.0, f"int8 bundle at {n}: differs from live by {gap}")
    check(sorted(launches) == ["int8 bundle 1", "int8 bundle 64"], f"calls {sorted(launches)}")
    return launches


def phase16(torch, dev, card: str) -> dict:
    """Phase 16: int8 serving, the crop methods, the head options and the
    int8 bundle. Returns the launches of its counted runs."""
    t_phase = time.perf_counter()
    work = RUN_DIR / "phase16"
    work.mkdir(parents=True, exist_ok=True)
    launches = phase16_int8(torch, dev, card)
    for part in (phase16_crops, phase16_head_options):
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(part(torch, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase16_bundle(torch, dev, card, work))
    say(f"phase 16: {time.perf_counter() - t_phase:.1f} s in all")
    return launches


# ------------------------------------------------------------------ phase 17

P17_SERVE_BATCH = 256
P17_TRAIN_BATCH = 256
P17_768_SERVE = 64
P17_768_TRAIN = 32
P17_WORLD = 2
P17_DEADLINE_S = 400
# The f32 steps of the two-rank world against the single process on the
# same card (sums over other row splits and another GEMM tiling, TF32 off):
# the loss to 1e-4; Adam's first moment, every leaf within P17_MU_RTOL of
# its largest entry in the single process (the BatchNorm and LayerNorm
# leaves are sums over every pixel of the batch that nearly cancel: their
# rounding reads up to 2.4e-3 of the leaf's largest entry; a wrong shard
# or a missing reduction moves a leaf by a large part of it); a leaf that
# is all rounding noise (a convolution's bias before a train-mode
# BatchNorm has no gradient), below P17_NOISE of the largest entry
# anywhere, within P17_NOISE of that. The head's scalar branches
# (P17_ROUTED) route their gradient through max-pool windows and a max
# over the grid: where a window's two largest entries lie within the
# convolution's rounding (cuDNN picks its algorithm by batch size), the
# other entry takes a sample's whole share, so their first moments are
# held normwise, within P17_ROUTED_RTOL of the leaf's norm, after the
# first step (a second starts from parameters that may differ by Adam's
# bound). The other leaves' moments are held after every step. Every
# parameter within 1e-5, except where a step's gradient (read off the
# first moments after each step) took another sign in the world than in
# the single process, or lay within P17_FLIP_RTOL of the leaf's largest
# entry of zero, and the scalar branches: Adam moves an element by lr
# whatever its gradient's size, so those stay within two learning rates a
# step, plus 1e-5.
P17_LOSS_RTOL = 1e-4
P17_MU_RTOL = 1e-2
P17_NOISE = 1e-5
P17_PARAM_ATOL = 1e-5
P17_ROUTED = "head.branches."
P17_ROUTED_RTOL = 5e-2
P17_FLIP_RTOL = 1e-4


def head_major_copy(torch, qkv, heads: int):
    """The head-major packing of a qkv-major (B, N, 3C) tensor, a copy."""
    B, N, C3 = qkv.shape
    return qkv.reshape(B, N, 3, heads, -1).transpose(2, 3).reshape(B, N, C3).contiguous()


def sdpa_views(torch, qkv, heads: int, layout: str):
    """q, k, v (B, heads, N, d) views of a packed qkv in `layout` for
    F.scaled_dot_product_attention, the yardstick (never called by the port)."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import split_qkv

    return tuple(t.transpose(1, 2) for t in split_qkv(qkv, heads, layout))


def phase17_kernel(torch, card: str, g, label: str, B: int, N: int, heads: int, backward: bool,
                   tiled: bool) -> dict:
    """One head-major kernel at (B, N, heads, d = 64) bf16: gated against its
    plain head-major version, its bits equal to the qkv-major kernel's on
    the same numbers, then timed in turns against the qkv-major kernel (a
    backward from the forward's saved out and lse, as the step calls it),
    and against the plain version and the library's attention on the
    head-major q, k, v views."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        packed_attention,
        packed_attention_backward,
        packed_attention_bwd_reference,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        short_forward,
        tiled_attention,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_reference,
        tiled_forward,
    )

    dev = torch.device("cuda")
    C = heads * 64
    hm = "head_major"
    qkv = torch.randn(B, N, 3 * C, generator=g, device=dev).to(torch.bfloat16)
    hq = head_major_copy(torch, qkv, heads)
    shape = f"qkv ({B}, {N}, {3 * C}) bf16 head-major"
    if not backward:
        fwd = tiled_attention if tiled else packed_attention
        out = fwd(hq, heads, hm)
        ref = (tiled_attention_reference(hq, heads, layout=hm) if tiled
               else packed_attention_reference(hq, heads, hm))
        err = gate(torch, f"{label} {shape}", out, ref, phase=17)
        check(torch.equal(out, fwd(qkv, heads)), f"{label}: head-major bits differ")
        del out, ref
        kernel, qkv_major = lambda: fwd(hq, heads, hm), lambda: fwd(qkv, heads)
        plain = ((lambda: tiled_attention_reference(hq, heads, layout=hm)) if tiled
                 else (lambda: packed_attention_reference(hq, heads, hm)))
        q, k, v = sdpa_views(torch, hq, heads, hm)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
        bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * C)
    else:
        fwd_lse = tiled_forward if tiled else short_forward
        bwd = tiled_attention_backward if tiled else packed_attention_backward
        dout = torch.randn(B, N, C, generator=g, device=dev).to(torch.bfloat16)
        out_h, lse_h = fwd_lse(hq, heads, True, hm)
        out_q, lse_q = fwd_lse(qkv, heads, True)
        got = bwd(hq, dout, heads, out_h, lse_h, layout=hm)
        ref = (tiled_attention_bwd_reference(hq, dout, heads, layout=hm) if tiled
               else packed_attention_bwd_reference(hq, dout, heads, hm))
        err = gate(torch, f"{label} {shape}", got, ref, phase=17)
        check(torch.equal(got, head_major_copy(torch, bwd(qkv, dout, heads, out_q, lse_q),
                                               heads)), f"{label}: head-major bits differ")
        del got, ref
        kernel = lambda: bwd(hq, dout, heads, out_h, lse_h, layout=hm)
        qkv_major = lambda: bwd(qkv, dout, heads, out_q, lse_q)
        plain = ((lambda: tiled_attention_bwd_reference(hq, dout, heads, layout=hm)) if tiled
                 else (lambda: packed_attention_bwd_reference(hq, dout, heads, hm)))
        q, k, v = (t.detach().requires_grad_(True) for t in sdpa_views(torch, hq, heads, hm))
        ctx = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        do = dout.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(ctx, (q, k, v), do, retain_graph=True)
        bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * B * N * N * C)
    iters = 20 if tiled else 50
    _, plain_ms = paired_ms(torch, kernel, plain, iters=3 if tiled else 10)
    ms, qkv_major_ms = yardstick_ms(torch, kernel, qkv_major, iters=iters)
    _, lib_ms = yardstick_ms(torch, kernel, lib, iters=iters)
    say(f"phase 17 [{card}]: {label} {shape}: kernel {ms:.4f} ms against the qkv-major "
        f"kernel's {qkv_major_ms:.4f} ms (in turns), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention on the q, k, v views {lib_ms:.4f} ms (medians of 3 "
        f"windows, in turns), bound {bound[0]:.4f} ms ({bound[1]})")
    return dict(err=err, ms=ms, qkv_major_ms=qkv_major_ms, plain_ms=plain_ms, bound=bound,
                lib_ms=lib_ms)


def phase17_flagship(torch, dev, card: str, g) -> tuple[dict, dict]:
    """17a on one card: the flagship's weights converted to head-major by the
    port's qkv_to_head_major, served and trained with attn_impl="fused_tp"
    (K1 and K4 head-major, counted), the serving output against the
    qkv-major run of the same weights; the same at 768 x 768 through K4;
    then each head-major kernel against its plain version and timed.
    Returns (launches by run, kernel numbers)."""
    from probpose_pytorch_tpu_torch.compat.layouts import qkv_to_head_major
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model

    launches = {}
    tp = lambda cfg: dataclasses.replace(cfg, attn_impl="fused_tp")
    cfg = train_config("bfloat16", P17_TRAIN_BATCH)
    heads = 6
    qm = build_model(cfg.model, device=dev, seed=0)
    peak_heatmap_branch(torch, qm)
    hm = build_model(tp(cfg.model), device=dev, seed=0)
    hm.load_state_dict(qkv_to_head_major(qm.state_dict(), heads))
    codec = make_codec(cfg.model)
    frames, boxes = request(170, P17_SERVE_BATCH)
    ref = TopDownPredictor(qm, codec, cfg.model.img_size, return_heatmaps=True)(frames, boxes)
    reset_counts()
    t0 = time.perf_counter()
    got = TopDownPredictor(hm, codec, cfg.model.img_size, return_heatmaps=True)(frames, boxes)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches["17a flagship serving"] = counts = read_counts()
    check_attention_route(counts, 12, 0, phase=17)
    check(counts["k2"] == 1, "K2 did not run once in the head-major forward")
    bound = 2 * 2**-8 * max(1.0, float(np.abs(ref["heatmaps"]).max()))
    err = float(np.abs(got["heatmaps"] - ref["heatmaps"]).max())
    say(f"phase 17: fused_tp (head-major) serving at B={P17_SERVE_BATCH}: heatmaps against "
        f"the qkv-major run of the same weights, max abs diff {err:.3e} (K1's bf16 bound "
        f"{bound:.3e}); keypoints max diff "
        f"{float(np.abs(got['keypoints'] - ref['keypoints']).max()):.3e} px; "
        f"{serve_ms:.1f} ms from host numpy")
    check(err <= bound, f"head-major serving differs from qkv-major by {err}")
    del qm, hm, got, ref

    from probpose_pytorch_tpu_torch.train.loop import Trainer

    H, W = cfg.model.img_size
    ds = SyntheticPoseDataset(P17_TRAIN_BATCH, (H, W), cfg.model.num_keypoints, seed=0)
    batch = next(iter(batch_iterator(ds, P17_TRAIN_BATCH, num_workers=8)))
    trainer = Trainer.create(dataclasses.replace(cfg, model=tp(cfg.model)), 1, device=dev)
    peak_heatmap_branch(torch, trainer.model)
    db = trainer.device_batch(batch)
    reset_counts()
    t0 = time.perf_counter()
    _, m = trainer.train_step(trainer.state, db)
    loss = float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    launches["17a flagship step"] = counts = read_counts()
    say(f"phase 17: fused_tp bf16 train step at B={P17_TRAIN_BATCH}: loss {loss:.6f}, "
        f"{step_ms:.1f} ms (first step)")
    check(np.isfinite(loss), "the head-major step's loss is not finite")
    check_attention_route(counts, 12, 12, phase=17)
    del trainer, db

    cfg768 = config_768("bfloat16", P17_768_TRAIN)
    model = build_model(tp(cfg768.model), device=dev, seed=0)
    x = torch.rand(P17_768_SERVE, *IMG_768, 3, generator=g, device=dev)
    reset_counts()
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    launches["17a 768 serving"] = counts = read_counts()
    say(f"phase 17: fused_tp at 768 x 768, B={P17_768_SERVE}: K4 forward {counts['k4f']} "
        "(expect 12), short forward and K1 CUDA cores 0")
    check(counts["k4f"] == 12 and counts["k1s"] == counts["k1f"] == 0,
          "the 768 x 768 head-major forward did not run K4 once per block")
    check(all(torch.isfinite(o).all() for o in out), "768 x 768 head-major outputs not finite")
    del model, out, x
    trainer = Trainer.create(dataclasses.replace(cfg768, model=tp(cfg768.model)), 1, device=dev)
    H, W = IMG_768
    ds = SyntheticPoseDataset(P17_768_TRAIN, (H, W), cfg768.model.num_keypoints, seed=2)
    db = trainer.device_batch(next(iter(batch_iterator(ds, P17_768_TRAIN, num_workers=8))))
    reset_counts()
    _, m = trainer.train_step(trainer.state, db)
    check(np.isfinite(float(m["loss"])), "the 768 x 768 head-major step's loss is not finite")
    launches["17a 768 step"] = counts = read_counts()
    say(f"phase 17: fused_tp bf16 step at 768 x 768, B={P17_768_TRAIN}: K4 forward "
        f"{counts['k4f']}, backward {counts['k4b']} (expect 12 each, "
        f"{counts['k4b_recomputes']} recomputes)")
    check(counts["k4f"] == counts["k4b"] == 12 and counts["k4b_recomputes"] == 0,
          "the 768 x 768 head-major step did not run K4 once per block each way")
    del trainer, db
    gc.collect()
    torch.cuda.empty_cache()

    numbers = dict(
        k1f=phase17_kernel(torch, card, g, "K1 forward", P17_SERVE_BATCH, 192, heads,
                           False, False),
        k1b=phase17_kernel(torch, card, g, "K1 backward", P17_TRAIN_BATCH, 192, heads,
                           True, False),
        k4f=phase17_kernel(torch, card, g, "K4 forward", P17_768_SERVE, 2304, heads,
                           False, True),
        k4b=phase17_kernel(torch, card, g, "K4 backward", P17_768_TRAIN, 2304, heads,
                           True, True))
    return launches, numbers


def phase17_scenarios():
    """(name, model axis, TrainConfig overrides, steps) of 17b's steps: f32
    flagship at the global batch, augmentation off; one step each, and a
    second ZeRO-1 step (it reads the first's sharded moments). The TP
    step's model axis is 2 (the flagship's 6 heads), its data axis the rest
    of the world."""
    return (("ddp", 1, {}, 1), ("tp", 2, dict(attn_impl="fused_tp"), 1),
            ("zero1", 1, dict(shard_opt_state=True), 2))


def phase17_whole(trainer) -> tuple[dict, dict]:
    """(parameters, Adam's first moments) of the trainer's state, whole and
    on the CPU, by name (collective on a mesh)."""
    from probpose_pytorch_tpu_torch.train.checkpoint import _state_payload

    payload = _state_payload(trainer.state)
    opt = payload["opt_state"]
    opt = opt.get("inner", opt)
    return payload["params"], dict(zip(trainer.state.names, opt["mu"]))


def phase17_tolerances(leaves: dict, rtol: float = P17_MU_RTOL) -> dict:
    """Per leaf: `rtol` of its largest entry, or P17_NOISE of the largest
    entry anywhere for a leaf that is all rounding noise (its largest
    entry below that)."""
    top = max(float(abs(a).max()) for a in leaves.values())
    return {n: P17_NOISE * top if float(abs(a).max()) < P17_NOISE * top
            else rtol * float(abs(a).max()) for n, a in leaves.items()}


def phase17_grads(mus: list, b1: float) -> list:
    """Each step's gradient, as numpy by name, from Adam's first moments
    after each step: g = (mu - b1 mu') / (1 - b1)."""
    out, prev = [], None
    for mu in mus:
        out.append({n: ((m - (0.0 if prev is None else b1 * prev[n])) / (1 - b1)).numpy()
                    for n, m in mu.items()})
        prev = mu
    return out


def phase17_config(over: dict):
    cfg = train_config("float32", P17_TRAIN_BATCH)
    attn = over.get("attn_impl")
    if attn:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attn_impl=attn))
    if over.get("shard_opt_state"):
        cfg = dataclasses.replace(cfg, shard_opt_state=True)
    return cfg


def phase17_batch():
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator

    cfg = phase17_config({})
    ds = SyntheticPoseDataset(P17_TRAIN_BATCH, cfg.model.img_size, cfg.model.num_keypoints,
                              seed=0)
    return next(iter(batch_iterator(ds, P17_TRAIN_BATCH, num_workers=8)))


def phase17_rank(rank: int, world: int, work: Path) -> None:
    """One rank of 17b's world on cuda:(rank % device count): the world's
    backend follows parallel/distributed.py's rule (gloo where ranks share a
    card); the DDP, TP and ZeRO-1 steps and the data-parallel predictor;
    every rank writes its numbers and rank 0 each scenario's whole
    parameters and its first moments after each step."""
    import torch

    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(f"file://{work / 'rendezvous'}", world, rank, device="cuda")
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    mine = dict(rank=rank, world=world, backend=dist.get_backend(), device=str(dev),
                card=torch.cuda.get_device_name(dev))
    batch = phase17_batch()
    for name, mp, over, steps in phase17_scenarios():
        mesh = make_mesh(world, mp)
        trainer = Trainer.create(phase17_config(over), 1, mesh, device="cuda")
        peak_heatmap_branch(torch, trainer.model)
        db = trainer.device_batch(batch)
        losses, ms, mus = [], [], []
        reset_counts()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = trainer.train_step(trainer.state, db)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            params, mu = phase17_whole(trainer)
            mus.append(mu)
        mine[name] = dict(losses=losses, ms=ms, attn_impl=trainer.cfg.model.attn_impl,
                          counts=read_counts(), split=len(trainer.model.tp_splits))
        if rank == 0:
            torch.save(dict(params=params, mus=mus), work / f"{name}.pt")
        del trainer, db, params, mus
        torch.cuda.empty_cache()
    cfg = phase17_config({})
    model = build_model(cfg.model, device=dev, seed=0)
    peak_heatmap_branch(torch, model)
    pred = TopDownPredictor(model, make_codec(cfg.model), cfg.model.img_size,
                            return_heatmaps=True, mesh=make_mesh(world, 1))
    frames, boxes = request(171, P17_SERVE_BATCH)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pred(frames, boxes)
    mine["predict"] = dict(ms=(time.perf_counter() - t0) * 1e3, counts=read_counts())
    np.savez(work / f"predict{rank}.npz", **out)
    (work / f"rank{rank}.json").write_text(json.dumps(mine))
    dist.barrier()
    dist.destroy_process_group()


def compare_world_state(torch, phase: int, name: str, ref: list, got: dict, b1: float,
                        steps: int) -> None:
    """A world's whole state after its steps (`got`: rank 0's parameters
    and Adam's first moments after each step, by the per-block names)
    against one process's (`ref`: per step, loss, parameters, first
    moments, learning rate) at phase 17's gates (see P17_*)."""
    ratios, normwise = {}, {}
    for k, (st, mu_got) in enumerate(zip(ref, got["mus"])):
        tols = phase17_tolerances(st["mu"])
        top = max(float(m.abs().max()) for m in st["mu"].values())
        for n, m in st["mu"].items():
            if n.startswith(P17_ROUTED) and float(m.abs().max()) >= P17_NOISE * top:
                if k == 0:  # later steps start from parameters Adam's bound lets differ
                    normwise[n] = float((mu_got[n] - m).norm() / m.norm())
            else:
                ratios[n] = max(ratios.get(n, 0.0),
                                float((mu_got[n] - m).abs().max()) / tols[n])
    worst = sorted(ratios, key=ratios.get)[-3:][::-1]
    worst_routed = sorted(normwise, key=normwise.get)[-3:][::-1]
    say(f"phase {phase}: {name}: Adam's mu after each of {steps} step(s), the worst leaves "
        + ", ".join(f"{n} {ratios[n]:.3e}" for n in worst)
        + f" of their tolerance ({P17_MU_RTOL:g} of the leaf's largest entry, or "
        f"{P17_NOISE:g} of the largest anywhere); the scalar branches' after the first "
        + ", ".join(f"{n} {normwise[n]:.3e}" for n in worst_routed)
        + f" normwise (tolerance {P17_ROUTED_RTOL:g})")
    check(ratios[worst[0]] <= 1.0 and normwise[worst_routed[0]] <= P17_ROUTED_RTOL,
          f"phase {phase}: {name}'s first moments differ")
    # where a step's gradient took another sign, or lay within
    # P17_FLIP_RTOL of zero, Adam's update may differ by 2 lr
    flips = {}
    for g_ref, g_got in zip(phase17_grads([st["mu"] for st in ref], b1),
                            phase17_grads(got["mus"], b1)):
        for n, tol in phase17_tolerances(g_ref, P17_FLIP_RTOL).items():
            flips[n] = (flips.get(n, False) | (np.abs(g_ref[n]) <= tol)
                        | (np.sign(g_ref[n]) != np.sign(g_got[n])) | n.startswith(P17_ROUTED))
    bound = 2 * sum(st["lr"] for st in ref) + P17_PARAM_ATOL
    worst = worst_flip = 0.0
    for n, p in ref[-1]["params"].items():
        d = (got["params"][n] - p).abs().numpy()
        worst = max(worst, float(d[~flips[n]].max(initial=0.0)))
        worst_flip = max(worst_flip, float(d[flips[n]].max(initial=0.0)))
    n_flip = sum(int(m.sum()) for m in flips.values())
    n_all = sum(m.size for m in flips.values())
    say(f"phase {phase}: {name}: parameters after {steps} step(s) max abs diff {worst:.3e} "
        f"(bound {P17_PARAM_ATOL:g}); {n_flip} of {n_all} elements in the scalar branches "
        f"or where a gradient took another sign or lay near zero {worst_flip:.3e} "
        f"(bound {bound:.3e})")
    check(worst <= P17_PARAM_ATOL and worst_flip <= bound,
          f"phase {phase}: {name}'s parameters differ by {worst} ({worst_flip} where Adam's "
          "update may take the other sign)")


def phase17_world(torch, dev, card: str) -> tuple[dict, dict]:
    """17b: P17_WORLD ranks spawned from this script, each on
    cuda:(rank % device count), held against the single process on the
    same card (f32, TF32 off): the DDP (data = 2) and TP (model = 2,
    "fused_tp") steps and two ZeRO-1 steps at the global batch (the loss,
    Adam's first moment, the parameters), and the data-parallel predictor.
    Returns (rank 0's launches by run, the single process's states after
    each step by attn_impl: phase 18 holds its worlds to them too)."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    work = RUN_DIR / "phase17"
    work.mkdir(parents=True, exist_ok=True)
    # The single process's steps and predictor first, then the world (both
    # on one card at once would hold three f32 batches of 256).
    batch = phase17_batch()
    steps_of = {}  # one process per attention, as many steps as its scenarios take
    for _, _, over, steps in phase17_scenarios():
        attn = over.get("attn_impl")
        steps_of[attn] = max(steps_of.get(attn, 0), steps)
    runs = {}  # the state after each step
    for attn, steps in steps_of.items():
        trainer = Trainer.create(phase17_config(dict(attn_impl=attn)), 1, device=dev)
        peak_heatmap_branch(torch, trainer.model)
        db = trainer.device_batch(batch)
        schedule = getattr(trainer.tx, "inner", trainer.tx).schedule
        runs[attn] = []
        for i in range(steps):
            loss = float(trainer.train_step(trainer.state, db)[1]["loss"])
            params, mu = phase17_whole(trainer)
            runs[attn].append(dict(loss=loss, params=params, mu=mu,
                                   lr=float(schedule(torch.tensor(i, device=dev)))))
        del trainer, db
    cfg = phase17_config({})
    b1 = cfg.optim.b1
    model = build_model(cfg.model, device=dev, seed=0)
    peak_heatmap_branch(torch, model)
    codec = make_codec(cfg.model)
    frames, boxes = request(171, P17_SERVE_BATCH)
    ref_pred = TopDownPredictor(model, codec, cfg.model.img_size, return_heatmaps=True)(
        frames, boxes)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    logs = [open(work / f"log{r}.txt", "w+") for r in range(P17_WORLD)]
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--phase17-rank",
                               str(r), str(P17_WORLD), str(work)],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(P17_WORLD)]
    deadline = time.monotonic() + P17_DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            say(f"phase 17: rank {r} log:\n{text[-6000:]}")
        check(p.returncode == 0, f"phase 17: rank {r} failed (exit {p.returncode})")
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(P17_WORLD)]
    say(f"phase 17 [{card}]: world of {P17_WORLD}, backend {ranks[0]['backend']}, cards "
        + ", ".join(f"rank {r['rank']} {r['device']} ({r['card']})" for r in ranks))
    expect = "nccl" if torch.cuda.device_count() >= P17_WORLD else "gloo"
    check(ranks[0]["backend"] == expect, f"backend {ranks[0]['backend']}, the rule says {expect}")
    launches = {}
    for name, mp, over, steps in phase17_scenarios():
        ref = runs[over.get("attn_impl")][:steps]
        losses = [st["loss"] for st in ref]
        got = torch.load(work / f"{name}.pt", weights_only=True)
        for r in ranks:
            say(f"phase 17: {name} rank {r['rank']}: losses {r[name]['losses']} against one "
                f"process's {losses}, step ms {[round(t, 1) for t in r[name]['ms']]}, "
                f"attention {r[name]['attn_impl']}, {r[name]['split']} split leaves")
            check(np.allclose(r[name]["losses"], losses, rtol=P17_LOSS_RTOL, atol=0),
                  f"phase 17: {name} rank {r['rank']}'s loss differs")
        compare_world_state(torch, 17, name, ref, got, b1, steps)
        launches[f"17b {name} rank 0"] = ranks[0][name]["counts"]
    check(ranks[0]["tp"]["attn_impl"] == "fused_tp" and ranks[0]["tp"]["split"] == 72,
          "phase 17: the TP step did not split the 12 blocks' six Megatron leaves")
    tp = ranks[0]["tp"]["counts"]
    tp_steps = next(n for name, _, _, n in phase17_scenarios() if name == "tp")
    check(tp["k1f"] == tp["k1b"] == 12 * tp_steps,
          "phase 17: the f32 TP step did not run K1 head-major once per block each way")
    sel = well_defined(torch, codec, ref_pred["heatmaps"], dev)
    for r in ranks:
        got = dict(np.load(work / f"predict{r['rank']}.npz"))
        kerr = float(np.abs(got["keypoints"] - ref_pred["keypoints"])[sel].max(initial=0.0))
        perr = float(np.abs(got["probabilities"] - ref_pred["probabilities"]).max())
        say(f"phase 17: data-parallel predictor rank {r['rank']}, B={P17_SERVE_BATCH}: "
            f"{r['predict']['ms']:.1f} ms; keypoint max diff {kerr:.3e} px over "
            f"{int(sel.sum())} well-defined (tolerance {KPT_TOL_PX:g}), probability "
            f"{perr:.3e} ({PROB_TOL:g})")
        check(kerr <= KPT_TOL_PX and perr <= PROB_TOL,
              f"phase 17: rank {r['rank']}'s predictions differ")
    launches["17b predict rank 0"] = ranks[0]["predict"]["counts"]
    return launches, runs


def phase17(torch, dev, card: str, g) -> tuple[dict, dict, dict]:
    """Phase 17: the head-major layout on one card (17a), then a two-rank
    world (17b). Returns (launches by run, head-major kernel numbers, the
    single process's f32 states by attn_impl)."""
    t_phase = time.perf_counter()
    launches, numbers = phase17_flagship(torch, dev, card, g)
    gc.collect()
    torch.cuda.empty_cache()
    t_world = time.perf_counter()
    world, runs = phase17_world(torch, dev, card)
    launches.update(world)
    say(f"phase 17: 17b in {time.perf_counter() - t_world:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    return launches, numbers, runs


# ------------------------------------------------------------------ phase 18

P18_SERVE_BATCH = 256
P18_TRAIN_BATCH = 256
# The pipe 2 x model 2 step takes the first 128 rows of the flagship's
# batch: gloo moves its Megatron all-reduces through host memory, four
# ranks on one card (256 rows cost 18-30 s a step there, and the world of 4
# shares the card with the world of 2).
P18_TP_BATCH = 128
P18_VITL_BATCH = 32
P18_DEADLINE_S = 420
# The 1F1B step's microbatch count: JAX's automatic one at the flagship's
# 256 rows on pipe = 2 (the largest divisor <= 4 S).
P18_MICROBATCHES = 8


def phase18_config(dtype: str, batch: int, **over):
    """The flagship TrainConfig (train_config) with TrainConfig and model
    overrides."""
    cfg = train_config(dtype, batch)
    model = {k: over.pop(k) for k in list(over) if hasattr(cfg.model, k)}
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model), **over)


def phase18_vitl_config():
    """configs/vitl_coco.json as shipped (ViT-L, bf16, remat, its four
    micro-steps an update) at B = P18_VITL_BATCH, augmentation off."""
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig.load(REPO / "configs/vitl_coco.json")
    return dataclasses.replace(cfg, augment=None, train_batch_size=P18_VITL_BATCH,
                               resume=False, **fit_outputs("vitl18"))


def phase18_whole(trainer) -> tuple[dict, dict]:
    """phase17_whole by the per-block names (a pipelined trainer's stacked
    leaves unstacked, compat/layouts.py)."""
    from probpose_pytorch_tpu_torch.compat.layouts import unstack_state_dict

    params, mu = phase17_whole(trainer)
    return unstack_state_dict(params), unstack_state_dict(mu)


def phase18_microbatched_step(torch, trainer, batch, M: int) -> float:
    """One process's step over M microbatches in turn (JAX's
    test_full_step_matches_microbatched_sequential): per microbatch, the
    model in train mode from the step's BatchNorm statistics, its loss and
    gradients, each 1/M of the step's; the running statistics the
    microbatches' mean; then the update. Returns the loss."""
    from probpose_pytorch_tpu_torch.train.loop import _augment_encode, _total

    cfg, model, state = trainer.cfg, trainer.model, trainer.state
    images, gt = _augment_encode(cfg, trainer.encode_codec, batch)
    model.train()
    bns = [m for m in model.head.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    start = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    weights = cfg.loss_weights.as_dict()
    grads = [torch.zeros_like(p) for p in state.params]
    stats = [torch.zeros_like(t) for pair in start for t in pair]
    loss = 0.0
    mb = images.shape[0] // M
    for j in range(M):
        sl = slice(j * mb, (j + 1) * mb)
        with torch.no_grad():
            for bn, (mean, var) in zip(bns, start):
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
        pred = model(images[sl])
        total = _total(trainer.loss_fn({k: v[sl] for k, v in gt.items()}, pred,
                                       learn_heatmaps_from_zeros=cfg.learn_heatmaps_from_zeros),
                       weights)
        got = torch.autograd.grad(total, state.params, allow_unused=True)
        for acc, g in zip(grads, got):
            if g is not None:
                acc += g / M
        for acc, t in zip(stats, [t for bn in bns for t in (bn.running_mean, bn.running_var)]):
            acc += t / M
        loss += float(total.detach()) / M
    with torch.no_grad():
        for i, bn in enumerate(bns):
            bn.running_mean.copy_(stats[2 * i])
            bn.running_var.copy_(stats[2 * i + 1])
    state.apply_gradients(grads, trainer.tx, ema_decay=cfg.optim.ema_decay)
    return loss


def phase18_scenarios(world: int):
    """(name, model axis, global batch, config overrides) of the f32 steps
    a world of `world` ranks takes on pipe = 2 (the 1F1B one with the fused
    MLP, so that K5 runs in the stages)."""
    if world == 2:
        return (("gpipe", 1, P18_TRAIN_BATCH, {}),
                ("1f1b", 1, P18_TRAIN_BATCH,
                 dict(pipeline_schedule="1f1b", mlp_impl="fused")))
    return (("pipe x model", 2, P18_TP_BATCH, dict(attn_impl="fused_tp")),)


def phase18_batch(rows: int) -> dict:
    """The first `rows` rows of the flagship's batch (phase17_batch)."""
    return {k: v[:rows] for k, v in phase17_batch().items()}


def phase18_step(torch, trainer, db) -> tuple[float, float, dict]:
    """(loss, ms, launches) of one step of the trainer."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = trainer.train_step(trainer.state, db)
    loss = float(m["loss"])
    return loss, (time.perf_counter() - t0) * 1e3, read_counts()


def phase18_rank(rank: int, world: int, work: Path) -> None:
    """One rank of phase 18's worlds on cuda:(rank % device count), gloo
    where ranks share a card (the pipe's sends staged through host
    memory). A world of 2 (pipe = 2): 18a, the bf16 flagship served through
    the GPipe forward; 18b, the f32 GPipe step and the 1F1B step with the
    fused MLP (K5 in the stages); 18c, configs/vitl_coco.json stepped with
    GPipe, then 1F1B, each rank's step ms and peak memory. A world of 4: the
    f32 pipe 2 x model 2 "fused_tp" step. Rank 0 writes each f32 step's
    whole state; every rank its numbers."""
    import torch

    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from probpose_pytorch_tpu_torch.train.loop import Trainer, make_train_step_1f1b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(f"file://{work / 'rendezvous'}", world, rank, device="cuda")
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    mine = dict(rank=rank, world=world, backend=dist.get_backend(), device=str(dev))
    if world == 2:
        mesh = make_mesh(world, 1, pipeline_parallel=2)
        cfg = phase18_config("bfloat16", P18_SERVE_BATCH)
        model = build_model(cfg.model, device=dev, seed=0)
        peak_heatmap_branch(torch, model)
        pred = TopDownPredictor(model, make_codec(cfg.model), cfg.model.img_size,
                                return_heatmaps=True, mesh=mesh)
        frames, boxes = request(180, P18_SERVE_BATCH)
        pred(frames, boxes)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred(frames, boxes)
        mine["serve"] = dict(ms=(time.perf_counter() - t0) * 1e3, counts=read_counts(),
                             stage_blocks=int(pred.model.backbone.blocks.qkv_kernel.shape[0]))
        np.savez(work / f"serve{rank}.npz", **out)
        del model, pred, out
    else:
        mesh = make_mesh(world, 2, pipeline_parallel=2)
    for name, mp, rows, over in phase18_scenarios(world):
        trainer = Trainer.create(phase18_config("float32", rows, **over), 1, mesh,
                                 device="cuda")
        peak_heatmap_branch(torch, trainer.model)
        loss, ms, counts = phase18_step(torch, trainer, trainer.device_batch(phase18_batch(rows)))
        params, mu = phase18_whole(trainer)
        mine[name] = dict(losses=[loss], ms=[ms], counts=counts,
                          attn_impl=trainer.cfg.model.attn_impl,
                          pp_stages=trainer.cfg.model.pp_stages,
                          split=len(trainer.model.tp_splits), staged=len(trainer.model.pp_splits))
        if rank == 0:
            torch.save(dict(params=params, mus=[mu]), work / f"{name}.pt")
        del trainer, params, mu
        torch.cuda.empty_cache()
    if world == 2:
        cfg = phase18_vitl_config()
        trainer = Trainer.create(cfg, 1, mesh, device="cuda")
        ds_batch = phase18_vitl_batch()
        db = trainer.device_batch(ds_batch)
        for label in ("gpipe", "1f1b"):
            if label == "1f1b":
                trainer.train_step = make_train_step_1f1b(
                    trainer.model, trainer.encode_codec, trainer.loss_fn, trainer.tx, cfg, mesh)
            phase18_step(torch, trainer, db)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss, ms, counts = phase18_step(torch, trainer, db)
            mine[f"vitl {label}"] = dict(losses=[loss], ms=[ms], counts=counts,
                                         peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        del trainer, db
    (work / f"rank{rank}.json").write_text(json.dumps(mine))
    dist.barrier()
    dist.destroy_process_group()


def phase18_vitl_batch():
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator

    cfg = phase18_vitl_config()
    ds = SyntheticPoseDataset(P18_VITL_BATCH, cfg.model.img_size, cfg.model.num_keypoints,
                              seed=3)
    return next(iter(batch_iterator(ds, P18_VITL_BATCH, num_workers=8)))


# The rank processes phase 18 started, which main() kills if a phase fails
# before phase 18 waits for them.
STARTED: list = []


def phase18_start(world: int, work: Path) -> tuple:
    """Start a world of `world` ranks of this script on phase 18's work;
    phase18_end takes what this returns."""
    logs = [open(work / f"log{world}_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--phase18-rank",
                               str(r), str(world), str(work / f"w{world}")],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(world)]
    STARTED.extend(procs)
    return world, work, procs, logs, time.monotonic() + P18_DEADLINE_S


def phase18_begin() -> list[tuple]:
    """Start phase 18's worlds (4 ranks, then 2) in RUN_DIR; phase18 waits
    for them. run() starts them before phase 15: phases 15 and 16 are
    host-bound (exports, fresh processes, CPU comparisons), so the worlds
    share the card with them rather than lengthen the run."""
    work = RUN_DIR / "phase18"
    for w in (2, 4):
        (work / f"w{w}").mkdir(parents=True, exist_ok=True)
    return [phase18_start(4, work), phase18_start(2, work)]


def phase18_end(handle: tuple) -> tuple:
    """Wait for a world's ranks until its deadline, kill what is left;
    (the handle, each rank's exit code and output)."""
    world, work, procs, logs, deadline = handle
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    return handle, [p.returncode for p in procs], texts


def phase18_ranks(ended: tuple) -> list[dict]:
    """Each rank's numbers of an ended world; a rank that failed fails the
    phase (its log printed)."""
    (world, work, *_), codes, texts = ended
    for r, (code, text) in enumerate(zip(codes, texts)):
        if code != 0:
            say(f"phase 18: rank {r} of {world} log:\n{text[-6000:]}")
        check(code == 0, f"phase 18: rank {r} of {world} failed (exit {code})")
    return [json.loads((work / f"w{world}" / f"rank{r}.json").read_text())
            for r in range(world)]


def phase18(torch, dev, card: str, refs17: dict | None = None,
            worlds: list[tuple] | None = None) -> dict:
    """Phase 18: pipeline parallelism on the card. A world of 4 ranks (pipe
    2 x model 2) and one of 2 (pipe 2), spawned from this script
    (phase18_rank; `worlds` from phase18_begin, started here when None),
    waited for first; then one process's timed references, alone on the
    card (the bf16 flagship served; ViT-L's step ms and peak memory), and
    its untimed ones (the f32 GPipe step is phase 17's single-process step,
    `refs17`, made here when None; the fused-MLP step over microbatches in
    turn for 1F1B; the fused_tp step at P18_TP_BATCH rows). Returns the
    launches by run."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    work = RUN_DIR / "phase18"
    ended = [phase18_end(w) for w in (worlds or phase18_begin())]
    t_worlds = time.perf_counter() - t_phase
    cfg = phase18_config("bfloat16", P18_SERVE_BATCH)
    model = build_model(cfg.model, device=dev, seed=0)
    peak_heatmap_branch(torch, model)
    codec = make_codec(cfg.model)
    frames, boxes = request(180, P18_SERVE_BATCH)
    pred = TopDownPredictor(model, codec, cfg.model.img_size, return_heatmaps=True)
    pred(frames, boxes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_serve = pred(frames, boxes)
    serve_ms = (time.perf_counter() - t0) * 1e3
    del model, pred
    trainer = Trainer.create(phase18_vitl_config(), 1, device=dev)
    db = trainer.device_batch(phase18_vitl_batch())
    phase18_step(torch, trainer, db)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vitl_loss, vitl_ms, _ = phase18_step(torch, trainer, db)
    vitl_peak = torch.cuda.max_memory_allocated() / 2**20
    del trainer, db
    gc.collect()
    torch.cuda.empty_cache()
    refs = {}
    for name, _, rows, over in phase18_scenarios(2) + phase18_scenarios(4):
        if refs17 is not None and name == "gpipe":
            refs[name] = refs17[None][:1]
            continue
        trainer = Trainer.create(phase18_config("float32", rows, **over), 1, device=dev)
        peak_heatmap_branch(torch, trainer.model)
        db = trainer.device_batch(phase18_batch(rows))
        schedule = getattr(trainer.tx, "inner", trainer.tx).schedule
        if name == "1f1b":
            loss = phase18_microbatched_step(torch, trainer, db, P18_MICROBATCHES)
        else:
            loss = float(trainer.train_step(trainer.state, db)[1]["loss"])
        params, mu = phase17_whole(trainer)
        refs[name] = [dict(loss=loss, params=params, mu=mu,
                           lr=float(schedule(torch.tensor(0, device=dev))))]
        del trainer, db
    gc.collect()
    torch.cuda.empty_cache()
    ranks4, ranks2 = (phase18_ranks(e) for e in ended)
    b1 = train_config("float32", P18_TRAIN_BATCH).optim.b1

    launches = {}
    say(f"phase 18 [{card}]: worlds of 4 and 2 ranks, backend {ranks2[0]['backend']}, "
        f"cards {sorted({r['device'] for r in ranks4 + ranks2})}")

    # 18a: the bf16 flagship served through the GPipe forward
    sel = well_defined(torch, codec, ref_serve["heatmaps"], dev)
    bound = 2 * 2**-8 * max(1.0, float(np.abs(ref_serve["heatmaps"]).max()))
    for r in ranks2:
        got = dict(np.load(work / "w2" / f"serve{r['rank']}.npz"))
        herr = float(np.abs(got["heatmaps"] - ref_serve["heatmaps"]).max())
        kerr = float(np.abs(got["keypoints"] - ref_serve["keypoints"])[sel].max(initial=0.0))
        c = r["serve"]["counts"]
        say(f"phase 18: 18a GPipe serving B={P18_SERVE_BATCH} bf16 on pipe = 2, rank "
            f"{r['rank']} ({r['serve']['stage_blocks']} blocks): {r['serve']['ms']:.1f} ms "
            f"against one process's {serve_ms:.1f} ms; K1 short forward {c['k1s']} (expect "
            f"{r['serve']['stage_blocks']} x 4 microbatches = {r['serve']['stage_blocks'] * 4}), "
            f"K2 {c['k2']}; heatmaps max abs diff {herr:.3e} (K1's bf16 bound {bound:.3e}), "
            f"keypoints {kerr:.3e} px over {int(sel.sum())} well-defined (tolerance "
            f"{KPT_TOL_PX:g})")
        check(r["serve"]["stage_blocks"] == 6, "phase 18: a stage does not hold 6 blocks")
        check(c["k1s"] == 24 and c["k2"] == 1 and c["k1f"] == 0,
              "phase 18: the GPipe forward did not run K1 per block per microbatch")
        check(herr <= bound and kerr <= KPT_TOL_PX,
              f"phase 18: rank {r['rank']}'s served outputs differ")
        launches[f"18a serving rank {r['rank']}"] = c

    # 18b: the f32 steps against one process
    for ranks, world in ((ranks2, 2), (ranks4, 4)):
        for name, _, _, _ in phase18_scenarios(world):
            ref = refs[name]
            for r in ranks:
                got_r = r[name]
                say(f"phase 18: 18b {name} f32 step, world {world} rank {r['rank']}: loss "
                    f"{got_r['losses']} against one process's {ref[0]['loss']!r}, "
                    f"{got_r['ms'][0]:.1f} ms, attention {got_r['attn_impl']}, pp_stages "
                    f"{got_r['pp_stages']}, {got_r['staged']} staged and {got_r['split']} "
                    f"model-split leaves; K1 forward {got_r['counts']['k1f']}, backward "
                    f"{got_r['counts']['k1b']}, K5 forward {got_r['counts']['k5f']}, backward "
                    f"{got_r['counts']['k5b']}, K2 {got_r['counts']['k2']}")
                check(np.allclose(got_r["losses"], [ref[0]["loss"]], rtol=P17_LOSS_RTOL, atol=0),
                      f"phase 18: {name} rank {r['rank']}'s loss differs")
                check(got_r["pp_stages"] == 2 and got_r["staged"] == 12,
                      f"phase 18: {name} did not stage the 12 stacked leaves")
            got = torch.load(work / f"w{world}" / f"{name}.pt", weights_only=True)
            compare_world_state(torch, 18, name, ref, got, b1, 1)
            launches[f"18b {name} rank 0"] = ranks[0][name]["counts"]
    c = ranks2[0]["gpipe"]["counts"]
    check(c["k1f"] == c["k1b"] == 6 * 4, "phase 18: the f32 GPipe step did not run K1 each way "
          "per block per microbatch")
    # 1F1B: a forward slot and a recompute a block a microbatch on stage 0,
    # one forward on the last stage; one backward a block a microbatch
    for r in ranks2:
        c, slots = r["1f1b"]["counts"], 6 * P18_MICROBATCHES
        fwd = slots if r["rank"] == 1 else 2 * slots
        check(c["k1f"] == c["k5f"] == fwd and c["k1b"] == c["k5b"] == slots,
              f"phase 18: the 1F1B stage of rank {r['rank']} did not run K1 and K5 once a "
              "block a slot")
    c = ranks4[0]["pipe x model"]["counts"]
    check(ranks4[0]["pipe x model"]["attn_impl"] == "fused_tp" and c["k1f"] == c["k1b"] == 24,
          "phase 18: the pipe x model step did not run K1 head-major in its stage")

    # 18c: ViT-L, the model pipelining is for (remat: GPipe 4 microbatches
    # of 8, 1F1B 8 of 4; each block's forward once more under remat)
    for r in ranks2:
        for label, fwd, bwd in (("gpipe", 2 * 12 * 4, 12 * 4), ("1f1b", 3 * 12 * 8, 12 * 8)):
            v = r[f"vitl {label}"]
            fwd_r = fwd if r["rank"] == 0 or label == "gpipe" else 2 * 12 * 8
            say(f"phase 18 [{card}]: 18c ViT-L (configs/vitl_coco.json, bf16, remat, B="
                f"{P18_VITL_BATCH}) {label} on pipe = 2, rank {r['rank']}: step "
                f"{v['ms'][0]:.1f} ms, peak {v['peak_mib']:.1f} MiB, loss {v['losses'][0]:.6f}; "
                f"one process: {vitl_ms:.1f} ms, peak {vitl_peak:.1f} MiB; K1 short forward "
                f"{v['counts']['k1s']} (expect {fwd_r}), backward {v['counts']['k4b']} "
                f"(expect {bwd})")
            check(np.isfinite(v["losses"][0]), f"phase 18: ViT-L {label} loss not finite")
            check(v["counts"]["k1s"] == fwd_r and v["counts"]["k4b"] == bwd
                  and v["counts"]["k4b_recomputes"] == 0,
                  f"phase 18: ViT-L {label} did not run K1 once a block a slot")
    launches["18c vitl gpipe rank 0"] = ranks2[0]["vitl gpipe"]["counts"]
    launches["18c vitl 1f1b rank 0"] = ranks2[0]["vitl 1f1b"]["counts"]
    say(f"phase 18: {time.perf_counter() - t_phase:.1f} s in all ({t_worlds:.1f} s waiting "
        "for the worlds)")
    return launches


# --------------------------------------------------------------- phase 19

P19_WIDTHS = (16, 48, 96, 112, 160, 256)
# bf16 takes the wgmma kernels at every multiple of 8 from 16 to 256; its
# CUDA-core widths here are none.
P19_BF16_WIDTHS = (20, 44, 100, 108, 156, 252)
# Tokens past K1's shared memory at every width of P19_WIDTHS and
# P19_BF16_WIDTHS (bf16 d = 16 fits K1 up to N = 2,319, f32 d = 16 up to
# 1,414).
P19_N = {"bfloat16": 2400, "float32": 1500}
P19_MLP = ((64, 128), (200, 600), (576, 2304), (1536, 6144))
# bf16 takes the wgmma kernels at every multiple of 8 since phase 21's
# redesign: its CUDA-core widths here are P19_MLP's plus 4, no multiples of 8.
P19_MLP_BF16 = tuple((C + 4, Hd + 4) for C, Hd in P19_MLP)
P19_MLP_ROWS = 2 * 192 + 9
P19_BATCH = 70000  # past the grid's 65,535
P19_STEPS = 3
# vit-h's 32 blocks cut to 4 (a run-time preset, as depth 2 and the 768 x
# 768 depth are) for the smoke's time; phase 20 runs ViT-g at full depth.
VITH_DEPTH = 4
VITH_TRAIN_BATCH = 32
VITH_TRAIN_STEPS = 5
VITH_F32_DEPTH = 2
VITH_F32_BATCH = 8
VITH_768_DEPTH = 4  # the 768 x 768 model's blocks: its build draws every weight on the host
VITH_768_BATCH = 4
VITH_HEADS, VITH_D = 16, 80
# The d = 80 wgmma shapes: vit-h served at 256 x 192 (N = 192) and at 768 x
# 768 (N = 2304).
P19_D80_SHAPES = ((64, 192), (8, 2304))


def vith_config(dtype: str, batch: int, backbone: str = "vit-h", img_size=None):
    """configs/vitb_coco.json (remat on, augmentation off) with the vit-h
    trunk and its dense MLP, attn_impl="fused", at `dtype` and `batch`;
    `img_size` replaces the crop (768 x 768 for the long-sequence path)."""
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig.load(REPO / "configs/vitb_coco.json")
    model = dataclasses.replace(cfg.model, backbone=backbone, compute_dtype=dtype,
                                attn_impl="fused", mlp_impl="dense",
                                img_size=img_size or cfg.model.img_size)
    return dataclasses.replace(cfg, augment=None, train_batch_size=batch, log_every=1,
                               resume=False, model=model, **fit_outputs(backbone))


def cuda_core_attention(torch, qkv, heads: int, kind: str, dout=None):
    """One launch of a CUDA-core attention kernel the route no longer gives
    bf16 d = 80 (K1's csrc/packed_attention.cu, "k1", or K4's
    csrc/tiled_attention.cu, "k4"): the context, or dqkv with `dout`. The
    yardstick the d = 80 wgmma kernels replace; timed, never on a path."""
    from probpose_pytorch_tpu_torch.ops.kernels import attention, attention_tiled

    B, N, C3 = qkv.shape
    dev, s = qkv.device.index or 0, torch.cuda.current_stream().cuda_stream
    code = attention_tiled.DTYPES[qkv.dtype]
    lib = attention._lib() if kind == "k1" else attention_tiled._lib()
    if dout is None:
        out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
        fn = lib.packed_attention_fwd if kind == "k1" else lib.tiled_attention_fwd
        err = fn(qkv.data_ptr(), out.data_ptr(), B, N, C3 // 3, heads, 0, code, dev, s)
    else:
        out = torch.empty_like(qkv)
        stats = torch.empty((3, B, heads, N), dtype=torch.float32, device=qkv.device)
        fn = lib.packed_attention_bwd if kind == "k1" else lib.tiled_attention_bwd
        err = fn(qkv.data_ptr(), dout.data_ptr(), out.data_ptr(), stats.data_ptr(), B, N,
                 C3 // 3, heads, 0, code, dev, s)
    check(err == 0, f"the {kind} CUDA-core kernel failed with cudaError {err}")
    return out


def cuda_core_mlp(torch, a, dout=None, exact: bool = False):
    """One call of K5's CUDA-core kernels (csrc/fused_mlp.cu) on K5's
    arguments `a`, whatever `mlp_route` gives the shape: the output, or the
    seven cotangents with `dout`. The yardstick the bf16 wgmma kernels
    replace at widths past the four presets; timed, never on a path."""
    from probpose_pytorch_tpu_torch.ops.kernels import mlp

    x = a[0]
    R, C = x.shape
    Hd = a[3].shape[1]
    _, w1t, w2t, (sc, bi, c1, c2), device = mlp._kernel_args(*a)
    lib, code = mlp._lib(), mlp._DTYPES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    if dout is None:
        out = torch.empty_like(x)
        err = lib.fused_mlp_cc_fwd(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), w1t.data_ptr(),
                                   c1.data_ptr(), w2t.data_ptr(), c2.data_ptr(), out.data_ptr(),
                                   R, C, Hd, int(exact), code, device, stream)
        check(err == 0, f"K5's CUDA-core forward failed with cudaError {err}")
        return out
    nbytes_ = mlp._cc_workspace_bytes(R, C, Hd)
    work = torch.empty(nbytes_, dtype=torch.uint8, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1t = torch.empty((Hd, C), dtype=x.dtype, device=x.device)
    dw2t = torch.empty((C, Hd), dtype=x.dtype, device=x.device)
    dscale, dbias, db2 = (torch.empty(C, **f32) for _ in range(3))
    db1 = torch.empty(Hd, **f32)
    ptrs = [t.data_ptr() for t in (x, sc, bi, w1t, c1, w2t, dout, dx, dscale, dbias, dw1t, db1,
                                   dw2t, db2, work)]
    err = lib.fused_mlp_cc_bwd(*ptrs, nbytes_, R, C, Hd, int(exact), code, device, stream)
    check(err == 0, f"K5's CUDA-core backward failed with cudaError {err}")
    return dx, dscale, dbias, dw1t.t(), db1, dw2t.t(), db2


def phase19_widths(torch, card: str, g) -> dict:
    """Fault 9: every P19_WIDTHS head width in f32 and every
    P19_BF16_WIDTHS one in bf16 (widths that are no multiple of 8) past
    K1's shared memory on K4's CUDA-core kernels, forward and backward
    against the plain versions (K1's bound), the backward twice bit for
    bit, one head-major case; then packed_attention timed at d = 48, N =
    1024 (bf16, the width a ViT with 48-wide heads gives; on the wgmma
    kernels since phase 20's redesign, its backward recomputing the
    forward), against the plain version and SDPA."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        kernel_path,
        packed_attention,
        packed_attention_backward,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        tiled_attention,
        tiled_attention_bwd_reference,
        tiled_attention_reference,
    )

    dev = torch.device("cuda")
    fwd_err = bwd_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        N = P19_N[name]
        for d in P19_BF16_WIDTHS if dtype == torch.bfloat16 else P19_WIDTHS:
            route = (kernel_path(N, d, dtype), kernel_path(N, d, dtype, backward=True))
            check(route == ("K4 CUDA cores",) * 2, f"d = {d} {name} routes to {route}")
            qkv = torch.randn(1, N, 6 * d, generator=g, device=dev).to(dtype)
            dout = torch.randn(1, N, 2 * d, generator=g, device=dev).to(dtype)
            label = f"K4 CUDA cores d = {d} qkv {tuple(qkv.shape)} {name}"
            fwd_err = max(fwd_err, gate(torch, f"{label} forward", packed_attention(qkv, 2),
                                        tiled_attention_reference(qkv, 2), phase=19))
            got = packed_attention_backward(qkv, dout, 2)
            check(torch.equal(got, packed_attention_backward(qkv, dout, 2)),
                  f"{label} backward differs between two runs")
            bwd_err = max(bwd_err, gate(torch, f"{label} backward", got,
                                        tiled_attention_bwd_reference(qkv, dout, 2), phase=19))
    # head-major (attn_impl="fused_tp"), d = 100 in bf16
    qkv = torch.randn(1, P19_N["bfloat16"], 6 * 100, generator=g, device=dev).to(torch.bfloat16)
    gate(torch, "K4 CUDA cores d = 100 head-major forward", tiled_attention(qkv, 2, "head_major"),
         tiled_attention_reference(qkv, 2, layout="head_major"), phase=19)
    # timed, not gated
    B, N, heads, d = 8, 1024, 8, 48
    qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(B, N, heads * d, generator=g, device=dev).to(torch.bfloat16)
    f_ms, f_plain = paired_ms(torch, lambda: packed_attention(qkv, heads),
                              lambda: tiled_attention_reference(qkv, heads), iters=5)
    b_ms, b_plain = paired_ms(torch, lambda: packed_attention_backward(qkv, dout, heads),
                              lambda: tiled_attention_bwd_reference(qkv, dout, heads), iters=3)
    f_lib = cuda_ms(torch, sdpa_fwd_fn(torch, qkv, heads), iters=10)
    b_lib = cuda_ms(torch, sdpa_bwd_fn(torch, qkv, dout, heads), iters=10)
    f_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * heads * d)
    b_bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * B * N * N * heads * d)
    say(f"phase 19 [{card}]: {kernel_path(N, d, torch.bfloat16)} qkv {tuple(qkv.shape)} bf16, "
        f"d = {d}: forward "
        f"{f_ms:.4f} ms (plain {f_plain:.4f}, SDPA {f_lib:.4f}, bound {f_bound[0]:.4f}), "
        f"backward {b_ms:.4f} ms (plain {b_plain:.4f}, SDPA {b_lib:.4f}, bound "
        f"{b_bound[0]:.4f})")
    shape = [B, N, 3 * heads * d]
    return dict(fwd=dict(err=fwd_err, ms=f_ms, plain_ms=f_plain, lib_ms=f_lib, bound=f_bound,
                         qkv=shape),
                bwd=dict(err=bwd_err, ms=b_ms, plain_ms=b_plain, lib_ms=b_lib, bound=b_bound,
                         qkv=shape))


def phase19_d80(torch, card: str, g) -> dict:
    """vit-h's attention (16 heads, d = 80) on the wgmma kernels at
    P19_D80_SHAPES: the short forward (N = 192) against the TPU-order plain
    version, the tiled forward (N = 2304) against the plain and
    kernel-order versions, the backward from the saved (out, lse) against
    both orders, each twice bit for bit; the short forward head-major too.
    Then, not gated, each against its plain version, SDPA and the
    CUDA-core kernel bf16 d = 80 ran before (K1's at N = 192, K4's at
    2304), in turns."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import kernel_path
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        short_attention_reference,
        short_forward,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_online_bwd_reference,
        tiled_attention_online_reference,
        tiled_attention_reference,
        tiled_forward,
    )

    dev = torch.device("cuda")
    heads, C = VITH_HEADS, VITH_HEADS * VITH_D
    out_rows = {}
    for B, N in P19_D80_SHAPES:
        short = N <= 256
        route = kernel_path(N, VITH_D, torch.bfloat16)
        check(route == ("sm90 short" if short else "sm90 tiled"), f"d = 80, N = {N}: {route}")
        check(kernel_path(N, VITH_D, torch.bfloat16, backward=True) == "sm90 tiled",
              "the d = 80 backward is not on wgmma")
        qkv = torch.randn(B, N, 3 * C, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(B, N, C, generator=g, device=dev).to(torch.bfloat16)
        fwd = short_forward if short else tiled_forward
        out, lse = fwd(qkv, heads, True)
        again = fwd(qkv, heads, True)
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"d = 80 forward at N = {N} differs between two runs")
        label = f"d = 80 {route} qkv {tuple(qkv.shape)} bf16"
        if short:
            ref, lse_ref = short_attention_reference(qkv, heads)
            f_err = gate(torch, f"{label} forward", out, ref, phase=19)
            hm = qkv.unflatten(-1, (3, heads, VITH_D)).transpose(2, 3).reshape(qkv.shape)
            gate(torch, f"{label} forward, head-major, against qkv-major",
                 short_forward(hm, heads, False, "head_major")[0], out, phase=19,
                 bound=0.0)  # the same bits: only addresses move
        else:
            ref = tiled_attention_reference(qkv, heads)
            f_err = gate(torch, f"{label} forward", out, ref, phase=19)
            ref, lse_ref = tiled_attention_online_reference(qkv, heads)
            gate(torch, f"{label} forward vs the kernel-order plain version", out, ref,
                 phase=19)
        lse_err = (lse - lse_ref).abs().max().item()
        say(f"phase 19: {label}: lse max abs err {lse_err:.3e}")
        check(lse_err <= 1e-5 * max(1.0, lse_ref.abs().max().item()), "d = 80 lse off")
        got = tiled_attention_backward(qkv, dout, heads, out, lse)
        check(torch.equal(got, tiled_attention_backward(qkv, dout, heads, out, lse)),
              f"d = 80 backward at N = {N} differs between two runs")
        b_err = gate(torch, f"{label} backward", got,
                     tiled_attention_bwd_reference(qkv, dout, heads), phase=19)
        gate(torch, f"{label} backward vs the kernel-order plain version", got,
             tiled_attention_online_bwd_reference(qkv, dout, heads, out, lse), phase=19)
        # timed, not gated
        plain = short_attention_reference if short else tiled_attention_reference
        f_ms, f_plain = paired_ms(torch, lambda: fwd(qkv, heads, True),
                                  lambda: plain(qkv, heads), iters=10)
        b_ms, b_plain = paired_ms(torch, lambda: tiled_attention_backward(qkv, dout, heads,
                                                                          out, lse),
                                  lambda: tiled_attention_bwd_reference(qkv, dout, heads),
                                  iters=5)
        kind = "k1" if short else "k4"
        cc = cuda_core_attention(torch, qkv, heads, kind)
        gate(torch, f"{label}: the {kind} CUDA-core forward it replaces", cc,
             short_attention_reference(qkv, heads)[0] if short
             else tiled_attention_reference(qkv, heads), phase=19)
        f_cc, f_ms2 = paired_ms(torch, lambda: cuda_core_attention(torch, qkv, heads, kind),
                                lambda: fwd(qkv, heads, True), iters=10)
        b_cc, b_ms2 = paired_ms(torch, lambda: cuda_core_attention(torch, qkv, heads, kind,
                                                                    dout),
                                lambda: tiled_attention_backward(qkv, dout, heads, out, lse),
                                iters=5)
        f_ms_lib, f_lib = yardstick_ms(torch, lambda: fwd(qkv, heads, True),
                                       sdpa_fwd_fn(torch, qkv, heads), iters=20, windows=1)
        b_ms_lib, b_lib = yardstick_ms(torch, lambda: tiled_attention_backward(
            qkv, dout, heads, out, lse), sdpa_bwd_fn(torch, qkv, dout, heads), iters=10,
            windows=1)
        f_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * C)
        b_bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * B * N * N * C)
        say(f"phase 19 [{card}]: {label}: forward {f_ms:.4f} ms ({f_ms2:.4f} in turns with "
            f"the CUDA-core {f_cc:.4f}; {f_ms_lib:.4f} in turns with SDPA {f_lib:.4f}), plain "
            f"{f_plain:.4f}, bound {f_bound[0]:.4f} ({f_bound[1]}); backward {b_ms:.4f} ms "
            f"({b_ms2:.4f} with the CUDA-core {b_cc:.4f}; {b_ms_lib:.4f} with SDPA "
            f"{b_lib:.4f}), plain {b_plain:.4f}, bound {b_bound[0]:.4f} ({b_bound[1]})")
        key = "n192" if short else "n2304"
        out_rows[key] = dict(
            qkv=[B, N, 3 * C],
            fwd=dict(err=f_err, ms=f_ms, plain_ms=f_plain, lib_ms=f_lib, bound=f_bound,
                     cuda_core_ms=f_cc),
            bwd=dict(err=b_err, ms=b_ms, plain_ms=b_plain, lib_ms=b_lib, bound=b_bound,
                     cuda_core_ms=b_cc))
        del qkv, dout, out, lse, got, again, cc
    return out_rows


def phase19_mlp(torch, card: str, g) -> dict:
    """Fault 10: K5 on its CUDA-core kernels at P19_MLP's widths in f32 and
    P19_MLP_BF16's in bf16, forward against the plain version (K1's bound),
    the seven cotangents against the plain backward (phase 7's bound) and,
    in bf16, the kernel-order twin (two ulps), twice bit for bit."""
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
        fused_ln_mlp,
        fused_ln_mlp_backward,
        fused_ln_mlp_bwd_kernel_order_reference,
        fused_ln_mlp_bwd_reference,
        fused_ln_mlp_reference,
        mlp_route,
    )

    dev = torch.device("cuda")
    f_err = b_err = 0.0
    R = P19_MLP_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for C, Hd in P19_MLP if dtype == torch.float32 else P19_MLP_BF16:
            check(mlp_route(C, Hd, dtype) == "CUDA cores", f"K5 ({C}, {Hd}) {name} route")
            a = p19_mlp_args(torch, g, dev, R, C, Hd, dtype)
            label = f"K5 CUDA cores x ({R}, {C}) hidden {Hd} {name}"
            f_err = max(f_err, gate(torch, f"{label} forward", fused_ln_mlp(*a),
                                    fused_ln_mlp_reference(*a), phase=19))
            dout = torch.randn(R, C, generator=g, device=dev).to(dtype)
            grads = fused_ln_mlp_backward(*a, dout)
            again = fused_ln_mlp_backward(*a, dout)
            for gname, got, rerun, ref, twin in zip(
                    ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"), grads, again,
                    fused_ln_mlp_bwd_reference(*a, dout),
                    fused_ln_mlp_bwd_kernel_order_reference(*a, dout)):
                check(torch.equal(got, rerun), f"{label} {gname} differs between two runs")
                bound = k5_grad_bound(ref) if dtype == torch.bfloat16 else \
                    1e-4 * ref.float().abs().max().item()
                b_err = max(b_err, gate(torch, f"{label} backward {gname}", got, ref,
                                        phase=19, bound=bound))
                if dtype == torch.bfloat16:
                    gate(torch, f"{label} backward {gname} vs the kernel-order twin", got, twin,
                         phase=19, bound=2 * 2**-8 * twin.float().abs().max().item())
    return dict(f_err=f_err, b_err=b_err)


def p19_mlp_args(torch, g, dev, R: int, C: int, Hd: int, dtype):
    """K5's arguments at (R, C, Hd): x and the weights (fan-in scale, the
    transposed views a Linear gives) in `dtype`, the vectors f32."""
    x = torch.randn(R, C, generator=g, device=dev).to(dtype)
    w1 = (torch.randn(Hd, C, generator=g, device=dev) / C**0.5).to(dtype).t()
    w2 = (torch.randn(C, Hd, generator=g, device=dev) / Hd**0.5).to(dtype).t()
    vec = lambda n, s: s * torch.randn(n, generator=g, device=dev)
    return x, 1 + vec(C, 0.1), vec(C, 0.1), w1, vec(Hd, 0.1), w2, vec(C, 0.1)


def phase19_vit_nano(torch, dev, card: str) -> dict:
    """vit-nano with mlp_impl="fused" (C = 64, hidden 128: K5's wgmma kernels
    since phase 21's redesign, the CUDA cores before) served at
    REQUEST_SIZES and stepped P19_STEPS bf16 steps through
    Trainer.fit: 2 K5 forwards (and 2 short attention forwards) a forward,
    2 K5 forwards and 2 backwards a step; then K5 at its step's rows timed
    against the plain version and the dense half-block."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
        fused_ln_mlp,
        fused_ln_mlp_backward,
        fused_ln_mlp_bwd_reference,
        fused_ln_mlp_reference,
        mlp_route,
    )

    cfg = dataclasses.replace(train_config("bfloat16", 64), **fit_outputs("vit-nano"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone="vit-nano",
                                                             mlp_impl="fused"))
    check(mlp_route(64, 128, torch.bfloat16) == "sm90", "vit-nano's K5 route")
    model = build_model(cfg.model, device=dev, seed=0)
    depth = len(model.backbone.blocks)
    predictor = TopDownPredictor(model, make_codec(cfg.model), cfg.model.img_size)
    requests = [request(60 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    reset_counts()
    answers = [predictor(f, b) for f, b in requests]
    torch.cuda.synchronize()
    serve = read_counts()
    check_answers(cfg.model, requests, answers, phase=19)
    say(f"phase 19: vit-nano (fused MLP) over {len(requests)} forwards: K5 forward "
        f"{serve['k5f']} (expect {depth * len(requests)}), short attention forward "
        f"{serve['k1s']} (expect {depth * len(requests)}), K2 {serve['k2']}")
    check(serve["k5f"] == depth * len(requests), "vit-nano's K5 did not run once a block")
    check(serve["k1s"] == depth * len(requests) and serve["k2"] == len(requests),
          "vit-nano's attention or K2 count off")

    B = cfg.train_batch_size
    H, W = cfg.model.img_size
    ds = SyntheticPoseDataset(B, (H, W), cfg.model.num_keypoints, seed=2)
    batch = next(iter(batch_iterator(ds, B, num_workers=4)))
    trainer = make_trainer(torch, cfg, dev)
    reset_counts()
    trainer.fit(lambda: iter([batch]), max_steps=P19_STEPS)
    torch.cuda.synchronize()
    step = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 19: vit-nano (fused MLP), {P19_STEPS} bf16 steps at B={B}: loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; K5 forward {step['k5f']} (expect "
        f"{depth * P19_STEPS}), K5 backward {step['k5b']} (expect {depth * P19_STEPS})")
    check(len(losses) == P19_STEPS and all(np.isfinite(losses)), "vit-nano losses not finite")
    check(step["k5f"] == step["k5b"] == depth * P19_STEPS, "vit-nano's K5 step count off")

    # K5 at the step's rows, timed (not gated)
    g = torch.Generator(device=dev).manual_seed(19)
    rows = B * trainer.model.backbone.pos_embed.shape[1]
    a = mlp_inputs(torch, trainer.model.backbone.blocks[0], rows, g, dev)
    dout = torch.randn(rows, 64, generator=g, device=dev).to(torch.bfloat16)
    f_err = gate(torch, f"K5 sm90 vit-nano x ({rows}, 64) forward", fused_ln_mlp(*a),
                 fused_ln_mlp_reference(*a), phase=19)
    grads = fused_ln_mlp_backward(*a, dout)
    b_err = max(gate(torch, f"K5 sm90 vit-nano backward {n}", got, ref, phase=19,
                     bound=k5_grad_bound(ref))
                for n, got, ref in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"),
                                       grads, fused_ln_mlp_bwd_reference(*a, dout)))
    f_ms, f_plain = paired_ms(torch, lambda: fused_ln_mlp(*a),
                              lambda: fused_ln_mlp_reference(*a), iters=20)
    b_ms, b_plain = paired_ms(torch, lambda: fused_ln_mlp_backward(*a, dout),
                              lambda: fused_ln_mlp_bwd_reference(*a, dout), iters=10)
    f_lib = cuda_ms(torch, dense_fwd_fn(torch, a), iters=20)
    b_lib = cuda_ms(torch, dense_bwd_fn(torch, a, dout), iters=10)
    C, Hd = 64, 128
    f_bound = bound_ms(nbytes(*a, a[0]), 4 * rows * C * Hd)
    b_bound = bound_ms(nbytes(*a, dout) + nbytes(*grads), 10 * rows * C * Hd)
    say(f"phase 19 [{card}]: K5 sm90 x ({rows}, {C}) hidden {Hd} bf16: forward "
        f"{f_ms:.4f} ms (plain {f_plain:.4f}, dense half-block {f_lib:.4f}, bound "
        f"{f_bound[0]:.4f}), backward {b_ms:.4f} ms (plain {b_plain:.4f}, dense "
        f"{b_lib:.4f}, bound {b_bound[0]:.4f})")
    del trainer, model, predictor, a, grads
    return dict(serve=serve, step=step,
                fwd=dict(err=f_err, ms=f_ms, plain_ms=f_plain, lib_ms=f_lib, bound=f_bound,
                         rows=rows),
                bwd=dict(err=b_err, ms=b_ms, plain_ms=b_plain, lib_ms=b_lib, bound=b_bound,
                         rows=rows))


def phase19_grid_and_int8(torch, g) -> None:
    """Fault 11: a batch of P19_BATCH at N = 8 through K1 (the short forward
    and K4's wgmma backward in bf16, the CUDA cores in f32), K4 (wgmma and
    CUDA cores) and K6 against the plain versions. Fault 12: int8 products
    at M = 5, K = 60 (and 16 rows, N = 100) equal to the CPU's."""
    from probpose_pytorch_tpu_torch.ops import quant
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        fused_attention,
        fused_attention_reference,
        packed_attention,
        packed_attention_backward,
        packed_attention_bwd_reference,
        packed_attention_reference,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        tiled_attention,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_reference,
    )

    dev = torch.device("cuda")
    B, N, heads, d = P19_BATCH, 8, 2, 32
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=dev).to(dtype)
        dout = torch.randn(B, N, heads * d, generator=g, device=dev).to(dtype)
        label = f"batch {B} qkv {tuple(qkv.shape)} {name}"
        gate(torch, f"K1 {label} forward", packed_attention(qkv, heads),
             packed_attention_reference(qkv, heads), phase=19)
        gate(torch, f"K1 {label} backward", packed_attention_backward(qkv, dout, heads),
             packed_attention_bwd_reference(qkv, dout, heads), phase=19)
        gate(torch, f"K4 {label} forward", tiled_attention(qkv, heads),
             tiled_attention_reference(qkv, heads), phase=19)
        gate(torch, f"K4 {label} backward", tiled_attention_backward(qkv, dout, heads),
             tiled_attention_bwd_reference(qkv, dout, heads), phase=19)
        q, k, v = qkv.unflatten(-1, (3, heads, d)).unbind(2)
        gate(torch, f"K6 {label}", fused_attention(q, k, v), fused_attention_reference(q, k, v),
             phase=19)
        del qkv, dout, q, k, v
    for M, K, N_ in ((5, 60, 64), (16, 64, 100)):
        x = torch.randn(M, K, generator=g, device=dev)
        wq, ws = quant.quantize_weight(torch.randn(K, N_, generator=g, device=dev))
        got = quant.int8_matmul(x, wq, ws, out_dtype=torch.float32).cpu()
        want = quant.int8_matmul(x.cpu(), wq.cpu(), ws.cpu(), out_dtype=torch.float32)
        say(f"phase 19: int8 ({M}, {K}) x ({K}, {N_}) on the card, padded to "
            f"{quant.int_mm_padding(M, K, N_)}: equal to the CPU's: {torch.equal(got, want)}")
        check(torch.equal(got, want), f"int8 ({M}, {K}, {N_}) card differs from the CPU")


def phase19_vith(torch, dev, card: str) -> dict:
    """vit-h (1280 wide, 16 heads of 80, bf16, attn_impl="fused") at depth
    VITH_DEPTH through the entry points: served by a TopDownPredictor at
    256 x 192 (a short forward a block and 1 K2 a forward, no CUDA-core
    attention); trained by Trainer.fit with remat (two short forwards and a
    backward from the saved out and lse a block, 1 K2 a step), losses
    finite and falling; an f32 step at vit-h width and depth 2 through the
    kernels against the plain versions (phase 5's gates); served at 768 x
    768 at vit-h width and depth VITH_768_DEPTH (a K4 wgmma forward a
    block). The predictor serves the trainer's model before it trains, so
    the weights are drawn once."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.models.vit import ViTConfig

    t_phase = time.perf_counter()
    ViTConfig.PRESETS[f"vit-h-depth{VITH_DEPTH}"] = dict(ViTConfig.PRESETS["vit-h"],
                                                         depth=VITH_DEPTH)
    cfg = vith_config("bfloat16", VITH_TRAIN_BATCH, backbone=f"vit-h-depth{VITH_DEPTH}")
    trainer = make_trainer(torch, cfg, dev)
    model = trainer.model
    depth = len(model.backbone.blocks)
    check(depth == VITH_DEPTH and model.backbone.blocks[0].attn.num_heads == VITH_HEADS,
          "vit-h geometry off")
    predictor = TopDownPredictor(model, make_codec(cfg.model), cfg.model.img_size)
    requests = [request(70 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    reset_counts()
    answers = [predictor(f, b) for f, b in requests]
    torch.cuda.synchronize()
    serve = read_counts()
    check_answers(cfg.model, requests, answers, phase=19)
    say(f"phase 19: vit-h served, {len(requests)} forwards: K2 {serve['k2']}")
    check_attention_route(serve, depth * len(requests), 0, phase=19)
    check(serve["k2"] == len(requests), "vit-h's K2 did not run once a forward")
    f_dev = torch.from_numpy(requests[-1][0]).to(dev)
    b_dev = torch.from_numpy(requests[-1][1]).to(dev)
    serve_ms = cuda_ms(torch, lambda: predictor.predict(f_dev, b_dev), iters=5)
    say(f"phase 19 [{card}]: vit-h bf16 serving B={len(f_dev)} crops on the card: "
        f"{serve_ms:.3f} ms/batch ({time.perf_counter() - t_phase:.1f} s into the path)")
    del predictor, model, answers

    H, W = cfg.model.img_size
    B = cfg.train_batch_size
    ds = SyntheticPoseDataset(B, (H, W), cfg.model.num_keypoints, seed=3)
    batch = next(iter(batch_iterator(ds, B, num_workers=8)))
    check(trainer.model.backbone.remat, "the vit-h config does not train with remat")
    # Trainer.fit ends by saving the state; vit-h's (params, EMA and Adam's
    # two moments in f32, ~10 GB at full depth) took the card machine past
    # its disk budget for one run, so this fit keeps it in memory: the
    # steps, the schedule, the logging and the history are fit's own.
    trainer._save = lambda ckpt, what, metadata=None: False
    steps = VITH_TRAIN_STEPS
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(lambda: iter([batch]), max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 19: Trainer.fit, {steps} bf16 vit-h steps with remat at B={B} in {fit_s:.2f} "
        f"s; loss {losses[0]:.6f} -> {losses[-1]:.6f}; K2 {train['k2']} (expect {steps})")
    check(len(losses) == steps and all(np.isfinite(losses)), "a vit-h loss is not finite")
    check(losses[-1] < losses[0], "the vit-h loss did not fall over the fixed batch")
    check_attention_route(train, 2 * depth * steps, depth * steps, phase=19)
    check(train["k2"] == steps, "vit-h's K2 did not run once a step")
    db = trainer.device_batch(batch)
    trainer.train_step(trainer.state, db)
    step_ms = cuda_ms(torch, lambda: trainer.train_step(trainer.state, db), iters=3, warmup=0)
    say(f"phase 19 [{card}]: vit-h bf16 train step with remat, B={B}: {step_ms:.3f} ms")
    lr0 = float(trainer.tx.schedule(torch.zeros((), dtype=torch.int32, device=dev)))
    del trainer, db
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 19: vit-h training done {time.perf_counter() - t_phase:.1f} s into the path")

    # f32 at vit-h width and depth 2: a preset of this run, not of the package
    ViTConfig.PRESETS["vit-h-depth2"] = dict(ViTConfig.PRESETS["vit-h"], depth=VITH_F32_DEPTH)
    cfg32 = vith_config("float32", VITH_F32_BATCH, backbone="vit-h-depth2")
    compare_f32_step(torch, dev, {k: v[:VITH_F32_BATCH] for k, v in batch.items()}, lr0,
                     cfg32, phase=19, routed=("head.branches.",))
    gc.collect()
    torch.cuda.empty_cache()

    ViTConfig.PRESETS[f"vit-h-depth{VITH_768_DEPTH}"] = dict(ViTConfig.PRESETS["vit-h"],
                                                             depth=VITH_768_DEPTH)
    cfg768 = vith_config("bfloat16", VITH_768_BATCH, backbone=f"vit-h-depth{VITH_768_DEPTH}",
                         img_size=IMG_768).model
    model = build_model(cfg768, device=dev, seed=0)
    depth = len(model.backbone.blocks)
    predictor = TopDownPredictor(model, make_codec(cfg768), cfg768.img_size)
    frames, boxes = request(75, VITH_768_BATCH)
    reset_counts()
    answer = predictor(frames, boxes)
    torch.cuda.synchronize()
    s768 = read_counts()
    check_answers(cfg768, [(frames, boxes)], [answer], phase=19)
    say(f"phase 19: vit-h at 768 x 768, B={VITH_768_BATCH}: K4 forward {s768['k4f']} (expect "
        f"{depth}), short forward {s768['k1s']}, K1 CUDA cores {s768['k1f']} (expect 0 each)")
    check(s768["k4f"] == depth and s768["k1s"] == s768["k1f"] == s768["k4b"] == 0,
          "vit-h at 768 x 768 did not run K4's wgmma forward once a block")
    del predictor, model
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 19: vit-h path {time.perf_counter() - t_phase:.1f} s")
    return dict(serve=serve, train=train, s768=s768)


def phase19(torch, dev, card: str) -> dict:
    """Phase 19: faults 9-12 closed and vit-h's d = 80 attention on wgmma
    (the module docstring)."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(19)
    widths = phase19_widths(torch, card, g)
    mlp = phase19_mlp(torch, card, g)
    phase19_grid_and_int8(torch, g)
    d80 = phase19_d80(torch, card, g)
    gc.collect()
    torch.cuda.empty_cache()
    nano = phase19_vit_nano(torch, dev, card)
    vith = phase19_vith(torch, dev, card)
    say(f"phase 19: {time.perf_counter() - t0:.1f} s in all")
    return dict(widths=widths, mlp=mlp, d80=d80, nano=nano, vith=vith)


def phase19_kernels(p19: dict, p20: dict) -> list:
    """The kernels line's entries of phase 19: the d = 80 wgmma kernels
    (launches on the vit-h path), K4's CUDA cores at any d (timed by phase
    20 at d = 48, where they ran bf16 before its redesign) and K5's wgmma
    kernels at vit-nano's (64, 128) (its step; the CUDA cores' before phase
    21's redesign, which phase 21 times at ViT-g's widths)."""
    tiled_cu = "csrc/tiled_attention_sm90.cu"
    entries = []
    vith, d80 = p19["vith"], p19["d80"]
    for label, key, replaces, launches, cc in (
            ("K1 packed_attention forward, d = 80 (vit-h)", "n192", "attention_kernel.py:120",
             vith["train"]["k1s"], "K1 CUDA cores"),
            ("K4 tiled_attention forward, d = 80 (vit-h 768^2)", "n2304",
             "attention_tiled.py:119", vith["s768"]["k4f"], "K4 CUDA cores")):
        n = d80[key]["fwd"]
        entries.append(kernel_entry(label, "cuda", tiled_cu, replaces, launches, n["err"],
                                    n["ms"], n["plain_ms"], n["bound"], n["lib_ms"],
                                    design="wgmma+TMA, 32-byte swizzle", qkv=d80[key]["qkv"],
                                    cuda_core_ms=n["cuda_core_ms"], replaced_route=cc))
    for label, key, replaces, cc in (
            ("K1 packed_attention backward, d = 80 (vit-h)", "n192", "attention_kernel.py:146",
             "K1 CUDA cores"),
            ("K4 tiled_attention backward, d = 80", "n2304", "attention_tiled.py:147",
             "K4 CUDA cores")):
        n = d80[key]["bwd"]
        entries.append(kernel_entry(label, "cuda", tiled_cu, replaces, vith["train"]["k4b"],
                                    n["err"], n["ms"], n["plain_ms"], n["bound"], n["lib_ms"],
                                    design="wgmma+TMA, 32-byte swizzle", qkv=d80[key]["qkv"],
                                    cuda_core_ms=n["cuda_core_ms"], replaced_route=cc))
    w, d48 = p19["widths"], p20["times"]["d = 48 (8, 1024, 1152)"]
    for label, key, replaces in (("K4 tiled_attention forward, CUDA cores, any d", "fwd",
                                  "attention_tiled.py:119"),
                                 ("K4 tiled_attention backward, CUDA cores, any d", "bwd",
                                  "attention_tiled.py:147")):
        n = d48[key]
        entries.append(kernel_entry(label, "cuda", "csrc/tiled_attention.cu", replaces, 0,
                                    w[key]["err"], n["cuda_core_ms"], n["plain_ms"],
                                    n["bound"], n["lib_ms"],
                                    design="CUDA cores, run-time d", qkv=d48["qkv"],
                                    widths=list(P19_WIDTHS),
                                    bf16_widths=list(P19_BF16_WIDTHS), entry_point_only=True))
    nano = p19["nano"]
    for label, key, replaces, counter in (
            ("K5 fused_ln_mlp forward, vit-nano (64, 128)", "fwd", "mlp_kernel.py:49", "k5f"),
            ("K5 fused_ln_mlp backward, vit-nano (64, 128)", "bwd", "mlp_kernel.py:57", "k5b")):
        n = nano[key]
        entries.append(kernel_entry(label, "cuda", "csrc/fused_mlp_sm90.cu", replaces,
                                    nano["step"][counter], n["err"], n["ms"], n["plain_ms"],
                                    n["bound"], n["lib_ms"],
                                    design="wgmma+TMA, ragged tiles and stages",
                                    rows=n["rows"], path="vit-nano, mlp_impl fused",
                                    cuda_core_widths_err=p19["mlp"][
                                        "f_err" if key == "fwd" else "b_err"]))
    return entries


# --------------------------------------------------------------- phase 20

# bf16 head widths of phase 20's kernel checks: multiples of 8 from 16 to
# 256, those 8 (mod 16) among them (24, 72, 88 for ViT-g, 104).
P20_WIDTHS = (16, 24, 48, 72, 88, 96, 104, 112, 160, 192, 256)
P20_HEADS = 2
# (batch, tokens): the short forward at 256 x 192 and the tiled one at 768^2.
P20_SHAPES = ((8, 192), (1, 2304))
# Fault 13: K4's CUDA cores past d = 256, one head, at these tokens.
P20_WIDE = (272, 320, 512, 1024)
P20_WIDE_N = (192, 1024)
# ViT-g/14 (Zhai et al., "Scaling Vision Transformers", 2022): 1408 wide,
# 40 deep, 16 heads of 88, MLP 6,144 (48/11 of the width). Neither package
# has a preset; vitg_model composes it as JAX's build_model would.
VITG_WIDTH, VITG_DEPTH, VITG_HEADS, VITG_MLP_RATIO = 1408, 40, 16, 48 / 11
VITG_D = VITG_WIDTH // VITG_HEADS
VITG_SERVE_BATCH = 64
VITG_TRAIN_BATCH = 32
VITG_TRAIN_STEPS = 3
VITG_F32_DEPTH = 2
VITG_F32_BATCH = 8
VITG_768_DEPTH = 4  # cut for time: its build draws every weight on the host
VITG_768_BATCH = 4
# Timed shapes: (label, B, N, heads, d, the CUDA-core kernel the route gave
# them before this redesign: K1's at N <= 256, where its shared memory fits,
# else K4's).
P20_TIMED = (("d = 48 (64, 192, 1152)", 64, 192, 8, 48, "k1"),
             ("d = 48 (8, 1024, 1152)", 8, 1024, 8, 48, "k4"),
             ("d = 88 ViT-g (64, 192, 4224)", 64, 192, 16, 88, "k1"),
             ("d = 88 ViT-g 768^2 (8, 2304, 4224)", 8, 2304, 16, 88, "k4"))


def sm90_ptxas(log: str) -> dict:
    """(registers, spill bytes) of every bf16 attention kernel of
    csrc/tiled_attention_sm90.cuh by padded width and kind, from nvcc's
    -Xptxas -v report."""
    import re

    found, current = {}, None
    pat = re.compile(r"probpose_sm90\d+(fwd_kernel|short_fwd_kernel|bwd_dq_kernel|bwd_dkv_kernel)"
                     r"ILi(\d+)E(?:Li(\d)E)?")
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = pat.search(line)
            current = (int(m.group(2)), m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")) \
                if m else None
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found.setdefault(current, {})["spill_bytes"] = nums[1] + nums[2]
        elif current and line.strip().startswith("ptxas info") and "Used" in line:
            found.setdefault(current, {})["registers"] = int(line.split("Used")[1].split()[0])
    return found


# The kernels of csrc/fused_mlp_sm90.cu by their template arguments: the
# GEMM's (W, BN, TA, TB, epilogue) at each tile of `_shape` for u = y W1
# (both GELU forms), o = h W2 + x, dy = du W1^T and dW1^T, dW2^T; the dual
# product's GELU form; the LayerNorm passes' pairs a lane; the sums.
K5_TILES = ((3, 192), (2, 256), (2, 128))
K5_GEMMS = ((0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 3), (1, 1, 4))
K5_LN_PAIRS = (2, 4, 6, 8, 12, 16, 20, 24, 28, 32)
K5_SM90_KERNELS = frozenset(
    [("gemm", (w, bn, *t)) for w, bn in K5_TILES for t in K5_GEMMS]
    + [("dual", (e,)) for e in (0, 1)]
    + [(k, (p,)) for k in ("ln_rows", "ln_bwd") for p in K5_LN_PAIRS] + [("sum", ())])


def k5_ptxas(log: str) -> dict:
    """(registers, spill bytes) of every kernel of csrc/fused_mlp_sm90.cu,
    keyed as K5_SM90_KERNELS, from nvcc's -Xptxas -v report."""
    import re

    found, current = {}, None
    pat = re.compile(r"\d+(gemm|dual|ln_rows|ln_bwd|sum)_kernel(I(?:Li-?\d+E)+E)?")
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = pat.search(line)
            current = (m.group(1), tuple(int(v) for v in re.findall(r"Li(-?\d+)E",
                                                                   m.group(2) or ""))) \
                if m else None
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found.setdefault(current, {})["spill_bytes"] = nums[1] + nums[2]
        elif current and line.strip().startswith("ptxas info") and "Used" in line:
            found.setdefault(current, {})["registers"] = int(line.split("Used")[1].split()[0])
    return found


def vitg_model(torch, m, depth: int, device, seed: int = 0):
    """ViT-g/14's trunk at `depth` under the ProbMap head, with the rest of
    ModelConfig `m` (crop, dtype, attention and MLP, remat, head), composed
    as ProbPoseModel(ViTBackbone(...), ProbMapHead(...)) the way JAX's
    build_model composes a preset (models/model.py:130-140), in eval mode.
    The model is made on `device` and init_weights draws there from a
    generator of that device seeded with `seed`: drawing ViT-g's 1.23B
    weights on the host took 28 s."""
    from probpose_pytorch_tpu_torch.models.head import ProbMapHead
    from probpose_pytorch_tpu_torch.models.model import ProbPoseModel, init_weights
    from probpose_pytorch_tpu_torch.models.vit import ViTBackbone

    device = torch.device(device)
    with torch.device(device):
        backbone = ViTBackbone(img_size=m.img_size, patch_size=m.patch_size,
                               embed_dim=VITG_WIDTH, depth=depth, num_heads=VITG_HEADS,
                               mlp_ratio=VITG_MLP_RATIO, dtype=m.dtype,
                               exact_gelu=m.exact_gelu, remat=m.remat, attn_impl=m.attn_impl,
                               mlp_impl=m.mlp_impl,
                               softmax_dtype=getattr(torch, m.softmax_dtype))
        head = ProbMapHead(in_channels=VITG_WIDTH, out_channels=m.num_keypoints,
                           pool_sizes=m.pool_sizes, deconv_out_channels=m.deconv_out_channels,
                           deconv_kernel_sizes=m.deconv_kernel_sizes,
                           conv_out_channels=m.conv_out_channels,
                           conv_kernel_sizes=m.conv_kernel_sizes,
                           final_layer_kernel_size=m.final_layer_kernel_size,
                           normalize=m.normalize, dtype=m.dtype)
        model = ProbPoseModel(backbone, head)
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


@contextlib.contextmanager
def vitg_trainers(torch, depth: int):
    """Within it, Trainer.create (train/loop.py, through the build_model it
    imported) builds ViT-g's model at `depth` from a config's other fields
    (`vitg_model`), so that the trainer, its step and fit are the
    package's own."""
    from probpose_pytorch_tpu_torch.train import loop

    saved = loop.build_model
    loop.build_model = lambda cfg, mesh=None, *, device, seed=0: vitg_model(
        torch, cfg, depth, device, seed)
    try:
        yield
    finally:
        loop.build_model = saved


def vitg_config(dtype: str, batch: int, img_size=None):
    """configs/vitb_coco.json's recipe (remat on, augmentation off, dense
    MLP, attn_impl="fused") at `dtype` and `batch`, for vitg_model;
    `img_size` replaces the crop."""
    return dataclasses.replace(vith_config(dtype, batch, img_size=img_size),
                               **fit_outputs("vit-g"))


def phase20_widths(torch, g) -> dict:
    """bf16 at every P20_WIDTHS head width on the wgmma kernels, both qkv
    layouts, at P20_SHAPES: the route checked (the short forward at N =
    192, the tiled forward at 2304, the tiled backward at both), each
    forward against the TPU-order plain version (the tiled one also against
    the kernel-order one) with its lse, the backward from the saved (out,
    lse) against both orders, forward and backward twice bit for bit; K6 at
    d = 88 against its plain version and K1's bits."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import (
        fused_attention,
        fused_attention_reference,
        kernel_path,
        packed_attention,
    )
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        LAYOUTS,
        short_attention_reference,
        short_forward,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_online_bwd_reference,
        tiled_attention_online_reference,
        tiled_attention_reference,
        tiled_forward,
    )

    dev = torch.device("cuda")
    heads = P20_HEADS
    errs = dict(short=0.0, tiled=0.0, bwd=0.0)
    for d in P20_WIDTHS:
        for B, N in P20_SHAPES:
            short = N <= 256
            routes = (kernel_path(N, d, torch.bfloat16),
                      kernel_path(N, d, torch.bfloat16, backward=True))
            want = ("sm90 short" if short else "sm90 tiled", "sm90 tiled")
            check(routes == want, f"bf16 d = {d}, N = {N} routes to {routes}")
            for layout in LAYOUTS:
                qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=dev).to(torch.bfloat16)
                dout = torch.randn(B, N, heads * d, generator=g, device=dev).to(torch.bfloat16)
                label = f"d = {d} {routes[0]} {layout} qkv {tuple(qkv.shape)}"
                fwd = short_forward if short else tiled_forward
                out, lse = fwd(qkv, heads, True, layout)
                again = fwd(qkv, heads, True, layout)
                check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                      f"{label} forward differs between two runs")
                if short:
                    ref, lse_ref = short_attention_reference(qkv, heads, layout)
                else:
                    gate(torch, f"{label} forward vs the TPU order", out,
                         tiled_attention_reference(qkv, heads, layout=layout), phase=20)
                    ref, lse_ref = tiled_attention_online_reference(qkv, heads, layout=layout)
                key = "short" if short else "tiled"
                errs[key] = max(errs[key], gate(torch, f"{label} forward", out, ref, phase=20))
                lse_err = (lse - lse_ref).abs().max().item()
                check(lse_err <= 1e-5 * max(1.0, lse_ref.abs().max().item()),
                      f"{label}: lse off by {lse_err}")
                got = tiled_attention_backward(qkv, dout, heads, out, lse, layout=layout)
                check(torch.equal(got, tiled_attention_backward(qkv, dout, heads, out, lse,
                                                                layout=layout)),
                      f"{label} backward differs between two runs")
                errs["bwd"] = max(errs["bwd"], gate(
                    torch, f"{label} backward", got,
                    tiled_attention_bwd_reference(qkv, dout, heads, layout=layout), phase=20))
                gate(torch, f"{label} backward vs the kernel order", got,
                     tiled_attention_online_bwd_reference(qkv, dout, heads, out, lse,
                                                          layout=layout), phase=20)
    say(f"phase 20: bf16 d in {P20_WIDTHS} on wgmma, both layouts, N = 192 and 2304: "
        f"largest errors {errs}, every forward and backward twice bit for bit")
    # K6 at ViT-g's width: the short forward, one tensor map per view
    qkv = torch.randn(8, 192, 3 * VITG_WIDTH, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unflatten(-1, (3, VITG_HEADS, VITG_D)).unbind(2)
    before = fused_attention.launches
    out = fused_attention(q, k, v)
    check(fused_attention.launches == before + 1, "K6 did not launch once")
    errs["k6"] = gate(torch, "K6 fused_attention d = 88 (8, 192, 16, 88)", out,
                      fused_attention_reference(q, k, v), phase=20)
    check(torch.equal(out.flatten(-2), packed_attention(qkv, VITG_HEADS)),
          "K6 at d = 88 differs from K1's bits")
    return errs



def phase20_fault13(torch, g) -> dict:
    """Fault 13: K4's CUDA-core kernels at P20_WIDE head widths and
    P20_WIDE_N tokens, one head, f32 and bf16, forward and backward through
    the K4 wrappers against the TPU-order plain versions (K1's bound), the
    backward twice bit for bit; packed_attention routes each to a kernel
    (K1's CUDA cores where their shared memory fits, else K4's)."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import kernel_path, packed_attention
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        tiled_attention,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_reference,
    )

    dev = torch.device("cuda")
    errs = dict(fwd=0.0, bwd=0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d in P20_WIDE:
            for N in P20_WIDE_N:
                route = kernel_path(N, d, dtype)
                check(route in ("K1 CUDA cores", "K4 CUDA cores"), f"d = {d} N = {N}: {route}")
                qkv = torch.randn(1, N, 3 * d, generator=g, device=dev).to(dtype)
                dout = torch.randn(1, N, d, generator=g, device=dev).to(dtype)
                label = f"K4 CUDA cores d = {d} qkv {tuple(qkv.shape)} {name}"
                ref = tiled_attention_reference(qkv, 1)
                errs["fwd"] = max(errs["fwd"], gate(torch, f"{label} forward",
                                                    tiled_attention(qkv, 1), ref, phase=20))
                got = tiled_attention_backward(qkv, dout, 1)
                check(torch.equal(got, tiled_attention_backward(qkv, dout, 1)),
                      f"{label} backward differs between two runs")
                errs["bwd"] = max(errs["bwd"], gate(
                    torch, f"{label} backward", got,
                    tiled_attention_bwd_reference(qkv, dout, 1), phase=20))
                gate(torch, f"{label}: packed_attention via {route}", packed_attention(qkv, 1),
                     ref, phase=20)
    # timed, not gated: d = 512 at N = 1024, one head, bf16
    N, d = 1024, 512
    qkv = torch.randn(1, N, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(1, N, d, generator=g, device=dev).to(torch.bfloat16)
    f_ms, f_plain = paired_ms(torch, lambda: tiled_attention(qkv, 1),
                              lambda: tiled_attention_reference(qkv, 1), iters=3)
    b_ms, b_plain = paired_ms(torch, lambda: tiled_attention_backward(qkv, dout, 1),
                              lambda: tiled_attention_bwd_reference(qkv, dout, 1), iters=2)
    f_lib = cuda_ms(torch, sdpa_fwd_fn(torch, qkv, 1), iters=5)
    b_lib = cuda_ms(torch, sdpa_bwd_fn(torch, qkv, dout, 1), iters=5)
    f_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * N * N * d)
    b_bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * N * N * d)
    say(f"phase 20: K4 CUDA cores d = {d} qkv {tuple(qkv.shape)} bf16: forward {f_ms:.4f} ms "
        f"(plain {f_plain:.4f}, SDPA {f_lib:.4f}, bound {f_bound[0]:.4f}), backward "
        f"{b_ms:.4f} ms (plain {b_plain:.4f}, SDPA {b_lib:.4f}, bound {b_bound[0]:.4f})")
    shape = [1, N, 3 * d]
    errs["timed"] = dict(
        fwd=dict(err=errs["fwd"], ms=f_ms, plain_ms=f_plain, lib_ms=f_lib, bound=f_bound,
                 qkv=shape),
        bwd=dict(err=errs["bwd"], ms=b_ms, plain_ms=b_plain, lib_ms=b_lib, bound=b_bound,
                 qkv=shape))
    return errs


def phase20_times(torch, card: str, g) -> dict:
    """Not gated: the new route at P20_TIMED's shapes against the CUDA-core
    kernel that took them before (in turns), SDPA and its backward (in
    turns), and the plain versions; the backward from the saved (out,
    lse). Each CUDA-core kernel is first held to its plain version."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import kernel_path, packed_attention
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
        short_attention_reference,
        short_forward,
        tiled_attention_backward,
        tiled_attention_bwd_reference,
        tiled_attention_reference,
        tiled_forward,
    )

    dev = torch.device("cuda")
    rows = {}
    for label, B, N, heads, d, kind in P20_TIMED:
        qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(B, N, heads * d, generator=g, device=dev).to(torch.bfloat16)
        short = N <= 256
        route = kernel_path(N, d, torch.bfloat16)
        fwd = short_forward if short else tiled_forward
        out, lse = fwd(qkv, heads, True)
        plain = short_attention_reference if short else tiled_attention_reference
        f_err = gate(torch, f"{label} {route} forward", packed_attention(qkv, heads),
                     plain(qkv, heads)[0] if short else plain(qkv, heads), phase=20)
        dref = tiled_attention_bwd_reference(qkv, dout, heads)
        b_err = gate(torch, f"{label} backward", tiled_attention_backward(
            qkv, dout, heads, out, lse), dref, phase=20)
        cc = cuda_core_attention(torch, qkv, heads, kind)
        gate(torch, f"{label}: the {kind} CUDA-core forward it replaces", cc,
             short_attention_reference(qkv, heads)[0] if short
             else tiled_attention_reference(qkv, heads), phase=20)
        gate(torch, f"{label}: the {kind} CUDA-core backward it replaces",
             cuda_core_attention(torch, qkv, heads, kind, dout), dref, phase=20)
        fk = lambda: fwd(qkv, heads, True)
        bk = lambda: tiled_attention_backward(qkv, dout, heads, out, lse)
        f_ms, f_plain = paired_ms(torch, fk, lambda: plain(qkv, heads), iters=5)
        b_ms, b_plain = paired_ms(torch, bk, lambda: tiled_attention_bwd_reference(
            qkv, dout, heads), iters=3)
        f_cc, f_ms2 = paired_ms(torch, lambda: cuda_core_attention(torch, qkv, heads, kind),
                                fk, iters=5)
        b_cc, b_ms2 = paired_ms(torch, lambda: cuda_core_attention(torch, qkv, heads, kind,
                                                                    dout), bk, iters=3)
        f_ms3, f_lib = yardstick_ms(torch, fk, sdpa_fwd_fn(torch, qkv, heads), iters=20,
                                    windows=1)
        b_ms3, b_lib = yardstick_ms(torch, bk, sdpa_bwd_fn(torch, qkv, dout, heads), iters=10,
                                    windows=1)
        f_bound = bound_ms(nbytes(qkv) * 4 / 3, 4 * B * N * N * heads * d)
        b_bound = bound_ms(nbytes(qkv) * 7 / 3, 10 * B * N * N * heads * d)
        say(f"phase 20 [{card}]: {label} bf16 via {route}: forward {f_ms:.4f} ms ({f_ms2:.4f} "
            f"in turns with the {kind} CUDA cores' {f_cc:.4f}; {f_ms3:.4f} with SDPA "
            f"{f_lib:.4f}), plain {f_plain:.4f}, bound {f_bound[0]:.4f} ({f_bound[1]}); "
            f"backward from the saved (out, lse) {b_ms:.4f} ms ({b_ms2:.4f} with the CUDA "
            f"cores' {b_cc:.4f}; {b_ms3:.4f} with SDPA backward {b_lib:.4f}), plain "
            f"{b_plain:.4f}, bound {b_bound[0]:.4f} ({b_bound[1]})")
        rows[label] = dict(
            qkv=[B, N, 3 * heads * d], route=route, replaced=kind,
            fwd=dict(err=f_err, ms=f_ms, plain_ms=f_plain, lib_ms=f_lib, bound=f_bound,
                     cuda_core_ms=f_cc),
            bwd=dict(err=b_err, ms=b_ms, plain_ms=b_plain, lib_ms=b_lib, bound=b_bound,
                     cuda_core_ms=b_cc))
        del qkv, dout, out, lse, cc, dref
    return rows


def phase20_vitg(torch, dev, card: str) -> dict:
    """ViT-g/14 (VITG_* geometry, bf16, attn_impl="fused", dense MLP, remat)
    under the ProbMap head at 256 x 192 (N = 192, d = 88): served by a
    TopDownPredictor at full depth (40 short wgmma forwards and 1 K2 a
    forward, no CUDA-core attention), ms a batch of 64; trained by
    Trainer.fit with remat at B = 32 (80 short forwards, 40 backwards from
    the saved out and lse, 1 K2 a step; losses finite and falling; its
    ~16 GB state kept in memory), ms a step and peak memory; its f32 step
    at depth 2 held to the plain step (phase 5's gates); served at 768 x
    768 at depth VITG_768_DEPTH (the tiled wgmma forward at d = 88)."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor

    t_phase = time.perf_counter()
    cfg = vitg_config("bfloat16", VITG_TRAIN_BATCH)
    with vitg_trainers(torch, VITG_DEPTH):
        trainer = make_trainer(torch, cfg, dev)
    model = trainer.model
    depth = len(model.backbone.blocks)
    n_params = sum(p.numel() for p in model.parameters())
    check(depth == VITG_DEPTH and model.backbone.blocks[0].attn.num_heads == VITG_HEADS
          and model.backbone.blocks[0].mlp.fc1.out_features == 6144, "ViT-g geometry off")
    say(f"phase 20: ViT-g/14 trunk ({VITG_WIDTH} wide, depth {depth}, {VITG_HEADS} heads of "
        f"{VITG_D}, MLP 6144) under the ProbMap head: {n_params / 1e6:.1f}M parameters, "
        f"built in {time.perf_counter() - t_phase:.1f} s")
    predictor = TopDownPredictor(model, make_codec(cfg.model), cfg.model.img_size)
    requests = [request(80 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    reset_counts()
    answers = [predictor(f, b) for f, b in requests]
    torch.cuda.synchronize()
    serve = read_counts()
    check_answers(cfg.model, requests, answers, phase=20)
    say(f"phase 20: ViT-g served, {len(requests)} forwards: K2 {serve['k2']}")
    check_attention_route(serve, depth * len(requests), 0, phase=20)
    check(serve["k2"] == len(requests), "ViT-g's K2 did not run once a forward")
    check(max(REQUEST_SIZES) == VITG_SERVE_BATCH, "ViT-g's serving batch")
    f_dev = torch.from_numpy(requests[-1][0]).to(dev)
    b_dev = torch.from_numpy(requests[-1][1]).to(dev)
    serve_ms = cuda_ms(torch, lambda: predictor.predict(f_dev, b_dev), iters=5)
    say(f"phase 20 [{card}]: ViT-g bf16 serving B={len(f_dev)} crops on the card: "
        f"{serve_ms:.3f} ms/batch ({time.perf_counter() - t_phase:.1f} s into the path)")
    del predictor, model, answers

    H, W = cfg.model.img_size
    B = cfg.train_batch_size
    ds = SyntheticPoseDataset(B, (H, W), cfg.model.num_keypoints, seed=4)
    batch = next(iter(batch_iterator(ds, B, num_workers=8)))
    check(trainer.model.backbone.remat, "the ViT-g config does not train with remat")
    # Trainer.fit ends by saving the state; ViT-g's (params, EMA and Adam's
    # two moments in f32, ~16 GB) would take the card machine past its disk
    # budget, so this fit keeps it in memory: the steps, the schedule, the
    # logging and the history are fit's own.
    trainer._save = lambda ckpt, what, metadata=None: False
    steps = VITG_TRAIN_STEPS
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(lambda: iter([batch]), max_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 20: Trainer.fit, {steps} bf16 ViT-g steps with remat at B={B} in {fit_s:.2f} "
        f"s; loss {losses[0]:.6f} -> {losses[-1]:.6f}; K2 {train['k2']} (expect {steps})")
    check(len(losses) == steps and all(np.isfinite(losses)), "a ViT-g loss is not finite")
    check(losses[-1] < losses[0], "the ViT-g loss did not fall over the fixed batch")
    check_attention_route(train, 2 * depth * steps, depth * steps, phase=20)
    check(train["k2"] == steps, "ViT-g's K2 did not run once a step")
    db = trainer.device_batch(batch)
    trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: trainer.train_step(trainer.state, db), iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 20 [{card}]: ViT-g bf16 train step with remat, B={B}: {step_ms:.3f} ms; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    lr0 = float(trainer.tx.schedule(torch.zeros((), dtype=torch.int32, device=dev)))
    del trainer, db
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 20: ViT-g training done {time.perf_counter() - t_phase:.1f} s into the path")

    cfg32 = vitg_config("float32", VITG_F32_BATCH)
    with vitg_trainers(torch, VITG_F32_DEPTH):
        compare_f32_step(torch, dev, {k: v[:VITG_F32_BATCH] for k, v in batch.items()}, lr0,
                         cfg32, phase=20, routed=("head.branches.",))
    gc.collect()
    torch.cuda.empty_cache()

    cfg768 = vitg_config("bfloat16", VITG_768_BATCH, img_size=IMG_768).model
    model = vitg_model(torch, cfg768, VITG_768_DEPTH, dev)
    predictor = TopDownPredictor(model, make_codec(cfg768), cfg768.img_size)
    frames, boxes = request(85, VITG_768_BATCH)
    reset_counts()
    answer = predictor(frames, boxes)
    torch.cuda.synchronize()
    s768 = read_counts()
    check_answers(cfg768, [(frames, boxes)], [answer], phase=20)
    say(f"phase 20: ViT-g at 768 x 768 (depth {VITG_768_DEPTH}), B={VITG_768_BATCH}: K4 "
        f"forward {s768['k4f']} (expect {VITG_768_DEPTH}), short forward {s768['k1s']}, K1 "
        f"CUDA cores {s768['k1f']} (expect 0 each)")
    check(s768["k4f"] == VITG_768_DEPTH and s768["k1s"] == s768["k1f"] == s768["k4b"] == 0,
          "ViT-g at 768 x 768 did not run K4's wgmma forward once a block")
    del predictor, model
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 20: ViT-g path {time.perf_counter() - t_phase:.1f} s")
    return dict(serve=serve, train=train, s768=s768, serve_ms=serve_ms, step_ms=step_ms,
                peak_gib=peak / 2**30)


def phase20(torch, dev, card: str) -> dict:
    """Phase 20: fault 13 closed and bf16 attention at every head width
    that is a multiple of 8 on the wgmma kernels, with ViT-g's d = 88 as
    the path (the module docstring)."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(20)
    widths = phase20_widths(torch, g)
    wide = phase20_fault13(torch, g)
    times = phase20_times(torch, card, g)
    gc.collect()
    torch.cuda.empty_cache()
    vitg = phase20_vitg(torch, dev, card)
    say(f"phase 20: {time.perf_counter() - t0:.1f} s in all")
    return dict(widths=widths, wide=wide, times=times, vitg=vitg)


def phase20_kernels(p20: dict) -> list:
    """The kernels line's entries of phase 20: the wgmma kernels at ViT-g's
    d = 88 (launches on the ViT-g path) and at d = 48, each beside the
    CUDA-core kernel it replaces; K6 at d = 88; K4's CUDA cores past
    d = 256 (fault 13, no path's width)."""
    tiled_cu = "csrc/tiled_attention_sm90.cu"
    vitg, times, widths = p20["vitg"], p20["times"], p20["widths"]
    entries = []
    for label, key, direction, replaces, launches in (
            ("K1 packed_attention forward, d = 88 (ViT-g)", "d = 88 ViT-g (64, 192, 4224)",
             "fwd", "attention_kernel.py:120", vitg["train"]["k1s"]),
            ("K1 packed_attention backward, d = 88 (ViT-g)", "d = 88 ViT-g (64, 192, 4224)",
             "bwd", "attention_kernel.py:146", vitg["train"]["k4b"]),
            ("K4 tiled_attention forward, d = 88 (ViT-g 768^2)",
             "d = 88 ViT-g 768^2 (8, 2304, 4224)", "fwd", "attention_tiled.py:119",
             vitg["s768"]["k4f"]),
            ("K4 tiled_attention backward, d = 88 (ViT-g 768^2 shape)",
             "d = 88 ViT-g 768^2 (8, 2304, 4224)", "bwd", "attention_tiled.py:147", 0),
            ("K1 packed_attention forward, d = 48", "d = 48 (64, 192, 1152)", "fwd",
             "attention_kernel.py:120", 0),
            ("K1 packed_attention backward, d = 48", "d = 48 (64, 192, 1152)", "bwd",
             "attention_kernel.py:146", 0),
            ("K4 tiled_attention forward, d = 48", "d = 48 (8, 1024, 1152)", "fwd",
             "attention_tiled.py:119", 0),
            ("K4 tiled_attention backward, d = 48", "d = 48 (8, 1024, 1152)", "bwd",
             "attention_tiled.py:147", 0)):
        row = times[key]
        n = row[direction]
        replaced = "K1 CUDA cores" if row["replaced"] == "k1" else "K4 CUDA cores"
        entries.append(kernel_entry(label, "cuda", tiled_cu, replaces, launches, n["err"],
                                    n["ms"], n["plain_ms"], n["bound"], n["lib_ms"],
                                    design="wgmma+TMA, padded width, 4-D head maps",
                                    qkv=row["qkv"], replaced_route=replaced,
                                    cuda_core_ms=n["cuda_core_ms"],
                                    entry_point_only=launches == 0,
                                    widths_gated=list(P20_WIDTHS),
                                    width_errs=widths if direction == "fwd" else None))
    for label, key, replaces in (("K4 tiled_attention forward, CUDA cores, d > 256", "fwd",
                                  "attention_tiled.py:119"),
                                 ("K4 tiled_attention backward, CUDA cores, d > 256", "bwd",
                                  "attention_tiled.py:147")):
        n = p20["wide"]["timed"][key]
        entries.append(kernel_entry(label, "cuda", "csrc/tiled_attention.cu", replaces, 0,
                                    n["err"], n["ms"], n["plain_ms"], n["bound"], n["lib_ms"],
                                    design="CUDA cores, 128-column chunks", qkv=n["qkv"],
                                    widths=list(P20_WIDE), entry_point_only=True))
    return entries


# --------------------------------------------------------------- phase 21

# K5's bits at the widths the wgmma kernels took before phase 21's redesign
# (C in SUPPORTED_WIDTHS, a hidden width that is a multiple of 256: 4 C and
# one more, so that every tile shape of `_shape` runs), both GELU forms,
# ragged rows.
P21_BITS_SHAPES = ((384, 1536), (384, 1280), (768, 3072), (768, 2048), (1024, 4096),
                   (1024, 2560), (1280, 5120), (1280, 3328))
P21_BITS_ROWS = (393, 4105)


def k5_digests(torch) -> dict:
    """The first 16 hex digits of the sha256 of K5's bf16 forward output and
    its seven cotangents, concatenated, at each P21_BITS_SHAPES x
    P21_BITS_ROWS x GELU form, on inputs drawn with numpy (the same bits on
    any torch). Only the package's public K5 calls: scripts/k5_bits.py runs
    it on another commit's package."""
    import hashlib

    from probpose_pytorch_tpu_torch.ops.kernels.mlp import fused_ln_mlp, fused_ln_mlp_backward

    dev = torch.device("cuda")
    out = {}
    for C, Hd in P21_BITS_SHAPES:
        for R in P21_BITS_ROWS:
            rng = np.random.default_rng(C * 7 + Hd + R)
            draw = lambda *shape, s=1.0, m=0.0: torch.from_numpy(
                rng.normal(m, s, shape).astype(np.float32)).to(dev)
            bf = torch.bfloat16
            a = (draw(R, C).to(bf), draw(C, s=0.1, m=1.0), draw(C, s=0.1),
                 draw(Hd, C, s=C**-0.5).to(bf).t(), draw(Hd, s=0.1),
                 draw(C, Hd, s=Hd**-0.5).to(bf).t(), draw(C, s=0.1))
            dout = draw(R, C).to(bf)
            for exact in (False, True):
                h = hashlib.sha256()
                for t in (fused_ln_mlp(*a, exact), *fused_ln_mlp_backward(*a, dout, exact)):
                    t = t.contiguous()
                    h.update((t.view(torch.int16) if t.dtype == bf else t).cpu().numpy().tobytes())
                out[f"{C}x{Hd} R={R} {'erf' if exact else 'tanh'}"] = h.hexdigest()[:16]
    return out


# k5_digests of the commit before the widths were opened (scripts/k5_bits.py
# on a `git archive` of it, NVIDIA H100 80GB HBM3, 700.00 W).
P21_PARENT_DIGESTS = {
    "384x1536 R=393 tanh": "bafe109686dba58a",
    "384x1536 R=393 erf": "5f925fc6c224f605",
    "384x1536 R=4105 tanh": "aea0fa3caf180a10",
    "384x1536 R=4105 erf": "ed3674736cc443bc",
    "384x1280 R=393 tanh": "7cbad8ce565a43e3",
    "384x1280 R=393 erf": "eecc37980fbf93ca",
    "384x1280 R=4105 tanh": "0439788ee6237e24",
    "384x1280 R=4105 erf": "c532f1c10845f52a",
    "768x3072 R=393 tanh": "567d6323b32c1020",
    "768x3072 R=393 erf": "c8b1b143001cfc5c",
    "768x3072 R=4105 tanh": "6f0a68b7c42885c9",
    "768x3072 R=4105 erf": "c3bb1a9f02a1ddd4",
    "768x2048 R=393 tanh": "1db4193d8d6ebb63",
    "768x2048 R=393 erf": "b9a2905f74e59eb6",
    "768x2048 R=4105 tanh": "2c28d2664756f5c4",
    "768x2048 R=4105 erf": "164dc0d0020924ab",
    "1024x4096 R=393 tanh": "97de790657bac5d7",
    "1024x4096 R=393 erf": "9bfb8d84b5ee4827",
    "1024x4096 R=4105 tanh": "9d459c1af418de43",
    "1024x4096 R=4105 erf": "6fdd6e3657fef7f6",
    "1024x2560 R=393 tanh": "59956db17726234b",
    "1024x2560 R=393 erf": "0db1d8926542a051",
    "1024x2560 R=4105 tanh": "2e66d56399d18733",
    "1024x2560 R=4105 erf": "298199249e10420d",
    "1280x5120 R=393 tanh": "6c0c06a5744be30f",
    "1280x5120 R=393 erf": "4c2b6497f909bfe7",
    "1280x5120 R=4105 tanh": "a91a0003c0d6b357",
    "1280x5120 R=4105 erf": "70581970ce119c20",
    "1280x3328 R=393 tanh": "7b307426fc5432c8",
    "1280x3328 R=393 erf": "c34a45402937d5f0",
    "1280x3328 R=4105 tanh": "5004005fef65cb10",
    "1280x3328 R=4105 erf": "fbca5705f5c28fc8",
}
# ViT-g's rows of K5: serving B = 64 and the remat step's B = 32, 192 tokens.
P21_ROWS = (VITG_SERVE_BATCH * 192, VITG_TRAIN_BATCH * 192)
P21_TIMED = ((VITG_SERVE_BATCH * 192, VITG_WIDTH, 6144), (VITG_TRAIN_BATCH * 192, VITG_WIDTH, 6144),
             (VITG_SERVE_BATCH * 192, 1536, 6144))


def phase21_gates(torch, g) -> dict:
    """bf16 K5 at ViT-g's exact shapes, P21_ROWS x (1408, 6144), both GELU
    forms, on the wgmma kernels: the forward within K1's bound of the plain
    version, the seven cotangents within phase 7's bound of the plain
    backward and two bf16 ulps of the kernel-order twin, both twice bit for
    bit; the scratch as the library counts it."""
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
        _lib,
        fused_ln_mlp,
        fused_ln_mlp_backward,
        fused_ln_mlp_bwd_kernel_order_reference,
        fused_ln_mlp_bwd_reference,
        fused_ln_mlp_reference,
        mlp_route,
        mlp_workspace_bytes,
    )

    dev = torch.device("cuda")
    C, Hd = VITG_WIDTH, 6144
    check(mlp_route(C, Hd, torch.bfloat16) == "sm90", "ViT-g's K5 does not route to sm90")
    errs = dict(fwd=0.0, bwd=0.0, twin=0.0)
    for R in P21_ROWS:
        check(_lib().fused_mlp_bwd_workspace_bytes(R, C, Hd) == mlp_workspace_bytes(R, C, Hd),
              f"K5's scratch at ({R}, {C}, {Hd}) differs from the library's")
        a = p19_mlp_args(torch, g, dev, R, C, Hd, torch.bfloat16)
        dout = torch.randn(R, C, generator=g, device=dev).to(torch.bfloat16)
        for exact in (False, True):
            label = f"K5 sm90 x ({R}, {C}) hidden {Hd} {'erf' if exact else 'tanh'}"
            out = fused_ln_mlp(*a, exact)
            check(torch.equal(out, fused_ln_mlp(*a, exact)), f"{label}: two forwards differ")
            errs["fwd"] = max(errs["fwd"], gate(torch, f"{label} forward", out,
                                                fused_ln_mlp_reference(*a, exact), phase=21))
            grads = fused_ln_mlp_backward(*a, dout, exact)
            again = fused_ln_mlp_backward(*a, dout, exact)
            for name, got, rerun, ref, twin in zip(
                    ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"), grads, again,
                    fused_ln_mlp_bwd_reference(*a, dout, exact),
                    fused_ln_mlp_bwd_kernel_order_reference(*a, dout, exact)):
                check(torch.equal(got, rerun), f"{label} {name} differs between two runs")
                errs["bwd"] = max(errs["bwd"], gate(torch, f"{label} backward {name}", got, ref,
                                                    phase=21, bound=k5_grad_bound(ref)))
                errs["twin"] = max(errs["twin"], gate(
                    torch, f"{label} backward {name} vs the kernel-order twin", got, twin,
                    phase=21, bound=2 * 2**-8 * twin.float().abs().max().item()))
            del grads, again
        del a, dout
    return errs


def phase21_bits(torch) -> None:
    """K5's bits at the widths the wgmma kernels took before (k5_digests)
    against the parent commit's, P21_PARENT_DIGESTS."""
    got = k5_digests(torch)
    differ = sorted(k for k in P21_PARENT_DIGESTS if got.get(k) != P21_PARENT_DIGESTS[k])
    say(f"phase 21: K5 at C in {sorted({c for c, _ in P21_BITS_SHAPES})}: {len(got)} cases of "
        f"8 outputs, {len(got) - len(differ)} with the parent commit's bits")
    check(set(got) == set(P21_PARENT_DIGESTS) and not differ,
          f"K5's bits at the preset widths changed: {differ}")


def phase21_times(torch, card: str, g) -> dict:
    """Not gated: K5 at P21_TIMED's shapes in bf16, the wgmma kernels against
    the CUDA-core ones they replace (`cuda_core_mlp`, in turns, three
    launches a window: a CUDA-core backward takes ~0.4-0.9 s), the dense
    half-block on cuBLAS (in turns) and the plain versions; forward at each
    shape, backward at each but the serving rows of 1408."""
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
        fused_ln_mlp,
        fused_ln_mlp_backward,
        fused_ln_mlp_bwd_reference,
        fused_ln_mlp_reference,
    )

    dev = torch.device("cuda")
    rows = {}
    for R, C, Hd in P21_TIMED:
        a = p19_mlp_args(torch, g, dev, R, C, Hd, torch.bfloat16)
        dout = torch.randn(R, C, generator=g, device=dev).to(torch.bfloat16)
        key = f"({R}, {C}, {Hd})"
        cc = cuda_core_mlp(torch, a)
        f_cc_err = gate(torch, f"{key} the CUDA-core forward it replaces", cc,
                        fused_ln_mlp_reference(*a), phase=21)
        fk = lambda: fused_ln_mlp(*a)
        f_ms, f_plain = paired_ms(torch, fk, lambda: fused_ln_mlp_reference(*a), iters=10)
        f_cc, f_ms2 = (cuda_ms(torch, lambda: cuda_core_mlp(torch, a), 3, warmup=1),
                       cuda_ms(torch, fk, 10))
        f_ms3, f_lib = yardstick_ms(torch, fk, dense_fwd_fn(torch, a), iters=20, windows=1)
        f_bound = bound_ms(nbytes(*a, a[0]), 4 * R * C * Hd)
        row = dict(x=[R, C], hidden=Hd,
                   fwd=dict(ms=f_ms, plain_ms=f_plain, lib_ms=f_lib, bound=f_bound,
                            cuda_core_ms=f_cc, cuda_core_err=f_cc_err, ms_in_turns=[f_ms2, f_ms3]))
        msg = (f"phase 21 [{card}]: K5 x ({R}, {C}) hidden {Hd} bf16: forward {f_ms:.4f} ms "
               f"({f_ms2:.4f} beside the CUDA cores' {f_cc:.4f}; {f_ms3:.4f} in turns with the "
               f"dense half-block's {f_lib:.4f}), plain {f_plain:.4f}, bound {f_bound[0]:.4f}")
        if (R, C) != (P21_ROWS[0], VITG_WIDTH):
            grads = cuda_core_mlp(torch, a, dout)
            ref = fused_ln_mlp_bwd_reference(*a, dout)
            b_cc_err = max(gate(torch, f"{key} the CUDA-core backward it replaces, {n}", got, r,
                                phase=21, bound=k5_grad_bound(r))
                           for n, got, r in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2",
                                                 "db2"), grads, ref))
            bk = lambda: fused_ln_mlp_backward(*a, dout)
            b_ms, b_plain = paired_ms(torch, bk, lambda: fused_ln_mlp_bwd_reference(*a, dout),
                                      iters=5)
            b_cc, b_ms2 = (cuda_ms(torch, lambda: cuda_core_mlp(torch, a, dout), 3, warmup=1),
                           cuda_ms(torch, bk, 5))
            b_ms3, b_lib = yardstick_ms(torch, bk, dense_bwd_fn(torch, a, dout), iters=10,
                                        windows=1)
            b_bound = bound_ms(nbytes(*a, dout) + nbytes(*grads), 10 * R * C * Hd)
            row["bwd"] = dict(ms=b_ms, plain_ms=b_plain, lib_ms=b_lib, bound=b_bound,
                              cuda_core_ms=b_cc, cuda_core_err=b_cc_err,
                              ms_in_turns=[b_ms2, b_ms3])
            msg += (f"; backward {b_ms:.4f} ms ({b_ms2:.4f} beside the CUDA cores' {b_cc:.4f}; "
                    f"{b_ms3:.4f} with the dense backward's {b_lib:.4f}), plain {b_plain:.4f}, "
                    f"bound {b_bound[0]:.4f}")
            del grads, ref
        say(msg)
        rows[key] = row
        del a, dout, cc
        torch.cuda.empty_cache()
    return rows


def phase21_vitg(torch, dev, card: str) -> dict:
    """ViT-g/14 as phase 20 builds it (VITG_* geometry, bf16,
    attn_impl="fused", remat) with mlp_impl="fused": served by a
    TopDownPredictor at full depth (40 K5 forwards and 40 short attention
    forwards a forward), ms a batch of 64; trained by Trainer.fit with remat
    for 3 steps at B = 32 (80 K5 forwards and 40 K5 backwards a step, 80
    short forwards and 40 attention backwards; losses finite and falling;
    the state kept in memory), ms a step and peak memory (under the card's
    80 GiB)."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor

    t_phase = time.perf_counter()
    cfg = vitg_config("bfloat16", VITG_TRAIN_BATCH)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, mlp_impl="fused"),
                              **fit_outputs("vit-g-fused"))
    with vitg_trainers(torch, VITG_DEPTH):
        trainer = make_trainer(torch, cfg, dev)
    model = trainer.model
    depth = len(model.backbone.blocks)
    check(depth == VITG_DEPTH and all(b.mlp_impl == "fused" for b in model.backbone.blocks),
          "ViT-g's blocks do not run the fused MLP")
    predictor = TopDownPredictor(model, make_codec(cfg.model), cfg.model.img_size)
    requests = [request(90 + i, B) for i, B in enumerate(REQUEST_SIZES)]
    reset_counts()
    answers = [predictor(f, b) for f, b in requests]
    torch.cuda.synchronize()
    serve = read_counts()
    check_answers(cfg.model, requests, answers, phase=21)
    say(f"phase 21: ViT-g (fused MLP) served, {len(requests)} forwards: K5 forward "
        f"{serve['k5f']} (expect {depth * len(requests)}), K5 backward {serve['k5b']}, K2 "
        f"{serve['k2']}")
    check(serve["k5f"] == depth * len(requests) and serve["k5b"] == 0,
          "ViT-g's K5 did not run once a block")
    check_attention_route(serve, depth * len(requests), 0, phase=21)
    check(serve["k2"] == len(requests), "ViT-g's K2 did not run once a forward")
    f_dev = torch.from_numpy(requests[-1][0]).to(dev)
    b_dev = torch.from_numpy(requests[-1][1]).to(dev)
    serve_ms = cuda_ms(torch, lambda: predictor.predict(f_dev, b_dev), iters=5)
    say(f"phase 21 [{card}]: ViT-g (fused MLP) bf16 serving B={len(f_dev)} crops on the "
        f"card: {serve_ms:.3f} ms/batch (phase 20's dense MLP: see its line)")
    del predictor, model, answers, f_dev, b_dev

    B = cfg.train_batch_size
    H, W = cfg.model.img_size
    ds = SyntheticPoseDataset(B, (H, W), cfg.model.num_keypoints, seed=5)
    batch = next(iter(batch_iterator(ds, B, num_workers=8)))
    check(trainer.model.backbone.remat, "the ViT-g config does not train with remat")
    trainer._save = lambda ckpt, what, metadata=None: False  # as phase 20: state in memory
    steps = VITG_TRAIN_STEPS
    reset_counts()
    trainer.fit(lambda: iter([batch]), max_steps=steps)
    torch.cuda.synchronize()
    train = read_counts()
    losses = [m["loss"] for p, _, m in trainer.history if p == "training"]
    say(f"phase 21: Trainer.fit, {steps} bf16 ViT-g (fused MLP) steps with remat at B={B}: "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; K5 forward {train['k5f']} (expect "
        f"{2 * depth * steps}), backward {train['k5b']} (expect {depth * steps})")
    check(len(losses) == steps and all(np.isfinite(losses)), "a ViT-g loss is not finite")
    check(losses[-1] < losses[0], "the ViT-g loss did not fall over the fixed batch")
    check(train["k5f"] == 2 * depth * steps and train["k5b"] == depth * steps,
          "ViT-g's K5 step count off")
    check_attention_route(train, 2 * depth * steps, depth * steps, phase=21)
    db = trainer.device_batch(batch)
    trainer.train_step(trainer.state, db)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: trainer.train_step(trainer.state, db), iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 21 [{card}]: ViT-g (fused MLP) bf16 train step with remat, B={B}: "
        f"{step_ms:.3f} ms; peak device memory {peak / 2**30:.2f} GiB")
    check(peak < 80 * 2**30, "ViT-g's fused step peaks past 80 GiB")
    del trainer, db
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 21: ViT-g (fused MLP) path {time.perf_counter() - t_phase:.1f} s")
    return dict(serve=serve, train=train, serve_ms=serve_ms, step_ms=step_ms,
                peak_gib=peak / 2**30)


def phase21(torch, dev, card: str) -> dict:
    """Phase 21: bf16 K5 on the wgmma kernels at every width that is a
    multiple of 8, with ViT-g's (1408, 6144) fused MLP as the path (the
    module docstring)."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(21)
    errs = phase21_gates(torch, g)
    phase21_bits(torch)
    times = phase21_times(torch, card, g)
    gc.collect()
    torch.cuda.empty_cache()
    vitg = phase21_vitg(torch, dev, card)
    say(f"phase 21: {time.perf_counter() - t0:.1f} s in all")
    return dict(errs=errs, times=times, vitg=vitg)


def phase21_kernels(p21: dict) -> list:
    """The kernels line's entries of phase 21: the wgmma kernels at ViT-g's
    (1408, 6144) (launches on the ViT-g path; the forward at serving's rows,
    the backward at the step's) beside the CUDA-core kernels they replace,
    and the CUDA-core kernels themselves (f32 at every width, bf16 at widths
    that are not multiples of 8: on no bf16 path), timed at those shapes."""
    mlp_cu = "csrc/fused_mlp_sm90.cu"
    train, times, errs = p21["vitg"]["train"], p21["times"], p21["errs"]
    fwd = times[f"({P21_ROWS[0]}, {VITG_WIDTH}, 6144)"]["fwd"]
    bwd = times[f"({P21_ROWS[1]}, {VITG_WIDTH}, 6144)"]["bwd"]
    step_fwd = times[f"({P21_ROWS[1]}, {VITG_WIDTH}, 6144)"]["fwd"]
    wide = times[f"({P21_ROWS[0]}, 1536, 6144)"]
    shape = lambda R: dict(x=[R, VITG_WIDTH], hidden=6144)
    return [
        kernel_entry("K5 fused_ln_mlp forward, ViT-g (1408, 6144)", "cuda", mlp_cu,
                     "mlp_kernel.py:49", train["k5f"], errs["fwd"], fwd["ms"], fwd["plain_ms"],
                     fwd["bound"], fwd["lib_ms"], design="wgmma+TMA, 128 x 128 tiles",
                     replaced_route="K5 CUDA cores", cuda_core_ms=fwd["cuda_core_ms"],
                     step_rows=dict(ms=step_fwd["ms"], bound_ms=step_fwd["bound"][0],
                                    cuda_core_ms=step_fwd["cuda_core_ms"],
                                    library_ms=step_fwd["lib_ms"]),
                     serve_launches=p21["vitg"]["serve"]["k5f"], **shape(P21_ROWS[0]),
                     at_1536=wide),
        kernel_entry("K5 fused_ln_mlp backward, ViT-g (1408, 6144)", "cuda", mlp_cu,
                     "mlp_kernel.py:57", train["k5b"], errs["bwd"], bwd["ms"], bwd["plain_ms"],
                     bwd["bound"], bwd["lib_ms"], design="wgmma+TMA, 128 x 128 tiles",
                     replaced_route="K5 CUDA cores", cuda_core_ms=bwd["cuda_core_ms"],
                     twin_err=errs["twin"], **shape(P21_ROWS[1])),
        kernel_entry("K5 fused_ln_mlp forward, CUDA cores (f32; bf16 off multiples of 8)",
                     "cuda", "csrc/fused_mlp.cu", "mlp_kernel.py:49", 0, fwd["cuda_core_err"],
                     fwd["cuda_core_ms"], fwd["plain_ms"], fwd["bound"], fwd["lib_ms"],
                     design="CUDA cores, any C <= 2048", entry_point_only=True,
                     **shape(P21_ROWS[0])),
        kernel_entry("K5 fused_ln_mlp backward, CUDA cores (f32; bf16 off multiples of 8)",
                     "cuda", "csrc/fused_mlp.cu", "mlp_kernel.py:57", 0, bwd["cuda_core_err"],
                     bwd["cuda_core_ms"], bwd["plain_ms"], bwd["bound"], bwd["lib_ms"],
                     design="CUDA cores, any C <= 2048", entry_point_only=True,
                     **shape(P21_ROWS[1])),
    ]


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
    q, k, v and dO, at ATTENTION_SHAPES in bf16; then K2's loop at phase
    3's rows; printed, not gated. Uses only the package's public attention
    and sparsemax calls, so any commit of the port can be timed."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import packed_attention
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    z = k2_rows(torch, g, SERVE_BATCH * 17, 3072, "random")
    say(json.dumps(dict(sparsemax="flagship serving", card=card, rows=list(z.shape),
                        ms=cuda_ms(torch, lambda: sparsemax_rows(z), iters=50))))
    del z
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


SERVING_TIMED_CALLS = 20
SERVING_BOX_COUNTS = (1, 64, 256)


def serving_times(torch, card: str) -> None:
    """The flagship bf16 predictor (configs/flagship_coco_vits.json, random
    weights) served end to end: predict_frame on one 1080 x 1920 frame at
    SERVING_BOX_COUNTS boxes and a call on REQUEST_SIZES[-1] crops, each
    timed on the host clock over SERVING_TIMED_CALLS calls (upload,
    compute, download) and traced with torch.profiler over 5 calls for the
    device's busy time and idle share; one JSON line each, printed, not
    gated. Uses only build_model, TopDownPredictor and its calls, so a
    copy of this script in another commit's checkout times that commit on
    the same card."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.models.model import build_model
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = TrainConfig.load(REPO / "configs/flagship_coco_vits.json").model
    pred = TopDownPredictor(build_model(cfg, device=dev, seed=0), make_codec(cfg), cfg.img_size)
    rng = np.random.default_rng(40)
    frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    calls = [(f"predict_frame, {n} boxes", lambda b=camera_boxes(rng, n): pred.predict_frame(
        frame, b)) for n in SERVING_BOX_COUNTS]
    frames, boxes = request(41, REQUEST_SIZES[-1])
    calls.append((f"call, {len(frames)} crops", lambda: pred(frames, boxes)))
    for label, fn in calls:
        for _ in range(3):
            fn()
        host = []
        for _ in range(SERVING_TIMED_CALLS):
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        say(json.dumps(dict(serving=label, card=card, host_ms_median=float(np.median(host)),
                            host_ms_min=min(host), host_ms_max=max(host),
                            traced_ms=wall / 5, device_busy_ms=busy / 5,
                            idle_share=1 - busy / wall)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this smoke "
                         "run needs an NVIDIA GPU")
    if sys.argv[1:2] == ["--phase17-rank"]:  # one rank of phase 17's world
        phase17_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
        return
    if sys.argv[1:2] == ["--phase18-rank"]:  # one rank of phase 18's worlds
        phase18_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
        return
    if "--attention-times" in sys.argv[1:]:
        attention_times(torch, card_line())
        return
    if "--serving-times" in sys.argv[1:]:
        serving_times(torch, card_line())
        return
    global RUN_DIR
    RUN_DIR = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run(torch)
    finally:
        for p in STARTED:  # ranks a failed phase left running
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(RUN_DIR, ignore_errors=True)


def run(torch) -> None:
    """Phases 0 to 21, then the kernels line and the result line."""
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
    sm90 = sm90_ptxas(report.get("ptxas", ""))
    widths = sorted({dp for dp, _ in sm90})
    say(f"phase 0: bf16 attention kernels (csrc/tiled_attention_sm90.cuh) at padded widths "
        f"{widths}: registers " + ", ".join(
            f"{dp}: " + "/".join(str(sm90[(dp, k)]["registers"]) for k in
                                 ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel"))
            for dp in widths) + " (forward / dQ / dK,dV); spill bytes "
        f"{sum(v.get('spill_bytes', 0) for v in sm90.values())} over {len(sm90)} kernels")
    check(widths == list(range(16, 257, 16)), "a padded width is missing from nvcc's report")
    check(all(v.get("spill_bytes", 0) == 0 for v in sm90.values()),
          "a bf16 attention kernel spills: " + str({k: v for k, v in sm90.items()
                                                    if v.get("spill_bytes")}))
    k5 = k5_ptxas(report.get("ptxas", ""))
    say("phase 0: K5's bf16 kernels (csrc/fused_mlp_sm90.cu), registers: " + ", ".join(
        f"{name}<{','.join(map(str, targs))}> {v.get('registers')}"
        for (name, targs), v in sorted(k5.items())) + f"; spill bytes "
        f"{sum(v.get('spill_bytes', 0) for v in k5.values())} over {len(k5)} kernels")
    check(set(k5) == K5_SM90_KERNELS, "a K5 sm90 kernel is missing from nvcc's report: "
          f"{sorted(K5_SM90_KERNELS - set(k5))}")
    check(all(v.get("spill_bytes", 0) == 0 for v in k5.values()),
          "a K5 sm90 kernel spills: " + str({k: v for k, v in k5.items() if v.get("spill_bytes")}))

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
    model = build_model(cfg, device=dev, seed=0)
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
    model32 = build_model(cfg32, device=dev)
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
    worlds18 = phase18_begin()  # phase 18's worlds run beside phases 15 and 16
    bundles15 = phase15(torch, dev, card)

    # --------------------------------------------------------------- phase 16
    gc.collect()
    torch.cuda.empty_cache()
    int8_16 = phase16(torch, dev, card)

    # --------------------------------------------------------------- phase 17
    gc.collect()
    torch.cuda.empty_cache()
    world17, hm17, refs17 = phase17(torch, dev, card, g)

    # --------------------------------------------------------------- phase 18
    gc.collect()
    torch.cuda.empty_cache()
    pipe18 = phase18(torch, dev, card, refs17, worlds18)

    # --------------------------------------------------------------- phase 19
    gc.collect()
    torch.cuda.empty_cache()
    p19 = phase19(torch, dev, card)

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
    # The head-major layout of attn_impl="fused_tp" (phase 17): the same
    # kernels reading q, k and v at a head stride of 3d; launches on the
    # fused_tp main paths (the flagship step, the 768 x 768 step), the
    # library's time on the head-major q, k, v views.
    for label, key, cu, replaces, run_key, counter in (
            ("K1 packed_attention forward", "k1f", tiled_cu, "attention_kernel.py:120",
             "17a flagship step", "k1s"),
            ("K1 packed_attention backward", "k1b", tiled_cu, "attention_kernel.py:146",
             "17a flagship step", "k4b"),
            ("K4 tiled_attention forward", "k4f", tiled_cu, "attention_tiled.py:119",
             "17a 768 step", "k4f"),
            ("K4 tiled_attention backward", "k4b", tiled_cu, "attention_tiled.py:147",
             "17a 768 step", "k4b")):
        n = hm17[key]
        kernels.append(kernel_entry(
            f"{label}, head-major", "cuda", cu, replaces, world17[run_key][counter], n["err"],
            n["ms"], n["plain_ms"], n["bound"], n["lib_ms"], design="wgmma+TMA",
            layout="head_major", qkv_major_ms=n["qkv_major_ms"]))
    # Phase 10's launches (the three eval runs) beside each kernel's.
    eval_counter = {"K1 packed_attention forward": "k1s", "K1 packed_attention backward": "k4b",
                    "K2 sparsemax": "k2", "K3 expected_value_decode_fused": "k3",
                    "K4 tiled_attention forward": "k4f", "K4 tiled_attention backward": "k4b",
                    "K5 fused_ln_mlp forward": "k5f", "K5 fused_ln_mlp backward": "k5b",
                    "K6 fused_attention": "k6"}
    for name in list(eval_counter):
        eval_counter[f"{name}, head-major"] = eval_counter[name]
    for entry in kernels:
        entry["phase17_launches"] = {run: c[eval_counter[entry["name"]]]
                                     for run, c in world17.items()}
        entry["phase18_launches"] = {run: c[eval_counter[entry["name"]]]
                                     for run, c in pipe18.items()}
        if entry.get("layout") == "head_major":
            continue  # no earlier phase runs the head-major layout
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
        entry["phase16_launches"] = {run: c[eval_counter[entry["name"]]]
                                     for run, c in int8_16.items()}
    # --------------------------------------------------------------- phase 20
    gc.collect()
    torch.cuda.empty_cache()
    p20 = phase20(torch, dev, card)

    # --------------------------------------------------------------- phase 21
    gc.collect()
    torch.cuda.empty_cache()
    p21 = phase21(torch, dev, card)

    kernels += phase19_kernels(p19, p20) + phase20_kernels(p20) + phase21_kernels(p21)
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
