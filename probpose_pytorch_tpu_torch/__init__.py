"""PyTorch/CUDA port of probpose-tpu's top-down serving path and its front
ends, training and evaluation.

The package mirrors the module names of the JAX package `probpose_pytorch_tpu`
(the reference it is tested against) but imports only torch and numpy:

    ops/preprocess.py     crop_resize (every JAX method), keypoint maps
    ops/quant.py          int8 weights, dynamic int8 rows, int8 products
    models/vit.py         ViTBackbone; attention goes through kernel K1
    models/head.py        ProbMapHead; sparsemax goes through kernel K2
    models/vit_int8.py    QuantizedViT, the int8 serving trunk
    models/convnet.py     ConvBackbone, the conv-s / conv-t trunks
    models/model.py       ModelConfig, ProbPoseModel, build_model
    ops/heatmap.py        expected-value decode, PCK distances
    ops/probmaps.py       OKS target maps (encode)
    ops/udp.py            argmax + DarkPose/UDP refinement
    ops/oks.py            OKS targets from decoded coordinates
    codec.py              ProbMap and ArgMaxProbMap: encode and decode
    losses.py             the five-term ProbPoseLoss and its metrics
    inference.py          TopDownPredictor (flip and scale test,
                          temperatures, predict_stream, predict_frame with
                          its buckets and OKS-NMS), load_predictor, the
                          single-image CLI (main)
    configs/              the serving record: batch and bucket ladder by card
    ops/oks_nms.py        pose OKS-NMS and soft OKS-NMS (numpy)
    serve/server.py       MicroBatcher, the HTTP server and its CLI
    serve/export.py       exported serving bundles (torch.export programs
                          of the pose, detector, bottom-up and fused
                          predictors, the weights stored once) and the
                          export CLI; they serve without model code
    video.py              frame sequences: OksTracker, run_video,
                          run_video_stream and the video CLI
    utils/smoothing.py    one-euro smoothing of tracked poses (numpy)
    eval/                 COCO keypoint AP, calibration, results files,
                          evaluate_topdown and the eval CLI (run.py)
    viz.py                keypoint overlays and reliability diagrams
    detect/               the person detector (CenterNet heads on the conv
                          trunk), its codec, loss, data, trainer and CLI,
                          DetectorPredictor, the single-stage BottomUpPredictor,
                          FusedTwoStagePredictor and the end-to-end evals
    doctor.py             the environment self-check
    ops/augment.py        on-device augmentation: draws and transforms
    data/                 synthetic poses, COCO and YOLO loaders, the crop
                          cache, batching and prefetch (host)
    native/               the C++ data plane (JPEG decode and crop-resize
                          on the host, resample="native"), built with g++
    train/                TrainConfig, AdamW + one-cycle + EMA (+ MultiSteps),
                          Trainer, checkpoints, the training CLI (cli.py)
    utils/logging.py      metrics.jsonl (and TensorBoard where installed)
    compat/from_jax.py    load the JAX package's weights and train state
    ops/kernels/          hand-written Hopper kernels, their plain versions,
                          the probpose:: ops of the serving launches, and
                          the nvcc builder for csrc/*.cu

Importing the package builds nothing: kernels are compiled at their first
launch on a CUDA tensor, the data plane at its first use.
"""

__version__ = "0.1.0"

# The JAX package's top-level names, bound on first use: importing one
# submodule (a serving bundle's loader, say) loads no model code.
_EXPORTS = {
    "codec": None, "losses": None, "models": None, "ops": None,
    "ArgMaxProbMap": "codec", "Codec": "codec", "ProbMap": "codec",
    "ProbPoseLoss": "losses",
    "ModelConfig": "models", "ProbMapHead": "models", "ProbPoseModel": "models",
    "ViTBackbone": "models", "build_model": "models",
}

__all__ = [n for n, m in _EXPORTS.items() if m is not None]


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f"{__name__}.{_EXPORTS[name] or name}")
    return module if _EXPORTS[name] is None else getattr(module, name)
