"""PyTorch/CUDA port of probpose-tpu's top-down serving path, training and
evaluation.

The package mirrors the module names of the JAX package `probpose_pytorch_tpu`
(the reference it is tested against) but imports only torch and numpy:

    ops/preprocess.py     crop_resize ("bilinear_matmul"), keypoint maps
    models/vit.py         ViTBackbone; attention goes through kernel K1
    models/head.py        ProbMapHead; sparsemax goes through kernel K2
    models/model.py       ModelConfig, ProbPoseModel, build_model
    ops/heatmap.py        expected-value decode, PCK distances
    ops/probmaps.py       OKS target maps (encode)
    ops/udp.py            argmax + DarkPose/UDP refinement
    ops/oks.py            OKS targets from decoded coordinates
    codec.py              ProbMap and ArgMaxProbMap: encode and decode
    losses.py             the five-term ProbPoseLoss and its metrics
    inference.py          TopDownPredictor (flip and scale test,
                          temperatures, predict_stream), load_predictor
    eval/                 COCO keypoint AP, calibration, results files,
                          evaluate_topdown and the eval CLI (run.py)
    viz.py                keypoint overlays and reliability diagrams
    ops/augment.py        on-device augmentation: draws and transforms
    data/                 synthetic poses, COCO and YOLO loaders, the crop
                          cache, batching and prefetch (host)
    train/                TrainConfig, AdamW + one-cycle + EMA (+ MultiSteps),
                          Trainer, checkpoints, the training CLI (cli.py)
    utils/logging.py      metrics.jsonl (and TensorBoard where installed)
    compat/from_jax.py    load the JAX package's weights and train state
    ops/kernels/          hand-written Hopper kernels, their plain versions,
                          and the nvcc builder for csrc/*.cu

Importing the package builds nothing: kernels are compiled at their first
launch on a CUDA tensor.
"""

__all__: list[str] = []
