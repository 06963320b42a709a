"""Environment self-check (port of probpose_pytorch_tpu/doctor.py):
`python -m probpose_pytorch_tpu_torch.doctor`.

One command that shows what this host can do for the port: the card, the
nvcc build of csrc/ (ops/kernels/_build.py), a tiny pose model's forward
through the kernels (K1's short forward and K2), a person detector's
forward and decode, then the optional pieces: the native data plane, the
serving record for this card and the optional dependencies. One line per
check and a verdict; exit code 1 if a required check fails (optional ones
only warn). Every model check runs on the card.
"""

from __future__ import annotations

import subprocess
import sys
import time

__all__ = ["main"]


def _check(name: str, fn, required: bool = True) -> tuple[bool, str]:
    try:
        detail = fn() or "ok"
        return True, f"  [ok]   {name}: {detail}"
    except Exception as e:  # noqa: BLE001 — diagnostics surface everything
        tag = "FAIL" if required else "warn"
        return not required, f"  [{tag}] {name}: {e}"


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} ({smi}), " \
           f"torch {torch.__version__}, CUDA {torch.version.cuda}"


def kernel_build() -> str:
    from probpose_pytorch_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    report = _build.build_report()
    how = "built" if report.get("built") else "cached"
    return f"{report['path']} ({how} in {time.perf_counter() - t0:.1f}s)"


def model_forward(device: str = "cuda") -> str:
    """A tiny bf16 ViT (vit-nano, d = 32) + ProbMap head: its attention runs
    K1's short forward and its heatmaps K2, counted by their wrappers."""
    import torch

    from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import short_forward
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_rows

    cfg = ModelConfig(img_size=(64, 48), num_keypoints=5, backbone="vit-nano",
                      compute_dtype="bfloat16", attn_impl="fused",
                      deconv_out_channels=(16, 16), pool_sizes=((2, 2), (2, 2)))
    model = build_model(cfg, device=device)
    k1, k2 = short_forward.launches, sparsemax_rows.launches
    with torch.inference_mode():
        out = model(torch.zeros(1, 64, 48, 3, device=device))
    if not all(bool(torch.isfinite(t.float()).all()) for t in out):
        raise RuntimeError("non-finite outputs")
    return (f"heatmaps {tuple(out[0].shape)}; K1 short forward x"
            f"{short_forward.launches - k1}, K2 x{sparsemax_rows.launches - k2}")


def detector_forward(device: str = "cuda") -> str:
    import torch

    from probpose_pytorch_tpu_torch.detect.codec import decode_boxes
    from probpose_pytorch_tpu_torch.detect.model import PersonDetector, init_detector_weights
    from probpose_pytorch_tpu_torch.models.model import resolve_device

    model = PersonDetector(img_size=(64, 64), preset="conv-t")
    init_detector_weights(model, torch.Generator().manual_seed(0))
    model = model.to(resolve_device(device, "detector forward")).eval()
    with torch.inference_mode():
        out = model(torch.zeros(1, 64, 64, 3, device=device))
        boxes, scores = decode_boxes(out["center"], out["size"], out["offset"], k=4)
    if not bool(torch.isfinite(boxes).all()):
        raise RuntimeError("non-finite boxes")
    return f"boxes {tuple(boxes.shape)}"


def native() -> str:
    from probpose_pytorch_tpu_torch import native as plane

    if not plane.native_available():
        raise RuntimeError(f"C++ data plane unavailable ({plane.build_report().get('reason')}); "
                           "resample='native' raises, the other resamplers decode with PIL")
    report = plane.build_report()
    if not report["jpeg"]:
        raise RuntimeError("C++ data plane built with its crop-resize half only (jpeglib.h not "
                           "found): native JPEG decode raises")
    return "crop-resize and JPEG halves built (libjpeg linked)"


def serving_record() -> str:
    from probpose_pytorch_tpu_torch.inference import tuned_bucket_ladder, tuned_serving_batch

    ladder = tuned_bucket_ladder()
    if ladder:
        return f"batch {tuned_serving_batch()}, ladder {ladder}"
    return f"batch {tuned_serving_batch()} (no entry for this card)"


def optional_deps() -> str:
    have = []
    for mod in ("PIL", "matplotlib", "tensorboard", "scipy"):
        try:
            __import__(mod)
            have.append(mod)
        except ImportError:
            pass
    return ", ".join(have) or "none"


CHECKS = (
    ("card", card, True),
    ("kernel build (nvcc, csrc/)", kernel_build, True),
    ("model forward (tiny ViT + head, K1 + K2)", model_forward, True),
    ("person detector forward + decode", detector_forward, True),
    ("native data plane", native, False),
    ("serving record", serving_record, False),
    ("optional deps", optional_deps, False),
)


def main(argv=None) -> None:
    print("probpose-tpu doctor (PyTorch port)")
    ok = True
    for name, fn, required in CHECKS:
        good, line = _check(name, fn, required)
        print(line, flush=True)
        ok &= good
    print("verdict:", "healthy" if ok else "REQUIRED CHECKS FAILED")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
