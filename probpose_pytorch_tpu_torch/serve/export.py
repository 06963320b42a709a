"""Serving bundles (port of probpose_pytorch_tpu/serve/export.py): export a
predictor's whole serving program, reload it without model code.

`export_predictor_bundle` traces `TopDownPredictor.predict` -- per-box crop
and resize, trunk, head, decode, un-mapping to frame space, flip and scale
test and temperatures -- with `torch.export`, once per batch bucket, and
writes a directory:

    bundle/
      manifest.json      # version, format, buckets, frame shape, input size,
                         # platforms, device, TTA, calibration, indexed buckets
      params.pt          # the weights, once: a flat {name: tensor} dict
      fn_b{B}.pt2.gz     # one exported program per bucket (gzip of a .pt2)
      fn_b{B}_f.pt2.gz   # with `indexed`: the frame-indexed program of B

The programs take the weights as inputs, as JAX's take their variables, so
a bundle holds them once however many programs it has. Each unique frame of
an indexed call crosses to the device once; its program takes F frames for
any F of `indexed_buckets[B]` (the powers of two up to B, and B itself, as
JAX's `_pow2_ladder`): one program with a dynamic frame count where JAX
writes one per F, and the loader accepts exactly JAX's counts.

On the card the kernels are `probpose::` custom ops (ops/kernels/), each one
node of the exported graph: a loaded program launches the same K1, K2, K4,
K5 or K6 kernel as the live predictor, and counts its launches on the same
wrapper. `ServingBundle.load` registers the ops first and imports nothing
of the port's models, training, codecs or predictors: the serving host
needs torch and numpy. A program runs on the device it was exported for; a
bundle exported for several platforms (`platforms=("cpu", "cuda")`) is
traced with the plain versions (`plain_versions()`), as JAX traces its
portable bundles with the XLA sparsemax, and moves to the device it is
loaded on.

`export_detector_bundle`, `export_bottomup_bundle` and `export_fused_bundle`
write the detector, single-stage and fused two-stage programs the same way
(JAX :401-927); their classes duck-type the live predictors, so every
--detector, --bottomup and --fused surface takes either.

    python -m probpose_pytorch_tpu_torch.serve.export --checkpoint runs/x/checkpoints \\
        --out bundle/ --buckets 1,64 --frame-size 1088,1920 [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gzip
import io
import json
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = [
    "BUNDLE_VERSION",
    "BottomUpBundle",
    "DetectorBundle",
    "FusedBundle",
    "ServingBundle",
    "export_bottomup_bundle",
    "export_detector_bundle",
    "export_fused_bundle",
    "export_predictor_bundle",
    "main",
]

BUNDLE_VERSION = 2  # as JAX's: bottom-up programs return a 4-tuple
FORMAT = "torch.export"  # manifest["format"], which JAX's bundles lack
PLATFORMS = ("cpu", "cuda")
PARAMS = "params.pt"


def _pow2_ladder(top: int) -> list[int]:
    """Powers of two up to `top`, plus `top` itself: callers pad the
    unique-frame count to min(next_pow2(F), bucket), so a bucket that is no
    power of two needs its own rung (JAX :66)."""
    out, f = [], 1
    while f <= top:
        out.append(f)
        f *= 2
    if out[-1] != top:
        out.append(top)
    return out


def _platforms(platforms: Sequence[str] | None, device: torch.device) -> tuple[list[str], bool]:
    """(the manifest's platforms, whether the bundle is portable: exported
    for more than the device it is traced on)."""
    if not platforms:
        return [device.type], False
    platforms = list(platforms)
    bad = sorted(set(platforms) - set(PLATFORMS))
    if bad:
        raise ValueError(f"unknown platforms {bad} (the port exports for {PLATFORMS})")
    return platforms, set(platforms) != {device.type}


def _weights(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Every parameter and buffer of `module` by name, detached."""
    out = {k: v.detach() for k, v in module.named_parameters()}
    out.update({k: v.detach() for k, v in module.named_buffers()})
    return out


class _Program(torch.nn.Module):
    """`fn(*inputs)` with the weights of `modules` as inputs: forward(weights,
    *inputs), weights a {module name: {param name: tensor}} dict. The
    modules are held outside the module tree, so the exported program lifts
    none of their tensors."""

    def __init__(self, fn: Callable, modules: dict[str, torch.nn.Module]):
        super().__init__()
        body = torch.nn.Module()
        for name, m in modules.items():
            body.add_module(name, m)
        body.forward = fn
        object.__setattr__(self, "_body", body)

    def forward(self, weights: dict, *inputs):
        flat = {f"{name}.{k}": v for name, ws in weights.items() for k, v in ws.items()}
        return torch.func.functional_call(self._body, flat, inputs)


class _Undecorated:
    """A live predictor whose `predict` runs without its inference_mode
    decorator: export traces under no_grad. Everything else is the
    predictor's own."""

    def __init__(self, predictor):
        object.__setattr__(self, "_p", predictor)

    def __getattr__(self, name):
        return getattr(self._p, name)

    def predict(self, *args):
        return type(self._p).predict.__wrapped__(self._p, *args)


def _traced_copy(predictor):
    """A shallow copy of a pose predictor with its own copy of the codec:
    the codec caches its operators by device, and the trace must not leave
    fake tensors in the live predictor's cache."""
    return dataclasses.replace(predictor, codec=copy.deepcopy(predictor.codec))


def _export(make_fn: Callable[[], Callable], modules: dict[str, torch.nn.Module], inputs: tuple,
            dynamic_shapes=None) -> torch.export.ExportedProgram:
    """One program of `make_fn()` on `inputs`. The function is made afresh
    for each trace and run once on the inputs before it: its codec's
    operator caches then hold device tensors, which the program keeps as
    constants on the device (a cache filled while tracing would hold
    fakes, and tensors made from host data would be copied to the device
    on every call, a synchronising copy)."""
    weights = {name: _weights(m) for name, m in modules.items()}
    fn = make_fn()
    program = _Program(fn, modules)
    with torch.no_grad():
        fn(*inputs)
        ds = None
        if dynamic_shapes is not None:
            static = {name: dict.fromkeys(ws) for name, ws in weights.items()}
            ds = (static, tuple(dynamic_shapes))
        ep = torch.export.export(program, (weights, *inputs), dynamic_shapes=ds)
    _restore_cudnn_args(ep)
    return ep


def _restore_cudnn_args(ep: torch.export.ExportedProgram) -> None:
    """torch.export traces with cuDNN switched off, and so records
    `cudnn_enabled=False` in every op that takes the flag as an argument
    (aten.batch_norm): the program would run the native BatchNorm where
    eager runs cuDNN's, in other bits. Record the flag as eager passes it,
    `torch.backends.cudnn.enabled` of the exporting process."""
    enabled = torch.backends.cudnn.enabled
    for node in ep.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op != "call_function" or schema is None:
            continue
        for i, arg in enumerate(schema.arguments):
            if arg.name in ("cudnn_enabled", "cudnn_enable") and i < len(node.args):
                node.update_arg(i, enabled)
    ep.graph_module.recompile()


def _save_program(ep: torch.export.ExportedProgram, path: Path) -> None:
    """The program without its example inputs (they hold the weights) and
    without the tracing host's stack traces, gzipped."""
    ep.example_inputs = None
    for node in ep.graph.nodes:
        for key in ("stack_trace", "nn_module_stack", "source_fn_stack", "from_node"):
            node.meta.pop(key, None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    path.write_bytes(gzip.compress(buf.getvalue(), compresslevel=6))


def _load_program(path: Path, exported_on: str, device: torch.device) -> torch.nn.Module:
    """The callable of one saved program, on `device`. The `probpose::`
    ops are registered before the program is read."""
    from probpose_pytorch_tpu_torch.ops.kernels import register_ops

    register_ops()
    ep = torch.export.load(io.BytesIO(gzip.decompress(path.read_bytes())))
    if device.type != exported_on:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    return ep.module()


def _save_weights(path: Path, weights: dict[str, torch.Tensor]) -> None:
    torch.save({k: v.detach().cpu().contiguous() for k, v in weights.items()}, path)


def _write_manifest(out_dir: Path, manifest: dict) -> None:
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _resolve_device(device, platforms: Sequence[str], directory: Path) -> torch.device:
    """The device to serve on: the card unless the caller asks for the CPU;
    one the bundle was not exported for raises, and so does a card the host
    does not have."""
    device = torch.device(device)
    if device.type not in platforms:
        raise ValueError(
            f"{directory} was exported for {list(platforms)}, not for {device.type!r}; "
            "load it on its device or re-export it with --platforms "
            f"{','.join(sorted(set(platforms) | {device.type}))}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{directory}: device {str(device)!r} asked for, but torch sees no "
                           "CUDA device; pass device='cpu' for a bundle exported for the CPU")
    return device


def _read_manifest(directory: Path, kind: str, wrong: Callable[[dict], str]) -> dict:
    """The manifest of a port bundle of `kind`; a JAX bundle, another kind
    or another version raises ValueError."""
    manifest = json.loads((directory / "manifest.json").read_text())
    if manifest.get("format") != FORMAT and any(directory.glob("*.bin")):
        raise ValueError(
            f"{directory} is a JAX bundle (jax.export programs, *.bin); the PyTorch port "
            "serves bundles of its own export CLI: python -m "
            "probpose_pytorch_tpu_torch.serve.export")
    if manifest.get("kind", "pose") != kind:
        raise ValueError(wrong(manifest))
    if manifest.get("version") != BUNDLE_VERSION:
        raise ValueError(f"bundle version {manifest.get('version')} != {BUNDLE_VERSION} "
                         "(re-export with this release)")
    return manifest


def _load_weights(directory: Path, device: torch.device) -> dict[str, torch.Tensor]:
    return torch.load(directory / PARAMS, map_location=device, weights_only=True)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` on `device`. To a card through pinned memory and a copy on the
    current stream that the host does not wait for: a pageable copy would
    synchronise, and dispatch must not."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_numpy(out) -> Any:
    if isinstance(out, dict):
        return {k: v.float().cpu().numpy() for k, v in out.items()}
    return tuple(v.float().cpu().numpy() for v in out)


def _fit_shape(shapes, H: int, W: int) -> tuple[int, int]:
    fit = [s for s in shapes if s[0] >= H and s[1] >= W]
    if not fit:
        raise ValueError(f"frame {(H, W)} exceeds every exported shape {shapes}")
    return min(fit)


def _check_exportable(predictor, what: str) -> None:
    if getattr(predictor, "mesh", None) is not None:  # JAX's refusal (serve/export.py there)
        raise ValueError("bundle export is single-device; pass a mesh-free predictor "
                         "(data-parallel serving replicates single-device bundles)")


# --------------------------------------------------------------------------
# top-down pose bundles


def export_predictor_bundle(
    predictor: Any,
    out_dir: str | Path,
    buckets: Sequence[int],
    frame_shape: tuple[int, int],
    platforms: Sequence[str] | None = None,
    indexed: bool = True,
) -> Path:
    """Export `predictor` (a TopDownPredictor) as a serving bundle.

    buckets: ascending batch sizes; each becomes one exported program.
    frame_shape: (H, W) of the frames the bundle accepts (smaller frames
        zero-pad up at serve time).
    platforms: devices the programs run on, "cpu" and/or "cuda" (default:
        the predictor's). A set beyond the predictor's device is traced with
        the plain versions, and an attention that is a kernel refuses it.
    indexed: also export the frame-indexed programs: each unique frame then
        crosses to the device once per dispatch instead of once per crop.
    """
    from probpose_pytorch_tpu_torch.ops import kernels

    _check_exportable(predictor, "bundle export")
    buckets = tuple(sorted(int(b) for b in buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"invalid buckets {buckets}")
    Hf, Wf = (int(v) for v in frame_shape)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = _module_device(predictor.model)
    platforms, portable = _platforms(platforms, device)
    if portable:
        attn = next((m.impl for m in predictor.model.modules()
                     if type(m).__name__ == "Attention"), "einsum")
        if attn in ("fused", "fused_tp", "pallas"):
            raise ValueError(
                f"multi-platform export with attn_impl={attn!r}: the packed attention is a "
                "kernel of one device -- export per-platform, or rebuild the predictor with "
                "attn_impl='einsum' for a portable bundle")
    make = lambda: _Undecorated(_traced_copy(predictor)).predict  # noqa: E731
    modules = {"model": predictor.model}
    frames = lambda n: torch.zeros((n, Hf, Wf, 3), dtype=torch.uint8, device=device)  # noqa: E731
    indexed_buckets: dict[str, list[int]] = {}
    with kernels.plain_versions() if portable else contextlib.nullcontext():
        for b in buckets:
            boxes = torch.tensor([[0.0, 0.0, Wf, Hf]], device=device).repeat(b, 1)
            _save_program(_export(make, modules, (frames(b), boxes)), out_dir / f"fn_b{b}.pt2.gz")
            if indexed and b > 1:
                ids = torch.zeros((b,), dtype=torch.int64, device=device)
                f = torch.export.Dim(f"frames_b{b}", min=1, max=b)
                ep = _export(make, modules, (frames(2), boxes, ids),
                             dynamic_shapes=({0: f}, None, None))
                _save_program(ep, out_dir / f"fn_b{b}_f.pt2.gz")
                indexed_buckets[str(b)] = _pow2_ladder(b)
    _save_weights(out_dir / PARAMS, _weights(predictor.model))
    _write_manifest(out_dir, {
        "version": BUNDLE_VERSION,
        "format": FORMAT,
        "buckets": list(buckets),
        "frame_shape": [Hf, Wf],
        "input_size": list(predictor.input_size),
        "platforms": platforms,
        "device": device.type,
        "return_heatmaps": bool(predictor.return_heatmaps),
        # Informational: the TTA baked into the programs.
        "flip_test": bool(getattr(predictor, "flip_test", False)),
        "scale_test": list(getattr(predictor, "scale_test", ()) or ()),
        "calibration": {k: float(t)
                        for k, t in (getattr(predictor, "calibration", None) or {}).items()},
        "indexed_buckets": indexed_buckets,
    })
    return out_dir


@dataclasses.dataclass
class ServingBundle:
    """A loaded serving bundle: frames + boxes -> keypoints, no model code.
    Programs load lazily, per bucket, on first use."""

    directory: Path
    manifest: dict
    variables: dict
    device: torch.device | None = None
    # loaded programs, keyed (bucket, indexed)
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.device is None:
            self.device = next(iter(self.variables.values())).device
        self.device = torch.device(self.device)

    @classmethod
    def load(cls, directory: str | Path, device: torch.device | str = "cuda") -> "ServingBundle":
        """The bundle in `directory`, served on `device` (the card unless
        the caller asks for the CPU)."""
        directory = Path(directory)
        manifest = _read_manifest(directory, "pose", lambda m: (
            f"{directory} is a {m['kind']!r} bundle, not a pose bundle (detector bundles "
            "load with DetectorBundle)"))
        device = _resolve_device(device, manifest["platforms"], directory)
        return cls(directory=directory, manifest=manifest,
                   variables=_load_weights(directory, device), device=device)

    @property
    def buckets(self) -> tuple[int, ...]:
        return tuple(self.manifest["buckets"])

    @property
    def frame_shape(self) -> tuple[int, int]:
        return tuple(self.manifest["frame_shape"])

    @property
    def input_size(self) -> tuple[int, int]:
        """(H, W) crop size baked into the programs: TopDownPredictor's
        contract (the eval pipeline reads it)."""
        return tuple(self.manifest["input_size"])

    @property
    def indexed_buckets(self) -> dict[int, tuple[int, ...]]:
        """{crop bucket: exported unique-frame counts}; empty for bundles
        exported with indexed=False."""
        return {int(b): tuple(fs) for b, fs in self.manifest.get("indexed_buckets", {}).items()}

    def _program(self, bucket: int, indexed: bool = False) -> torch.nn.Module:
        key = (bucket, indexed)
        if key not in self._programs:
            name = f"fn_b{bucket}_f.pt2.gz" if indexed else f"fn_b{bucket}.pt2.gz"
            self._programs[key] = _load_program(self.directory / name, self.manifest["device"],
                                                self.device)
        return self._programs[key]

    def _upload(self, a: np.ndarray, dtype) -> torch.Tensor:
        return _upload(np.require(a, dtype, ("C", "W")), self.device)

    def dispatch(self, frames: np.ndarray, boxes: np.ndarray,
                 frame_ids: np.ndarray | None = None) -> dict[str, torch.Tensor]:
        """Upload one batch and launch its program; returns the outputs on
        the device, still being computed there (no synchronisation): the
        server's pipelined path. `__call__` is this plus the download."""
        b = len(boxes)
        if b not in self.buckets:
            raise ValueError(f"batch {b} is not an exported bucket {self.buckets}")
        frames = self._pad_frames(np.asarray(frames, np.uint8))
        w = {"model": self.variables}
        if frame_ids is not None:
            fs = self.indexed_buckets.get(b, ())
            f = len(frames)
            if f not in fs:
                if f == b:
                    # no indexed program but one frame per crop anyway
                    # (e.g. bucket 1): the gather is free on the host
                    return self._program(b)(
                        w, self._upload(frames[np.asarray(frame_ids, np.int64)], np.uint8),
                        self._upload(boxes, np.float32))
                raise ValueError(f"unique-frame count {f} not exported for bucket {b} "
                                 f"(available: {fs})")
            return self._program(b, True)(w, self._upload(frames, np.uint8),
                                          self._upload(boxes, np.float32),
                                          self._upload(frame_ids, np.int64))
        if len(frames) != b:
            raise ValueError(f"{len(frames)} frames != {b} boxes (pass frame_ids for "
                             "indexed serving)")
        return self._program(b)(w, self._upload(frames, np.uint8), self._upload(boxes, np.float32))

    # the MicroBatcher's names for the launch and the readback
    _dispatch = dispatch

    @staticmethod
    def _download(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        return _to_numpy(out)

    def __call__(self, frames: np.ndarray, boxes: np.ndarray,
                 frame_ids: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """frames (B, H, W, 3) uint8 with (H, W) <= the exported frame shape
        (zero-padded up); boxes (B, 4) xywh, B an exported bucket. Returns
        numpy arrays (frame-space keypoints etc.). With frame_ids (B,),
        frames holds each unique frame once, a count of
        `indexed_buckets[B]` (pad with blank frames)."""
        return _to_numpy(self.dispatch(frames, boxes, frame_ids))

    def _pad_frames(self, frames: np.ndarray) -> np.ndarray:
        Hf, Wf = self.frame_shape
        B, H, W, C = frames.shape
        if (H, W) == (Hf, Wf):
            return frames
        if H > Hf or W > Wf:
            raise ValueError(f"frame {(H, W)} exceeds the exported shape {(Hf, Wf)}")
        return np.pad(frames, ((0, 0), (0, Hf - H), (0, Wf - W), (0, 0)))

    def predict_stream(self, batches, depth: int = 2):
        """Stream serving over (frames, boxes[, frame_ids]) batches: uploads
        and launches run on a worker thread while this thread downloads, so
        batch i+1's upload overlaps batch i's compute. Yields the output
        dicts in order."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as pool:
            for item in batches:
                b = len(item[1])
                if b not in self.buckets:
                    raise ValueError(f"batch {b} is not an exported bucket {self.buckets}")
                pending.append(pool.submit(self.dispatch, *item))
                if len(pending) > depth:
                    yield _to_numpy(pending.popleft().result())
            while pending:
                yield _to_numpy(pending.popleft().result())

    def predict_frame(self, frame: np.ndarray, boxes: np.ndarray) -> dict:
        """Variable-count boxes on one frame: the box list pads to the next
        exported bucket (chunked past the largest) and the padding is
        stripped: TopDownPredictor.predict_frame on the bundle's side."""
        n = len(boxes)
        if n == 0:
            return {}
        top = self.buckets[-1]
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:
            parts = [self.predict_frame(frame, boxes[i:i + top]) for i in range(0, n, top)]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        boxes = np.asarray(boxes, np.float32)
        padded = np.concatenate([boxes, np.tile(boxes[-1:], (bucket - n, 1))], axis=0)
        frame = np.asarray(frame, np.uint8)
        if 1 in self.indexed_buckets.get(bucket, ()):
            # one frame upload instead of `bucket` (indexed program)
            out = self(frame[None], padded, np.zeros((bucket,), np.int64))
        else:
            out = self(np.broadcast_to(frame, (bucket, *frame.shape)), padded)
        return {k: v[:n] for k, v in out.items()}


# --------------------------------------------------------------------------
# person detector bundles


def export_detector_bundle(
    detector: Any,
    out_dir: str | Path,
    frame_shapes: Sequence[tuple[int, int]],
    platforms: Sequence[str] | None = None,
) -> Path:
    """Export a `detect.DetectorPredictor` as a codeless bundle: one program
    per accepted (H, W) frame shape, batch 1 (detection is per frame).
    Smaller frames zero-pad to the closest exported shape at serve time
    (bottom/right: decoded coordinates are unchanged). The detector runs no
    kernel (convolutions, BatchNorm and resizes are PyTorch's), so any
    platform set traces as it is."""
    _check_exportable(detector, "detector bundle export")
    shapes = sorted({(int(h), int(w)) for h, w in frame_shapes})
    if not shapes:
        raise ValueError("need at least one frame shape")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = _module_device(detector.model)
    platforms, _ = _platforms(platforms, device)
    make = lambda: _Undecorated(detector).predict  # noqa: E731
    modules = {"model": detector.model}
    for H, W in shapes:
        frames = torch.zeros((1, H, W, 3), dtype=torch.uint8, device=device)
        _save_program(_export(make, modules, (frames,)), out_dir / f"det_h{H}w{W}.pt2.gz")
    _save_weights(out_dir / PARAMS, _weights(detector.model))
    _write_manifest(out_dir, {
        "version": BUNDLE_VERSION,
        "format": FORMAT,
        "kind": "detector",
        "frame_shapes": [list(s) for s in shapes],
        "score_threshold": float(detector.score_threshold),
        "max_detections": int(detector.max_detections),
        "img_size": list(detector.model.img_size),
        "platforms": platforms,
        "device": device.type,
    })
    return out_dir


class _FrameBundle:
    """What the frame-batch bundles share: the manifest's shapes and
    batches, the lazy programs and the shape fit."""

    @property
    def frame_shapes(self) -> tuple[tuple[int, int], ...]:
        return tuple(tuple(s) for s in self.manifest["frame_shapes"])

    @property
    def batches(self) -> tuple[int, ...]:
        return tuple(self.manifest.get("batches", (1,)))

    @property
    def score_threshold(self) -> float:
        return float(self.manifest["score_threshold"])

    def _fit_shape(self, H: int, W: int) -> tuple[int, int]:
        return _fit_shape(self.frame_shapes, H, W)

    def _program(self, name: str) -> torch.nn.Module:
        if name not in self._programs:
            self._programs[name] = _load_program(self.directory / name, self.manifest["device"],
                                                 self.device)
        return self._programs[name]

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return _upload(np.require(frames, np.uint8, ("C", "W")), self.device)

    def _check_exported(self, frames: np.ndarray) -> None:
        B, H, W = frames.shape[:3]
        if B not in self.batches or (H, W) not in self.frame_shapes:
            raise ValueError(f"batch {B} / frame {(H, W)} not exported (batches "
                             f"{self.batches}, shapes {self.frame_shapes})")


def _load_frame_bundle(cls, directory, device, kind: str, wrong: Callable[[dict], str],
                       split: Callable[[dict], dict]):
    directory = Path(directory)
    manifest = _read_manifest(directory, kind, wrong)
    device = _resolve_device(device, manifest["platforms"], directory)
    return cls(directory=directory, manifest=manifest,
               **split(_load_weights(directory, device)), device=device)


@dataclasses.dataclass
class DetectorBundle(_FrameBundle):
    """A loaded detector bundle: frame -> (boxes, scores), no model code.
    Duck-types `detect.DetectorPredictor.detect_frame`, so it drops into
    every --detector surface."""

    directory: Path
    manifest: dict
    variables: dict
    device: torch.device | None = None
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device or next(iter(self.variables.values())).device)

    @classmethod
    def load(cls, directory: str | Path, device: torch.device | str = "cuda") -> "DetectorBundle":
        return _load_frame_bundle(cls, directory, device, "detector", lambda m: (
            f"{directory} is not a detector bundle (kind={m.get('kind')!r}; pose bundles load "
            "with ServingBundle)"), lambda w: {"variables": w})

    @property
    def max_detections(self) -> int:
        return int(self.manifest["max_detections"])

    def detect_frame(self, frame: np.ndarray, score_threshold: float | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """One (H, W, 3) uint8 frame -> (boxes (n, 4), scores (n,)) above
        the threshold, in frame pixels."""
        frame = np.asarray(frame, np.uint8)
        H, W = frame.shape[:2]
        He, We = self._fit_shape(H, W)
        if (H, W) != (He, We):
            frame = np.pad(frame, ((0, He - H), (0, We - W), (0, 0)))
        boxes, scores = _to_numpy(self._program(f"det_h{He}w{We}.pt2.gz")(
            {"model": self.variables}, self._upload(frame[None])))
        thr = self.score_threshold if score_threshold is None else score_threshold
        keep = scores[0] >= thr
        return boxes[0][keep], scores[0][keep]


# --------------------------------------------------------------------------
# single-stage (bottom-up) pose bundles


def export_bottomup_bundle(
    predictor: Any,
    out_dir: str | Path,
    frame_shapes: Sequence[tuple[int, int]],
    batches: Sequence[int] = (1,),
    platforms: Sequence[str] | None = None,
) -> Path:
    """Export a `detect.BottomUpPredictor` as a codeless bundle: one program
    per (batch bucket, frame shape), returning (boxes, scores, keypoints,
    keypoint_scores), JAX's version-2 tuple. Smaller frames zero-pad to the
    closest exported shape; short batches pad with zero frames and are
    trimmed."""
    _check_exportable(predictor, "bottom-up bundle export")
    shapes = sorted({(int(h), int(w)) for h, w in frame_shapes})
    buckets = sorted({int(b) for b in batches})
    if not shapes or not buckets or buckets[0] < 1:
        raise ValueError("need at least one frame shape and batch >= 1")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = _module_device(predictor.model)
    platforms, _ = _platforms(platforms, device)
    live = _Undecorated(predictor)

    def fn(frames):
        out = live.predict(frames)
        return out["boxes"], out["scores"], out["keypoints"], out["keypoint_scores"]

    for B in buckets:
        for H, W in shapes:
            frames = torch.zeros((B, H, W, 3), dtype=torch.uint8, device=device)
            _save_program(_export(lambda: fn, {"model": predictor.model}, (frames,)),
                          out_dir / f"bu_b{B}_h{H}w{W}.pt2.gz")
    _save_weights(out_dir / PARAMS, _weights(predictor.model))
    _write_manifest(out_dir, {
        "version": BUNDLE_VERSION,
        "format": FORMAT,
        "kind": "bottomup",
        "frame_shapes": [list(s) for s in shapes],
        "batches": buckets,
        "score_threshold": float(predictor.score_threshold),
        "max_detections": int(predictor.max_detections),
        "img_size": list(predictor.model.img_size),
        "num_keypoints": int(predictor.model.num_keypoints),
        "kpt_heatmaps": bool(getattr(predictor.model, "kpt_heatmaps", False)),
        "platforms": platforms,
        "device": device.type,
    })
    return out_dir


@dataclasses.dataclass
class BottomUpBundle(_FrameBundle):
    """A loaded single-stage pose bundle: frames -> every person's pose in
    one forward per frame, no model code. Duck-types
    `detect.BottomUpPredictor` (`dispatch`, `__call__`, `predict_frame`)."""

    directory: Path
    manifest: dict
    variables: dict
    device: torch.device | None = None
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device or next(iter(self.variables.values())).device)

    @classmethod
    def load(cls, directory: str | Path, device: torch.device | str = "cuda") -> "BottomUpBundle":
        return _load_frame_bundle(cls, directory, device, "bottomup", lambda m: (
            f"{directory} is not a bottom-up pose bundle (kind={m.get('kind')!r})"),
            lambda w: {"variables": w})

    def _run(self, frames: np.ndarray):
        B, H, W = frames.shape[:3]
        return self._program(f"bu_b{B}_h{H}w{W}.pt2.gz")({"model": self.variables},
                                                        self._upload(frames))

    def dispatch(self, frames: np.ndarray) -> dict[str, torch.Tensor]:
        """Launch one batch at an exported (batch, frame shape) exactly (the
        micro-batcher pads to both); the outputs (boxes, scores, keypoints,
        keypoint_scores) stay on the device, still being computed."""
        frames = np.asarray(frames, np.uint8)
        self._check_exported(frames)
        boxes, scores, poses, kscores = self._run(frames)
        return dict(boxes=boxes, scores=scores, keypoints=poses, keypoint_scores=kscores)

    def __call__(self, frames: np.ndarray) -> tuple[np.ndarray, ...]:
        """frames (B, H, W, 3) uint8 -> (boxes (B, K, 4), scores (B, K),
        poses (B, K, Kj, 2), keypoint_scores (B, K, Kj)), frame pixels,
        unthresholded. B splits greedily over the batch buckets (the
        largest that fits, else the smallest, zero-padded)."""
        frames = np.asarray(frames, np.uint8)
        B, H, W = frames.shape[:3]
        He, We = self._fit_shape(H, W)
        if (H, W) != (He, We):
            frames = np.pad(frames, ((0, 0), (0, He - H), (0, We - W), (0, 0)))
        outs: list[tuple] = []
        i = 0
        while i < B:
            left = B - i
            fits = [b for b in self.batches if b <= left]
            b = max(fits) if fits else min(self.batches)
            chunk = frames[i:i + min(b, left)]
            if len(chunk) < b:
                chunk = np.pad(chunk, ((0, b - len(chunk)), (0, 0), (0, 0), (0, 0)))
            n = min(b, left)
            outs.append(tuple(v[:n] for v in _to_numpy(self._run(chunk))))
            i += n
        return tuple(np.concatenate([o[j] for o in outs]) for j in range(4))

    def predict_frame(self, frame: np.ndarray, score_threshold: float | None = None
                      ) -> dict[str, np.ndarray]:
        """One frame -> dict(keypoints (n, Kj, 2), scores (n,), boxes (n, 4),
        keypoint_scores (n, Kj)) above the threshold, frame pixels."""
        thr = self.score_threshold if score_threshold is None else score_threshold
        boxes, scores, poses, kscores = self(np.asarray(frame, np.uint8)[None])
        keep = scores[0] >= thr
        return dict(keypoints=poses[0][keep], scores=scores[0][keep], boxes=boxes[0][keep],
                    keypoint_scores=kscores[0][keep])


# --------------------------------------------------------------------------
# fused two-stage bundles


def export_fused_bundle(
    predictor,
    out_dir: str | Path,
    frame_shapes: Sequence[tuple[int, int]],
    batches: Sequence[int] = (1,),
    platforms: Sequence[str] | None = None,
) -> Path:
    """Export a `detect.FusedTwoStagePredictor` (detector -> crops -> pose,
    detect/fused.py) as a codeless bundle: one program per (batch, frame
    shape), both stages' weights in one file (prefixed det/ and pose/)."""
    from probpose_pytorch_tpu_torch.ops import kernels

    _check_exportable(predictor.pose, "fused bundle export")
    shapes = sorted({(int(h), int(w)) for h, w in frame_shapes})
    buckets = sorted({int(b) for b in batches})
    if not shapes or not buckets or buckets[0] < 1:
        raise ValueError("need at least one frame shape and batch >= 1")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = _module_device(predictor.pose.model)
    platforms, portable = _platforms(platforms, device)

    def make():
        traced = copy.copy(predictor)
        traced.detector = _Undecorated(predictor.detector)
        traced.pose = _Undecorated(_traced_copy(predictor.pose))
        return lambda frames: type(predictor).predict.__wrapped__(traced, frames)

    modules = {"det": predictor.detector.model, "pose": predictor.pose.model}
    with kernels.plain_versions() if portable else contextlib.nullcontext():
        for B in buckets:
            for H, W in shapes:
                frames = torch.zeros((B, H, W, 3), dtype=torch.uint8, device=device)
                _save_program(_export(make, modules, (frames,)),
                              out_dir / f"fused_b{B}_h{H}w{W}.pt2.gz")
    flat = {f"det/{k}": v for k, v in _weights(predictor.detector.model).items()}
    flat.update({f"pose/{k}": v for k, v in _weights(predictor.pose.model).items()})
    _save_weights(out_dir / PARAMS, flat)
    _write_manifest(out_dir, {
        "version": BUNDLE_VERSION,
        "format": FORMAT,
        "kind": "fused",
        "frame_shapes": [list(s) for s in shapes],
        "batches": buckets,
        "score_threshold": float(predictor.score_threshold),
        "max_people": int(predictor.max_people),
        "bbox_scale": float(predictor.bbox_scale),
        "platforms": platforms,
        "device": device.type,
    })
    return out_dir


def _split_stages(weights: dict) -> dict:
    det = {k[4:]: v for k, v in weights.items() if k.startswith("det/")}
    pose = {k[5:]: v for k, v in weights.items() if k.startswith("pose/")}
    return {"det_variables": det, "pose_variables": pose}


@dataclasses.dataclass
class FusedBundle(_FrameBundle):
    """A loaded fused two-stage bundle: frames -> detector -> crops -> poses
    in one program per dispatch, no model code. Duck-types
    `detect.FusedTwoStagePredictor` (`dispatch`, `__call__`,
    `predict_frame`)."""

    directory: Path
    manifest: dict
    det_variables: dict
    pose_variables: dict
    device: torch.device | None = None
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = torch.device(
            self.device or next(iter(self.pose_variables.values())).device)

    @classmethod
    def load(cls, directory: str | Path, device: torch.device | str = "cuda") -> "FusedBundle":
        return _load_frame_bundle(cls, directory, device, "fused", lambda m: (
            f"{directory} is not a fused two-stage bundle (kind={m.get('kind')!r})"),
            _split_stages)

    @property
    def max_people(self) -> int:
        return int(self.manifest["max_people"])

    def dispatch(self, frames: np.ndarray) -> dict[str, torch.Tensor]:
        """Launch one batch at an exported (batch, frame shape) exactly (the
        micro-batcher pads to both); the outputs stay on the device, still
        being computed."""
        frames = np.asarray(frames, np.uint8)
        self._check_exported(frames)
        B, H, W = frames.shape[:3]
        return self._program(f"fused_b{B}_h{H}w{W}.pt2.gz")(
            {"det": self.det_variables, "pose": self.pose_variables}, self._upload(frames))

    def __call__(self, frames: np.ndarray) -> dict[str, np.ndarray]:
        """frames (B, H, W, 3) uint8 -> dict of (B, max_people, ...) pose
        fields, boxes and det_scores: the live fused predictor's contract.
        (B, H, W) must be an exported (batch, frame shape)."""
        return _to_numpy(self.dispatch(frames))

    def predict_frame(self, frame: np.ndarray, score_threshold: float | None = None
                      ) -> dict[str, np.ndarray]:
        """One frame -> the detections above the threshold (the live
        predictor's predict_frame contract)."""
        thr = self.score_threshold if score_threshold is None else score_threshold
        out = self(np.asarray(frame, np.uint8)[None])
        keep = out["det_scores"][0] >= thr
        return {k: v[0][keep] for k, v in out.items()}


# --------------------------------------------------------------------------
# CLI


def _run_dir(path: Path) -> Path:
    return path / "checkpoints" if (path / "checkpoints").exists() else path


def _shapes(spec: str) -> list[tuple[int, ...]]:
    return [tuple(int(v) for v in part.split(",")) for part in spec.split(";")]


def main(argv: Sequence[str] | None = None) -> Path:
    """The export CLI; returns the bundle directory it wrote."""
    parser = argparse.ArgumentParser(description="Export a checkpoint as a serving bundle "
                                     "(torch.export programs, PyTorch)")
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="checkpoint directory of the port's training CLI (pose model)")
    parser.add_argument("--detector-checkpoint", type=Path, default=None, metavar="DIR",
                        help="export a person-detector bundle instead (detect.train output "
                        "dir); --frame-size (';' for several) for the accepted shapes")
    parser.add_argument("--bottomup-checkpoint", type=Path, default=None, metavar="DIR",
                        help="export a single-stage pose bundle instead (detect.train "
                        "--keypoints output dir); --frame-size for the accepted shapes, "
                        "--buckets for the frame-batch ladder (default 1)")
    parser.add_argument("--detector-threshold", type=float, default=0.3,
                        help="default score threshold baked into the detector / bottom-up / "
                        "fused bundle manifest")
    parser.add_argument("--fused-detector", type=Path, default=None, metavar="DIR",
                        help="with --checkpoint: export a fused two-stage bundle (this "
                        "detector -> crops -> the pose checkpoint, one program per dispatch); "
                        "--frame-size for the shapes, --buckets for frame batches (default "
                        "1), --max-people for the pose slots")
    parser.add_argument("--max-people", type=int, default=8,
                        help="pose slots per frame in the fused bundle")
    parser.add_argument("--config", type=Path, default=None,
                        help="TrainConfig JSON (default: beside checkpoint)")
    parser.add_argument("--out", type=Path, required=True, help="bundle output directory")
    parser.add_argument("--buckets", type=str, default=None,
                        help="comma-separated batch buckets (default: this card's recorded "
                        "ladder, else its serving batch)")
    parser.add_argument("--frame-size", type=str, required=True,
                        help="H,W frame shape the bundle accepts")
    parser.add_argument("--ema", action="store_true", help="use EMA params")
    parser.add_argument("--no-indexed", action="store_true",
                        help="skip the frame-indexed programs (serving then uploads frames "
                        "per crop)")
    parser.add_argument("--platforms", type=str, default=None,
                        help="comma-separated devices the programs run on ('cpu,cuda' for a "
                        "portable bundle, traced with the plain versions; needs "
                        "attn_impl='einsum')")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the checkpoint loads and is traced on")
    args = parser.parse_args(argv)
    modes = (args.checkpoint, args.detector_checkpoint, args.bottomup_checkpoint)
    if sum(x is not None for x in modes) != 1:
        parser.error("pass exactly one of --checkpoint / --detector-checkpoint / "
                     "--bottomup-checkpoint")
    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    batches = tuple(int(b) for b in args.buckets.split(",")) if args.buckets else (1,)

    if args.bottomup_checkpoint is not None:
        from probpose_pytorch_tpu_torch.detect.train import load_bottomup

        predictor = load_bottomup(_run_dir(args.bottomup_checkpoint),
                                  score_threshold=args.detector_threshold, device=args.device)
        shapes = _shapes(args.frame_size)
        export_bottomup_bundle(predictor, args.out, shapes, batches=batches, platforms=platforms)
        print(f"wrote bottom-up bundle {args.out} (frames {shapes}, batches {batches})")
        return args.out
    if args.detector_checkpoint is not None:
        from probpose_pytorch_tpu_torch.detect.train import load_detector

        detector = load_detector(_run_dir(args.detector_checkpoint),
                                 score_threshold=args.detector_threshold, device=args.device)
        shapes = _shapes(args.frame_size)
        export_detector_bundle(detector, args.out, shapes, platforms=platforms)
        print(f"wrote detector bundle {args.out} (frames {shapes})")
        return args.out

    from probpose_pytorch_tpu_torch.inference import (
        load_predictor,
        tuned_bucket_ladder,
        tuned_serving_batch,
    )

    pose = load_predictor(args.checkpoint, args.config, ema=args.ema, device=args.device)
    if args.fused_detector is not None:
        from probpose_pytorch_tpu_torch.detect.fused import FusedTwoStagePredictor
        from probpose_pytorch_tpu_torch.detect.train import load_detector

        detector = load_detector(_run_dir(args.fused_detector),
                                 score_threshold=args.detector_threshold,
                                 max_detections=max(args.max_people, 8), device=args.device)
        fused = FusedTwoStagePredictor(detector=detector, pose=pose, max_people=args.max_people,
                                       score_threshold=args.detector_threshold)
        shapes = _shapes(args.frame_size)
        export_fused_bundle(fused, args.out, shapes, batches=batches, platforms=platforms)
        print(f"wrote fused two-stage bundle {args.out} (frames {shapes}, batches {batches}, "
              f"max_people {args.max_people})")
        return args.out

    if args.buckets:
        buckets = batches
    else:
        buckets = tuned_bucket_ladder() or (tuned_serving_batch(),)
    frame_shape = tuple(int(v) for v in args.frame_size.split(","))
    export_predictor_bundle(pose, args.out, buckets, frame_shape, platforms=platforms,
                            indexed=not args.no_indexed)
    print(f"wrote bundle {args.out} (buckets {buckets}, frame {frame_shape})")
    return args.out


if __name__ == "__main__":
    main()
