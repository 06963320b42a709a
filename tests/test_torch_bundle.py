"""The port's serving bundles (probpose_pytorch_tpu_torch/serve/export.py)
against the JAX package's (probpose_pytorch_tpu/serve/export.py), on the
CPU.

Each fixture exports the same model from both packages: the JAX test's tiny
float32 predictor (tests/test_serve_export.py: vit-tiny-e2e at 64 x 48, 5
keypoints, head kernels redrawn so the heatmaps are peaked) with its
weights carried into the port by compat/from_jax.py, buckets (1, 4) at a
64 x 64 frame with the indexed ladder; and the conv-t detector, bottom-up
and fused configs of that file's det_env / bu_env / fused_env. Frames and
boxes come from numpy seeds. Tolerances:
- against JAX's loaded bundle: keypoints within 1e-3 px; the other fields
  within 1e-5 (and 1e-4 relative) where the two packages' crops of the
  request are equal, and within test_torch_serving.py's SCALED_ATOL (2e-4)
  where the f32 product of crop_resize rounds to another bf16 value than
  XLA's at a few of a crop's values (one ulp, checked in `_field_atol`):
  the bars of the live predictors' parity tests;
- against the live port predictor: 1e-6 (the program runs the same ops in
  the same order; equality is expected).
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.detect import pipeline as jax_pipeline
from probpose_pytorch_tpu.detect.fused import FusedTwoStagePredictor as JaxFused
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.models.model import ModelConfig as JaxModelConfig
from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu.ops.preprocess import crop_resize as jax_crop_resize
from probpose_pytorch_tpu.serve import export as jax_export
from probpose_pytorch_tpu.train import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu.train import Trainer as JaxTrainer
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables
from probpose_pytorch_tpu_torch.detect import (
    BottomUpPredictor,
    DetectorPredictor,
    FusedTwoStagePredictor,
    load_bottomup,
    load_detector,
)
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.models.model import ModelConfig
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.ops import kernels
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize
from probpose_pytorch_tpu_torch.serve import export
from probpose_pytorch_tpu_torch.serve.export import (
    BottomUpBundle,
    DetectorBundle,
    FusedBundle,
    ServingBundle,
    export_bottomup_bundle,
    export_detector_bundle,
    export_fused_bundle,
    export_predictor_bundle,
)
from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer

from test_torch_detect import detector_pair
from test_torch_frame import FIELD_TOL, KPT_TOL_PX
from test_torch_models import peaked_variables
from test_torch_serving import SCALED_ATOL

torch.set_num_threads(2)

TINY = dict(embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0)
JaxViTConfig.PRESETS.setdefault("vit-tiny-e2e", TINY)
ViTConfig.PRESETS.setdefault("vit-tiny-e2e", TINY)
MODEL = dict(img_size=(64, 48), num_keypoints=5, backbone="vit-tiny-e2e",
             compute_dtype="float32", deconv_out_channels=(16, 16),
             deconv_kernel_sizes=(4, 4), pool_sizes=((2, 2), (2, 2)), normalize=1.0)
FIELDS = ("keypoints", "scores", "probabilities", "visibilities", "oks", "errors")


def _frames_boxes(rng, b, h=64, w=64):
    """tests/test_serve_export.py's request: b frames and b boxes."""
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    boxes = np.stack([rng.uniform(0, w / 2, b), rng.uniform(0, h / 2, b),
                      rng.uniform(10, w / 2, b), rng.uniform(10, h / 2, b)],
                     axis=-1).astype(np.float32)
    return frames, boxes


def _field_atol(frames, boxes, ids=None, frame_shape=(64, 64)):
    """FIELD_TOL where the two packages' crops of the request are equal,
    else SCALED_ATOL, after checking that they differ by at most one bf16
    ulp at a few values (test_torch_frame.py's `_field_tol`)."""
    frames = np.asarray(frames, np.uint8)
    H, W = frame_shape
    frames = np.pad(frames, ((0, 0), (0, H - frames.shape[1]), (0, W - frames.shape[2]),
                             (0, 0)))
    if ids is not None:
        frames = frames[np.asarray(ids)]
    frames = np.ascontiguousarray(np.broadcast_to(frames, (len(boxes), H, W, 3)))
    crops = crop_resize(torch.from_numpy(frames), torch.from_numpy(np.array(boxes, np.float32)),
                        MODEL["img_size"]).numpy()
    ref = np.asarray(jax_crop_resize(frames, np.asarray(boxes), MODEL["img_size"],
                                     "bilinear_matmul"))
    assert (np.abs(crops - ref) <= 2.0**-7 * np.abs(ref)).all()
    assert (crops != ref).mean() < 0.02
    return FIELD_TOL if np.array_equal(crops, ref) else SCALED_ATOL


def _close_to_jax(out, ref, atol=FIELD_TOL, fields=FIELDS):
    """Keypoints within 1e-3 px, the other fields within `atol` (and 1e-4
    relative)."""
    assert set(fields) <= set(out) and set(out) == set(ref)
    for k in fields:
        a, b = np.asarray(out[k]), np.asarray(ref[k], np.float32)
        assert a.shape == b.shape, k
        if k == "keypoints":
            np.testing.assert_allclose(a, b, rtol=0, atol=KPT_TOL_PX, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol, err_msg=k)


def _equal_live(out, live):
    assert set(out) == set(live)
    for k in live:
        np.testing.assert_allclose(out[k], live[k], rtol=1e-6, atol=1e-6, err_msg=k)


def _predictors(**kw):
    """(JAX TopDownPredictor, port TopDownPredictor) of one peaked f32 state,
    each with its own trainer's codec."""
    jcfg = JaxTrainConfig(model=JaxModelConfig(**MODEL))
    jtrainer = JaxTrainer.create(jcfg, steps_per_epoch=1)
    variables = peaked_variables({"params": jtrainer.state.params,
                                  "batch_stats": jtrainer.state.batch_stats})
    jax_pred = JaxPredictor(model=jtrainer.model, variables=variables,
                            codec=jtrainer.encode_codec, input_size=MODEL["img_size"], **kw)
    trainer = Trainer.create(TrainConfig(model=ModelConfig(**MODEL)), steps_per_epoch=1,
                             device="cpu")
    load_jax_variables(trainer.model, variables["params"], variables["batch_stats"])
    port_pred = TopDownPredictor(model=trainer.model, codec=trainer.encode_codec,
                                 input_size=MODEL["img_size"], **kw)
    return jax_pred, port_pred


@pytest.fixture(scope="module")
def bundle_env(tmp_path_factory):
    """(JAX bundle, port bundle, live port predictor), buckets (1, 4) at a
    64 x 64 frame, indexed."""
    root = tmp_path_factory.mktemp("bundle")
    jax_pred, port_pred = _predictors()
    jb = jax_export.ServingBundle.load(jax_export.export_predictor_bundle(
        jax_pred, root / "jax", buckets=(1, 4), frame_shape=(64, 64)))
    pb = ServingBundle.load(export_predictor_bundle(port_pred, root / "port", buckets=(1, 4),
                                                    frame_shape=(64, 64)), device="cpu")
    return jb, pb, port_pred


# --------------------------------------------------------------------------
# pose bundles against JAX's


def test_manifest_matches_jax(bundle_env):
    jb, pb, _ = bundle_env
    assert set(pb.manifest) == set(jb.manifest) | {"format", "device"}
    for k in jb.manifest:
        assert pb.manifest[k] == jb.manifest[k], k
    assert pb.manifest["format"] == "torch.export" and pb.manifest["device"] == "cpu"
    assert pb.indexed_buckets == jb.indexed_buckets == {4: (1, 2, 4)}
    assert (pb.buckets, pb.frame_shape, pb.input_size) == (jb.buckets, jb.frame_shape,
                                                            jb.input_size)
    assert sorted(p.name for p in pb.directory.iterdir()) == [
        "fn_b1.pt2.gz", "fn_b4.pt2.gz", "fn_b4_f.pt2.gz", "manifest.json", "params.pt"]


@pytest.mark.parametrize("b,hw", [(1, (64, 64)), (4, (64, 64)), (4, (50, 40))])
def test_call_matches_jax_and_live(bundle_env, b, hw):
    """__call__ at each bucket, and a smaller frame zero-padded up."""
    jb, pb, live = bundle_env
    frames, boxes = _frames_boxes(np.random.default_rng(b), b, *hw)
    out = pb(frames, boxes)
    _close_to_jax(out, jb(frames, boxes), _field_atol(frames, boxes))
    _equal_live(out, live(frames, boxes))


@pytest.mark.parametrize("f", [1, 2, 4])
def test_indexed_matches_jax_and_live(bundle_env, f):
    """The indexed program at each unique-frame count of the ladder."""
    jb, pb, live = bundle_env
    rng = np.random.default_rng(10 + f)
    frames, boxes = _frames_boxes(rng, 4)
    frames = frames[:f]
    ids = rng.integers(0, f, 4)
    out = pb(frames, boxes, ids)
    _close_to_jax(out, jb(frames, boxes, ids.astype(np.int32)), _field_atol(frames, boxes, ids))
    _equal_live(out, live(frames, boxes, ids))


def test_indexed_bucket1_gathers_on_the_host(bundle_env):
    jb, pb, live = bundle_env
    frames, boxes = _frames_boxes(np.random.default_rng(13), 1)
    out = pb(frames, boxes, np.zeros((1,), np.int64))
    _close_to_jax(out, jb(frames, boxes, np.zeros((1,), np.int32)), _field_atol(frames, boxes))
    _equal_live(out, live(frames, boxes))


@pytest.mark.parametrize("n", [3, 9])
def test_predict_frame_pads_and_chunks(bundle_env, n):
    """n = 3 pads to bucket 4; n = 9 chunks past the top bucket (4, 4, 1)."""
    jb, pb, live = bundle_env
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    _, boxes = _frames_boxes(rng, n)
    out = pb.predict_frame(frame, boxes)
    assert len(out["keypoints"]) == n
    _close_to_jax(out, jb.predict_frame(frame, boxes), _field_atol(frame[None], boxes, [0] * n))
    ref = live.predict_frame(frame, boxes, buckets=(1, 4))
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=1e-6, atol=1e-6)
    assert pb.predict_frame(frame, boxes[:0]) == {}


def test_predict_stream_matches_jax(bundle_env):
    """Pairs and indexed triples through predict_stream, in order."""
    jb, pb, _ = bundle_env
    rng = np.random.default_rng(7)
    batches = [_frames_boxes(rng, b, 50, 40) for b in (4, 1, 4)]
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    batches.append((frame[None], batches[0][1], np.zeros((4,), np.int64)))
    got = list(pb.predict_stream(iter(batches), depth=2))
    ref = list(jb.predict_stream(iter(batches), depth=2))
    assert len(got) == len(ref) == 4
    for out, r, item in zip(got, ref, batches):
        _close_to_jax(out, r, _field_atol(*item))
        _equal_live(out, pb(*item))
    with pytest.raises(ValueError, match="bucket"):
        list(pb.predict_stream(iter([_frames_boxes(rng, 3)])))
    with pytest.raises(ValueError, match="depth"):
        list(pb.predict_stream(iter(batches), depth=0))


def test_calibrated_bundle_matches_jax(tmp_path):
    """Temperatures are part of the traced program on both sides."""
    cal = {"presence": 3.0, "visibility": 0.4}
    jax_pred, port_pred = _predictors(calibration=cal)
    jb = jax_export.ServingBundle.load(jax_export.export_predictor_bundle(
        jax_pred, tmp_path / "jax", buckets=(2,), frame_shape=(64, 64)))
    pb = ServingBundle.load(export_predictor_bundle(port_pred, tmp_path / "port", buckets=(2,),
                                                    frame_shape=(64, 64)), device="cpu")
    assert pb.manifest["calibration"] == jb.manifest["calibration"] == cal
    frames, boxes = _frames_boxes(np.random.default_rng(7), 2)
    out = pb(frames, boxes)
    _close_to_jax(out, jb(frames, boxes), _field_atol(frames, boxes))
    _equal_live(out, port_pred(frames, boxes))


def test_direct_dataclass_construction(bundle_env):
    _, pb, _ = bundle_env
    direct = ServingBundle(directory=pb.directory, manifest=pb.manifest, variables=pb.variables)
    assert direct.device == torch.device("cpu")
    frames, boxes = _frames_boxes(np.random.default_rng(3), 1)
    _equal_live(direct(frames, boxes), pb(frames, boxes))


# --------------------------------------------------------------------------
# gates


def test_batch_frame_and_count_gates(bundle_env):
    _, pb, _ = bundle_env
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="exceeds"):
        pb(*_frames_boxes(rng, 4, 65, 64))
    with pytest.raises(ValueError, match="bucket"):
        pb(*_frames_boxes(rng, 3))
    frames, boxes = _frames_boxes(rng, 4)
    with pytest.raises(ValueError, match="unique-frame count"):
        pb(frames[:3], boxes, np.array([0, 1, 2, 2]))
    with pytest.raises(ValueError, match="frame_ids"):
        pb(frames[:2], boxes)


def test_version_and_kind_gates(bundle_env, tmp_path):
    _, pb, _ = bundle_env
    copy = tmp_path / "old"
    shutil.copytree(pb.directory, copy)
    manifest = json.loads((copy / "manifest.json").read_text())
    (copy / "manifest.json").write_text(json.dumps(dict(manifest, version=0)))
    with pytest.raises(ValueError, match="version"):
        ServingBundle.load(copy, device="cpu")
    (copy / "manifest.json").write_text(json.dumps(dict(manifest, kind="detector")))
    with pytest.raises(ValueError, match="not a pose bundle"):
        ServingBundle.load(copy, device="cpu")
    with pytest.raises(ValueError, match="not a detector bundle"):
        DetectorBundle.load(pb.directory, device="cpu")


def test_jax_bundle_directory_is_refused(bundle_env):
    """A JAX bundle (jax.export programs, *.bin, no "format" key) is refused
    by every loader, naming the port's export CLI."""
    jb, _, _ = bundle_env
    for cls in (ServingBundle, DetectorBundle, BottomUpBundle, FusedBundle):
        with pytest.raises(ValueError, match="probpose_pytorch_tpu_torch.serve.export"):
            cls.load(jb.directory, device="cpu")


def test_card_bundle_on_the_cpu_raises(bundle_env, tmp_path):
    """A bundle exported for the card does not run anything on the CPU; the
    card asked for on a host without one raises too."""
    _, pb, _ = bundle_env
    copy = tmp_path / "card"
    shutil.copytree(pb.directory, copy)
    manifest = json.loads((copy / "manifest.json").read_text())
    (copy / "manifest.json").write_text(json.dumps(dict(manifest, platforms=["cuda"],
                                                        device="cuda")))
    with pytest.raises(ValueError, match="exported for \\['cuda'\\], not for 'cpu'"):
        ServingBundle.load(copy, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingBundle.load(copy, device="cuda")
        with pytest.raises(ValueError, match="not for 'cuda'"):
            ServingBundle.load(pb.directory)


def test_quantize_and_mesh_raise_their_items(bundle_env, tmp_path):
    _, _, live = bundle_env
    for attr, item in (("quantize", 12), ("mesh", 13)):
        pred = dataclasses.replace(live)
        object.__setattr__(pred, attr, object())
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            export_predictor_bundle(pred, tmp_path / attr, buckets=(1,), frame_shape=(64, 64))


def test_portable_guard_and_platforms(tmp_path):
    """platforms beyond the tracing device: traced with the plain versions;
    a kernel-bearing attn_impl is refused as JAX refuses a Pallas one."""
    _, port_pred = _predictors()
    out = export_predictor_bundle(port_pred, tmp_path / "b", buckets=(2,), frame_shape=(64, 64),
                                  platforms=("cpu", "cuda"))
    pb = ServingBundle.load(out, device="cpu")
    assert pb.manifest["platforms"] == ["cpu", "cuda"]
    frames, boxes = _frames_boxes(np.random.default_rng(0), 2)
    _equal_live(pb(frames, boxes), port_pred(frames, boxes))
    with pytest.raises(ValueError, match="unknown platforms"):
        export_predictor_bundle(port_pred, tmp_path / "c", buckets=(2,), frame_shape=(64, 64),
                                platforms=("tpu",))
    for impl in ("fused", "pallas"):
        cfg = TrainConfig(model=ModelConfig(**MODEL, attn_impl=impl))
        trainer = Trainer.create(cfg, steps_per_epoch=1, device="cpu")
        pred = TopDownPredictor(model=trainer.model, codec=trainer.encode_codec,
                                input_size=MODEL["img_size"])
        with pytest.raises(ValueError, match="per-platform"):
            export_predictor_bundle(pred, tmp_path / impl, buckets=(2,), frame_shape=(64, 64),
                                    platforms=("cpu", "cuda"))


# --------------------------------------------------------------------------
# the deployment promise: no model code, weights once


def test_load_does_not_need_model_code(bundle_env, monkeypatch):
    _, pb, _ = bundle_env
    import probpose_pytorch_tpu_torch.models.model as model_mod

    def boom(*a, **k):  # pragma: no cover - would fail the test
        raise AssertionError("model code invoked during bundle serving")

    monkeypatch.setattr(model_mod, "build_model", boom)
    monkeypatch.setattr(Trainer, "create", boom)
    fresh = ServingBundle.load(pb.directory, device="cpu")
    frames, boxes = _frames_boxes(np.random.default_rng(5), 1)
    assert fresh(frames, boxes)["keypoints"].shape == (1, 5, 2)


SERVE_ALONE = """
import sys
import numpy as np
from probpose_pytorch_tpu_torch.serve.export import ServingBundle
b = ServingBundle.load(sys.argv[1], device="cpu")
out = b.predict_frame(np.zeros((64, 64, 3), np.uint8), np.array([[4, 4, 40, 50]], np.float32))
assert out["keypoints"].shape == (1, 5, 2)
banned = ("models", "train", "detect.model", "codec", "codec_simcc", "inference")
loaded = [m for m in sys.modules if m.startswith("probpose_pytorch_tpu_torch.")
          and m.split(".", 1)[1].startswith(banned)]
print(sorted(loaded))
"""


def test_serves_in_a_process_without_model_modules(bundle_env):
    _, pb, _ = bundle_env
    proc = subprocess.run([sys.executable, "-c", SERVE_ALONE, str(pb.directory)],
                          capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_weights_stored_once(tmp_path):
    """Four programs (buckets 2 and 4, each with its indexed program) take
    the weights as inputs: the bundle is below 1.5 x the weights' bytes."""
    _, port_pred = _predictors()
    out = export_predictor_bundle(port_pred, tmp_path / "b", buckets=(2, 4),
                                  frame_shape=(64, 64))
    programs = sorted(out.glob("*.pt2.gz"))
    assert len(programs) == 4
    weights = sum(t.numel() * t.element_size()
                  for t in list(port_pred.model.parameters()) + list(port_pred.model.buffers()))
    total = sum(p.stat().st_size for p in out.iterdir())
    assert total < 1.5 * weights, (total, weights)


# --------------------------------------------------------------------------
# the ops' fake implementations (export traces them on the card)

OP_CASES = {
    "short_attention_fwd": (lambda: (_fake((256, 192, 1152), torch.bfloat16), 6, False),
                            [(256, 192, 384), (0,)]),
    "short_attention_fwd_lse": (lambda: (_fake((8, 192, 1152), torch.bfloat16), 6, True),
                                [(8, 192, 384), (8, 6, 192)]),
    "tiled_attention_fwd": (lambda: (_fake((8, 2304, 1152), torch.bfloat16), 6, False),
                            [(8, 2304, 384), (0,)]),
    "tiled_attention_fwd_lse": (lambda: (_fake((2, 576, 96), torch.bfloat16), 1, True),
                                [(2, 576, 32), (2, 1, 576)]),
    "tiled_attention_fwd_f32": (lambda: (_fake((2, 2304, 1152), torch.float32), 6, True),
                                [(2, 2304, 384), (0,)]),
    "packed_attention_fwd": (lambda: (_fake((4, 192, 1152), torch.float32), 6),
                             [(4, 192, 384)]),
    "flat_attention_fwd": (lambda: tuple(_fake((256, 192, 12, 64), torch.bfloat16)
                                         for _ in range(3)), [(256, 192, 12, 64)]),
    "fused_ln_mlp_fwd": (lambda: (_fake((256 * 192, 768), torch.bfloat16),
                                  *(_fake((768,), torch.float32) for _ in range(2)),
                                  _fake((768, 3072), torch.bfloat16), _fake((3072,), torch.float32),
                                  _fake((3072, 768), torch.bfloat16), _fake((768,), torch.float32),
                                  False), [(256 * 192, 768)]),
    "sparsemax_rows": (lambda: (_fake((256 * 17, 3072), torch.float32),), [(256 * 17, 3072)]),
}


def _fake(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_fake_impl(case):
    """Each `probpose::` op's fake implementation under FakeTensorMode at
    the card's shapes: output shapes, dtypes and device, and no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert set(kernels.register_ops()) >= {f"probpose::{n}" for ops in
                                           kernels.SERVING_OPS.values() for n in ops}
    name = case.removesuffix("_lse").removesuffix("_f32")
    make, shapes = OP_CASES[case]
    with FakeTensorMode():
        args = make()
        out = getattr(torch.ops.probpose, name)(*args)
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == [tuple(s) for s in shapes]
    assert all(o.device.type == "cuda" for o in outs)
    assert outs[0].dtype == args[0].dtype
    assert all(o.dtype == torch.float32 for o in outs[1:])


# --------------------------------------------------------------------------
# detector, bottom-up and fused bundles against JAX's


@pytest.fixture(scope="module")
def det_env(tmp_path_factory):
    jm, variables, pm = detector_pair(seed=4)
    jlive = jax_pipeline.DetectorPredictor(model=jm, variables=variables, score_threshold=0.0,
                                           max_detections=8)
    live = DetectorPredictor(model=pm, score_threshold=0.0, max_detections=8)
    root = tmp_path_factory.mktemp("detbundle")
    shapes = [(64, 64), (96, 96)]
    jb = jax_export.DetectorBundle.load(jax_export.export_detector_bundle(
        jlive, root / "jax", frame_shapes=shapes))
    out = export_detector_bundle(live, root / "port", frame_shapes=shapes)
    return live, jb, DetectorBundle.load(out, device="cpu"), out


@pytest.mark.parametrize("hw", [(64, 64), (80, 70)])
def test_detector_bundle_matches_jax(det_env, hw):
    """detect_frame at an exported shape and padded up to the next one:
    boxes within 1e-4 px and scores 1e-6 of JAX's (the live pair's bar),
    1e-6 of the live port detector fed the padded frame."""
    live, jb, pb, _ = det_env
    frame = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    (b, s), (rb, rs) = pb.detect_frame(frame), jb.detect_frame(frame)
    assert len(s) == len(rs) == 8
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b, rb, rtol=0, atol=1e-4)
    padded = np.pad(frame, ((0, 96 - hw[0] if hw != (64, 64) else 0),
                            (0, 96 - hw[1] if hw != (64, 64) else 0), (0, 0)))
    lb, ls = live.detect_frame(padded)
    np.testing.assert_allclose(b, lb, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s, ls, rtol=1e-6, atol=1e-6)


def test_detector_bundle_gates_and_manifest(det_env, bundle_env):
    _, jb, pb, out = det_env
    assert set(pb.manifest) == set(jb.manifest) | {"format", "device"}
    assert {k: pb.manifest[k] for k in jb.manifest} == jb.manifest
    assert pb.frame_shapes == ((64, 64), (96, 96)) and pb.score_threshold == 0.0
    with pytest.raises(ValueError, match="exceeds"):
        pb.detect_frame(np.zeros((128, 128, 3), np.uint8))
    with pytest.raises(ValueError, match="not a pose bundle"):
        ServingBundle.load(out, device="cpu")
    with pytest.raises(ValueError, match="not a detector bundle"):
        DetectorBundle.load(bundle_env[1].directory, device="cpu")
    assert len(pb.detect_frame(np.zeros((64, 64, 3), np.uint8), 2.0)[1]) == 0


def test_load_detector_dispatches_to_bundle(det_env):
    _, _, pb, out = det_env
    loaded = load_detector(out, device="cpu")
    assert isinstance(loaded, DetectorBundle)
    frame = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(loaded.detect_frame(frame)[0], pb.detect_frame(frame)[0])
    with pytest.raises(ValueError, match="single-device"):
        load_detector(out, mesh=object(), device="cpu")


@pytest.fixture(scope="module")
def bu_env(tmp_path_factory):
    jm, variables, pm = detector_pair(5, seed=6)
    jlive = jax_pipeline.BottomUpPredictor(model=jm, variables=variables, score_threshold=0.0,
                                           max_detections=6)
    live = BottomUpPredictor(model=pm, score_threshold=0.0, max_detections=6)
    root = tmp_path_factory.mktemp("bubundle")
    shapes = [(64, 64), (96, 96)]
    jb = jax_export.BottomUpBundle.load(jax_export.export_bottomup_bundle(
        jlive, root / "jax", frame_shapes=shapes, batches=(1, 2)))
    out = export_bottomup_bundle(live, root / "port", frame_shapes=shapes, batches=(1, 2))
    return live, jb, BottomUpBundle.load(out, device="cpu"), out


NAMES = ("boxes", "scores", "keypoints", "keypoint_scores")


@pytest.mark.parametrize("n", [2, 5])
def test_bottomup_bundle_matches_jax(bu_env, n):
    """The 4-tuple at a bucket and split 2 + 2 + 1 over the (1, 2) ladder:
    keypoints and boxes within 1e-3 px, scores 1e-5 of JAX's (the live
    pair's bar), 1e-6 of the live port predictor."""
    live, jb, pb, _ = bu_env
    frames = np.random.default_rng(n).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    got, ref, want = pb(frames), jb(frames), live(frames)
    for o, r, w, name in zip(got, ref, want, NAMES):
        assert o.shape == r.shape == w.shape, name
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-5 if "scores" in name else 1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(o, w, rtol=1e-6, atol=1e-6, err_msg=name)


def test_bottomup_predict_frame_dispatch_and_gates(bu_env, bundle_env):
    live, jb, pb, out = bu_env
    assert set(pb.manifest) == set(jb.manifest) | {"format", "device"}
    assert {k: pb.manifest[k] for k in jb.manifest} == jb.manifest
    frame = np.random.default_rng(1).integers(0, 256, (80, 70, 3), dtype=np.uint8)
    padded = np.pad(frame, ((0, 16), (0, 26), (0, 0)))
    got, ref = pb.predict_frame(frame), live.predict_frame(padded)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert len(pb.predict_frame(frame, score_threshold=2.0)["keypoints"]) == 0
    dev = pb.dispatch(np.zeros((2, 64, 64, 3), np.uint8))
    assert {k: tuple(v.shape) for k, v in dev.items()} == {
        "boxes": (2, 6, 4), "scores": (2, 6), "keypoints": (2, 6, 5, 2),
        "keypoint_scores": (2, 6, 5)}
    with pytest.raises(ValueError, match="not exported"):
        pb.dispatch(np.zeros((3, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="exceeds"):
        pb.predict_frame(np.zeros((128, 128, 3), np.uint8))
    with pytest.raises(ValueError, match="not a bottom-up"):
        BottomUpBundle.load(bundle_env[1].directory, device="cpu")
    assert isinstance(load_bottomup(out, device="cpu"), BottomUpBundle)
    with pytest.raises(ValueError, match="single-device"):
        load_bottomup(out, mesh=object(), device="cpu")


@pytest.fixture(scope="module")
def fused_env(tmp_path_factory):
    """tests/test_serve_export.py's fused_env: a conv-t detector (4
    detections) and a vit-tiny pose model, 3 slots, frames 72 x 80, batches
    (1, 2)."""
    jm, variables, pm = detector_pair(seed=7)
    jax_pose, port_pose = _predictors()
    jlive = JaxFused(detector=jax_pipeline.DetectorPredictor(model=jm, variables=variables,
                                                             max_detections=4),
                     pose=jax_pose, max_people=3, score_threshold=-1.0)
    live = FusedTwoStagePredictor(detector=DetectorPredictor(model=pm, max_detections=4),
                                  pose=port_pose, max_people=3, score_threshold=-1.0)
    root = tmp_path_factory.mktemp("fusedbundle")
    jb = jax_export.FusedBundle.load(jax_export.export_fused_bundle(
        jlive, root / "jax", frame_shapes=[(72, 80)], batches=(1, 2)))
    out = export_fused_bundle(live, root / "port", frame_shapes=[(72, 80)], batches=(1, 2))
    return live, jb, FusedBundle.load(out, device="cpu"), out


@pytest.mark.parametrize("b", [1, 2])
def test_fused_bundle_matches_jax(fused_env, b):
    """Every slot: det_scores 1e-6 and boxes 1e-3 px of JAX's (the live
    pair's bar), the pose fields as the pose bundle's; 1e-6 of the live
    fused predictor."""
    live, jb, pb, _ = fused_env
    frames = np.random.default_rng(3 + b).integers(0, 256, (b, 72, 80, 3), dtype=np.uint8)
    out, ref = pb(frames), jb(frames)
    assert set(out) == set(ref) and out["keypoints"].shape == (b, 3, 5, 2)
    np.testing.assert_allclose(out["det_scores"], ref["det_scores"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["boxes"], ref["boxes"], rtol=0, atol=1e-3)
    flat = lambda d: {k: v.reshape((b * 3,) + v.shape[2:]) for k, v in d.items()}  # noqa: E731
    atol = _field_atol(frames, ref["boxes"].reshape(-1, 4), np.repeat(np.arange(b), 3),
                       frame_shape=(72, 80))
    _close_to_jax(flat(out), flat(ref), atol)
    _equal_live(out, live(frames))


def test_fused_bundle_gates(fused_env, bu_env):
    live, jb, pb, out = fused_env
    assert set(pb.manifest) == set(jb.manifest) | {"format", "device"}
    assert {k: pb.manifest[k] for k in jb.manifest} == jb.manifest
    weights = torch.load(out / "params.pt", weights_only=True)
    assert {k.split("/")[0] for k in weights} == {"det", "pose"}
    frame = np.random.default_rng(9).integers(0, 256, (72, 80, 3), dtype=np.uint8)
    assert pb.predict_frame(frame)["keypoints"].shape == (3, 5, 2)
    with pytest.raises(ValueError, match="not exported"):
        pb(np.zeros((1, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="not a fused"):
        FusedBundle.load(bu_env[3], device="cpu")
    with pytest.raises(ValueError, match="not a bottom-up"):
        BottomUpBundle.load(out, device="cpu")
    with pytest.raises(ValueError, match="LIVE predictors"):
        FusedTwoStagePredictor(detector=pb, pose=live.pose, max_people=2)


# --------------------------------------------------------------------------
# the export CLI and --bundle through the front ends

from test_torch_eval import LINE_KEYS, coco_root, tiny_run  # noqa: E402,F401 (fixtures)
from test_torch_video import det_runs  # noqa: E402,F401 (fixture)


@pytest.fixture(scope="module")
def cli_bundles(tmp_path_factory, tiny_run, det_runs):
    """The export CLI in its four modes with --device cpu, on the train
    CLI's checkpoint and detect.train's detector and bottom-up runs."""
    ckpt, cfg = tiny_run
    det, bu = det_runs
    root = tmp_path_factory.mktemp("cli")
    export.main(["--checkpoint", str(ckpt), "--out", str(root / "pose"), "--buckets", "1,4",
                 "--frame-size", "96,96", "--ema", "--device", "cpu"])
    export.main(["--detector-checkpoint", str(det), "--out", str(root / "det"),
                 "--frame-size", "96,96;120,160", "--detector-threshold", "0.0",
                 "--device", "cpu"])
    export.main(["--bottomup-checkpoint", str(bu), "--out", str(root / "bu"),
                 "--frame-size", "96,96", "--buckets", "1,2", "--device", "cpu"])
    export.main(["--checkpoint", str(ckpt), "--fused-detector", str(det), "--out",
                 str(root / "fused"), "--frame-size", "96,96", "--max-people", "3",
                 "--device", "cpu"])
    return root


def test_export_cli_modes(cli_bundles, tiny_run, det_runs):
    from probpose_pytorch_tpu_torch.inference import load_predictor

    root = cli_bundles
    pose = ServingBundle.load(root / "pose", device="cpu")
    assert pose.buckets == (1, 4) and pose.indexed_buckets == {4: (1, 2, 4)}
    live = load_predictor(tiny_run[0], ema=True, device="cpu")
    frames, boxes = _frames_boxes(np.random.default_rng(0), 4, 96, 96)
    _equal_live(pose(frames, boxes), live(frames, boxes))
    det = DetectorBundle.load(root / "det", device="cpu")
    assert det.frame_shapes == ((96, 96), (120, 160)) and det.score_threshold == 0.0
    ref = load_detector(det_runs[0] / "checkpoints", score_threshold=0.0, device="cpu")
    frame = frames[0][:90]
    for got, want in zip(det.detect_frame(frame), ref.detect_frame(np.pad(
            frame, ((0, 6), (0, 0), (0, 0))))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    bu = BottomUpBundle.load(root / "bu", device="cpu")
    assert bu.batches == (1, 2)
    assert bu.predict_frame(frames[0])["keypoints"].shape[1:] == (17, 2)
    fused = FusedBundle.load(root / "fused", device="cpu")
    assert fused.manifest["max_people"] == 3
    out = fused.predict_frame(frames[0], score_threshold=-1.0)
    assert out["keypoints"].shape == (3, 17, 2) and out["boxes"].shape == (3, 4)
    with pytest.raises(SystemExit):
        export.main(["--out", str(root / "x"), "--frame-size", "96,96"])


def test_eval_cli_bundle(cli_bundles, tiny_run, coco_root, capsys):
    """eval.run --bundle: the same summary as the live checkpoint with the
    flags the bundle baked in (--ema), the batch size snapped to a
    bucket."""
    from probpose_pytorch_tpu_torch.eval import run as eval_run

    ann = coco_root / "annotations" / "person_keypoints_val2017.json"
    base = ["--annotations", str(ann), "--images", str(coco_root / "val2017"), "--device", "cpu"]
    got = eval_run.main(base + ["--bundle", str(cli_bundles / "pose"), "--batch-size", "6"])
    assert "[eval] batch 6 -> bucket 4" in capsys.readouterr().out
    want = eval_run.main(base + ["--checkpoint", str(tiny_run[0]), "--ema", "--batch-size", "4"])
    assert set(got) == set(LINE_KEYS)
    assert got == want


def test_server_cli_bundles(cli_bundles, monkeypatch):
    """serve.server --bundle / --bottomup <bundle> / --fused <bundle>:
    batchers on the bundles' buckets and frame shapes; a detector bundle is
    refused for live fusion."""
    from probpose_pytorch_tpu_torch.serve import server as port_server

    made = {}

    class Stop(Exception):
        pass

    def fake_server(batchers, host, port, detector=None):
        made.update(batchers=batchers, detector=detector)
        raise Stop

    monkeypatch.setattr(port_server, "PoseHTTPServer", fake_server)
    root = cli_bundles
    with pytest.raises(Stop):
        port_server.main(["--bundle", f"pose={root / 'pose'}", "--bottomup", str(root / "bu"),
                          "--fused", str(root / "fused"), "--detector", str(root / "det"),
                          "--frame-shape", "96,96", "--device", "cpu"])
    mbs = made["batchers"]
    try:
        assert sorted(mbs) == ["bottomup0", "fused0", "pose"]
        assert (mbs["pose"].buckets, mbs["pose"].frame_shape, mbs["pose"].indexed) == (
            (1, 4), (96, 96), True)
        assert mbs["bottomup0"].buckets == (1, 2) and mbs["fused0"].buckets == (1,)
        assert isinstance(made["detector"], DetectorBundle)
        frame = np.random.default_rng(2).integers(0, 256, (96, 96, 3), dtype=np.uint8)
        boxes = np.array([[5, 5, 40, 60], [20, 10, 50, 70]], np.float32)
        got = mbs["pose"].submit(frame, boxes).result(timeout=120)
        want = ServingBundle.load(root / "pose", device="cpu").predict_frame(frame, boxes)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        fused = mbs["fused0"].submit(frame, np.array([[0, 0, 96, 96]], np.float32))
        assert fused.result(timeout=120)["keypoints"].shape == (1, 3, 17, 2)
    finally:
        for mb in mbs.values():
            mb.close()
    with pytest.raises(SystemExit):
        port_server.main(["--fused", str(root / "pose"), "--detector", str(root / "det"),
                          "--device", "cpu"])


def test_video_cli_bundle(cli_bundles, tiny_run, tmp_path):
    """video --bundle: per frame and in --stream-batch mode, the records of
    the live checkpoint with --ema; the fixed frame shape is refused."""
    from probpose_pytorch_tpu_torch import video

    frames = np.random.default_rng(3).integers(0, 256, (3, 90, 96, 3), dtype=np.uint8)
    np.save(tmp_path / "frames.npy", frames)
    boxes = [[[5, 5, 40, 60], [30, 10, 50, 70]]] * 3
    (tmp_path / "boxes.json").write_text(json.dumps(boxes))
    common = ["--frames", str(tmp_path / "frames.npy"), "--boxes", str(tmp_path / "boxes.json"),
              "--device", "cpu", "--nms", "none"]
    for mode in ([], ["--stream-batch", "4"]):
        video.main(["--bundle", str(cli_bundles / "pose"), "--out", str(tmp_path / "b")]
                   + common + mode)
        video.main(["--checkpoint", str(tiny_run[0]), "--ema", "--out", str(tmp_path / "c")]
                   + common + mode)
        got = (tmp_path / "b" / "poses.jsonl").read_text().splitlines()
        want = (tmp_path / "c" / "poses.jsonl").read_text().splitlines()
        assert len(got) == 3
        for g, w in zip(got, want):
            g, w = json.loads(g), json.loads(w)
            np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=1e-6, atol=1e-5)
    with pytest.raises(SystemExit):
        video.main(["--bundle", str(cli_bundles / "pose"), "--out", str(tmp_path / "d"),
                    "--stream-batch", "4", "--stream-frame-shape", "96,96"] + common)
    with pytest.raises(SystemExit):
        video.main(["--bundle", str(cli_bundles / "pose"), "--out", str(tmp_path / "d"),
                    "--ema"] + common)
