"""The port's TopDownPredictor against the JAX predictor, on the CPU: plain,
with flip and scale test and temperatures, `predict_stream`, and
`load_predictor` on the same train state saved by each package.

Same tiny float32 model (weights carried across by compat/from_jax.py, head
kernels redrawn so the heatmaps are peaked), same uint8 frames and boxes.
"""

import inspect
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.inference import _scale_boxes as jax_scale_boxes
from probpose_pytorch_tpu.inference import load_predictor as jax_load_predictor
from probpose_pytorch_tpu.ops.augment import average_flip_pred as jax_average_flip_pred
from probpose_pytorch_tpu.ops.heatmap import build_oks_conv_operators, oks_conv
from probpose_pytorch_tpu.ops.preprocess import crop_resize as jax_crop_resize
from probpose_pytorch_tpu.train import Trainer as JaxTrainer
from probpose_pytorch_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_train_state
from probpose_pytorch_tpu_torch.eval import calibration
from probpose_pytorch_tpu_torch.inference import TopDownPredictor, _scale_boxes, load_predictor
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.ops.augment import average_flip_pred
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize
from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_models import TINY_CFG, init_pair, peaked_variables

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

K = TINY_CFG["num_keypoints"]
CODEC_KW = dict(input_size=(48, 64), heatmap_size=(12, 16),
                sigmas=np.full(K, 0.05, np.float32), sigma=2.0)


def _request(seed, B):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, 80, 64, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 30, 45], [15, 15, 50, 70], (B, 4)).astype(np.float32)
    return frames, boxes


def _top2_margin(heatmaps):
    """Gap between the two largest values of each convolved map: where it
    is tiny the argmax, and so the keypoint, is not well defined."""
    B, Kk, H, W = heatmaps.shape
    ops = build_oks_conv_operators(CODEC_KW["sigmas"], H, W)
    conv = np.asarray(oks_conv(jnp.asarray(heatmaps), ops)).reshape(B, Kk, -1)
    top2 = np.sort(conv, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.fixture(scope="module")
def predictors():
    jm, variables, pm = init_pair()
    jax_pred = JaxPredictor(model=jm, variables=variables,
                            codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                            input_size=TINY_CFG["img_size"], return_heatmaps=True)
    port_pred = TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                                 input_size=TINY_CFG["img_size"], return_heatmaps=True)
    return jax_pred, port_pred


@pytest.mark.parametrize("B,indexed", [(3, False), (4, True)])
def test_predictor_matches_jax(predictors, B, indexed):
    jax_pred, port_pred = predictors
    frames, boxes = _request(B, B)
    ids = None
    if indexed:
        ids = np.array([1, 0, 1, 1], np.int32)
        frames = frames[:2]
    ref = jax_pred(frames, boxes, ids)
    out = port_pred(frames, boxes, ids)
    assert sorted(out) == sorted(ref)
    for k in out:
        assert out[k].shape == ref[k].shape, k
        assert np.isfinite(out[k]).all(), k
    # Heatmaps and scalar heads: the model bar (rtol 1e-4, atol 1e-5) of
    # test_torch_models.py, after crops that agree to bf16 rounding.
    for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # Keypoints: the repo's 1e-3 px decode bar, on every keypoint whose
    # convolved map has a top-2 margin above 1e-4 (near-ties excepted).
    ok = _top2_margin(ref["heatmaps"]) > 1e-4
    assert ok.mean() > 0.8
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], atol=1e-3)
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=1e-4, atol=1e-5)


def test_predictor_refuses_unported_options(predictors):
    """On a mesh, indexed frames raise JAX's ValueError (mesh serving takes
    per-crop frames; a world-free 1 x 1 mesh here); with a quantize mode,
    JAX's ValueError comes first (quantized serving is single-device)."""
    _, port_pred = predictors
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.zeros(1, 1))
    pred = TopDownPredictor(model=port_pred.model, codec=port_pred.codec, input_size=(64, 48),
                            mesh=mesh)
    assert pred.model.mesh is mesh and port_pred.model.mesh is None
    with pytest.raises(ValueError, match="indexed frames are single-device"):
        pred(np.zeros((1, 64, 48, 3), np.uint8), np.zeros((2, 4), np.float32),
             np.zeros((2,), np.int64))
    with pytest.raises(ValueError, match="quantize='int8' is single-device only"):
        TopDownPredictor(model=port_pred.model, codec=port_pred.codec, input_size=(64, 48),
                         quantize="int8", mesh=object())


def _pair(jm, variables, pm, **kw):
    """(JAX predictor, port predictor) of the same weights and options."""
    return (JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                         input_size=TINY_CFG["img_size"], **kw),
            TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                             input_size=TINY_CFG["img_size"], **kw))


def _well_defined(jm, variables, frames, boxes, scales=(1.0,), **kw):
    """Keypoints whose convolved map (flip-averaged with flip test) has a
    top-2 margin above 1e-4 at every scale, from JAX's maps."""
    one = JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                       input_size=TINY_CFG["img_size"], return_heatmaps=True, **kw)
    ok = np.ones((len(boxes), K), bool)
    for s in scales:
        b = boxes if s == 1.0 else np.asarray(jax_scale_boxes(jnp.asarray(boxes), s))
        ok &= _top2_margin(one(frames, b)["heatmaps"]) > 1e-4
    return ok


def _same_answers(out, ref, ok, atol=1e-5):
    """The bars of test_predictor_matches_jax, keypoints where `ok`; the
    fields' absolute bar `atol`."""
    assert sorted(out) == sorted(ref)
    for k in out:
        assert out[k].shape == ref[k].shape and np.isfinite(out[k]).all(), k
    for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors"):
        if k in out:
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=atol, err_msg=k)
    assert ok.mean() > 0.7
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], atol=1e-3)
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=1e-4, atol=atol)


def test_average_flip_pred_matches_jax():
    rng = np.random.default_rng(11)
    pred = [rng.random((2, K, 16, 12), np.float32)] + [
        rng.random((2, K, 1, 1), np.float32) for _ in range(4)]
    flipped = [rng.random(p.shape, np.float32) for p in pred]
    pairs = ((1, 2), (3, 4))
    ours = average_flip_pred([torch.from_numpy(p) for p in pred],
                             [torch.from_numpy(p) for p in flipped], pairs)
    ref = jax_average_flip_pred([jnp.asarray(p) for p in pred],
                                [jnp.asarray(p) for p in flipped], pairs)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("pairs", [None, ((0, 4), (1, 3))])
def test_flip_test_matches_jax(pairs):
    jm, variables, pm = init_pair()
    jax_pred, port_pred = _pair(jm, variables, pm, flip_test=True, flip_pairs=pairs,
                                return_heatmaps=True)
    frames, boxes = _request(12, 4)
    ok = _well_defined(jm, variables, frames, boxes, flip_test=True, flip_pairs=pairs)
    _same_answers(port_pred(frames, boxes), jax_pred(frames, boxes), ok)


# Crops of rescaled boxes: crop_resize rounds its f32 product to bf16, and
# the two libraries sum that product in other orders, so up to ~0.5 % of a
# rescaled crop's values differ from JAX's by one bf16 rounding (checked
# below). Through the tiny model that moves heatmaps by up to 1.2e-4 and
# probabilities by 3.2e-5 (request 13 at scale 0.9): the fields of rescaled
# forwards are held to 2e-4 absolute, keypoints to the 1e-3 px bar.
SCALED_ATOL = 2e-4


@pytest.mark.parametrize("scores,scales,flip", [
    ("unit", (0.9, 1.0, 1.1), False), ("mean", (0.9, 1.1), False),
    ("unit", (1.2, 0.85), True), ("mean", (0.9, 1.0, 1.1), True)])
def test_scale_test_matches_jax(scores, scales, flip):
    jm, variables, pm = init_pair()
    kw = dict(scale_test=scales, scale_test_scores=scores, flip_test=flip)
    jax_pred, port_pred = _pair(jm, variables, pm, return_heatmaps=True, **kw)
    frames, boxes = _request(13, 4)
    for s in scales:
        b = _scale_boxes(torch.from_numpy(boxes), s)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jax_scale_boxes(jnp.asarray(boxes), s)))
        crops = crop_resize(torch.from_numpy(frames), b, TINY_CFG["img_size"],
                            "bilinear_matmul").numpy()
        ref = np.asarray(jax_crop_resize(jnp.asarray(frames), jnp.asarray(b.numpy()),
                                         TINY_CFG["img_size"], "bilinear_matmul"))
        # at most one bf16 ulp (2**-7 of the value) apart, at under 1 % of values
        assert (np.abs(crops - ref) <= 2.0**-7 * np.abs(ref)).all()
        assert (crops != ref).mean() < 0.01
    ok = _well_defined(jm, variables, frames, boxes, scales, flip_test=flip)
    out = port_pred(frames, boxes)
    _same_answers(out, jax_pred(frames, boxes), ok, atol=SCALED_ATOL)
    if scores == "unit":  # confidences of the unit (or first) scale's forward
        one = TopDownPredictor(model=pm, codec=port_pred.codec, input_size=TINY_CFG["img_size"],
                               flip_test=flip)
        s = 1.0 if 1.0 in scales else scales[0]
        unit = one(frames, np.asarray(_scale_boxes(torch.from_numpy(boxes), s)))
        np.testing.assert_array_equal(out["probabilities"], unit["probabilities"])


def test_calibration_matches_jax(predictors):
    jm, variables, pm = init_pair()
    temps = {"presence": 1.7, "visibility": 0.6}
    jax_pred, port_pred = _pair(jm, variables, pm, calibration=temps, return_heatmaps=True)
    frames, boxes = _request(14, 3)
    ok = _well_defined(jm, variables, frames, boxes)
    out = port_pred(frames, boxes)
    _same_answers(out, jax_pred(frames, boxes), ok)
    _, plain = predictors
    raw = plain(frames, boxes)
    assert not np.allclose(out["probabilities"], raw["probabilities"], atol=1e-3)
    np.testing.assert_allclose(
        out["probabilities"], calibration.apply_temperature(raw["probabilities"], 1.7),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["oks"], raw["oks"])
    only = TopDownPredictor(model=pm, codec=port_pred.codec, input_size=TINY_CFG["img_size"],
                            calibration={"presence": 1.7})(frames, boxes)
    np.testing.assert_array_equal(only["visibilities"], raw["visibilities"])


@pytest.mark.parametrize("kw,match", [
    (dict(scale_test=(0.9, 0.0)), "positive"), (dict(scale_test=(-1.0,)), "positive"),
    (dict(scale_test_scores="max"), "'unit' or 'mean'"),
    (dict(calibration={"presence": 1.2, "oks": 2.0}), "unknown calibration branches"),
    (dict(calibration={"presence": 0.0}), "positive finite"),
    (dict(calibration={"visibility": float("inf")}), "positive finite")])
def test_predictor_refuses_bad_options_as_jax(predictors, kw, match):
    jax_pred, port_pred = predictors
    with pytest.raises(ValueError, match=match):
        TopDownPredictor(model=port_pred.model, codec=port_pred.codec,
                         input_size=TINY_CFG["img_size"], **kw)
    with pytest.raises(ValueError, match=match):
        JaxPredictor(model=jax_pred.model, variables=jax_pred.variables, codec=jax_pred.codec,
                     input_size=TINY_CFG["img_size"], **kw)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_predict_stream_equals_call(predictors, depth):
    _, port_pred = predictors
    batches = [_request(20 + i, B) for i, B in enumerate((3, 1, 4, 2))]
    frames, boxes = _request(30, 4)
    batches.append((frames[:2], boxes, np.array([1, 0, 0, 1], np.int32)))
    streamed = list(port_pred.predict_stream(iter(batches), depth=depth))
    assert len(streamed) == len(batches)
    for item, out in zip(batches, streamed):
        ref = port_pred(*item)
        assert sorted(out) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match="depth"):
        next(port_pred.predict_stream(iter(batches), depth=0))


@pytest.fixture(scope="module")
def saved_runs(tmp_path_factory):
    """One JAX train state (peaked head, an EMA unlike the params) saved as
    JAX's Orbax checkpoint, and the same state carried into the port by
    compat/from_jax.py and saved by the port's CheckpointManager: (JAX run
    directory, port run directory)."""
    root = tmp_path_factory.mktemp("runs")
    raw = dict(model=dict(TINY_CFG), optim=dict(ema_decay=0.99), kpt_sigma_value=0.05,
               sigma=2.0, out_dir=str(root / "unused"))
    jcfg = JaxTrainConfig.from_dict(raw)
    jstate = JaxTrainer.create(jcfg, steps_per_epoch=1).state
    tree = dict(params=jstate.params, batch_stats=jstate.batch_stats)
    peaked, ema = peaked_variables(tree, 0), peaked_variables(tree, 1)
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jstate = jstate.replace(params=as_jnp(peaked["params"]),
                            batch_stats=as_jnp(peaked["batch_stats"]),
                            ema_params=as_jnp(ema["params"]))
    jax_dir, port_dir = root / "jax", root / "port"
    jax_dir.mkdir()
    jcfg.save(jax_dir / "config.json")
    mgr = JaxCheckpointManager(jax_dir / "checkpoints", keep=1)
    mgr.save(0, jstate)
    mgr.close()
    cfg = TrainConfig.from_dict(raw)
    trainer = Trainer.create(cfg, steps_per_epoch=1, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(jstate))
    port_dir.mkdir()
    cfg.save(port_dir / "config.json")
    CheckpointManager(port_dir / "checkpoints").save(0, trainer.state)
    return jax_dir, port_dir


@pytest.mark.parametrize("ema", [False, True])
def test_load_predictor_matches_jax(saved_runs, ema):
    jax_dir, port_dir = saved_runs
    jax_pred = jax_load_predictor(jax_dir / "checkpoints", ema=ema)
    port_pred = load_predictor(port_dir / "checkpoints", ema=ema, device="cpu")
    assert port_pred.input_size == tuple(jax_pred.input_size)
    jax_pred.return_heatmaps = port_pred.return_heatmaps = True
    frames, boxes = _request(15, 4)
    ref = jax_pred(frames, boxes)
    ok = _top2_margin(ref["heatmaps"]) > 1e-4
    _same_answers(port_pred(frames, boxes), ref, ok)
    if ema:  # the EMA weights, not the params
        other = load_predictor(port_dir / "checkpoints", device="cpu")
        assert not torch.equal(other.model.head.final.weight, port_pred.model.head.final.weight)


def test_load_predictor_runs_on_the_card_unless_told(saved_runs, monkeypatch):
    _, port_dir = saved_runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_predictor(port_dir / "checkpoints")


def test_load_predictor_signature_matches_jax():
    """JAX's parameters keep their places and defaults (quantize and mesh
    4th and 5th), so a positional call binds as in JAX; `device` is last."""
    ours = inspect.signature(load_predictor).parameters
    theirs = inspect.signature(jax_load_predictor).parameters
    assert list(ours)[:len(theirs)] == list(theirs) and list(ours)[len(theirs):] == ["device"]
    for name, p in theirs.items():
        assert ours[name].default == p.default, name


# A world-free mesh with a pipe axis: stage 0 of 2 (the pipelines' runs are
# tests/test_torch_pipeline.py's).
PIPE_MESH = SimpleNamespace(mesh_dim_names=("data", "model", "pipe"), mesh=torch.zeros(1, 1, 2),
                            get_group=lambda name: None, get_coordinate=lambda: [0, 0, 0])


@pytest.mark.parametrize("args,kw,error", [
    ((), dict(quantize="int8", mesh=object()), ValueError),
    pytest.param((), dict(mesh=PIPE_MESH), None, id="args1-kw1-NotImplementedError"),
    ((None, False, "int8_wo", object()), {}, ValueError),
    pytest.param((None, False, None, PIPE_MESH), {}, None, id="args3-kw3-NotImplementedError"),
])
def test_load_predictor_refuses_quantize_and_mesh(saved_runs, args, kw, error, monkeypatch):
    """quantize and mesh, by keyword or in their JAX places: a quantize
    mode with a mesh raises JAX's ValueError (single device); a mesh with a
    pipe axis binds: the trainer of the config is built on it with its
    trunk staged (pp_stages 2, this stage half of each stacked leaf's
    depth) and the predictor serves on it (the checkpoint's restore onto
    the stages and the served outputs against JAX's are
    tests/test_torch_pipeline.py's world: restoring needs the pipe group,
    so it is recorded here, not run). A TypeError would mean a shifted
    signature."""
    _, port_dir = saved_runs
    if error is not None:
        with pytest.raises(error, match="single-device only"):
            load_predictor(port_dir / "checkpoints", *args, device="cpu", **kw)
        return
    from probpose_pytorch_tpu_torch.train import loop

    restored = []
    monkeypatch.setattr(loop, "restore_state_with_layout",
                        lambda ckpt, state, cfg: restored.append(cfg) or state)
    pred = load_predictor(port_dir / "checkpoints", *args, device="cpu", **kw)
    assert pred.mesh is PIPE_MESH and pred.model.mesh is PIPE_MESH
    assert restored and restored[0].model.pp_stages == 2
    depth = ViTConfig.PRESETS[restored[0].model.backbone]["depth"]
    assert pred.model.backbone.blocks.qkv_kernel.shape[0] == depth // 2


@pytest.mark.parametrize("args,kw", [((), dict(quantize="int8")), ((None, True, "int8_wo"), {})])
def test_load_predictor_quantizes(saved_runs, args, kw):
    """load_predictor(quantize=...), by keyword or in JAX's place: the
    predictor of the checkpoint (EMA with ema) with its trunk quantised,
    equal to TopDownPredictor(quantize=...) over the float predictor's
    model. tests/test_torch_quant.py holds the quantised predictor to
    JAX's."""
    _, port_dir = saved_runs
    pred = load_predictor(port_dir / "checkpoints", *args, device="cpu", **kw)
    mode = kw.get("quantize") or args[2]
    assert pred.quantize == mode and type(pred.model.backbone).__name__ == "QuantizedViT"
    assert pred.model.backbone.weight_only == (mode == "int8_wo")
    plain = load_predictor(port_dir / "checkpoints", ema=bool(args and args[1]), device="cpu")
    same = TopDownPredictor(model=plain.model, codec=plain.codec, input_size=plain.input_size,
                            quantize=mode)
    frames, boxes = _request(16, 3)
    a, b = pred(frames, boxes), same(frames, boxes)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_load_predictor_positional_call_binds_like_jax(saved_runs):
    """(checkpoint, config, ema, quantize, mesh, flip_test, scale_test) by
    position, as a JAX caller writes it."""
    _, port_dir = saved_runs
    pred = load_predictor(port_dir / "checkpoints", None, True, None, None, True, (0.9, 1.1),
                          device="cpu")
    assert pred.flip_test is True and pred.scale_test == (0.9, 1.1)


def test_inferno_table_equals_matplotlib():
    """The inference CLI's heatmap colours: matplotlib's inferno colormap
    byte for byte, out-of-range and NaN values included."""
    from matplotlib import colormaps

    from probpose_pytorch_tpu_torch.viz import inferno_rgba

    x = np.random.default_rng(16).uniform(-0.2, 1.2, (64, 48)).astype(np.float32)
    x[0, :8] = [0.0, 1.0, np.nan, 255 / 256, np.nextafter(np.float32(1), 0), -1e-9, np.inf,
                -np.inf]
    np.testing.assert_array_equal(inferno_rgba(x), (colormaps["inferno"](x) * 255).astype(np.uint8))
    np.testing.assert_array_equal(inferno_rgba(x.astype(np.float64)),
                                  (colormaps["inferno"](x.astype(np.float64)) * 255).astype(np.uint8))


@pytest.mark.parametrize("flags", [[], ["--normalize", "--ema", "--flip-test"]])
def test_inference_cli_matches_jax(saved_runs, tmp_path, flags):
    """python -m ...inference --device cpu on the port's checkpoint against
    the JAX CLI on the same state saved by JAX: predictions.json with JAX's
    keys within the bars of test_load_predictor_matches_jax, heatmap PNGs
    within 1 grey level, the rendered image."""
    import PIL.Image

    from probpose_pytorch_tpu.inference import main as jax_main
    from probpose_pytorch_tpu_torch.inference import main

    jax_dir, port_dir = saved_runs
    image = np.random.default_rng(17).integers(0, 256, (80, 100, 3), dtype=np.uint8)
    PIL.Image.fromarray(image).save(tmp_path / "img.png")
    common = ["--image", str(tmp_path / "img.png"), "--prob-threshold", "0.0"] + flags
    main(["--checkpoint", str(port_dir / "checkpoints"), "--output", str(tmp_path / "port"),
          "--device", "cpu"] + common)
    jax_main(["--checkpoint", str(jax_dir / "checkpoints"), "--output", str(tmp_path / "jax")]
             + common)
    got, ref = (json.loads((tmp_path / d / "predictions.json").read_text())
                for d in ("port", "jax"))
    assert sorted(got) == sorted(ref)
    got, ref = ({k: np.asarray(v, np.float32) for k, v in r.items()} for r in (got, ref))
    jax_pred = jax_load_predictor(jax_dir / "checkpoints", ema="--ema" in flags,
                                  flip_test="--flip-test" in flags)
    jax_pred.return_heatmaps = True
    box = np.array([[0, 0, 100, 80]], np.float32)
    ok = _well_defined(jax_pred.model, jax_pred.variables, image[None], box,
                       flip_test="--flip-test" in flags)
    ref["heatmaps"] = jax_pred(image[None], box)["heatmaps"]
    got["heatmaps"] = ref["heatmaps"]  # compared below, as the PNGs
    _same_answers(got, ref, ok)
    for i in range(K):
        a, b = (np.asarray(PIL.Image.open(tmp_path / d / f"heatmap_{i}.png"), np.int16)
                for d in ("port", "jax"))
        assert a.shape == b.shape == (16, 12, 4)
        assert np.abs(a - b).max() <= 1
    rendered = PIL.Image.open(tmp_path / "port" / "output_image.png")
    assert rendered.size == (100, 80)


@pytest.mark.parametrize("flag", ["--int8", "--int8-weight-only"])
def test_inference_cli_refuses_int8(saved_runs, tmp_path, flag):
    """--int8 and --int8-weight-only, refused until the int8 path was
    ported, now serve: predictions.json is the quantised predictor's
    answer on the whole image (JAX's keys), and the heatmap PNGs are
    written."""
    import PIL.Image

    from probpose_pytorch_tpu_torch.inference import main

    _, port_dir = saved_runs
    image = np.random.default_rng(18).integers(0, 256, (80, 100, 3), dtype=np.uint8)
    PIL.Image.fromarray(image).save(tmp_path / "img.png")
    main(["--checkpoint", str(port_dir / "checkpoints"), "--image", str(tmp_path / "img.png"),
          "--output", str(tmp_path / "out"), "--device", "cpu", flag])
    got = json.loads((tmp_path / "out" / "predictions.json").read_text())
    mode = "int8" if flag == "--int8" else "int8_wo"
    pred = load_predictor(port_dir / "checkpoints", quantize=mode, device="cpu")
    ref = pred(image[None], np.array([[0, 0, 100, 80]], np.float32))
    assert sorted(got) == sorted(k for k in ref if k != "heatmaps")
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), ref[k], err_msg=k)
    assert len(list((tmp_path / "out").glob("heatmap_*.png"))) == K
