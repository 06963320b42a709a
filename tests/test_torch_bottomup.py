"""The port's single-stage (bottom-up) pose family and conv-trunk pose
models against the JAX package's, on the CPU.

Tiny sizes as tests/test_torch_detect.py (conv-t at 64 x 64, 16 x 16 maps),
float32, weights carried by compat/from_jax.py. Tolerances:
- `decode_poses` on identical maps: the top-k order with ties (a plateau of
  equal peaks, a tail of exact 0.0) and the snap's masked argmin (the first
  index wins) ==, and so the boxes, scores and poses ==; the per-joint
  scores within two f32 ulps (torch's sigmoid and XLA's differ by one at
  some inputs);
- through the model (frames resized on each side, then the forward):
  boxes and keypoints within 1e-3 px, scores within 1e-5;
- `evaluate_bottomup` summaries within 1e-6;
- a conv-t ProbMap pose model: heatmaps and the scalar branches within the
  flagship's bar (rtol 1e-4, atol 1e-5) in eval mode.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.detect import codec as jax_codec
from probpose_pytorch_tpu.detect import pipeline as jax_pipeline
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables
from probpose_pytorch_tpu_torch.detect import (
    BottomUpPredictor,
    decode_poses,
    evaluate_bottomup,
    load_bottomup,
)
from probpose_pytorch_tpu_torch.detect import train as detect_train
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from test_torch_detect import SYNTH, _frames, detector_pair
from test_torch_models import TINY_CFG, peaked_variables

torch.set_num_threads(2)

KJ = 5


def _pose_maps(seed, B=2, H=16, W=16, Kj=KJ, offset=True):
    """decode_poses' inputs with ties: center logits as test_torch_detect's
    (a plateau, equal isolated peaks, a low random background), joint
    displacements that land some joints outside their box, joint heat maps
    with their own plateau and two equal candidates at equal distance from
    a regressed joint, and sub-cell offsets."""
    from test_torch_detect import _maps

    c, size, off = _maps(seed, B, H, W)
    rng = np.random.default_rng(seed + 1)
    kpts = rng.normal(0, 2, (B, H, W, 2 * Kj)).astype(np.float32)
    heat = (-6.0 + 0.5 * rng.normal(size=(B, H, W, Kj))).astype(np.float32)
    for j in range(Kj):
        ys, xs = rng.integers(0, H, 4), rng.integers(0, W, 4)
        heat[:, ys, xs, j] = rng.normal(1.0, 1.0, 4)
    heat[0, 7:9, 4:6, 0] = 2.0  # a plateau of joint-0 peaks
    heat[0, 2, 1, 1] = heat[0, 2, 5, 1] = 1.0  # equal candidates either side of x = 3
    kpts[0, 2, 3, 2:4] = 0.0  # the (2, 3) peak's joint 1 sits between them
    out = dict(center_logits=c, size=size, offset=off, kpts=kpts, kpt_heat=heat)
    if offset:
        out["kpt_offset"] = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    return out


@pytest.mark.parametrize("k", [3, 12, 40])
@pytest.mark.parametrize("heads", ["regression", "snap", "snap with offsets"])
def test_decode_poses_matches_jax_with_ties(k, heads):
    maps = _pose_maps(k, offset=heads == "snap with offsets")
    if heads == "regression":
        maps = {n: maps[n] for n in ("center_logits", "size", "offset", "kpts")}
    ours = decode_poses(**{n: torch.from_numpy(v) for n, v in maps.items()}, k=k, stride=4)
    ref = jax_codec.decode_poses(**{n: jnp.asarray(v) for n, v in maps.items()}, k=k,
                                 stride=4)
    for o, r, name in zip(ours, ref, ("boxes", "scores", "poses", "kpt_scores")):
        assert o.shape == r.shape, name
        if name == "kpt_scores":  # sigmoids: torch's and XLA's differ by an ulp at some values
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)


def test_decode_poses_snaps_like_jax():
    """The snap moves joints (some, not all), and unsnapped joints score the
    heat probability at their regressed cell."""
    maps = _pose_maps(0)
    _, _, poses, ks = decode_poses(**{n: torch.from_numpy(v) for n, v in maps.items()}, k=12)
    _, _, plain, _ = decode_poses(**{n: torch.from_numpy(v) for n, v in maps.items()
                                     if n in ("center_logits", "size", "offset", "kpts")}, k=12)
    moved = (poses != plain).any(-1)
    assert 0 < moved.float().mean() < 1
    assert ((ks > 0) & (ks < 1)).all()


@pytest.fixture(scope="module")
def bu_pair():
    return detector_pair(KJ, kpt_heatmaps=True, seed=6)


def test_bottomup_predictor_matches_jax(bu_pair):
    jm, variables, pm = bu_pair
    ours = BottomUpPredictor(model=pm, max_detections=8, score_threshold=0.0)
    ref = jax_pipeline.BottomUpPredictor(model=jm, variables=variables, max_detections=8,
                                         score_threshold=0.0)
    frames = _frames(4)
    got, want = ours(frames), ref(frames)
    for o, r, name in zip(got, want, ("boxes", "scores", "keypoints", "keypoint_scores")):
        assert o.shape == r.shape, name
        tol = 1e-5 if "scores" in name else 1e-3
        np.testing.assert_allclose(o, r, rtol=0, atol=tol, err_msg=name)
    one, one_ref = ours.predict_frame(frames[0]), ref.predict_frame(frames[0])
    assert set(one) == set(one_ref) and len(one["scores"]) == 8
    dev = ours.dispatch(frames)
    assert {k: tuple(v.shape) for k, v in dev.items()} == {
        "boxes": (2, 8, 4), "scores": (2, 8), "keypoints": (2, 8, KJ, 2),
        "keypoint_scores": (2, 8, KJ)}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    from probpose_pytorch_tpu_torch.data import generate_coco_synth

    return generate_coco_synth(tmp_path_factory.mktemp("coco"), **SYNTH)


def test_evaluate_bottomup_matches_jax(coco_root):
    """COCO AP of the single-stage family on a generate_coco_synth set (17
    joints), plain regression and with the snap."""
    ann, images = coco_root / "annotations" / "person_keypoints_val2017.json", coco_root / "val2017"
    for heat in (False, True):
        jm, variables, pm = detector_pair(17, kpt_heatmaps=heat, seed=7)
        common = dict(score_threshold=0.0, sigmas=np.full(17, 0.5))
        ours = evaluate_bottomup(BottomUpPredictor(model=pm, max_detections=6), ann, images,
                                 **common)
        ref = jax_pipeline.evaluate_bottomup(
            jax_pipeline.BottomUpPredictor(model=jm, variables=variables, max_detections=6),
            ann, images, **common)
        assert set(ours) == set(ref)
        for key in ref:
            assert abs(ours[key] - ref[key]) <= 1e-6, (heat, key)


@pytest.fixture(scope="module")
def bu_run(tmp_path_factory, coco_root):
    out = tmp_path_factory.mktemp("bu") / "run"
    logged = detect_train.main(["--data-root", str(coco_root), "--out", str(out), "--steps", "2",
                                "--batch-size", "2", "--img-size", "64", "--keypoints", "17",
                                "--kpt-heatmaps", "--log-every", "2", "--num-workers", "1",
                                "--device", "cpu"])
    return out, logged


def test_bottomup_cli_and_load_bottomup(bu_run, coco_root):
    """The CLI with --keypoints 17 --kpt-heatmaps on the CPU: every loss term
    finite; load_bottomup takes the run directory (it descends into
    checkpoints/) or checkpoints/ itself, and serves frames."""
    out, logged = bu_run
    assert set(logged[-1]) == {"total", "center", "size", "offset", "kpts", "kpt_heat",
                               "kpt_offset"}
    assert all(np.isfinite(v) for v in logged[-1].values())
    assert json.loads((out / "detector.json").read_text())["kpt_heatmaps"] is True
    for path in (out, out / "checkpoints"):
        bu = load_bottomup(path, score_threshold=0.0, max_detections=4, device="cpu")
        assert bu.model.kpt_heatmaps and bu.model.num_keypoints == 17
        frame = np.asarray(__import__("PIL.Image").Image.open(
            sorted((coco_root / "val2017").glob("*.jpg"))[0]).convert("RGB"))
        res = bu.predict_frame(frame)
        assert res["keypoints"].shape == (4, 17, 2) and np.isfinite(res["keypoints"]).all()


def test_load_bottomup_refusals(tmp_path, bu_run, monkeypatch):
    out, _ = bu_run
    (tmp_path / "manifest.json").write_text(json.dumps({"kind": "bottomup"}))
    # a bundle directory loads as a BottomUpBundle: this one has no version
    with pytest.raises(ValueError, match="bundle version"):
        load_bottomup(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        load_bottomup(tmp_path, mesh=object(), device="cpu")
    # a live checkpoint serves on a mesh (data-parallel; the world-free
    # 1 x 1 mesh here binds it)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.zeros(1, 1))
    assert load_bottomup(out, mesh=mesh, device="cpu").mesh is mesh
    (tmp_path / "manifest.json").unlink()
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "detector.json").write_text(json.dumps({"num_keypoints": 0}))
    with pytest.raises(ValueError, match="not a single-stage pose checkpoint"):
        load_bottomup(tmp_path, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_bottomup(out)


# --------------------------------------------------------------------------
# a conv trunk under the ProbMap head


CONV_CFG = dict(TINY_CFG, backbone="conv-t", attn_impl="einsum")


def _conv_pair(over=None, seed=0):
    kw = {**CONV_CFG, **(over or {})}
    jm = jax_model.build_model(jax_model.ModelConfig(**kw))
    x = jnp.zeros((1, *kw["img_size"], 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(seed), x, train=False), seed)
    pm = build_model(ModelConfig(**kw), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm


@pytest.mark.parametrize("over", [None, dict(head_type="simcc"), dict(frozen_backbone=True)])
def test_conv_pose_model_matches_jax(over):
    """build_model(backbone="conv-t") against JAX's build_model: every head
    output in eval mode."""
    jm, variables, pm = _conv_pair(over, seed=2)
    x = np.random.default_rng(2).random((3, *CONV_CFG["img_size"], 3), np.float32)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))

    def flat(pred):
        return [t for p in pred for t in (p if isinstance(p, tuple) else (p,))]

    assert len(flat(out)) == len(flat(ref))
    for o, r in zip(flat(out), flat(ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_conv_pose_model_build_and_refusals():
    """conv-s builds with its preset's widths and a float32 stride-16 grid
    under the head; lora_rank keeps JAX's ValueError; frozen_backbone
    detaches the trunk."""
    pm = build_model(ModelConfig(**dict(CONV_CFG, backbone="conv-s")), device="cpu")
    assert pm.backbone.out_channels == 384 and len(pm.backbone.blocks) == 8
    feats = pm.backbone(torch.zeros(1, *CONV_CFG["img_size"], 3))
    assert feats.shape == (1, 4, 3, 384) and feats.dtype == torch.float32
    with pytest.raises(ValueError, match="ViT backbones only"):
        build_model(ModelConfig(**dict(CONV_CFG, lora_rank=4)), device="cpu")
    frozen = build_model(ModelConfig(**dict(CONV_CFG, frozen_backbone=True)), device="cpu")
    frozen.train()
    out = frozen(torch.rand(2, *CONV_CFG["img_size"], 3))
    out[0].sum().backward()
    assert all(p.grad is None for p in frozen.backbone.parameters())
