"""The port's person detector (probpose_pytorch_tpu_torch/detect/,
models/convnet.py) against the JAX package's, on the CPU.

Tiny sizes: conv-t at a 64 x 64 input (16 x 16 maps), frames of 96 x 128,
M = 4 boxes, inputs drawn with numpy seeds, float32 everywhere. Weights
cross with compat/from_jax.py. Tolerances:
- forwards in eval mode: 1e-5 of the map's scale (max(1, max |ref|)); in
  train mode, where BatchNorm normalises by the statistics of a batch of
  2 and so magnifies f32 summation order through 13 layers, 1e-4 of it
  (2e-5 for the trunk alone); the updated BN statistics within 1e-5;
- the codec's integer outputs (`ind`, top-k indices with ties), the box
  IoU matrix, detection AP and the expanded crops are `==`; float targets
  within 1e-6 (one or two f32 ulps of exp and sqrt);
- the loss terms within 1e-5 relative;
- two f32 train steps from one carried state: loss terms within 1e-4
  relative, BN statistics 1e-4 of their scale (the second step's batch
  statistics come from the first step's params). Train-mode gradients of this random net
  are not smooth in f32: a pre-activation within rounding of 0 flips its
  ReLU gate, and one flip moves the gradient of every weight of the layer
  below (a float64 run of the port puts the port's f32 gradients, and
  JAX's, 1e-3 to 5e-2 of their scale away). So the params are held to
  what Adam allows: every element within twice the two steps' summed lr
  of JAX's, and the median within 5 % of it (measured: 1.8 %).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probpose_pytorch_tpu.detect import codec as jax_codec
from probpose_pytorch_tpu.detect import pipeline as jax_pipeline
from probpose_pytorch_tpu.detect.data import FrameDetectionDataset as JaxFrameDataset
from probpose_pytorch_tpu.detect.fused import FusedTwoStagePredictor as JaxFused
from probpose_pytorch_tpu.detect.fused import expand_boxes_jax as jax_expand_boxes
from probpose_pytorch_tpu.detect.loss import detection_loss as jax_detection_loss
from probpose_pytorch_tpu.detect.model import PersonDetector as JaxDetector
from probpose_pytorch_tpu.detect.train import DetectorTrainer as JaxTrainer
from probpose_pytorch_tpu.models.convnet import ConvBackbone as JaxConvBackbone
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.compat import from_jax
from probpose_pytorch_tpu_torch.compat.from_jax import (
    load_jax_train_state,
    load_jax_variables,
    state_dict_from_jax,
)
from probpose_pytorch_tpu_torch.data import generate_coco_synth
from probpose_pytorch_tpu_torch.detect import (
    DetectorPredictor,
    DetectorTrainer,
    FrameDetectionDataset,
    FusedTwoStagePredictor,
    PersonDetector,
    box_iou_matrix,
    decode_boxes,
    detection_loss,
    detection_pr,
    encode_boxes,
    evaluate_detector_topdown,
    expand_boxes_jax,
    gaussian_radius,
    load_detector,
)
from probpose_pytorch_tpu_torch.detect import train as detect_train
from probpose_pytorch_tpu_torch.detect.pipeline import expand_detections
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.models.convnet import ConvBackbone
from probpose_pytorch_tpu_torch.train.state import warmup_cosine_decay_schedule

torch.set_num_threads(2)

IMG = (64, 64)
FRAME_HW = (96, 128)
M = 4
SYNTH = dict(n_train_images=4, n_val_images=3, frame_hw=(160, 200), seed=5)


def _stats(tree, rng):
    """`tree` (flax batch_stats) with means near 0 and variances near 1,
    drawn from `rng`, so eval-mode BatchNorm does real work."""
    def one(path, v):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return (1 + 0.1 * rng.normal(size=v.shape) ** 2).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def detector_pair(num_keypoints=0, kpt_heatmaps=False, seed=0, img_size=IMG):
    """(JAX PersonDetector, numpy variables, port PersonDetector) in f32,
    sharing weights; the size head's bias puts boxes at ~5 x 8 cells."""
    jm = JaxDetector(img_size=img_size, preset="conv-t", dtype=jnp.float32,
                     num_keypoints=num_keypoints, kpt_heatmaps=kpt_heatmaps)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *img_size, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.array, v["params"])
    params["size"]["bias"] = np.array([5.0, 8.0], np.float32)
    variables = {"params": params, "batch_stats": _stats(v["batch_stats"], rng)}
    pm = PersonDetector(img_size=img_size, preset="conv-t", dtype=torch.float32,
                        num_keypoints=num_keypoints, kpt_heatmaps=kpt_heatmaps)
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm.eval()


def _images(seed, n=2, hw=IMG):
    return np.random.default_rng(seed).random((n, *hw, 3), np.float32)


# --------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_backbone_matches_jax(train):
    """ConvBackbone (conv-t) in f32: the feature grid, and in train mode
    the batch statistics flax's mutable batch_stats take."""
    jm = JaxConvBackbone(img_size=IMG, stage_channels=(32, 64, 128, 256),
                         stage_blocks=(1, 1, 2, 2), dtype=jnp.float32)
    x = _images(1)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    v = {"params": v["params"], "batch_stats": _stats(v["batch_stats"], np.random.default_rng(3))}
    pm = ConvBackbone((32, 64, 128, 256), (1, 1, 2, 2), dtype=torch.float32)
    # the trunk alone: mapped as a model's trunk, the prefix stripped
    sd = {}
    from_jax._conv_backbone(sd, v["params"], v["batch_stats"])
    pm.load_state_dict({k[len("backbone."):]: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    pm.train(train)
    with torch.no_grad():
        out = pm(torch.from_numpy(x)).numpy()
    if train:
        ref, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        new = {}
        from_jax._conv_backbone(new, v["params"],
                                jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        got = pm.state_dict()
        for k in new:
            if "running" in k:
                np.testing.assert_allclose(got[k[len("backbone."):]].numpy(), new[k],
                                           rtol=0, atol=1e-5, err_msg=k)
    else:
        ref = jm.apply(v, jnp.asarray(x), train=False)
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 4, 4, 256) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=(2e-5 if train else 1e-5)
                               * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("heads", ["boxes", "kpts", "kpt_heatmaps"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_detector_matches_jax(heads, train):
    K = 0 if heads == "boxes" else 5
    jm, variables, pm = detector_pair(K, heads == "kpt_heatmaps", seed=1)
    x = _images(2)
    pm.train(train)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    if train:
        ref, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        new = state_dict_from_jax(variables["params"],
                                  jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        got = pm.state_dict()
        for k in new:
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), new[k], rtol=0, atol=1e-5, err_msg=k)
    else:
        ref = jm.apply(variables, jnp.asarray(x), train=False)
    assert set(out) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert out[k].shape == r.shape and r.shape[1:3] == (16, 16), k
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0,
                                   atol=(1e-4 if train else 1e-5) * scale, err_msg=k)


def test_nearest_resize_is_jax_nearest():
    """jax.image.resize(..., "nearest") at exactly 2x takes pixel i // 2: it
    equals F.interpolate(scale_factor=2, mode="nearest") bit for bit."""
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), "nearest")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), x.repeat(2, 1).repeat(2, 2))


# --------------------------------------------------------------------------
# the codec and the loss


def _boxes(seed, B=2, m=M, hw=IMG, off_grid=True):
    """(boxes (B, m, 4), mask (B, m)) in input pixels: one padded row, one
    box whose center falls off the grid, one of zero width."""
    rng = np.random.default_rng(seed)
    H, W = hw
    xy = rng.uniform(0, [W * 0.8, H * 0.8], (B, m, 2))
    wh = rng.uniform(4, [W * 0.5, H * 0.6], (B, m, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.ones((B, m), np.float32)
    mask[0, -1] = 0.0
    if off_grid:
        boxes[1, 0] = [W - 2.0, H * 0.5, 10.0, 6.0]  # center at x = W + 3
        boxes[1, 1, 2] = 0.0
    return boxes, mask


def _keypoints(seed, boxes, K=5):
    rng = np.random.default_rng(seed + 7)
    B, m = boxes.shape[:2]
    kp = boxes[..., None, :2] + rng.uniform(0, 1, (B, m, K, 2)) * boxes[..., None, 2:]
    v = rng.integers(0, 3, (B, m, K, 1)).astype(np.float32)
    kp[0, 1, 0] = [-3.0, 5.0]  # a joint off the grid
    return np.concatenate([kp, v], -1).astype(np.float32)


def test_gaussian_radius_matches_jax():
    rng = np.random.default_rng(0)
    h, w = rng.uniform(0.2, 60, (2, 50)).astype(np.float32)
    for iou in (0.3, 0.7):
        np.testing.assert_allclose(
            gaussian_radius(torch.from_numpy(h), torch.from_numpy(w), iou).numpy(),
            np.asarray(jax_codec.gaussian_radius(jnp.asarray(h), jnp.asarray(w), iou)),
            rtol=1e-6, atol=1e-6)


def _encode_both(case, seed=0):
    boxes, mask = _boxes(seed)
    kw = {}
    if case in ("ignore", "kpts", "kpt_heatmaps"):
        ig, igm = _boxes(seed + 1, m=3, off_grid=False)
        igm[1, 2] = 0.0
        kw.update(ignore_boxes=ig, ignore_mask=igm)
    if case in ("kpts", "kpt_heatmaps"):
        kw["keypoints"] = _keypoints(seed, boxes)
        kw["kpt_heatmaps"] = case == "kpt_heatmaps"
    feat = (IMG[0] // 4, IMG[1] // 4)
    t = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v  # noqa: E731
    ours = encode_boxes(t(boxes), t(mask), feat, 4, **{k: t(v) for k, v in kw.items()})
    ref = jax_codec.encode_boxes(jnp.asarray(boxes), jnp.asarray(mask), feat, 4,
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
    return ours, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("case", ["plain", "ignore", "kpts", "kpt_heatmaps"])
def test_encode_boxes_matches_jax(case):
    """Every field: integer cells and masks ==, float targets within 1e-6;
    the centers are exactly 1.0 where the loss looks for them."""
    ours, ref = _encode_both(case)
    assert set(ours) == set(ref)
    for k, r in ref.items():
        o = ours[k].numpy()
        assert o.shape == r.shape, k
        if r.dtype in (np.int32, np.bool_):
            assert o.dtype == r.dtype, k
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-6, err_msg=k)
    assert ref["mask"][1, 0] == ref["mask"][1, 1] == ref["mask"][0, -1] == 0  # off grid, w 0, pad
    for heat in ("heat", "kpt_heat"):
        if heat in ref:
            np.testing.assert_array_equal(ours[heat].numpy() >= 1 - 1e-6, ref[heat] >= 1 - 1e-6)
    if case != "plain":
        assert 0 < ref["neg_weight"].mean() < 1


def _maps(seed, B=2, H=16, W=16, ties=True):
    """Center logits with deliberate ties: a low random background (after
    the peak NMS every non-peak cell is exactly 0.0, so a frame with fewer
    than k peaks ties in its tail), a plateau of equal peaks, and two
    isolated peaks of equal height."""
    rng = np.random.default_rng(seed)
    c = (-8.0 + 0.5 * rng.normal(size=(B, H, W, 1))).astype(np.float32)
    c[0, 2, 3] = c[0, 9, 12] = 1.5  # equal isolated peaks
    c[0, 5:7, 5:7] = 0.7  # a 2 x 2 plateau: every cell a peak
    c[1, rng.integers(0, H, 6), rng.integers(0, W, 6), 0] = rng.normal(size=6)
    if not ties:
        c += rng.normal(size=c.shape).astype(np.float32) * 0.01
    size = rng.uniform(1, 6, (B, H, W, 2)).astype(np.float32)
    size[0, 0, 0] = -1.0  # clipped at 0
    offset = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    return c, size, offset


@pytest.mark.parametrize("k", [4, 12, 40])
def test_decode_boxes_matches_jax_with_ties(k):
    """lax.top_k's order among equal scores (the lower index first): the
    tied peaks and the 0.0 tail come out in JAX's order, boxes ==."""
    c, size, offset = _maps(0)
    boxes, scores = decode_boxes(torch.from_numpy(c), torch.from_numpy(size),
                                 torch.from_numpy(offset), k=k, stride=4)
    rb, rs = jax_codec.decode_boxes(jnp.asarray(c), jnp.asarray(size), jnp.asarray(offset),
                                    k=k, stride=4)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(rb))
    s = np.asarray(rs)
    assert (s[0, 1:] == s[0, :-1]).any()  # ties among frame 0's kept peaks
    if k == 40:
        assert (s == 0).sum(1).min() > 1  # fewer peaks than k: a tail of 0.0


@pytest.mark.parametrize("heads", ["boxes", "kpts", "kpt_heatmaps"])
def test_detection_loss_matches_jax(heads):
    """Each term of the loss on encoded targets against random maps."""
    case = {"boxes": "ignore", "kpts": "kpts", "kpt_heatmaps": "kpt_heatmaps"}[heads]
    ours_t, ref_t = _encode_both(case, seed=3)
    rng = np.random.default_rng(3)
    pred = dict(center=rng.normal(-2, 2, (2, 16, 16, 1)), size=rng.normal(3, 2, (2, 16, 16, 2)),
                offset=rng.random((2, 16, 16, 2)))
    if heads != "boxes":
        pred["kpts"] = rng.normal(0, 3, (2, 16, 16, 10))
    if heads == "kpt_heatmaps":
        pred["kpt_heat"] = rng.normal(-2, 2, (2, 16, 16, 5))
        pred["kpt_offset"] = rng.random((2, 16, 16, 2))
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    _, ours = detection_loss({k: torch.from_numpy(v) for k, v in pred.items()}, ours_t)
    _, ref = jax_detection_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                {k: jnp.asarray(v) for k, v in ref_t.items()})
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_detector_schedule_matches_optax():
    """The detector's warm-up cosine with the exact warm-up count
    max(total // 20, 1), against optax within 3e-7 of the peak."""
    import optax

    for lr, total in ((2.5e-4, 1500), (1e-3, 3), (2.5e-4, 61), (5e-4, 20)):
        warmup = max(total // 20, 1)
        ref = jax.jit(optax.warmup_cosine_decay_schedule(lr / 25, lr, warmup,
                                                         max(total, warmup + 1)))
        ours = detect_train.detector_optimizer(lr, total).schedule
        assert ours is not None
        mine = warmup_cosine_decay_schedule(lr / 25, lr, warmup, max(total, warmup + 1))
        for count in range(0, total + 3, max(1, total // 97)):
            r = float(ref(count))
            assert abs(float(mine(torch.tensor(count, dtype=torch.int32))) - r) <= 3e-7 * lr
            assert abs(float(ours(torch.tensor(count, dtype=torch.int32))) - r) <= 3e-7 * lr


# --------------------------------------------------------------------------
# training


def _frame_batch(seed, K=0, B=2):
    """A FrameDetectionDataset-like host batch of native 96 x 128 frames."""
    rng = np.random.default_rng(seed)
    boxes, mask = _boxes(seed, B=B, hw=FRAME_HW)
    ig, igm = _boxes(seed + 1, B=B, m=2, hw=FRAME_HW, off_grid=False)
    batch = dict(frame=rng.integers(0, 256, (B, *FRAME_HW, 3), dtype=np.uint8), boxes=boxes,
                 box_mask=mask, ignore_boxes=ig, ignore_mask=igm,
                 image_id=np.arange(B, dtype=np.int64))
    if K:
        batch["keypoints"] = _keypoints(seed, boxes, K)
    return batch


@pytest.mark.parametrize("heads", ["boxes", "kpt_heatmaps"])
def test_trainer_steps_match_jax(heads):
    """Two f32 DetectorTrainer steps against JAX's jitted step, from one
    state carried by compat/from_jax.py (params, batch_stats, Adam's mu, nu
    and count, the schedule's count): loss terms, params, BN statistics."""
    K = 5 if heads == "kpt_heatmaps" else 0
    kw = dict(img_size=IMG, preset="conv-t", total_steps=40, seed=2, num_keypoints=K,
              kpt_heatmaps=bool(K))
    jt = JaxTrainer.create(**kw)
    jt = JaxTrainer(model=JaxDetector(img_size=IMG, preset="conv-t", dtype=jnp.float32,
                                      num_keypoints=K, kpt_heatmaps=bool(K)),
                    state=jt.state, tx=jt.tx)
    step = jax.jit(jt._make_step())
    pt = DetectorTrainer.create(**kw, dtype=torch.float32, device="cpu")
    load_jax_train_state(pt.state, jax.device_get(jt.state))
    jstate = jt.state
    for i in range(2):
        batch = _frame_batch(10 + i, K)
        jstate, jterms = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        terms = pt.train_step(batch)
        assert set(terms) == set(jterms)
        for k in jterms:
            np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=1e-4, err_msg=k)
    host = jax.device_get(jstate)
    ref = state_dict_from_jax(host.params, host.batch_stats)
    got = pt.model.state_dict()
    assert int(pt.state.step) == int(host.step) == 2
    # Adam moves an element by at most its step's lr (times 1 + wd |p|): two
    # steps from equal params differ by at most twice the sum.
    lrs = sum(float(pt.tx.schedule(torch.tensor(c))) for c in range(2))
    for k, r in ref.items():
        d = np.abs(got[k].numpy() - r)
        if "running" in k:
            assert d.max() <= 1e-4 * max(1.0, np.abs(r).max()), k
        elif r.dtype == np.float32:
            assert d.max() <= 2 * lrs * (1 + 1e-4 * np.abs(r).max()), k
            assert np.median(d) <= 0.05 * lrs, k


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DetectorTrainer.create(img_size=IMG)


# --------------------------------------------------------------------------
# host pieces: ==


def test_expand_detections_matches_jax():
    rng = np.random.default_rng(0)
    det = rng.uniform(0, 80, (9, 4)).astype(np.float32)
    det[2, 2] = det[3, 3] = 0.0  # degenerate: floored at 1 px
    for size, scale in (((256, 192), 1.25), ((64, 48), 1.0), ((32, 64), 1.4)):
        ours = expand_detections(det, size, scale)
        np.testing.assert_array_equal(ours, jax_pipeline.expand_detections(det, size, scale))
        np.testing.assert_array_equal(
            expand_boxes_jax(torch.from_numpy(det), size, scale).numpy(),
            np.asarray(jax_expand_boxes(jnp.asarray(det), size, scale)))
    assert expand_detections(np.zeros((0, 4)), (256, 192)).shape == (0, 4)


def test_box_iou_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 50, (7, 4))
    b = np.concatenate([a[:3] + rng.normal(0, 2, (3, 4)), rng.uniform(0, 50, (5, 4))])
    b[4, 2] = 0.0
    np.testing.assert_array_equal(box_iou_matrix(a, b), jax_pipeline.box_iou_matrix(a, b))
    np.testing.assert_array_equal(box_iou_matrix(a[:0], b), jax_pipeline.box_iou_matrix(a[:0], b))


def test_detection_pr_matches_jax():
    rng = np.random.default_rng(2)
    images = []
    for i in range(6):
        gt = rng.uniform(0, 100, (i % 4, 4)) + [0, 0, 10, 10]
        dt = np.concatenate([gt + rng.normal(0, 3, gt.shape), rng.uniform(0, 100, (3, 4))])
        images.append(dict(dt_boxes=dt, dt_scores=rng.random(len(dt)).round(2), gt_boxes=gt,
                           ignore_boxes=rng.uniform(0, 100, (i % 2, 4)) + [0, 0, 40, 40]))
    for thr in (0.3, 0.5, 0.75):
        assert detection_pr(images, thr) == jax_pipeline.detection_pr(images, thr)
    assert detection_pr([]) == jax_pipeline.detection_pr([])


def test_frame_dataset_matches_jax(tmp_path):
    root = generate_coco_synth(tmp_path / "coco", **SYNTH)
    ann, images = root / "annotations" / "person_keypoints_train2017.json", root / "train2017"
    for K in (0, 17):
        ours = FrameDetectionDataset(ann, images, max_boxes=3, max_ignore=2, num_keypoints=K)
        ref = JaxFrameDataset(ann, images, max_boxes=3, max_ignore=2, num_keypoints=K)
        assert ours.image_ids == ref.image_ids and len(ours) == len(ref) > 0
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------
# serving and the end-to-end pipeline


def _frames(seed, n=2, hw=FRAME_HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def det_pair():
    return detector_pair(seed=4)


def test_detector_predictor_matches_jax(det_pair):
    """The full-frame resize, forward, decode and un-mapping: boxes within
    1e-4 px, scores 1e-6; detect_frame's threshold keeps the same rows."""
    jm, variables, pm = det_pair
    ours = DetectorPredictor(model=pm, max_detections=10)
    ref = jax_pipeline.DetectorPredictor(model=jm, variables=variables, max_detections=10)
    frames = _frames(0)
    (b, s), (rb, rs) = ours(frames), ref(frames)
    assert b.shape == (2, 10, 4) and s.shape == (2, 10)
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b, rb, rtol=0, atol=1e-4)
    thr = float(np.median(rs[0]))
    (db, ds), (rdb, rds) = ours.detect_frame(frames[0], thr), ref.detect_frame(frames[0], thr)
    assert len(ds) == len(rds) > 0
    np.testing.assert_allclose(db, rdb, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def pose_pair():
    from test_torch_eval import CFG17, init_pair
    return init_pair(CFG17)


def _pose_predictors(pose_pair, **kw):
    from probpose_pytorch_tpu.codec import Codec as JaxCodec
    from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
    from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
    from test_torch_eval import CFG17, CODEC_KW

    jm, variables, pm = pose_pair
    return (TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                             input_size=CFG17["img_size"], **kw),
            JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                         input_size=CFG17["img_size"], **kw))


def _close_poses(out, ref, n=None):
    """Pose fields of two predictions: keypoints within 1e-3 px and the
    other fields within 1e-4 (test_torch_frame.py's bars on crops one bf16
    ulp apart) wherever the JAX heatmaps' top-2 margin leaves the argmax
    well defined is not tested here: the tiny model's maps are peaked."""
    for k in ("keypoints", "scores", "probabilities", "visibilities", "oks", "errors"):
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3 if k == "keypoints" else 1e-4,
                                   err_msg=k)


def test_predict_frame_standalone_matches_jax(det_pair, pose_pair):
    """TopDownPredictor(detector=...).predict_frame(frame) with no boxes:
    the detector's boxes expanded to the crop (==), then the pose fields."""
    jm, variables, pm = det_pair
    port_pose, jax_pose = _pose_predictors(pose_pair)
    port_pose.detector = DetectorPredictor(model=pm, max_detections=6, score_threshold=0.0)
    jax_pose.detector = jax_pipeline.DetectorPredictor(model=jm, variables=variables,
                                                       max_detections=6, score_threshold=0.0)
    frame = _frames(1, 1)[0]
    out = port_pose.predict_frame(frame, buckets=(8,))
    ref = jax_pose.predict_frame(frame, buckets=(8,))
    assert out["boxes"].shape == (6, 4)
    np.testing.assert_allclose(out["boxes"], ref["boxes"], rtol=0, atol=1e-3)
    _close_poses(out, ref)
    nms = port_pose.predict_frame(frame, buckets=(8,), nms="oks", detector_threshold=0.0)
    assert len(nms["boxes"]) == len(nms["keep"]) <= 6
    empty = port_pose.predict_frame(frame, buckets=(8,), detector_threshold=2.0)
    assert set(empty) == {"boxes"} and empty["boxes"].shape == (0, 4)


def test_fused_matches_jax_and_the_two_stage_path(det_pair, pose_pair):
    """FusedTwoStagePredictor: every slot against JAX's fused program, and
    against the two-stage path on the same boxes; its refusals."""
    jm, variables, pm = det_pair
    port_pose, jax_pose = _pose_predictors(pose_pair)
    det = DetectorPredictor(model=pm, max_detections=8, score_threshold=0.0)
    ours = FusedTwoStagePredictor(detector=det, pose=port_pose, max_people=5,
                                  score_threshold=0.0)
    ref = JaxFused(detector=jax_pipeline.DetectorPredictor(model=jm, variables=variables,
                                                          max_detections=8),
                   pose=jax_pose, max_people=5, score_threshold=0.0)
    frames = _frames(2)
    out, r = ours(frames), ref(frames)
    assert set(out) == set(r) and out["keypoints"].shape == (2, 5, 17, 2)
    np.testing.assert_allclose(out["det_scores"], r["det_scores"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["boxes"], r["boxes"], rtol=0, atol=1e-3)
    _close_poses({k: v.reshape((10,) + v.shape[2:]) for k, v in out.items()},
                 {k: v.reshape((10,) + v.shape[2:]) for k, v in r.items()})
    two = port_pose(np.repeat(frames, 5, 0), out["boxes"].reshape(10, 4))
    _close_poses({k: v.reshape((10,) + v.shape[2:]) for k, v in out.items()}, two)
    one = ours.predict_frame(frames[0], score_threshold=float(out["det_scores"][0, 2]))
    assert len(one["det_scores"]) == 3
    with pytest.raises(ValueError, match="max_detections"):
        FusedTwoStagePredictor(detector=det, pose=port_pose, max_people=9)
    with pytest.raises(ValueError, match="return_heatmaps"):
        FusedTwoStagePredictor(detector=det, pose=_pose_predictors(
            pose_pair, return_heatmaps=True)[0])
    with pytest.raises(ValueError, match="bundles"):
        FusedTwoStagePredictor(detector=object(), pose=port_pose)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return generate_coco_synth(tmp_path_factory.mktemp("coco"), **SYNTH)


def test_evaluate_detector_topdown_matches_jax(det_pair, pose_pair, coco_root):
    """The end-to-end summary on a generate_coco_synth set: the same keys,
    AP/AR within the bar the pose fields allow (1e-3 px moves no OKS match
    of this set), det_ap50 and det_recall50 ==."""
    jm, variables, pm = det_pair
    port_pose, jax_pose = _pose_predictors(pose_pair)
    ann, images = coco_root / "annotations" / "person_keypoints_val2017.json", coco_root / "val2017"
    common = dict(score_threshold=0.0, sigmas=np.full(17, 0.5))
    ours = evaluate_detector_topdown(port_pose, DetectorPredictor(model=pm, max_detections=5),
                                     ann, images, **common)
    ref = jax_pipeline.evaluate_detector_topdown(
        jax_pose, jax_pipeline.DetectorPredictor(model=jm, variables=variables, max_detections=5),
        ann, images, **common)
    assert set(ours) == set(ref)
    for k in ("det_ap50", "det_recall50", "det_per_image"):
        assert ours[k] == ref[k], k
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-6, k


# --------------------------------------------------------------------------
# the CLI and load_detector


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, coco_root):
    out = tmp_path_factory.mktemp("det") / "run"
    logged = detect_train.main(["--data-root", str(coco_root), "--out", str(out), "--steps", "2",
                                "--batch-size", "2", "--img-size", "64", "--log-every", "1",
                                "--num-workers", "1", "--device", "cpu"])
    return out, logged


def test_detect_cli_and_load_detector(cli_run):
    """The CLI with --device cpu writes detector.json and checkpoints/2 in
    JAX's layout; load_detector restores them (from checkpoints/, reading
    detector.json beside it) into a predictor with the trained weights."""
    out, logged = cli_run
    assert len(logged) == 2 and all(np.isfinite(v) for t in logged for v in t.values())
    assert set(logged[0]) == {"total", "center", "size", "offset"}
    assert json.loads((out / "detector.json").read_text()) == dict(
        img_size=[64, 64], preset="conv-t", num_keypoints=0, kpt_heatmaps=False)
    assert (out / "checkpoints" / "2").is_file()
    det = load_detector(out / "checkpoints", score_threshold=0.0, max_detections=3,
                        device="cpu")
    assert det.model.img_size == (64, 64) and not det.model.training
    saved = torch.load(out / "checkpoints" / "2", weights_only=True)
    for k, v in det.model.state_dict().items():
        ref = saved["params"].get(k, saved["buffers"].get(k))
        torch.testing.assert_close(v, ref, rtol=0, atol=0, msg=k)
    boxes, scores = det.detect_frame(_frames(3, 1, (160, 200))[0])
    assert boxes.shape == (3, 4) and np.isfinite(boxes).all()


def test_load_detector_refusals(tmp_path, cli_run, monkeypatch):
    out, _ = cli_run
    (tmp_path / "manifest.json").write_text(json.dumps({"kind": "detector"}))
    # a bundle directory loads as a DetectorBundle: this one has no version
    with pytest.raises(ValueError, match="bundle version"):
        load_detector(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        load_detector(tmp_path, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        load_detector(out / "checkpoints", mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_detector(out / "checkpoints")
    with pytest.raises(RuntimeError, match="cuda"):
        detect_train.main(["--data-root", str(tmp_path), "--out", str(tmp_path / "o"),
                           "--steps", "1"])


def test_doctor_on_cpu(capsys):
    """doctor exits 1 without a card, naming it; its model and detector
    checks run on a device they are given (here the CPU)."""
    from probpose_pytorch_tpu_torch import doctor

    with pytest.raises(SystemExit) as exit_:
        doctor.main([])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] card: torch sees no CUDA device" in out
    assert "[ok]   native data plane: crop-resize and JPEG halves built" in out
    assert "REQUIRED CHECKS FAILED" in out
    assert doctor.detector_forward("cpu") == "boxes (1, 4, 4)"
    assert "heatmaps (1, 5, 16, 12)" in doctor.model_forward("cpu")
