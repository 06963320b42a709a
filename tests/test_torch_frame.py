"""The port's frame front end against the JAX package's, on the CPU: the
numpy copies (OKS-NMS, the one-euro smoother, the bucket ladder) equal
JAX's; the serving record's lookup; and `TopDownPredictor.predict_frame`
(buckets, frame padding, the split past the top bucket, OKS-NMS) against
JAX's `predict_frame` on the same tiny f32 model.

NMS keeps a discrete decision, so its parity cases use exact duplicate
boxes (OKS 1 within a pair) among boxes whose poses are far apart, with pose
scores checked to sit well apart first.
"""

import json

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.inference import derive_bucket_ladder as jax_ladder
from probpose_pytorch_tpu.ops import oks_nms as jax_nms
from probpose_pytorch_tpu.ops.preprocess import crop_resize as jax_crop_resize
from probpose_pytorch_tpu.utils import smoothing as jax_smoothing
from probpose_pytorch_tpu_torch import inference
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.inference import TopDownPredictor, derive_bucket_ladder
from probpose_pytorch_tpu_torch.ops import oks_nms
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize
from probpose_pytorch_tpu_torch.utils import smoothing

from test_torch_models import TINY_CFG, init_pair
from test_torch_serving import CODEC_KW, SCALED_ATOL, _top2_margin

torch.set_num_threads(2)

K = TINY_CFG["num_keypoints"]
# Fields other than the keypoints: the 1e-5 bar of test_torch_serving.py
# where both sides' crops are equal; where crop_resize's f32 product rounds
# to another bf16 value than XLA's (one ulp, at a few of a crop's values,
# checked in `_field_tol`), that file's SCALED_ATOL.
FIELD_TOL = 1e-5
KPT_TOL_PX = 1e-3


# --------------------------------------------------------------------------
# numpy copies: equal to JAX's


def _poses(seed, n, k):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 400, (n, 1, 2))
    kpts = (centers + rng.normal(0, 20, (n, k, 2))).astype(np.float32)
    kpts[n // 2] = kpts[0] + rng.normal(0, 1.0, (k, 2))  # a near-duplicate
    return kpts, rng.uniform(0.1, 1, n).astype(np.float32), rng.uniform(800, 5000, n)


@pytest.mark.parametrize("k,sigmas,visible", [(17, None, False), (5, None, True),
                                              (5, "custom", False)])
def test_oks_nms_copies_equal_jax(k, sigmas, visible):
    kpts, scores, areas = _poses(k, 12, k)
    rng = np.random.default_rng(1)
    sig = rng.uniform(0.02, 0.1, k).astype(np.float32) if sigmas else None
    vis = (rng.random((12, k)) > 0.3) if visible else None
    np.testing.assert_array_equal(oks_nms.pairwise_oks(kpts, areas, sig, vis),
                                  jax_nms.pairwise_oks(kpts, areas, sig, vis))
    for thr in (0.3, 0.9):
        np.testing.assert_array_equal(
            oks_nms.oks_nms(kpts, scores, areas, thr, sig, vis),
            jax_nms.oks_nms(kpts, scores, areas, thr, sig, vis))
        for got, ref in zip(oks_nms.soft_oks_nms(kpts, scores, None, thr, sig, vis, 5),
                            jax_nms.soft_oks_nms(kpts, scores, None, thr, sig, vis, 5)):
            np.testing.assert_array_equal(got, ref)
    for fn in ("oks_nms", "soft_oks_nms"):
        got, ref = getattr(oks_nms, fn)(kpts[:0], scores[:0]), getattr(jax_nms, fn)(kpts[:0],
                                                                                    scores[:0])
        assert [np.asarray(a).shape for a in np.atleast_1d(got)] == \
            [np.asarray(a).shape for a in np.atleast_1d(ref)]
    with pytest.raises(ValueError, match="sigmas"):
        oks_nms.pairwise_oks(kpts, areas, np.ones(k + 1))


def test_smoothing_copies_equal_jax():
    rng = np.random.default_rng(3)
    kw = dict(min_cutoff=0.5, beta=0.05, d_cutoff=2.0)
    f, g = smoothing.OneEuroFilter(**kw), jax_smoothing.OneEuroFilter(**kw)
    # times with a repeat and a step back (both ignored), then a jump
    for t in (0.0, 0.03, 0.03, 0.02, 0.07, 0.1, 0.5):
        x = rng.normal(0, 5, (4, 2))
        np.testing.assert_array_equal(f(x, t), g(x, t))
    p, q = smoothing.PoseSmoother(max_gap=0.1), jax_smoothing.PoseSmoother(max_gap=0.1)
    for i, ids in enumerate(([0, 1], [1, 0, 2], [2], [0, 3], [3, 0])):
        x = rng.normal(100, 10, (len(ids), 17, 2)).astype(np.float32)
        np.testing.assert_array_equal(p.update(x, ids, i / 15), q.update(x, ids, i / 15))
    assert sorted(p._filters) == sorted(q._filters)


@pytest.mark.parametrize("sweep,margin", [
    ([dict(batch=1, ms_per_batch=5.0), dict(batch=8, ms_per_batch=5.0),
      dict(batch=32, ms_per_batch=5.1), dict(batch=128, ms_per_batch=13.0),
      dict(batch=384, ms_per_batch=39.0)], 0.10),
    ([dict(batch=b, ms_per_batch=float(b)) for b in (8, 1, 4, 2)], 0.10),
    ([dict(batch=4, ms_per_batch=9.5), dict(batch=8, ms_per_batch=10.0)], 0.10),
    ([dict(batch=4, ms_per_batch=9.5), dict(batch=8, ms_per_batch=10.0)], 0.01),
])
def test_derive_bucket_ladder_equals_jax(sweep, margin):
    assert derive_bucket_ladder(sweep, margin) == jax_ladder(sweep, margin)


@pytest.mark.parametrize("sweep", [[], [dict(batch=1, ms_per_batch=0.0)]])
def test_derive_bucket_ladder_refuses_as_jax(sweep):
    for fn in (derive_bucket_ladder, jax_ladder):
        with pytest.raises(ValueError):
            fn(sweep)


# --------------------------------------------------------------------------
# the serving record


def _record() -> dict:
    from importlib.resources import files

    return json.loads(files("probpose_pytorch_tpu_torch")
                      .joinpath("configs/autotune_serving.json").read_text())


def test_autotune_record_holds_cards_only():
    """The port's record is keyed by CUDA device names, each entry with the
    card's power limit, a sweep, and the ladder derive_bucket_ladder makes
    of its bucket sweep; no TPU entry."""
    record = _record()
    assert record and all(name.startswith("NVIDIA") for name in record)
    for entry in record.values():
        assert {"power_limit", "sweep", "batch", "bucket_sweep", "bucket_ladder"} <= set(entry)
        assert tuple(entry["bucket_ladder"]) == derive_bucket_ladder(entry["bucket_sweep"])
        assert entry["batch"] in [r["batch"] for r in entry["sweep"]]


def test_autotune_lookup_without_cuda(monkeypatch):
    """No card: {} and the defaults, without asking torch for a device name
    (a CPU build of torch raises AssertionError there)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_name(*args):
        raise AssertionError("Torch not compiled with CUDA enabled")

    monkeypatch.setattr(torch.cuda, "get_device_name", no_name)
    assert inference._load_autotune_entry() == {}
    assert inference.tuned_serving_batch() == 64
    assert inference.tuned_bucket_ladder() is None


def test_autotune_lookup_by_card_name(monkeypatch):
    name, entry = next(iter(_record().items()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert inference._load_autotune_entry() == entry
    assert inference.tuned_serving_batch() == entry["batch"]
    assert inference.tuned_bucket_ladder() == tuple(entry["bucket_ladder"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA B200")
    assert inference._load_autotune_entry() == {}


# --------------------------------------------------------------------------
# predict_frame against JAX's


@pytest.fixture(scope="module")
def frame_pair():
    jm, variables, pm = init_pair()
    jax_pred = JaxPredictor(model=jm, variables=variables,
                            codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                            input_size=TINY_CFG["img_size"], return_heatmaps=True)
    port_pred = TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                                 input_size=TINY_CFG["img_size"], return_heatmaps=True)
    return jax_pred, port_pred


def _frame_and_boxes(seed, n):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 40, 50], [60, 40, 90, 70], (n, 4)).astype(np.float32)
    return frame, boxes


def _field_tol(frame, boxes, multiple=64):
    """FIELD_TOL where the two sides' crops of the padded frame are equal,
    else SCALED_ATOL, after checking that they differ by at most one bf16
    ulp, at a few values (under 2 %: one 64 x 48 crop of the video tests
    has 96 of its 9,216 one ulp apart)."""
    if multiple:
        frame = np.pad(frame, ((0, -frame.shape[0] % multiple),
                               (0, -frame.shape[1] % multiple), (0, 0)))
    frames = np.broadcast_to(frame, (len(boxes), *frame.shape))
    crops = crop_resize(torch.from_numpy(np.ascontiguousarray(frames)),
                        torch.from_numpy(boxes), TINY_CFG["img_size"]).numpy()
    ref = np.asarray(jax_crop_resize(frames, boxes, TINY_CFG["img_size"], "bilinear_matmul"))
    assert (np.abs(crops - ref) <= 2.0**-7 * np.abs(ref)).all()
    assert (crops != ref).mean() < 0.02
    return FIELD_TOL if np.array_equal(crops, ref) else SCALED_ATOL


def _agree(out, ref, atol=FIELD_TOL):
    """JAX's keys and shapes; keypoints within KPT_TOL_PX where the
    convolved map's top-2 margin exceeds 1e-4 (from JAX's maps), the other
    fields within `atol` (and 1e-4 relative); `keep` equal."""
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        assert np.isfinite(out[k]).all(), k
    if "keep" in ref:
        np.testing.assert_array_equal(out["keep"], ref["keep"])
    ok = _top2_margin(ref["heatmaps"]) > 1e-4
    assert ok.mean() > 0.7
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], atol=KPT_TOL_PX)
    for k in set(ref) - {"keypoints", "keep"}:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=atol, err_msg=k)


def _spy_batches(monkeypatch, pred):
    """The batch sizes (crops, frames) of each forward `pred` runs."""
    seen = []
    call = type(pred).__call__

    def spy(self, frames, boxes, frame_ids=None):
        seen.append((len(boxes), len(frames)))
        return call(self, frames, boxes, frame_ids)

    monkeypatch.setattr(type(pred), "__call__", spy)
    return seen


@pytest.mark.parametrize("n,batches", [(3, [(4, 1)]), (8, [(8, 1)]),
                                       (11, [(8, 1), (4, 1)])])
def test_predict_frame_matches_jax(frame_pair, monkeypatch, n, batches):
    """Buckets (4, 8); the 120 x 160 frame padded to 128 x 192 and passed
    once; 11 boxes split at the top bucket into 8 + 3."""
    jax_pred, port_pred = frame_pair
    frame, boxes = _frame_and_boxes(n, n)
    ref = jax_pred.predict_frame(frame, boxes, buckets=(4, 8))
    seen = _spy_batches(monkeypatch, port_pred)
    out = port_pred.predict_frame(frame, boxes, buckets=(4, 8))
    assert seen == batches
    assert out["keypoints"].shape == (n, K, 2)
    _agree(out, ref, _field_tol(frame, boxes))
    # the port's direct call on the unpadded frame, one row per box
    direct = port_pred(np.broadcast_to(frame, (n, *frame.shape)), boxes)
    for k in direct:
        np.testing.assert_allclose(out[k], direct[k], rtol=0, atol=1e-5, err_msg=k)


def test_predict_frame_padding_samples_black(frame_pair):
    """A box past the frame's edge reads black in the padded frame and in
    the exact one (frame_size_multiple=None), in the port and in JAX."""
    jax_pred, port_pred = frame_pair
    frame, _ = _frame_and_boxes(1, 1)
    edge = np.array([[130.0, 90.0, 60.0, 60.0], [-20.0, -10.0, 50.0, 70.0]], np.float32)
    padded = port_pred.predict_frame(frame, edge, buckets=(4, 8))
    try:
        port_pred.frame_size_multiple = jax_pred.frame_size_multiple = None
        exact = port_pred.predict_frame(frame, edge, buckets=(4, 8))
        ref = jax_pred.predict_frame(frame, edge, buckets=(4, 8))
    finally:
        port_pred.frame_size_multiple = jax_pred.frame_size_multiple = 64
    _agree(exact, ref, _field_tol(frame, edge, None))
    for k in exact:
        np.testing.assert_allclose(padded[k], exact[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("nms", ["oks", "soft_oks"])
def test_predict_frame_nms_matches_jax(frame_pair, nms):
    """Each of three well-separated boxes twice: "oks" keeps one of each
    pair, "soft_oks" keeps all six with the duplicates' scores decayed."""
    jax_pred, port_pred = frame_pair
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    base = np.array([[0, 0, 48, 64], [100, 50, 48, 64], [50, 10, 60, 80]], np.float32)
    boxes = np.concatenate([base, base])
    ref = jax_pred.predict_frame(frame, boxes, buckets=(8,), nms=nms)
    raw = jax_pred.predict_frame(frame, boxes, buckets=(8,))
    scores = (raw["scores"] * raw["probabilities"][:, 0]).mean(axis=1)
    assert np.array_equal(scores[:3], scores[3:])  # duplicates tie exactly
    assert np.diff(np.sort(scores[:3])).min() > 1e-3  # the others far apart
    out = port_pred.predict_frame(frame, boxes, buckets=(8,), nms=nms)
    _agree(out, ref, _field_tol(frame, boxes))
    if nms == "oks":
        assert sorted(out["keep"] % 3) == [0, 1, 2] and len(out["keep"]) == 3
    else:
        assert len(out["keep"]) == 6
        assert (out["pose_scores"][3:] < out["pose_scores"][:3].min()).all()


def test_predict_frame_no_boxes(frame_pair):
    _, port_pred = frame_pair
    frame, _ = _frame_and_boxes(0, 0)
    assert port_pred.predict_frame(frame, np.zeros((0, 4), np.float32), buckets=(4,)) == {}
    assert port_pred.predict_frame(frame, np.zeros((0, 4), np.float32), nms="oks") == {}
    with pytest.raises(ValueError, match="needs boxes"):
        port_pred.predict_frame(frame)
    with pytest.raises(ValueError, match="unknown nms"):
        port_pred.predict_frame(frame, np.ones((1, 4), np.float32), buckets=(1,), nms="x")


def test_predictor_takes_a_detector(frame_pair):
    """TopDownPredictor(detector=...): predict_frame without boxes uses the
    detector's boxes above detector_threshold, expanded to the crop, and
    returns them; with boxes the detector is not asked."""
    from probpose_pytorch_tpu_torch.detect import DetectorPredictor
    from probpose_pytorch_tpu_torch.detect.pipeline import expand_detections
    from test_torch_detect import detector_pair

    _, port_pred = frame_pair
    det = DetectorPredictor(model=detector_pair(seed=14)[2], max_detections=5)
    pred = TopDownPredictor(model=port_pred.model, codec=port_pred.codec,
                            input_size=port_pred.input_size, detector=det)
    frame, boxes = _frame_and_boxes(1, 2)
    out = pred.predict_frame(frame, buckets=(8,), detector_threshold=0.0)
    want = expand_detections(det.detect_frame(frame, 0.0)[0], pred.input_size)
    np.testing.assert_array_equal(out["boxes"], want)
    direct = pred.predict_frame(frame, want, buckets=(8,))
    for k in direct:
        np.testing.assert_array_equal(out[k], direct[k], err_msg=k)
    assert set(pred.predict_frame(frame, boxes, buckets=(8,))) == set(direct)


def test_predict_frame_default_buckets(frame_pair, monkeypatch):
    """Without buckets: the card's recorded ladder; without a record,
    powers of two up to tuned_serving_batch()."""
    _, port_pred = frame_pair
    frame, boxes = _frame_and_boxes(5, 5)
    entry = next(iter(_record().values()))
    seen = _spy_batches(monkeypatch, port_pred)
    monkeypatch.setattr(inference, "_load_autotune_entry", lambda: entry)
    port_pred.predict_frame(frame, boxes[:3])
    ladder = entry["bucket_ladder"]
    assert seen[-1] == (next(b for b in ladder if b >= 3), 1)
    monkeypatch.setattr(inference, "_load_autotune_entry", lambda: {"batch": 4})
    port_pred.predict_frame(frame, boxes)
    assert seen[-2:] == [(4, 1), (1, 1)]  # buckets (1, 2, 4): 5 = 4 + 1
