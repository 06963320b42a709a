"""The port's evaluation (probpose_pytorch_tpu_torch/eval/, viz.py) against
the JAX package's, and the port's eval CLI, on the CPU.

The evaluators, the results interchange, calibration and the host metrics
are numpy copies: fed the same inputs they must give the same summaries
(==). `evaluate_topdown` runs the tiny float32 model pair of
tests/test_torch_models.py through each package's predictor on a small
COCO-format set written by `generate_coco_synth`.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu import viz as jax_viz
from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.data.coco import COCOPoseDataset as JaxCOCOPoseDataset
from probpose_pytorch_tpu.eval import calibration as jax_cal
from probpose_pytorch_tpu.eval import coco_eval as jax_coco_eval
from probpose_pytorch_tpu.eval import metrics_host as jax_metrics
from probpose_pytorch_tpu.eval import results as jax_results
from probpose_pytorch_tpu.eval.pipeline import evaluate_topdown as jax_evaluate_topdown
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.inference import _scale_boxes as jax_scale_boxes
from probpose_pytorch_tpu.ops.heatmap import build_oks_conv_operators, oks_conv
from probpose_pytorch_tpu_torch import viz
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.data import COCOPoseDataset, generate_coco_synth
from probpose_pytorch_tpu_torch.data.coco import COCO_SIGMAS
from probpose_pytorch_tpu_torch.eval import calibration, coco_eval, metrics_host, results
from probpose_pytorch_tpu_torch.eval import run as eval_run
from probpose_pytorch_tpu_torch.eval.pipeline import evaluate_topdown
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.train import cli
from test_coco_protocol import _random_dataset
from test_torch_models import TINY_CFG, init_pair

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

SYNTH = dict(n_train_images=4, n_val_images=3, frame_hw=(160, 200), seed=3)
CFG17 = dict(TINY_CFG, num_keypoints=17)
CODEC_KW = dict(input_size=(48, 64), heatmap_size=(12, 16),
                sigmas=np.full(17, 0.05, np.float32), sigma=2.0)
# The JAX eval CLI's summary keys (probpose_pytorch_tpu/eval/run.py).
AP_KEYS = ("AP", "AP50", "AP75", "AR", "AR50", "AR75", "AP_medium", "AP_large",
           "AR_medium", "AR_large")
LINE_KEYS = AP_KEYS + ("EPE", "PCK@0.2", "AUC")
MARGIN = 1e-4


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return generate_coco_synth(tmp_path_factory.mktemp("coco"), **SYNTH)


def _val(root):
    return root / "annotations" / "person_keypoints_val2017.json", root / "val2017"


def _feed(ev, images, K):
    """The fixture images of tests/test_coco_protocol.py into evaluator `ev`,
    as that file's oracle test feeds them."""
    for img in images:
        if not img["dts"] and not img["gts"]:
            continue
        D, G = len(img["dts"]), len(img["gts"])
        ev.add_image(
            np.stack([d["keypoints"] for d in img["dts"]]) if D else np.zeros((0, K, 3)),
            np.array([d["score"] for d in img["dts"]]),
            np.stack([g["keypoints"] for g in img["gts"]]) if G else np.zeros((0, K, 3)),
            np.array([g["area"] for g in img["gts"]]),
            np.array([g["bbox"] for g in img["gts"]]).reshape(G, 4),
            gt_ignore=np.array([g["ignore"] for g in img["gts"]], bool),
            gt_crowd=np.array([g.get("iscrowd", 0) for g in img["gts"]], bool),
        )
    return ev.summarize()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_evaluator_matches_jax(seed):
    images, sigmas = _random_dataset(seed)
    ours = _feed(coco_eval.COCOKeypointEvaluator(sigmas), images, len(sigmas))
    ref = _feed(jax_coco_eval.COCOKeypointEvaluator(sigmas), images, len(sigmas))
    assert ours == ref
    img = next(i for i in images if i["dts"] and i["gts"])
    args = (np.stack([d["keypoints"] for d in img["dts"]]),
            np.stack([g["keypoints"] for g in img["gts"]]),
            np.array([g["area"] for g in img["gts"]]), sigmas,
            np.array([g["bbox"] for g in img["gts"]]))
    np.testing.assert_array_equal(coco_eval.oks_matrix(*args), jax_coco_eval.oks_matrix(*args))
    np.testing.assert_array_equal(coco_eval.detection_areas(args[0]),
                                  jax_coco_eval.detection_areas(args[0]))


def _noisy_results(ds, seed):
    """COCO keypoint results near each record's ground truth, one spurious
    result, and one on an image the annotations do not hold."""
    rng = np.random.default_rng(seed)
    out = []
    for rec in ds.records:
        kp = rec["keypoints"][:, :2] + rng.normal(0, 4.0, (17, 2))
        out.append(results.keypoint_result(rec["image_id"], kp, rng.random(17), rng.random()))
    out.append(results.keypoint_result(ds.records[0]["image_id"], rng.uniform(0, 150, (17, 2)),
                                       rng.random(17), 0.99))
    out.append(results.keypoint_result(999_999, rng.uniform(0, 150, (17, 2)), rng.random(17), 0.5))
    return out


def test_score_results_matches_jax(coco_root):
    ann, images = _val(coco_root)
    ds = COCOPoseDataset(ann, images, (64, 48))
    ref_ds = JaxCOCOPoseDataset(ann, images, (64, 48))
    res = _noisy_results(ds, 0)
    ours = results.score_results(res, ds)
    assert ours == jax_results.score_results(res, ref_ds)
    assert ours["n_results"] == len(ds.records) + 1  # the unknown image is dropped
    assert 0.0 < ours["AP"] < 1.0


def test_perfect_predictions_score_ap_one(coco_root):
    ann, images = _val(coco_root)
    ds = COCOPoseDataset(ann, images, (64, 48))
    perfect = [results.keypoint_result(r["image_id"], r["keypoints"][:, :2], np.ones(17), 0.9)
               for r in ds.records]
    s = results.score_results(perfect, ds)
    assert s["AP"] == pytest.approx(1.0) and s["AR"] == pytest.approx(1.0)
    none = results.score_results([], ds)
    assert none["AR"] in (0.0, -1.0) and none["n_images"] >= 3


def test_results_round_trip(tmp_path, coco_root):
    ann, images = _val(coco_root)
    res = _noisy_results(COCOPoseDataset(ann, images, (64, 48)), 1)
    path = tmp_path / "preds.json"
    results.save_results(res, path)
    assert results.load_results(path) == res == jax_results.load_results(path)
    (tmp_path / "bad.json").write_text(json.dumps([{"image_id": 1, "keypoints": []}]))
    with pytest.raises(ValueError, match="missing 'score'"):
        results.load_results(tmp_path / "bad.json")
    (tmp_path / "obj.json").write_text(json.dumps({"image_id": 1}))
    with pytest.raises(ValueError, match="JSON list"):
        results.load_results(tmp_path / "obj.json")


@pytest.mark.parametrize("case", ["mixed", "overconfident", "one class", "saturated"])
def test_calibration_matches_jax(case):
    rng = np.random.default_rng(5)
    p = rng.random(400)
    y = (rng.random(400) < p).astype(np.float64)
    if case == "overconfident":
        p = np.where(p > 0.5, 1 - (1 - p) ** 3, p**3)
    elif case == "one class":
        y[:] = 1.0
    elif case == "saturated":
        p[:40], p[40:80] = 0.0, 1.0
    ours, ref = calibration.calibration_report(p, y), jax_cal.calibration_report(p, y)
    assert ours == ref
    assert (calibration.P_LO, calibration.P_HI) == (jax_cal.P_LO, jax_cal.P_HI)
    assert calibration.fit_temperature(p, y) == jax_cal.fit_temperature(p, y)
    assert calibration.balanced_accuracy(p, y) == jax_cal.balanced_accuracy(p, y)
    np.testing.assert_array_equal(calibration.apply_temperature(p, 1.7),
                                  jax_cal.apply_temperature(p, 1.7))
    bins, ref_bins = calibration.reliability_bins(p, y, 10), jax_cal.reliability_bins(p, y, 10)
    for k in ref_bins:
        np.testing.assert_array_equal(bins[k], ref_bins[k])
    for fn in ("expected_calibration_error", "max_calibration_error", "brier_score", "nll"):
        assert getattr(calibration, fn)(p, y) == getattr(jax_cal, fn)(p, y), fn


def test_host_metrics_match_jax():
    rng = np.random.default_rng(6)
    hm, target = rng.random((3, 5, 16, 12)), rng.random((3, 5, 16, 12))
    mask = rng.random((3, 5)) > 0.2
    ours = metrics_host.pose_pck_accuracy(hm, target, mask, thr=0.1)
    ref = jax_metrics.pose_pck_accuracy(hm, target, mask, thr=0.1)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1:] == ref[1:]
    dt, gt = rng.random(200), rng.random(200) > 0.5
    m = rng.random(200) > 0.1
    assert (metrics_host.balanced_binary_accuracy_sampled(dt, gt, m, np.random.default_rng(1))
            == jax_metrics.balanced_binary_accuracy_sampled(dt, gt, m, np.random.default_rng(1)))
    assert metrics_host.masked_mae(dt, gt, m) == jax_metrics.masked_mae(dt, gt, m)


def test_viz_matches_jax():
    import PIL.Image

    rng = np.random.default_rng(7)
    kp, probs = rng.uniform(0, 60, (17, 2)), rng.random(17)
    a = viz.draw_keypoints(PIL.Image.new("RGB", (64, 64)), kp, probs, prob_threshold=0.3)
    b = jax_viz.draw_keypoints(PIL.Image.new("RGB", (64, 64)), kp, probs, prob_threshold=0.3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bins = jax_cal.calibration_report(rng.random(100), rng.random(100) > 0.5)["bins"]
    np.testing.assert_array_equal(np.asarray(viz.reliability_diagram(bins, "t")),
                                  np.asarray(jax_viz.reliability_diagram(bins, "t")))


class _Recorder:
    """A predictor that keeps every (crops, boxes, outputs) it served."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.input_size = predictor.input_size
        self.calls = []

    def __call__(self, crops, boxes):
        out = self.predictor(crops, boxes)
        self.calls.append((crops, boxes, out))
        return out


def _well_defined(jax_pred_kw, jm, variables, crops, boxes, scales):
    """Keypoints whose OKS-convolved (flip-averaged) map has a top-2 margin
    above MARGIN at every scale, from JAX's maps."""
    one = JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                       input_size=CFG17["img_size"], return_heatmaps=True, **jax_pred_kw)
    ops = build_oks_conv_operators(CODEC_KW["sigmas"], 16, 12)
    ok = np.ones(boxes.shape[:1] + (17,), bool)
    for s in scales:
        b = boxes if s == 1.0 else np.asarray(jax_scale_boxes(jnp.asarray(boxes), s))
        hm = one(crops, b)["heatmaps"]
        conv = np.sort(np.asarray(oks_conv(jnp.asarray(hm), ops)).reshape(len(b), 17, -1), -1)
        ok &= conv[..., -1] - conv[..., -2] > MARGIN
    return ok


@pytest.fixture(scope="module")
def pair17():
    return init_pair(CFG17)


# The summary's bound: every well-defined keypoint agrees within 1e-3 px,
# so AP and AR can move only where a keypoint that is not well defined
# lands elsewhere; such a keypoint moves its instance's OKS and so at most
# that instance's match at each of the 10 OKS thresholds. With n instances
# that moves AP or AR by at most 1/n for each instance with a keypoint more
# than 1e-3 px apart, and EPE by at most the crop's diagonal over 17 for
# each; 1e-6 is left for scores that differ in their last bits. The
# evaluation's sigmas are wide (0.5), so that the random model's OKS spans
# the thresholds and AP is not 0.
WIDE_SIGMAS = np.full(17, 0.5)
@pytest.mark.parametrize("tta", ["plain", "flip, scales, temperatures"])
def test_evaluate_topdown_matches_jax(pair17, coco_root, tta):
    jm, variables, pm = pair17
    kw = {} if tta == "plain" else dict(flip_test=True, scale_test=(0.9, 1.1),
                                        calibration={"presence": 1.6, "visibility": 0.7})
    scales = kw.get("scale_test", (1.0,))
    jax_pred = _Recorder(JaxPredictor(model=jm, variables=variables,
                                      codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                                      input_size=CFG17["img_size"], **kw))
    port_pred = _Recorder(TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                                           input_size=CFG17["img_size"], **kw))
    ann, images = _val(coco_root)
    common = dict(batch_size=4, sigmas=WIDE_SIGMAS, calibration=True, per_joint=True, track_instances=True,
                  collect_predictions=True, num_workers=1)
    ours = evaluate_topdown(port_pred, COCOPoseDataset(ann, images, CFG17["img_size"]), **common)
    ref = jax_evaluate_topdown(jax_pred, JaxCOCOPoseDataset(ann, images, CFG17["img_size"]),
                               **common)
    n = len(ours["instances"])
    assert n == len(ref["instances"]) >= 6 and len(port_pred.calls) == 2
    # The predictor outputs each side collected, batch by batch (JAX pads
    # its tail batch; the port's is ragged).
    flip_kw = dict(flip_test=kw.get("flip_test", False))
    apart = 0  # instances with a keypoint more than 1e-3 px from JAX's
    for (crops, boxes, out), (_, _, out_ref) in zip(port_pred.calls, jax_pred.calls):
        B = len(crops)
        ok = _well_defined(flip_kw, jm, variables, crops, boxes, scales)
        assert ok.mean() > 0.6
        apart += int((np.abs(out["keypoints"] - out_ref["keypoints"][:B]) > 1e-3).any((1, 2)).sum())
        np.testing.assert_allclose(out["keypoints"][ok], out_ref["keypoints"][:B][ok], atol=1e-3)
        for k in ("scores", "probabilities", "visibilities", "oks", "errors"):
            np.testing.assert_allclose(out[k], out_ref[k][:B], rtol=1e-4, atol=1e-5, err_msg=k)
    assert [r["image_id"] for r in ours["predictions"]] == [
        r["image_id"] for r in ref["predictions"]]
    assert 0.0 < ref["AP"] < 1.0
    for key in AP_KEYS:
        assert abs(ours[key] - ref[key]) <= apart / n + 1e-6, key
    assert abs(ours["EPE"] - ref["EPE"]) <= apart * np.hypot(*CFG17["img_size"]) / 17 + 1e-4
    for branch in ("presence", "visibility"):
        for key in ("ece", "brier", "nll", "temperature"):
            a, b = ours["calibration"][branch][key], ref["calibration"][branch][key]
            assert a == pytest.approx(b, rel=1e-3, abs=1e-4), (branch, key)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory, coco_root):
    """A checkpoint written by the port's training CLI (2 steps, tiny
    config, EMA kept): (checkpoint directory, config path)."""
    tmp_path = tmp_path_factory.mktemp("train")
    raw = dict(model=CFG17, train_batch_size=2, val_batch_size=2, log_every=1, val_every=100,
               num_workers=2, epochs=3, optim=dict(ema_decay=0.9))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    out = tmp_path / "run"
    cli.main([str(out), "--config", str(cfg), "--data-root", str(coco_root),
              "--dataset-format", "coco", "--max-steps", "2", "--device", "cpu"])
    assert (out / "checkpoints" / "2").is_file()
    return out / "checkpoints", out / "config.json"


def test_eval_cli_on_cpu(tmp_path, coco_root, tiny_run, capsys):
    ckpt, cfg = tiny_run
    ann, images = _val(coco_root)
    base = ["--checkpoint", str(ckpt), "--annotations", str(ann), "--images", str(images),
            "--batch-size", "4", "--device", "cpu"]
    plain = eval_run.main(base + ["--config", str(cfg)])  # the config beside it is the default
    assert set(plain) == set(LINE_KEYS)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == plain
    assert all(0.0 <= plain[k] <= 1.0 for k in AP_KEYS + ("PCK@0.2", "AUC"))

    preds, cal = tmp_path / "out" / "preds.json", tmp_path / "out" / "cal.json"
    line = eval_run.main(base + ["--flip-test", "--calibration", "--calibration-dump", str(cal),
                                 "--per-joint", "--dump-worst", "2", "--dump-worst-dir",
                                 str(tmp_path / "worst"), "--dump-predictions", str(preds)])
    printed = capsys.readouterr().out
    cal_keys = {f"{k}_{b}" for b in ("presence", "visibility")
                for k in ("ece", "mce", "brier", "nll", "temperature")}
    assert set(line) == set(LINE_KEYS) | cal_keys
    assert "left_shoulder" in printed and "<- worst" in printed
    assert (tmp_path / "out" / "cal_presence.png").stat().st_size > 500
    assert len(json.loads((tmp_path / "worst" / "worst.json").read_text())) == 2
    dumped = json.loads(preds.read_text())
    assert dumped and all(set(r) == {"image_id", "category_id", "keypoints", "score"}
                          for r in dumped)

    scored = eval_run.main(["--score-predictions", str(preds), "--annotations", str(ann),
                            "--images", str(images)])
    assert {k: scored[k] for k in AP_KEYS} == {k: line[k] for k in AP_KEYS}

    # The fitted temperatures applied in the predictor: NLL on the same
    # split cannot get worse (to the line's rounding).
    applied = eval_run.main(base + ["--flip-test", "--calibration",
                                    "--apply-temperature", str(cal)])
    for branch in ("presence", "visibility"):
        assert applied[f"nll_{branch}"] <= line[f"nll_{branch}"] + 1e-4, branch
    tta = eval_run.main(base + ["--scale-test", "0.9,1.1", "--scale-test-scores", "mean",
                                "--ema", "--max-samples", "3", "--bbox-scale", "1.3",
                                "--apply-temperature", "presence=1.5"])
    assert set(tta) == set(LINE_KEYS)


@pytest.mark.parametrize("flags,item", [
    (["--bundle", "b", "--flip-test"], None), (["--data-parallel"], 13),
    (["--model-parallel", "2"], 13)])
def test_eval_cli_refuses_unported_flags(tmp_path, flags, item):
    """With --bundle, the flags a bundle bakes in at export are usage
    errors, as in JAX, and so is scale-out (item 13): --data-parallel
    (--model-parallel rides with it) needs a live predictor, as in JAX."""
    args = ["--annotations", str(tmp_path / "a.json"), "--images", str(tmp_path),
            "--bundle", str(tmp_path / "b")]
    if item is not None:
        flags = flags + ["--data-parallel"] * ("--data-parallel" not in flags)
    with pytest.raises(SystemExit):
        eval_run.main(args + [f for f in flags if f not in ("--bundle", "b")]
                      + ["--device", "cpu"])


@pytest.fixture(scope="module")
def det_runs(tmp_path_factory):
    from test_torch_video import make_det_runs

    return make_det_runs(tmp_path_factory.mktemp("det"))


@pytest.mark.parametrize("threshold", ["0", "0.5"])
def test_eval_cli_detector_on_cpu(coco_root, tiny_run, det_runs, threshold):
    """--detector RUN_DIR (--detector-threshold) on the CPU: JAX's summary
    keys with det_ap50, det_recall50 and det_per_image, equal to
    evaluate_detector_topdown run in process on the same checkpoints."""
    from probpose_pytorch_tpu_torch.detect import evaluate_detector_topdown, load_detector
    from probpose_pytorch_tpu_torch.inference import load_predictor

    ckpt, _ = tiny_run
    det_dir, _ = det_runs
    ann, images = _val(coco_root)
    line = eval_run.main(["--checkpoint", str(ckpt), "--detector", str(det_dir),
                          "--detector-threshold", threshold, "--annotations", str(ann),
                          "--images", str(images), "--device", "cpu"])
    assert set(line) == set(AP_KEYS) | {"det_ap50", "det_recall50", "det_per_image"}
    assert all(0.0 <= line[k] <= 1.0 for k in AP_KEYS)
    ref = evaluate_detector_topdown(
        load_predictor(ckpt, device="cpu"),
        load_detector(det_dir / "checkpoints", score_threshold=float(threshold), device="cpu"),
        ann, images)
    assert line == {k: round(float(v), 4) for k, v in ref.items()}
    if threshold == "0":  # 64 a frame, less those an ignore region absorbs
        assert 32 < line["det_per_image"] <= 64


def test_eval_cli_bottomup_on_cpu(coco_root, det_runs):
    """--bottomup RUN_DIR on the CPU: JAX's keys (AP/AR, det_ap50,
    det_recall50), in [0, 1]."""
    _, bu_dir = det_runs
    ann, images = _val(coco_root)
    line = eval_run.main(["--bottomup", str(bu_dir), "--detector-threshold", "0",
                          "--annotations", str(ann), "--images", str(images), "--device", "cpu"])
    assert set(line) == set(AP_KEYS) | {"det_ap50", "det_recall50"}
    assert all(0.0 <= v <= 1.0 for v in line.values())


@pytest.mark.parametrize("flag", [["--calibration"], ["--per-joint"], ["--dump-worst", "2"]])
def test_eval_cli_detector_refuses_gt_box_reports(tmp_path, flag):
    """--detector reports the end-to-end summary only, as in JAX."""
    with pytest.raises(SystemExit):
        eval_run.main(["--checkpoint", str(tmp_path), "--detector", str(tmp_path),
                       "--annotations", str(tmp_path / "a.json"), "--images", str(tmp_path),
                       "--device", "cpu"] + flag)


def test_eval_cli_needs_the_card_unless_told(coco_root, tiny_run, monkeypatch):
    ckpt, _ = tiny_run
    ann, images = _val(coco_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        eval_run.main(["--checkpoint", str(ckpt), "--annotations", str(ann),
                       "--images", str(images)])
