"""The port's video pipeline against the JAX package's, on the CPU: frame and
box IO, the OKS tracker, `run_video` and `run_video_stream` on the same tiny
f32 model, and the video CLI with --device cpu against JAX's CLI on the
same train state saved by each package.

Keypoints are held to 1e-3 px where JAX's convolved map has a top-2 margin
above 1e-4, smoothed keypoints where that held in every frame of the track
so far; the other fields to the bars of test_torch_frame.py.
"""

import json

import numpy as np
import PIL.Image
import pytest
import torch

from probpose_pytorch_tpu import video as jax_video
from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.inference import load_predictor as jax_load_predictor
from probpose_pytorch_tpu_torch import video
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.inference import TopDownPredictor

from test_torch_frame import KPT_TOL_PX, _field_tol
from test_torch_models import TINY_CFG, init_pair
from test_torch_serving import CODEC_KW, _top2_margin, saved_runs  # noqa: F401 (fixture)

torch.set_num_threads(2)

HW = (72, 96)


def _sequence(seed, n_frames=6, people=4):
    """Frames of HW and per-frame boxes of `people` drifting people, each
    present with probability 0.7, and none in frame 2."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, *HW, 3), dtype=np.uint8)
    start = np.concatenate([rng.uniform([0, 0], [50, 30], (people, 2)),
                            rng.uniform([25, 35], [40, 50], (people, 2))], 1)
    step = rng.normal(0, 1.5, (people, 2))
    boxes = []
    for i in range(n_frames):
        b = start.copy()
        b[:, :2] += i * step
        boxes.append(b[(rng.random(people) < 0.7) & (i != 2)].astype(np.float32))
    return frames, boxes


# --------------------------------------------------------------------------
# IO and tracking: equal to JAX's


def test_iter_frames_and_load_boxes_equal_jax(tmp_path):
    frames, boxes = _sequence(0)
    (tmp_path / "dir").mkdir()
    for i, f in enumerate(frames):
        PIL.Image.fromarray(f).save(tmp_path / "dir" / f"f{i:03d}.png")
    (tmp_path / "dir" / "notes.txt").write_text("ignored")
    np.save(tmp_path / "frames.npy", frames)
    np.savez(tmp_path / "frames.npz", frames=frames)
    for src in ("dir", "frames.npy", "frames.npz"):
        got = list(video.iter_frames(tmp_path / src))
        ref = list(jax_video.iter_frames(tmp_path / src))
        assert len(got) == len(ref) == len(frames)
        for g, r, f in zip(got, ref, frames):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, f)
    (tmp_path / "boxes.json").write_text(json.dumps([b.tolist() for b in boxes] + [[]]))
    got, ref = video.load_boxes(tmp_path / "boxes.json"), jax_video.load_boxes(tmp_path / "boxes.json")
    assert len(got) == len(ref) == len(boxes) + 1
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_io_refusals_match_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    np.save(tmp_path / "gray.npy", np.zeros((2, 8, 8), np.uint8))
    (tmp_path / "x.mp4").write_bytes(b"")
    (tmp_path / "obj.json").write_text(json.dumps({"a": 1}))
    for bad, match in (("empty", "no image files"), ("gray.npy", "frame stack shape"),
                       ("x.mp4", "expected a frame directory")):
        for mod in (video, jax_video):
            with pytest.raises(ValueError, match=match):
                list(mod.iter_frames(tmp_path / bad))
    for mod in (video, jax_video):
        with pytest.raises(ValueError, match="per-frame list"):
            mod.load_boxes(tmp_path / "obj.json")


@pytest.mark.parametrize("k,max_gap", [(17, 30), (5, 1)])
def test_oks_tracker_equals_jax(k, max_gap):
    """Moving poses, people leaving and coming back past the gap, a new
    person, an empty frame: the same ids as JAX's tracker."""
    rng = np.random.default_rng(k)
    people = rng.uniform(50, 400, (5, 1, 2)) + rng.normal(0, 15, (5, k, 2))
    ours, theirs = video.OksTracker(max_gap=max_gap), jax_video.OksTracker(max_gap=max_gap)
    for t in range(12):
        present = [p for p in range(5) if (p + t) % 4 or t < 2]
        if t == 6:
            present = []
        kpts = (people[present] + t * 3.0 + rng.normal(0, 1, (len(present), k, 2)))
        kpts = kpts.astype(np.float32)
        areas = rng.uniform(2000, 4000, len(present))
        got, ref = ours.update(kpts, areas), theirs.update(kpts, areas)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert sorted(ours._tracks) == sorted(theirs._tracks)


# --------------------------------------------------------------------------
# run_video and run_video_stream against JAX's


@pytest.fixture(scope="module")
def video_pair():
    jm, variables, pm = init_pair()
    jax_pred = JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                            input_size=TINY_CFG["img_size"])
    port_pred = TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                                 input_size=TINY_CFG["img_size"])
    maps = JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                        input_size=TINY_CFG["img_size"], return_heatmaps=True)
    return jax_pred, port_pred, maps


def _same_records(got, ref, frames, maps):
    """Track ids, boxes and frame indices equal; keypoints within
    KPT_TOL_PX where JAX's maps (from `maps`, a JAX predictor with
    heatmaps) have a top-2 margin, smoothed keypoints where every frame of
    the track had one; probabilities, scores and pose scores within the
    crop-rounding bar."""
    assert len(got) == len(ref) == len(frames)
    stable: dict = {}
    for frame, g, r in zip(frames, got, ref):
        assert sorted(g) == sorted(r)
        assert g["frame"] == r["frame"] and g["t"] == r["t"]
        np.testing.assert_array_equal(g["track_ids"], r["track_ids"])
        np.testing.assert_array_equal(g["boxes"], r["boxes"])
        for k in r:
            assert np.shape(g[k]) == np.shape(r[k]), k
        if not len(r["boxes"]):
            continue
        ok = _top2_margin(maps.predict_frame(frame, r["boxes"])["heatmaps"]) > 1e-4
        for j, tid in enumerate(r["track_ids"]):
            stable[tid] = stable.get(tid, np.ones(ok.shape[1], bool)) & ok[j]
        smooth_ok = np.stack([stable[t] for t in r["track_ids"]])
        np.testing.assert_allclose(g["keypoints"][ok], r["keypoints"][ok], atol=KPT_TOL_PX)
        np.testing.assert_allclose(g["smoothed"][smooth_ok], r["smoothed"][smooth_ok],
                                   atol=KPT_TOL_PX)
        atol = _field_tol(frame, r["boxes"])
        for k in ("probabilities", "scores", "pose_scores"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=atol, err_msg=k)
    return stable


@pytest.mark.parametrize("nms", [None, "soft_oks", "oks"])
def test_run_video_matches_jax(video_pair, nms):
    jax_pred, port_pred, maps = video_pair
    frames, boxes = _sequence(1)
    assert max(len(b) for b in boxes) > 1
    got = list(video.run_video(port_pred, frames, boxes, nms=nms))
    ref = list(jax_video.run_video(jax_pred, frames, boxes, nms=nms))
    stable = _same_records(got, ref, frames, maps)
    assert np.mean([m.mean() for m in stable.values()]) > 0.7


@pytest.mark.parametrize("batch,nms", [(4, None), (3, "soft_oks")])
def test_run_video_stream_matches_jax(video_pair, batch, nms):
    """Crops batched across frames through predict_stream: JAX's stream
    mode's records, and the port's per-frame mode's."""
    jax_pred, port_pred, maps = video_pair
    frames, boxes = _sequence(2)
    got = list(video.run_video_stream(port_pred, frames, boxes, nms=nms, batch=batch))
    ref = list(jax_video.run_video_stream(jax_pred, frames, boxes, nms=nms, batch=batch))
    _same_records(got, ref, frames, maps)
    per_frame = list(video.run_video(port_pred, frames, boxes, nms=nms))
    _same_records(got, per_frame, frames, maps)


def test_run_video_without_boxes_and_smoothing(video_pair):
    """No boxes: one full-frame box a frame; smooth=False: smoothed == raw."""
    jax_pred, port_pred, maps = video_pair
    frames, _ = _sequence(3, n_frames=3)
    got = list(video.run_video(port_pred, frames, smooth=False))
    ref = list(jax_video.run_video(jax_pred, frames, smooth=False))
    _same_records(got, ref, frames, maps)
    for g in got:
        np.testing.assert_array_equal(g["smoothed"], g["keypoints"])
        np.testing.assert_array_equal(g["boxes"], [[0, 0, HW[1], HW[0]]])


def test_run_video_refusals(video_pair):
    _, port_pred, _ = video_pair
    frames, boxes = _sequence(4, n_frames=2)
    with pytest.raises(ValueError, match="either boxes or a detector"):
        next(video.run_video(port_pred, frames, boxes, detector=object()))
    with pytest.raises(ValueError, match="needs a detector"):
        next(video.run_video(port_pred, frames, fused=True))
    with pytest.raises(ValueError, match="boxes list has 1 entries"):
        list(video.run_video(port_pred, frames, boxes[:1]))
    big = [np.zeros((HW[0] + 80, HW[1], 3), np.uint8)]
    with pytest.raises(ValueError, match="exceeds the stream frame shape"):
        list(video.run_video_stream(port_pred, [frames[0], big[0]],
                                    [np.ones((1, 4), np.float32)] * 2, batch=1))


# --------------------------------------------------------------------------
# the detector modes


@pytest.fixture(scope="module")
def detectors():
    """(JAX DetectorPredictor, the port's) on the same f32 weights, every
    top-4 box kept (threshold 0)."""
    from probpose_pytorch_tpu.detect.pipeline import DetectorPredictor as JaxDetectorPredictor
    from probpose_pytorch_tpu_torch.detect import DetectorPredictor
    from test_torch_detect import detector_pair

    jm, variables, pm = detector_pair(seed=8)
    return (JaxDetectorPredictor(model=jm, variables=variables, max_detections=4,
                                 score_threshold=0.0),
            DetectorPredictor(model=pm, max_detections=4, score_threshold=0.0))


def _close_records(got, ref, box_tol=1e-3):
    """Records of two runs on boxes that agree to `box_tol` px: the same
    track ids and shapes, boxes within box_tol, keypoints within 0.05 px
    (a crop moved by 1e-3 px moves a keypoint by far less on this model's
    smooth maps), the other fields within 1e-3."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r) and g["frame"] == r["frame"]
        np.testing.assert_array_equal(g["track_ids"], r["track_ids"])
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=box_tol)
        for k in ("keypoints", "smoothed"):
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=0.05, err_msg=k)
        for k in ("probabilities", "scores", "pose_scores"):
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-3, err_msg=k)


def test_detector_boxes_match_jax(video_pair, detectors):
    jax_det, port_det = detectors
    frames, _ = _sequence(5, n_frames=3)
    for f in frames:
        for thr in (None, 0.5):
            got = video.detector_boxes(port_det, f, TINY_CFG["img_size"], 1.25, thr)
            ref = jax_video.detector_boxes(jax_det, f, TINY_CFG["img_size"], 1.25, thr)
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("nms", [None, "soft_oks"])
def test_run_video_with_detector_matches_jax(video_pair, detectors, nms):
    """Standalone mode, per frame: the detector's boxes each frame, then the
    records of JAX's run_video(detector=...)."""
    jax_pred, port_pred, _ = video_pair
    jax_det, port_det = detectors
    frames, _ = _sequence(6, n_frames=4)
    got = list(video.run_video(port_pred, frames, detector=port_det, nms=nms))
    ref = list(jax_video.run_video(jax_pred, frames, detector=jax_det, nms=nms))
    assert all(len(r["boxes"]) == 4 for r in ref) or nms
    _close_records(got, ref)


def test_run_video_fused_matches_the_two_stage_path(video_pair, detectors):
    """fused=True (boxes kept on the device) against the per-frame detector
    mode and JAX's fused mode; run_video_fused_stream against run_video's
    fused records, with a short tail batch."""
    jax_pred, port_pred, _ = video_pair
    jax_det, port_det = detectors
    frames, _ = _sequence(7, n_frames=5)
    fused = list(video.run_video(port_pred, frames, detector=port_det, fused=True,
                                 max_people=3, nms=None))
    two = list(video.run_video(port_pred, frames, detector=port_det, nms=None))
    ref = list(jax_video.run_video(jax_pred, frames, detector=jax_det, fused=True,
                                   max_people=3, nms=None))
    _close_records(fused, ref)
    for f, t in zip(fused, two):
        np.testing.assert_allclose(f["boxes"], t["boxes"][:3], rtol=0, atol=1e-3)
        np.testing.assert_allclose(f["keypoints"], t["keypoints"][:3], rtol=0, atol=0.05)
    from probpose_pytorch_tpu_torch.detect import FusedTwoStagePredictor

    fp = FusedTwoStagePredictor(detector=port_det, pose=port_pred, max_people=3,
                                score_threshold=0.0)
    stream = list(video.run_video_fused_stream(fp, frames, nms=None, batch=2))
    _close_records(stream, fused)


def test_run_video_bottomup_matches_jax():
    """Single-stage mode against JAX's run_video_bottomup on the same f32
    bottom-up model (joint heat heads: per-joint scores)."""
    from probpose_pytorch_tpu.detect.pipeline import BottomUpPredictor as JaxBottomUp
    from probpose_pytorch_tpu_torch.detect import BottomUpPredictor
    from test_torch_detect import detector_pair

    jm, variables, pm = detector_pair(17, kpt_heatmaps=True, seed=9)
    frames, _ = _sequence(8, n_frames=4)
    for thr in (0.0, 0.0035):
        got = list(video.run_video_bottomup(BottomUpPredictor(model=pm, max_detections=5),
                                            frames, score_threshold=thr, nms="oks"))
        ref = list(jax_video.run_video_bottomup(
            JaxBottomUp(model=jm, variables=variables, max_detections=5), frames,
            score_threshold=thr, nms="oks"))
        _close_records(got, ref)
        assert sum(len(r["boxes"]) for r in ref) > 0


# --------------------------------------------------------------------------
# the CLI


def _cli_records(main, ckpt, tmp_path, name, frames_path, boxes_path, extra):
    out = tmp_path / name
    main(["--checkpoint", str(ckpt), "--frames", str(frames_path), "--boxes", str(boxes_path),
          "--out", str(out)] + extra)
    return [json.loads(line) for line in (out / "poses.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("extra", [[], ["--stream-batch", "4"], ["--nms", "none", "--render"]])
def test_video_cli_matches_jax(saved_runs, tmp_path, extra):  # noqa: F811
    """python -m ...video --device cpu on the port's checkpoint against the
    JAX CLI on the same state saved by JAX: the same poses.jsonl within the
    bars above."""
    jax_dir, port_dir = saved_runs
    frames, boxes = _sequence(5)
    np.save(tmp_path / "frames.npy", frames)
    (tmp_path / "boxes.json").write_text(json.dumps([b.tolist() for b in boxes]))
    args = (tmp_path / "frames.npy", tmp_path / "boxes.json")
    got = _cli_records(video.main, port_dir / "checkpoints", tmp_path, "port", *args,
                       extra + ["--device", "cpu"])
    ref = _cli_records(jax_video.main, jax_dir / "checkpoints", tmp_path, "jax", *args, extra)
    maps = jax_load_predictor(jax_dir / "checkpoints")
    maps.return_heatmaps = True
    as_np = lambda recs: [{k: np.asarray(v, np.float32) if isinstance(v, list) else v  # noqa: E731
                           for k, v in r.items()} for r in recs]
    got, ref = as_np(got), as_np(ref)
    for r in got + ref:
        r["track_ids"] = r["track_ids"].astype(np.int64)
        r["boxes"] = r["boxes"].reshape(-1, 4)
    _same_records(got, ref, frames, maps)
    if "--render" in extra:
        pngs = sorted((tmp_path / "port").glob("frame_*.png"))
        assert len(pngs) == len(frames)
        assert np.asarray(PIL.Image.open(pngs[0])).shape == (*HW, 3)


@pytest.mark.parametrize("flags,item", [(["--bundle", "b"], 8)])
def test_video_cli_refuses_unported_flags(tmp_path, flags, item):
    """--bundle serves the port's bundles (item 8, done); a JAX bundle
    directory is refused, naming the port's export CLI."""
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "manifest.json").write_text(json.dumps({"version": 2}))
    (tmp_path / "b" / "fn_b1.bin").write_bytes(b"")
    flags = [f if f.startswith("--") else str(tmp_path / f) for f in flags]
    with pytest.raises(ValueError, match="probpose_pytorch_tpu_torch.serve.export"):
        video.main(flags + ["--frames", str(tmp_path), "--out", str(tmp_path / "o"),
                            "--device", "cpu"])


def make_det_runs(root):
    """A detector run and a bottom-up run (--keypoints 17 --kpt-heatmaps)
    of the port's detect.train CLI on a synthetic COCO set, 2 steps each at
    a 64 x 64 input, --device cpu: (detector run dir, bottom-up run dir)."""
    from probpose_pytorch_tpu_torch.data import generate_coco_synth
    from probpose_pytorch_tpu_torch.detect import train as detect_train

    coco = generate_coco_synth(root / "coco", n_train_images=4, n_val_images=1,
                               frame_hw=(160, 200), seed=11)
    common = ["--data-root", str(coco), "--steps", "2", "--batch-size", "2", "--img-size", "64",
              "--num-workers", "1", "--device", "cpu"]
    detect_train.main(common + ["--out", str(root / "det")])
    detect_train.main(common + ["--out", str(root / "bu"), "--keypoints", "17", "--kpt-heatmaps"])
    return root / "det", root / "bu"


@pytest.fixture(scope="module")
def det_runs(tmp_path_factory):
    return make_det_runs(tmp_path_factory.mktemp("det"))


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("mode", [[], ["--fused", "--max-people", "3"],
                                  ["--fused", "--max-people", "3", "--stream-batch", "2"]],
                         ids=["per-frame", "fused", "fused-stream"])
def test_video_cli_detector_modes(saved_runs, det_runs, tmp_path, mode):  # noqa: F811
    """--detector (the detect.train run's checkpoints/, as JAX's CLI takes
    it) with --detector-threshold 0 on the CPU: a record per frame with the
    detector's boxes; per frame the same records as run_video(detector=...)
    in process; --fused keeps --max-people slots a frame."""
    _, port_dir = saved_runs
    det_dir, _ = det_runs
    frames, _ = _sequence(9, n_frames=3)
    np.save(tmp_path / "frames.npy", frames)
    video.main(["--checkpoint", str(port_dir / "checkpoints"), "--frames",
                str(tmp_path / "frames.npy"), "--detector", str(det_dir / "checkpoints"),
                "--detector-threshold", "0", "--nms", "none", "--out", str(tmp_path / "o"),
                "--device", "cpu"] + mode)
    recs = _jsonl(tmp_path / "o" / "poses.jsonl")
    assert [r["frame"] for r in recs] == [0, 1, 2]
    n = 3 if mode else 64
    assert all(np.asarray(r["boxes"]).shape == (n, 4) for r in recs)
    assert all(np.asarray(r["keypoints"]).shape == (n, TINY_CFG["num_keypoints"], 2)
               for r in recs)
    if not mode:
        from probpose_pytorch_tpu_torch.detect import load_detector
        from probpose_pytorch_tpu_torch.inference import load_predictor

        ref = list(video.run_video(load_predictor(port_dir / "checkpoints", device="cpu"),
                                   frames, nms=None, detector_threshold=0.0,
                                   detector=load_detector(det_dir / "checkpoints",
                                                          device="cpu")))
        for r, g in zip(ref, recs):
            np.testing.assert_array_equal(np.asarray(g["keypoints"], np.float32),
                                          r["keypoints"].astype(np.float32))


def test_video_cli_bottomup(det_runs, tmp_path):
    """--bottomup RUN_DIR on the CPU: one forward a frame, records with each
    kept person's 17 joints."""
    _, bu_dir = det_runs
    frames, _ = _sequence(10, n_frames=3)
    np.save(tmp_path / "frames.npy", frames)
    video.main(["--bottomup", str(bu_dir), "--frames", str(tmp_path / "frames.npy"),
                "--detector-threshold", "0", "--out", str(tmp_path / "o"), "--device", "cpu"])
    recs = _jsonl(tmp_path / "o" / "poses.jsonl")
    assert len(recs) == 3
    for r in recs:
        k = np.asarray(r["keypoints"])
        assert k.ndim == 3 and k.shape[1:] == (17, 2) and len(r["boxes"]) == len(k) > 0


@pytest.mark.parametrize("flags", [
    ["--checkpoint", "c", "--fused"],
    ["--checkpoint", "c", "--detector", "d", "--boxes", "b.json"],
    ["--checkpoint", "c", "--detector", "d", "--stream-batch", "4"],
    ["--bottomup", "b", "--detector", "d"],
])
def test_video_cli_detector_flag_errors(tmp_path, flags):
    """The combinations JAX's CLI refuses with a usage error."""
    with pytest.raises(SystemExit):
        video.main(flags + ["--frames", str(tmp_path), "--out", str(tmp_path / "o")])


def test_video_cli_stream_refuses_render(tmp_path):
    with pytest.raises(SystemExit):
        video.main(["--checkpoint", "c", "--frames", str(tmp_path), "--out", str(tmp_path),
                    "--stream-batch", "4", "--render"])
