"""The port's serving server, on the CPU: the MicroBatcher's behaviour on a
numpy echo runner (as JAX's tests/test_server.py drives its own), then the
HTTP front end over a tiny f32 predictor against the direct predictor and
against JAX's server on the same request, multi-model routing, the metrics
and error replies, the refusals, and `main` as a user runs it.

Every wait has its own timeout, and every server binds port 0.
"""

import base64
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.serve.server import MicroBatcher as JaxMicroBatcher
from probpose_pytorch_tpu.serve.server import PoseHTTPServer as JaxPoseHTTPServer
from probpose_pytorch_tpu_torch import inference
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.serve import server as port_server
from probpose_pytorch_tpu_torch.serve.server import MAX_REQUEST_BYTES, MicroBatcher, PoseHTTPServer

from test_torch_models import TINY, TINY_CFG, init_pair
from test_torch_serving import CODEC_KW, _top2_margin, saved_runs  # noqa: F401 (fixture)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
K = TINY_CFG["num_keypoints"]
TIMEOUT_S = 60


class EchoRunner:
    """Identifies every crop row in the output, so the tests can check that
    batching, padding and splitting never mix rows up."""

    def __init__(self, buckets):
        self.buckets = set(buckets)
        self.calls = []

    def __call__(self, frames, boxes):
        assert len(frames) == len(boxes)
        assert len(frames) in self.buckets, f"dispatch size {len(frames)} not a bucket"
        self.calls.append(len(frames))
        return {"echo_box": np.asarray(boxes, np.float32).copy(),
                "frame_mean": frames.reshape(len(frames), -1).astype(np.float64).mean(axis=1)}


def _frame(seed, h=16, w=16):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture
def batcher_factory():
    made = []

    def make(*args, **kw):
        mb = MicroBatcher(*args, **kw)
        made.append(mb)
        return mb

    yield make
    for mb in made:
        mb.close()
        assert not mb._thread.is_alive() and not mb._completion.is_alive()


# --------------------------------------------------------------------------
# MicroBatcher on an echo runner


def test_single_request_pads_and_strips(batcher_factory):
    runner = EchoRunner({4})
    mb = batcher_factory(runner, (4,), (16, 16), max_wait_ms=0)
    boxes = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.float32)
    out = mb.submit(_frame(0), boxes).result(timeout=TIMEOUT_S)
    np.testing.assert_array_equal(out["echo_box"], boxes)
    assert runner.calls == [4]


def test_concurrent_requests_coalesce(batcher_factory):
    runner = EchoRunner({1, 8})
    mb = batcher_factory(runner, (1, 8), (16, 16), max_wait_ms=50)
    boxes = [np.array([[i, i, 10, 10]], np.float32) for i in range(6)]
    futs = [mb.submit(_frame(i), boxes[i]) for i in range(6)]
    for i, fut in enumerate(futs):
        out = fut.result(timeout=TIMEOUT_S)
        np.testing.assert_array_equal(out["echo_box"], boxes[i])
        # each crop carried its own request's frame
        np.testing.assert_allclose(out["frame_mean"][0], _frame(i).astype(np.float64).mean())
    assert len(runner.calls) < 6, f"no coalescing happened: {runner.calls}"


def test_oversized_request_splits(batcher_factory):
    runner = EchoRunner({4})
    mb = batcher_factory(runner, (4,), (16, 16), max_wait_ms=0)
    boxes = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    out = mb.submit(_frame(3), boxes).result(timeout=TIMEOUT_S)
    np.testing.assert_array_equal(out["echo_box"], boxes)
    assert runner.calls == [4, 4, 4]
    assert mb.stats_snapshot()["dispatches"] == 3


def test_empty_boxes(batcher_factory):
    runner = EchoRunner({2})
    mb = batcher_factory(runner, (2,), (16, 16), max_wait_ms=0)
    assert mb.submit(_frame(4), np.zeros((0, 4), np.float32)).result(timeout=TIMEOUT_S) == {}
    assert runner.calls == []


@pytest.mark.parametrize("n_boxes", [1, 5])
def test_runner_error_propagates(batcher_factory, n_boxes):
    """A launch error reaches the request's future, split or not."""
    def broken(frames, boxes):
        raise RuntimeError("card on fire")

    mb = batcher_factory(broken, (2,), (16, 16), max_wait_ms=0)
    fut = mb.submit(_frame(5), np.ones((n_boxes, 4), np.float32))
    with pytest.raises(RuntimeError, match="card on fire"):
        fut.result(timeout=TIMEOUT_S)


def test_readback_error_propagates(batcher_factory):
    """An error in the completion thread's download reaches the future."""
    class Bad:
        def _dispatch(self, frames, boxes):
            return {"x": np.zeros(len(boxes))}

        def _download(self, dev):
            raise RuntimeError("readback failed")

    mb = batcher_factory(Bad(), (2,), (16, 16), max_wait_ms=0)
    with pytest.raises(RuntimeError, match="readback failed"):
        mb.submit(_frame(5), np.ones((1, 4), np.float32)).result(timeout=TIMEOUT_S)


def test_oversized_frame_rejected(batcher_factory):
    mb = batcher_factory(EchoRunner({2}), (2,), (16, 16), max_wait_ms=0)
    with pytest.raises(ValueError, match="exceeds"):
        mb.submit(_frame(6, h=17), np.ones((1, 4), np.float32))


def test_stats(batcher_factory):
    mb = batcher_factory(EchoRunner({2}), (2,), (16, 16), max_wait_ms=0)
    mb.submit(_frame(7), np.ones((2, 4), np.float32)).result(timeout=TIMEOUT_S)
    s = mb.stats_snapshot()
    assert s["requests"] == 1 and s["crops"] == 2 and s["dispatches"] == 1
    assert s["latency_ms"]["p50"] > 0 and s["mean_batch"] == 2.0 and s["max_batch"] == 2


def test_closed_rejects():
    mb = MicroBatcher(EchoRunner({2}), (2,), (16, 16), max_wait_ms=0)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_frame(8), np.ones((1, 4), np.float32))


def test_indexed_mode_deduplicates_frames(batcher_factory):
    """indexed=True: the runner gets each request's frame once (a
    power-of-two count) and frame_ids; results come back per request."""
    calls = []

    def runner(frames, boxes, frame_ids):
        assert len(boxes) == len(frame_ids)
        assert frames.shape[0] & (frames.shape[0] - 1) == 0
        assert frames.shape[0] < len(boxes)
        calls.append((frames.shape[0], len(boxes)))
        per_crop = frames[frame_ids]
        return {"echo_box": np.asarray(boxes, np.float32).copy(),
                "frame_mean": per_crop.reshape(len(per_crop), -1).astype(np.float64).mean(1)}

    mb = batcher_factory(runner, (8,), (16, 16), max_wait_ms=50, indexed=True)
    boxes = [np.array([[i, i, 10, 10], [i, i, 5, 5]], np.float32) for i in range(3)]
    futs = [mb.submit(_frame(10 + i), boxes[i]) for i in range(3)]
    for i, fut in enumerate(futs):
        out = fut.result(timeout=TIMEOUT_S)
        np.testing.assert_array_equal(out["echo_box"], boxes[i])
        np.testing.assert_allclose(out["frame_mean"],
                                   np.full(2, _frame(10 + i).astype(np.float64).mean()))
    assert calls


def test_warmup_dispatches_every_shape(batcher_factory):
    """warmup() sends every (bucket, frame count) once, as JAX's does;
    afterwards a request mix reuses those shapes only."""
    shapes = set()

    def runner(frames, boxes, frame_ids):
        shapes.add((frames.shape[0], len(boxes)))
        return {"echo_box": np.asarray(boxes, np.float32).copy()}

    mb = batcher_factory(runner, (1, 4), (16, 16), max_wait_ms=0, indexed=True)
    jax_shapes = set()

    def jax_runner(frames, boxes, frame_ids):
        jax_shapes.add((frames.shape[0], len(boxes)))
        return {"echo_box": np.asarray(boxes, np.float32).copy()}

    jmb = JaxMicroBatcher(jax_runner, (1, 4), (16, 16), max_wait_ms=0, indexed=True)
    try:
        assert mb.warmup() == jmb.warmup() == 1 + 3  # bucket 1 (f=1); 4 (f=1, 2, 4)
    finally:
        jmb.close()
    assert shapes == jax_shapes
    warm = set(shapes)
    futs = [mb.submit(_frame(20 + i), np.ones((1, 4), np.float32)) for i in range(3)]
    [f.result(timeout=TIMEOUT_S) for f in futs]
    assert shapes == warm, f"new shapes appeared: {shapes - warm}"


def test_close_during_coalescing_window_is_prompt():
    mb = MicroBatcher(EchoRunner({4}), (4,), (16, 16), max_wait_ms=500)
    fut = mb.submit(_frame(0), np.ones((1, 4), np.float32))
    time.sleep(0.05)  # the dispatcher is inside its 500 ms window
    t0 = time.perf_counter()
    mb.close()
    assert time.perf_counter() - t0 < 5, "close() hit the join timeout"
    assert not mb._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=1)


def test_many_clients_keep_their_rows(batcher_factory):
    """More client threads than cores, a short switch interval: every
    reply holds its own request's rows, and the counts add up."""
    runner = EchoRunner({4, 8})
    mb = batcher_factory(runner, (4, 8), (16, 16), max_wait_ms=1)
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            rng = np.random.default_rng(c)
            for r in range(10):
                boxes = rng.uniform(0, 99, (int(rng.integers(1, 12)), 4)).astype(np.float32)
                boxes[:, 0] = c * 1000 + r
                out = mb.submit(_frame(c), boxes).result(timeout=TIMEOUT_S)
                if not np.array_equal(out["echo_box"], boxes):
                    errors.append((c, r))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    s = mb.stats_snapshot()
    assert s["requests"] == 160 and sum(runner.calls) >= s["crops"]


# --------------------------------------------------------------------------
# HTTP over a tiny predictor


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def _payload(frame, boxes=None, **extra):
    out = {"frame_b64": base64.b64encode(frame.tobytes()).decode(), "shape": list(frame.shape)}
    if boxes is not None:
        out["boxes"] = np.asarray(boxes).tolist()
    return out | extra


@pytest.fixture(scope="module")
def http_env():
    """Live servers over the same tiny f32 weights, on OS-assigned ports:
    the port's and JAX's, each indexed over buckets (1, 4) and frames
    padded to 64 x 64. Yields (port base URL, port predictor, JAX base URL,
    JAX predictor)."""
    jm, variables, pm = init_pair()
    jax_pred = JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                            input_size=TINY_CFG["img_size"], return_heatmaps=True)
    port_pred = TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                                 input_size=TINY_CFG["img_size"], return_heatmaps=True)
    servers = [PoseHTTPServer(MicroBatcher(port_pred, (1, 4), (64, 64), max_wait_ms=2.0,
                                           indexed=True), host="127.0.0.1", port=0),
               JaxPoseHTTPServer(JaxMicroBatcher(jax_pred, (1, 4), (64, 64), max_wait_ms=2.0,
                                                 indexed=True), host="127.0.0.1", port=0)]
    for s in servers:
        s.start()
    try:
        yield (f"http://127.0.0.1:{servers[0].port}", port_pred,
               f"http://127.0.0.1:{servers[1].port}", jax_pred)
    finally:
        for s in servers:
            s.shutdown()


def test_predict_matches_direct_and_jax(http_env):
    """/predict equals the direct predictor on the padded frame (1e-5), and
    JAX's server on the same request (1e-3 px where JAX's map has a top-2
    margin, 1e-4 relative and 2e-4 absolute on the other fields: the
    crops of a rescaled box may differ from XLA's by one bf16 rounding,
    test_torch_serving.py)."""
    base, pred, jax_base, _ = http_env
    frame = np.random.default_rng(0).integers(0, 256, (60, 62, 3), dtype=np.uint8)
    boxes = [[2.0, 3.0, 30.0, 40.0], [10.0, 5.0, 25.0, 35.0], [20, 20, 40, 40]]
    status, out = _post(base + "/predict", _payload(frame, boxes))
    assert status == 200
    jstatus, ref = _post(jax_base + "/predict", _payload(frame, boxes))
    assert jstatus == 200 and sorted(out) == sorted(ref)
    padded = np.pad(frame, ((0, 4), (0, 2), (0, 0)))
    direct = pred(np.stack([padded] * 3), np.asarray(boxes, np.float32))
    for k in direct:
        np.testing.assert_allclose(np.asarray(out[k]), direct[k], rtol=0, atol=1e-5, err_msg=k)
    ok = _top2_margin(np.asarray(ref["heatmaps"], np.float32)) > 1e-4
    assert ok.mean() > 0.7
    np.testing.assert_allclose(np.asarray(out["keypoints"])[ok],
                               np.asarray(ref["keypoints"])[ok], atol=1e-3)
    for k in set(ref) - {"keypoints"}:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=2e-4, err_msg=k)


def test_concurrent_requests_match_direct(http_env):
    """Eight clients at once, 1-6 boxes each, across both buckets (a split
    past 4 too): every reply equals the direct predictor's."""
    base, pred, _, _ = http_env
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(8):
        frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        reqs.append((frame, rng.uniform([0, 0, 20, 20], [30, 30, 40, 40],
                                        (1 + i % 6, 4)).astype(np.float32)))
    results = [None] * len(reqs)

    def worker(i):
        results[i] = _post(base + "/predict", _payload(*reqs[i]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    for (frame, boxes), (status, out) in zip(reqs, results):
        assert status == 200
        direct = pred(np.stack([frame] * len(boxes)), boxes)
        np.testing.assert_allclose(np.asarray(out["keypoints"]), direct["keypoints"],
                                   rtol=0, atol=1e-5)


def test_healthz_stats_models_metrics(http_env):
    base = http_env[0]
    _post(base + "/predict", _payload(_frame(9, 64, 64), [[0.0, 0.0, 30.0, 30.0]]))
    assert json.loads(_get(base + "/healthz")[1]) == {"ok": True}
    assert json.loads(_get(base + "/models")[1]) == {"models": ["default"], "default": "default"}
    stats = json.loads(_get(base + "/stats")[1])
    assert stats["requests"] >= 1 and stats["latency_ms"]["p99"] > 0
    ctype, text = _get(base + "/metrics")
    assert "text/plain" in ctype
    assert 'pose_requests_total{model="default"}' in text
    assert 'pose_request_latency_ms{model="default",quantile="0.5"}' in text
    assert 'pose_mean_batch_size{model="default"}' in text


@pytest.mark.parametrize("payload,status,match", [
    (dict(frame_b64=base64.b64encode(b"abc").decode(), shape=[64, 64, 3], boxes=[[0, 0, 1, 1]]),
     400, "bytes"),
    (dict(frame_b64="", shape=[64, 64], boxes=[[0, 0, 1, 1]]), 400, "shape"),
    (_payload(np.zeros((128, 128, 3), np.uint8), [[0, 0, 10, 10]]), 400, "exceeds"),
    (_payload(np.zeros((64, 64, 3), np.uint8)), 400, "no --detector"),
    (_payload(np.zeros((64, 64, 3), np.uint8), [[0, 0, 1, 1]], model="nope"), 404,
     "unknown model"),
])
def test_error_replies(http_env, payload, status, match):
    got, out = _post(http_env[0] + "/predict", payload)
    assert got == status and match in out["error"]


def test_unknown_path_404(http_env):
    assert _post(http_env[0] + "/nope", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(http_env[0] + "/nope")
    assert e.value.code == 404


def test_request_too_large_413(http_env):
    host, port = http_env[0].removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT_S)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(MAX_REQUEST_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413 and "limit" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_multi_model_routing():
    """Two models behind one server: the JSON "model" field routes, unknown
    names 404, /models lists, /stats and /metrics key per model."""
    def tag(value):
        runner = EchoRunner({2})

        def run(frames, boxes):
            out = runner(frames, boxes)
            out["tag"] = np.full((len(boxes),), value, np.float32)
            return out
        return run

    srv = PoseHTTPServer({"small": MicroBatcher(tag(1.0), (2,), (16, 16), max_wait_ms=0),
                          "big": MicroBatcher(tag(2.0), (2,), (16, 16), max_wait_ms=0)},
                         host="127.0.0.1", port=0, default="small")
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        payload = _payload(_frame(30), [[0.0, 0.0, 8.0, 8.0]])
        assert _post(base + "/predict", payload) == (200, {"echo_box": [[0, 0, 8, 8]],
                                                           "frame_mean": [_frame(30).mean()],
                                                           "tag": [1.0]})
        status, out = _post(base + "/predict", payload | {"model": "big"})
        assert status == 200 and out["tag"] == [2.0]
        status, out = _post(base + "/predict", payload | {"model": "nope"})
        assert status == 404 and "unknown model" in out["error"]
        assert json.loads(_get(base + "/models")[1]) == {"models": ["big", "small"],
                                                         "default": "small"}
        assert set(json.loads(_get(base + "/stats")[1])) == {"small", "big"}
        assert 'pose_requests_total{model="big"}' in _get(base + "/metrics")[1]
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="not in"):
        PoseHTTPServer({"a": MicroBatcher(tag(1.0), (2,), (16, 16))}, port=0, default="b")


@pytest.fixture(scope="module")
def detector_env():
    """The port's and JAX's DetectorPredictor (f32, same weights, every top-3
    box kept) and a tiny port pose predictor: (port detector, JAX detector,
    pose predictor)."""
    from probpose_pytorch_tpu.detect.pipeline import DetectorPredictor as JaxDetectorPredictor
    from probpose_pytorch_tpu_torch.detect import DetectorPredictor
    from test_torch_detect import detector_pair

    jm, variables, dm = detector_pair(seed=12)
    _, _, pm = init_pair()
    pose = TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                            input_size=TINY_CFG["img_size"])
    return (DetectorPredictor(model=dm, max_detections=3, score_threshold=0.0),
            JaxDetectorPredictor(model=jm, variables=variables, max_detections=3,
                                 score_threshold=0.0), pose)


def test_server_detects_when_boxes_are_omitted(detector_env):
    """PoseHTTPServer(detector=...): a top-down request without boxes gets
    the detector's expanded boxes (JAX's within 1e-3 px) back with the
    poses of predict_frame on them; a request with boxes is served as
    before; a detector_threshold above every score answers no one."""
    from probpose_pytorch_tpu import video as jax_video
    from probpose_pytorch_tpu_torch import video

    det, jax_det, pose = detector_env
    srv = PoseHTTPServer(MicroBatcher(pose, (1, 4), (64, 64), max_wait_ms=2.0, indexed=True),
                         host="127.0.0.1", port=0, detector=det)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        frame = np.random.default_rng(3).integers(0, 256, (60, 62, 3), dtype=np.uint8)
        status, out = _post(base + "/predict", _payload(frame))
        assert status == 200
        boxes = video.detector_boxes(det, frame, pose.input_size)
        np.testing.assert_allclose(out["boxes"], boxes, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            out["boxes"], jax_video.detector_boxes(jax_det, frame, pose.input_size), atol=1e-3)
        direct = pose(np.stack([np.pad(frame, ((0, 4), (0, 2), (0, 0)))] * 3), boxes)
        for k in direct:
            np.testing.assert_allclose(np.asarray(out[k]), direct[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        status, given = _post(base + "/predict", _payload(frame, boxes[:1]))
        assert status == 200 and "boxes" not in given
        status, none = _post(base + "/predict", _payload(frame, detector_threshold=2.0))
        assert status == 200 and none == {"boxes": [], "keypoints": []}
    finally:
        srv.shutdown()


def test_whole_frame_runners_over_http(detector_env):
    """BottomUpRunner and FusedRunner behind the MicroBatcher: whole frames
    in (no 'boxes'), each reply thresholded on its row's scores (fused:
    det_scores) and equal to the predictor's own output on the padded
    frame; a request with boxes is a 400."""
    from probpose_pytorch_tpu_torch.detect import BottomUpPredictor, FusedTwoStagePredictor
    from probpose_pytorch_tpu_torch.serve.server import BottomUpRunner, FusedRunner
    from test_torch_detect import detector_pair

    det, _, pose = detector_env
    _, _, bm = detector_pair(5, kpt_heatmaps=True, seed=13)
    bu = BottomUpPredictor(model=bm, max_detections=4, score_threshold=0.0)
    fused = FusedTwoStagePredictor(detector=det, pose=pose, max_people=2, score_threshold=0.0)
    batchers = {"bu": MicroBatcher(BottomUpRunner(bu), (1, 2), (64, 64), max_wait_ms=2.0),
                "fused": MicroBatcher(FusedRunner(fused), (1, 2), (64, 64), max_wait_ms=2.0)}
    srv = PoseHTTPServer(batchers, host="127.0.0.1", port=0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        frame = np.random.default_rng(4).integers(0, 256, (64, 60, 3), dtype=np.uint8)
        padded = np.pad(frame, ((0, 0), (0, 4), (0, 0)))[None]
        status, out = _post(base + "/predict", _payload(frame, model="bu"))
        assert status == 200
        direct = dict(zip(("boxes", "scores", "keypoints", "keypoint_scores"), bu(padded)))
        for k, v in direct.items():
            np.testing.assert_allclose(np.asarray(out[k]), v[0], rtol=0, atol=1e-5, err_msg=k)
        thr = float(direct["scores"][0, 1])
        status, cut = _post(base + "/predict", _payload(frame, model="bu", score_threshold=thr))
        assert status == 200 and len(cut["scores"]) == 2
        status, out = _post(base + "/predict", _payload(frame, model="fused"))
        assert status == 200 and len(out["det_scores"]) == 2
        ref = fused(padded)
        for k, v in ref.items():
            np.testing.assert_allclose(np.asarray(out[k]), v[0], rtol=0, atol=1e-5, err_msg=k)
        for model in ("bu", "fused"):
            status, err = _post(base + "/predict", _payload(frame, [[0, 0, 5, 5]], model=model))
            assert status == 400 and "whole frames" in err["error"]
    finally:
        srv.shutdown()


# --------------------------------------------------------------------------
# main


@pytest.mark.parametrize("flags,item", [
    (["--bundle", "x"], 8), (["--checkpoint", "x", "--bundle", "y"], 8),
])
def test_main_refuses_unported_flags(tmp_path, flags, item):
    """--bundle serves the port's bundles (item 8, done); a JAX bundle
    directory is refused, naming the port's export CLI."""
    for name in ("x", "y"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "manifest.json").write_text(json.dumps({"version": 2}))
        (tmp_path / name / "fn_b1.bin").write_bytes(b"")
    flags = [f if f.startswith("--") else str(tmp_path / f) for f in flags]
    with pytest.raises(ValueError, match="probpose_pytorch_tpu_torch.serve.export"):
        port_server.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("flags", [[], ["--fused", "x"]])
def test_main_usage_errors(flags):
    """No model at all, and --fused without the --detector it composes with."""
    with pytest.raises(SystemExit):
        port_server.main(flags)


@pytest.fixture(scope="module")
def det_runs(tmp_path_factory):
    from test_torch_video import make_det_runs

    return make_det_runs(tmp_path_factory.mktemp("det"))


def test_main_serves_detector_modes(saved_runs, det_runs, monkeypatch):  # noqa: F811
    """main with --checkpoint, --detector, --bottomup and --fused on the CPU:
    each model's batcher (kind, buckets, indexed) and the detector the
    handler gets; a SIGTERM stops it."""
    _, port_dir = saved_runs
    det_dir, bu_dir = det_runs
    seen = {}

    def stop(self):
        seen["models"] = {name: (getattr(mb.runner, "kind", None), mb.buckets, mb.indexed)
                          for name, mb in self.batchers.items()}
        threading.Timer(0.2, os.kill, (os.getpid(), signal.SIGTERM)).start()
        self.httpd.serve_forever()

    make_handler = port_server._make_handler

    def spy(*args, **kw):
        seen["detector"] = args[3] if len(args) > 3 else kw.get("detector")
        return make_handler(*args, **kw)

    monkeypatch.setattr(PoseHTTPServer, "serve_forever", stop)
    monkeypatch.setattr(port_server, "_make_handler", spy)
    monkeypatch.setattr(inference, "_load_autotune_entry", lambda: {"batch": 4})
    before = signal.getsignal(signal.SIGTERM)
    try:
        port_server.main(["--checkpoint", f"{port_dir}/checkpoints", "--detector", str(det_dir),
                          "--detector-threshold", "0", "--bottomup", f"b={bu_dir}", "--fused",
                          f"f={port_dir}/checkpoints", "--max-people", "2", "--port", "0",
                          "--host", "127.0.0.1", "--frame-shape", "64,64", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert seen["models"] == {"model0": (None, (4,), True), "b": ("bottomup", (1, 2, 4, 8), False),
                              "f": ("fused", (1, 2, 4), False)}
    det = seen["detector"]
    assert det.score_threshold == 0.0 and det.max_detections == 64
    assert det.model.img_size == (64, 64)


def test_main_uses_recorded_ladder(saved_runs, monkeypatch, capsys):  # noqa: F811
    """Without --buckets, main serves each checkpoint over the card's
    recorded ladder (here a fake card's), else over the serving batch
    alone; a SIGTERM to the process stops it (the handler is put back)."""
    _, port_dir = saved_runs
    monkeypatch.setattr(inference, "_load_autotune_entry",
                        lambda: {"batch": 8, "bucket_ladder": [2, 8]})
    seen = {}

    def stop(self):
        seen.update({name: (mb.buckets, mb.frame_shape, mb.indexed, mb.runner.device.type)
                     for name, mb in self.batchers.items()})
        threading.Timer(0.2, os.kill, (os.getpid(), signal.SIGTERM)).start()
        self.httpd.serve_forever()

    monkeypatch.setattr(PoseHTTPServer, "serve_forever", stop)
    before = signal.getsignal(signal.SIGTERM)
    try:
        port_server.main(["--checkpoint", f"a={port_dir}/checkpoints", "--checkpoint",
                          f"{port_dir}/checkpoints", "--port", "0", "--host", "127.0.0.1",
                          "--frame-shape", "64,96", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert seen == {"a": ((2, 8), (64, 96), True, "cpu"), "model1": ((2, 8), (64, 96), True, "cpu")}
    monkeypatch.setattr(inference, "_load_autotune_entry", lambda: {})
    try:
        port_server.main(["--checkpoint", f"{port_dir}/checkpoints", "--port", "0",
                          "--host", "127.0.0.1", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert seen["default"] == ((64,), (1080, 1920), True, "cpu")
    assert "shut down" in capsys.readouterr().out


def test_main_serves_and_stops_on_sigterm(saved_runs):  # noqa: F811
    """python -m ...serve.server --device cpu --warmup: answers /healthz and
    /predict, then exits 0 on SIGTERM."""
    _, port_dir = saved_runs
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    # main as `python -m` runs it, with the test's tiny preset registered
    launch = ("import sys, runpy; from probpose_pytorch_tpu_torch.models.vit import ViTConfig; "
              f"ViTConfig.PRESETS['vit-tiny-port'] = {TINY!r}; sys.argv[0] = 'server'; "
              "runpy.run_module('probpose_pytorch_tpu_torch.serve.server', run_name='__main__')")
    proc = subprocess.Popen(
        [sys.executable, "-c", launch, "--checkpoint",
         f"{port_dir}/checkpoints", "--port", "0", "--host", "127.0.0.1", "--frame-shape",
         "64,64", "--buckets", "1,2", "--warmup", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    lines = []
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving "), "".join(lines)
        assert any(line.startswith("warmed 3 programs") for line in lines), "".join(lines)
        base = "http://" + lines[-1].split(" on ")[1].split()[0]
        assert json.loads(_get(base + "/healthz")[1]) == {"ok": True}
        status, out = _post(base + "/predict", _payload(_frame(1, 40, 50), [[0, 0, 30, 40]]))
        assert status == 200 and np.asarray(out["keypoints"]).shape == (1, K, 2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "shut down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
