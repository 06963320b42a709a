"""Pose-serving server: dynamic micro-batching over HTTP (port of
probpose_pytorch_tpu/serve/server.py, top-down models).

Two layers, separately usable:

* `MicroBatcher`, the batching core, HTTP-free. Concurrent callers
  `submit(frame, boxes)`; a dispatcher thread coalesces everything pending
  (across requests) into one padded bucket-size batch per dispatch, and a
  completion thread reads each batch back and resolves the per-request
  futures. Padding rows repeat a real crop and are stripped.

* `PoseHTTPServer` / `main`, a stdlib ThreadingHTTPServer front end:

      python -m probpose_pytorch_tpu_torch.serve.server \\
          --checkpoint runs/flagship/checkpoints --port 8000 [--device cuda] \\
          [--detector runs/detector] [--bottomup [NAME=]runs/bottomup] \\
          [--fused [NAME=]runs/flagship/checkpoints --max-people 8] \\
          [--bundle [NAME=]bundle_dir]

  POST /predict   {"frame_b64": <base64 raw HxWx3 uint8>,
                   "shape": [H, W, 3], "boxes": [[x,y,w,h], ...],
                   "model": NAME (optional), "detector_threshold" /
                   "score_threshold" (optional)}
                  -> {"keypoints": ..., "scores": ..., ...} (JSON lists)
  GET  /healthz   -> {"ok": true}
  GET  /models    -> served model names and the default
  GET  /stats     -> request/crop/dispatch counts, latency quantiles (ms),
                     mean and max batch
  GET  /metrics   -> the same in Prometheus text format

Frames are zero-padded to the server's frame shape (crop_resize samples
black outside a frame either way). With a live `TopDownPredictor` the
batcher runs indexed: each request's frame crosses to the device once, and
crop i reads frame frame_ids[i].

On a CUDA predictor the dispatcher thread uploads and launches and the
completion thread downloads, both on the device's current stream, so a
batch's readback waits for its own work only.

With `--detector`, a top-down request may omit "boxes": the handler finds
the people itself (detect/pipeline.py) and returns the boxes it used.
`--bottomup` models (one forward per frame, `BottomUpRunner`) and
`--fused` models (detector -> crops -> pose with the boxes kept on the
card, `FusedRunner`) take whole frames and no "boxes"; their rows are
thresholded on "scores" or "det_scores". `--bundle` serves an exported
pose bundle (serve/export.py: `ServingBundle`, its buckets and frame shape),
and `--bottomup` and `--fused` take bottom-up and fused bundle directories
as well as run directories; a detector bundle answers boxes-omitted
requests but cannot be fused live.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

__all__ = ["BottomUpRunner", "FusedRunner", "MicroBatcher", "PoseHTTPServer", "main"]

# One 4K RGB frame base64-encodes to ~33 MB; 128 MB bounds any sane request
# while keeping a ThreadingHTTPServer from buffering unbounded bodies.
MAX_REQUEST_BYTES = 128 * 1024 * 1024


class _SplitAggregate:
    """Reassembles an oversized request's chunks in order and resolves its
    future once all arrive (completion thread, plus a fail() that may race
    from the dispatcher: guarded)."""

    def __init__(self, fut: Future, n_chunks: int, total: int, t0: float):
        self.fut = fut
        self.parts: list = [None] * n_chunks
        self.remaining = n_chunks
        self.total = total
        self.t0 = t0
        self._lock = threading.Lock()
        self._failed = False

    def add(self, idx: int, out: dict) -> bool:
        with self._lock:
            if self._failed:
                return False
            self.parts[idx] = out
            self.remaining -= 1
            if self.remaining:
                return False
        self.fut.set_result({k: np.concatenate([p[k] for p in self.parts])
                             for k in self.parts[0]})
        return True

    def fail(self, e: Exception) -> None:
        with self._lock:
            if self._failed:
                return
            self._failed = True
        self.fut.set_exception(e)


class MicroBatcher:
    """Coalesce concurrent (frame, boxes) requests into bucket-size batches.

    runner: callable (frames (B, Hf, Wf, 3) uint8, boxes (B, 4) f32[,
    frame_ids (B,)]) -> dict of (B, ...) arrays, e.g. a `TopDownPredictor`.
    Where it has `_dispatch` (launch, return device tensors) and `_download`
    (device tensors -> numpy), the batcher launches with the first on its
    dispatcher thread and reads back with the second on its completion
    thread, so batch i+1's assembly and upload overlap batch i's compute.
    buckets: ascending batch sizes the runner is called with.
    max_wait_ms: how long the dispatcher waits for more work after the first
    pending crop before dispatching a partial batch (0: no wait).
    frame_shape: (Hf, Wf) all frames are zero-padded to.
    indexed: the runner takes frame_ids; each request's frame is then passed
    once, the unique-frame count padded to a power of two.
    """

    def __init__(self, runner: Callable[..., dict], buckets: Sequence[int],
                 frame_shape: tuple[int, int], max_wait_ms: float = 5.0,
                 indexed: bool = False):
        self.runner = runner
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets {self.buckets}")
        self.frame_shape = (int(frame_shape[0]), int(frame_shape[1]))
        self.max_wait_ms = float(max_wait_ms)
        self.indexed = bool(indexed)
        self._dispatch_fn = getattr(runner, "_dispatch", None) or runner
        download = getattr(runner, "_download", None)
        self._download = download or (lambda dev: {k: np.asarray(v) for k, v in dev.items()})
        self._queue: deque = deque()  # (frame, boxes, future, t0)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self.stats = {"requests": 0, "crops": 0, "dispatches": 0, "batch_sizes": [],
                      "latency_ms": []}
        # bounded: at most 2 batches in flight on the device
        self._done: queue.Queue = queue.Queue(maxsize=2)
        self._completion = threading.Thread(target=self._completion_loop,
                                            name="microbatcher-read", daemon=True)
        self._completion.start()
        self._thread = threading.Thread(target=self._dispatch_loop, name="microbatcher",
                                        daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, frame: np.ndarray, boxes: np.ndarray) -> Future:
        """Enqueue one request (one frame, N boxes). The future resolves to
        a dict of (N, ...) numpy arrays, or raises the dispatch error."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        frame = self._pad_frame(np.asarray(frame, np.uint8))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        fut: Future = Future()
        if len(boxes) == 0:
            fut.set_result({})
            return fut
        with self._lock:
            self._queue.append((frame, boxes, fut, time.perf_counter()))
            self.stats["requests"] += 1
            self.stats["crops"] += len(boxes)
        self._wake.set()
        return fut

    def warmup(self, verbose: bool = False) -> int:
        """One dummy dispatch per (bucket, unique-frame count) the batcher
        can send (indexed mode walks the power-of-two frame ladder), read
        back before traffic: the first launch builds the kernels and each
        shape's first call sets up its library state. Returns the count."""
        Hf, Wf = self.frame_shape
        frame = np.zeros((Hf, Wf, 3), np.uint8)
        n = 0
        for b in self.buckets:
            fs = [1]
            if self.indexed and b > 1:
                fs = [1 << i for i in range((b - 1).bit_length())] + [b]
            for f in fs:
                f = min(f, b)
                # f * (b // f) <= b crops; _dispatch_device pads the rest
                boxes = [np.tile(np.array([[0, 0, Wf, Hf]], np.float32),
                                 (max(b // f, 1), 1))] * f
                self._download(self._dispatch_device([frame] * len(boxes), boxes, b))
                n += 1
                if verbose:
                    print(f"[warmup] bucket {b}, frames {len(boxes)} ready", flush=True)
        return n

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=10)
        self._done.put(None)  # completion-thread sentinel
        self._completion.join(timeout=30)
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for _, _, fut, _ in pending:
            fut.set_exception(RuntimeError("batcher closed"))

    # -- dispatcher --------------------------------------------------------

    def _pad_frame(self, frame: np.ndarray) -> np.ndarray:
        Hf, Wf = self.frame_shape
        H, W, _ = frame.shape
        if (H, W) == (Hf, Wf):
            return frame
        if H > Hf or W > Wf:
            raise ValueError(f"frame {(H, W)} exceeds the server frame shape {(Hf, Wf)}")
        return np.pad(frame, ((0, Hf - H), (0, Wf - W), (0, 0)))

    def _dispatch_loop(self) -> None:
        while True:
            self._wake.wait()
            if self._closed:
                return
            # coalescing window: let concurrent requests pile up
            if self.max_wait_ms > 0:
                deadline = time.perf_counter() + self.max_wait_ms / 1e3
                while time.perf_counter() < deadline:
                    with self._lock:
                        pending = sum(len(b) for _, b, _, _ in self._queue)
                    if pending >= self.buckets[-1]:
                        break
                    time.sleep(min(0.001, self.max_wait_ms / 1e3))
            batch = []
            count = 0
            with self._lock:
                self._wake.clear()
                # re-check after the clear: close() may have set _closed and
                # woken us since wait() returned, and the clear would swallow
                # its signal
                if self._closed:
                    return
                # pop requests while they fit in the top bucket (at least
                # one, so a single oversized request still dispatches:
                # _run_batch splits it)
                while self._queue:
                    n = len(self._queue[0][1])
                    if batch and count + n > self.buckets[-1]:
                        break
                    batch.append(self._queue.popleft())
                    count += n
                    if count >= self.buckets[-1]:
                        break
            if not batch:
                continue
            self._run_batch(batch, count)
            with self._lock:
                if self._queue:
                    self._wake.set()

    def _run_batch(self, batch, count: int) -> None:
        bucket = next((b for b in self.buckets if b >= count), None)
        if bucket is None:
            # only a single request can exceed the top bucket: split it into
            # top-bucket chunks, each dispatched like a batch
            top = self.buckets[-1]
            frame, boxes, fut, t0 = batch[0]
            chunks = [boxes[i:i + top] for i in range(0, len(boxes), top)]
            agg = _SplitAggregate(fut, len(chunks), len(boxes), t0)
            for ci, chunk in enumerate(chunks):
                try:
                    dev = self._dispatch_device([frame], [chunk], top)
                except Exception as e:  # noqa: BLE001 — the future carries it
                    agg.fail(e)
                    return
                self._done.put(("chunk", dev, len(chunk), agg, ci))
                with self._lock:
                    self.stats["dispatches"] += 1
            with self._lock:
                self.stats["batch_sizes"].append(int(len(boxes)))
            return
        try:
            dev = self._dispatch_device([f for f, _, _, _ in batch],
                                        [b for _, b, _, _ in batch], bucket)
        except Exception as e:  # noqa: BLE001 — the futures carry it
            for _, _, fut, _ in batch:
                fut.set_exception(e)
            return
        self._done.put(("batch", dev, count, batch, None))
        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["batch_sizes"].append(int(count))

    def _completion_loop(self) -> None:
        """Readback and result fan-out, off the dispatcher thread. The real
        rows are sliced off on the device before the download."""
        while True:
            item = self._done.get()
            if item is None:
                return
            kind, dev, n, target, ci = item
            try:
                out = self._download({k: v[:n] for k, v in dev.items()})
            except Exception as e:  # noqa: BLE001 — the futures carry it
                if kind == "batch":
                    for _, _, fut, _ in target:
                        fut.set_exception(e)
                else:
                    target.fail(e)
                continue
            if kind == "batch":
                i = 0
                for _, b, fut, t0 in target:
                    m = len(b)
                    fut.set_result({k: v[i:i + m] for k, v in out.items()})
                    self._note(t0)
                    i += m
            elif target.add(ci, out):
                self._note(target.t0)

    def _dispatch_device(self, req_frames, req_boxes, bucket: int) -> dict:
        """Assemble one padded batch for a list of (frame, boxes) requests
        and launch it: crops pad to `bucket` (repeating the last crop);
        indexed mode passes each unique frame once and frame_ids (the frame
        count padded to a power of two, at most the bucket), else frames
        repeat per crop."""
        counts = [len(b) for b in req_boxes]
        boxes = np.concatenate(req_boxes).astype(np.float32)
        pad = bucket - sum(counts)
        if pad:
            boxes = np.concatenate([boxes, np.repeat(boxes[-1:], pad, axis=0)])
        if self.indexed:
            ids = np.repeat(np.arange(len(req_frames), dtype=np.int64), counts)
            if pad:
                ids = np.concatenate([ids, np.full((pad,), ids[-1], np.int64)])
            f = len(req_frames)
            fcap = min(1 << (f - 1).bit_length() if f > 1 else 1, bucket)
            frames = np.stack(list(req_frames) + [np.zeros_like(req_frames[0])] * (fcap - f))
            return self._dispatch_fn(frames, boxes, ids)
        rows = [np.broadcast_to(fr[None], (c,) + fr.shape) for fr, c in zip(req_frames, counts)]
        if pad:
            last = req_frames[-1]
            rows.append(np.broadcast_to(last[None], (pad,) + last.shape))
        return self._dispatch_fn(np.ascontiguousarray(np.concatenate(rows)), boxes)

    def _note(self, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.stats["latency_ms"].append(ms)
            # bound the in-memory windows (quantiles reflect recent load)
            if len(self.stats["latency_ms"]) > 10_000:
                del self.stats["latency_ms"][:5_000]
            if len(self.stats["batch_sizes"]) > 10_000:
                del self.stats["batch_sizes"][:5_000]

    def stats_snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self.stats["latency_ms"])
            sizes = list(self.stats["batch_sizes"])
            out = {k: self.stats[k] for k in ("requests", "crops", "dispatches")}
        if lat:
            q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]  # noqa: E731
            out["latency_ms"] = {"p50": round(q(0.50), 3), "p90": round(q(0.90), 3),
                                 "p99": round(q(0.99), 3), "max": round(lat[-1], 3)}
        if sizes:
            out["mean_batch"] = round(float(np.mean(sizes)), 2)
            out["max_batch"] = int(max(sizes))
        return out


class BottomUpRunner:
    """The single-stage pose family (detect.BottomUpPredictor) as a
    MicroBatcher runner: each request is one frame, one batch row; the
    full-frame box rows the batcher assembles are ignored. `kind` tells the
    handler to threshold each row on "scores"."""

    kind = "bottomup"

    def __init__(self, predictor):
        self.predictor = predictor
        self.score_threshold = float(predictor.score_threshold)

    def _dispatch(self, frames: np.ndarray, boxes: np.ndarray) -> dict:
        del boxes  # one full-frame row per request: nothing to crop
        return self.predictor.dispatch(frames)

    @staticmethod
    def _download(out: dict) -> dict[str, np.ndarray]:
        return {k: v.float().cpu().numpy() for k, v in out.items()}


class FusedRunner(BottomUpRunner):
    """The fused two-stage predictor (detect.FusedTwoStagePredictor) as a
    runner: whole-frame rows like the bottom-up family, detector -> crops
    -> pose in one dispatch, rows thresholded on "det_scores"."""

    kind = "fused"


def _metrics_text(batchers: dict[str, MicroBatcher]) -> str:
    """Prometheus text exposition, one label set per model."""
    lines = ["# TYPE pose_requests_total counter", "# TYPE pose_crops_total counter",
             "# TYPE pose_dispatches_total counter",
             "# TYPE pose_request_latency_ms summary", "# TYPE pose_mean_batch_size gauge"]
    for name, mb in sorted(batchers.items()):
        s = mb.stats_snapshot()
        m = f'model="{name}"'
        lines += [f"pose_requests_total{{{m}}} {s['requests']}",
                  f"pose_crops_total{{{m}}} {s['crops']}",
                  f"pose_dispatches_total{{{m}}} {s['dispatches']}"]
        if "latency_ms" in s:
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lines.append(f'pose_request_latency_ms{{{m},quantile="{q}"}} '
                             f"{s['latency_ms'][key]}")
        if "mean_batch" in s:
            lines.append(f"pose_mean_batch_size{{{m}}} {s['mean_batch']}")
    return "\n".join(lines) + "\n"


def _make_handler(batchers: dict[str, MicroBatcher], default: str,
                  request_timeout_s: float = 300.0, detector=None):
    # batchers: one MicroBatcher per served model; requests pick one with
    # the JSON "model" field (default: the first configured model).
    # detector: a detect.DetectorPredictor; top-down requests that omit
    # "boxes" then detect people in the frame (in the handler's thread),
    # and the reply carries the boxes used.
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/models":
                self._reply(200, {"models": sorted(batchers), "default": default})
            elif self.path == "/stats":
                if len(batchers) == 1:
                    self._reply(200, batchers[default].stats_snapshot())
                else:
                    self._reply(200, {name: mb.stats_snapshot()
                                      for name, mb in batchers.items()})
            elif self.path == "/metrics":
                self._send(200, _metrics_text(batchers).encode(),
                           "text/plain; version=0.0.4")
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_REQUEST_BYTES:
                    self._reply(413, {"error": f"request {length} B exceeds the "
                                      f"{MAX_REQUEST_BYTES} B limit"})
                    return
                req = json.loads(self.rfile.read(length))
                shape = tuple(int(v) for v in req["shape"])
                if len(shape) != 3 or shape[2] != 3:
                    raise ValueError(f"shape {shape} != (H, W, 3)")
                frame = np.frombuffer(base64.b64decode(req["frame_b64"]), np.uint8)
                if frame.size != shape[0] * shape[1] * shape[2]:
                    raise ValueError(f"{frame.size} bytes != shape {shape}")
                frame = frame.reshape(shape)
                boxes = (np.asarray(req["boxes"], np.float32).reshape(-1, 4)
                         if "boxes" in req else None)
                model = req.get("model", default)
            except Exception as e:  # noqa: BLE001 — client error -> 400
                self._reply(400, {"error": str(e)})
                return
            batcher = batchers.get(model)
            if batcher is None:
                self._reply(404, {"error": f"unknown model {model!r} "
                                  f"(serving: {sorted(batchers)})"})
                return
            kind = getattr(batcher.runner, "kind", None)
            whole = kind in ("bottomup", "fused")
            if whole:
                if boxes is not None:
                    fam = "fused two-stage" if kind == "fused" else "bottom-up"
                    self._reply(400, {"error": f"{fam} models take whole frames — omit "
                                      "'boxes' (pass 'score_threshold' to filter)"})
                    return
                boxes = np.array([[0.0, 0.0, frame.shape[1], frame.shape[0]]], np.float32)
            elif boxes is None and detector is None:
                self._reply(400, {"error": "request has no 'boxes' and the server has "
                                  "no --detector configured"})
                return
            detected = None
            if boxes is None:
                from probpose_pytorch_tpu_torch.video import detector_boxes

                try:
                    boxes = detector_boxes(detector, frame, batcher.runner.input_size,
                                           threshold=req.get("detector_threshold"))
                except Exception as e:  # noqa: BLE001 — server error -> 500
                    self._reply(500, {"error": f"detector: {e}"})
                    return
                detected = boxes
                if len(boxes) == 0:
                    self._reply(200, {"boxes": [], "keypoints": []})
                    return
            try:
                fut = batcher.submit(frame, boxes)
            except ValueError as e:
                # synchronous validation (a frame past the server frame
                # shape) is the client's fault, not a server fault
                self._reply(400, {"error": str(e)})
                return
            try:
                out = fut.result(timeout=request_timeout_s)
            except Exception as e:  # noqa: BLE001 — server error -> 500
                self._reply(500, {"error": str(e)})
                return
            if whole:
                # one row per request: (1, k, ...) -> the kept (n, ...) slots
                thr = float(req.get("score_threshold", batcher.runner.score_threshold))
                keep = out["det_scores" if kind == "fused" else "scores"][0] >= thr
                payload = {k: v[0][keep].tolist() for k, v in out.items()}
            else:
                payload = {k: v.tolist() for k, v in out.items()}
            if detected is not None:
                payload["boxes"] = detected.tolist()
            self._reply(200, payload)

    return Handler


class PoseHTTPServer:
    """ThreadingHTTPServer over one or more MicroBatchers; `serve_forever`
    in the calling thread, or `start()` / `shutdown()` for embedding. A dict
    {name: MicroBatcher} serves several models from one port (requests
    route with the JSON "model" field; `default`, else the first name,
    serves unrouted requests). With `detector` (a DetectorPredictor),
    top-down requests may omit "boxes"."""

    def __init__(self, batcher, host: str = "0.0.0.0", port: int = 8000,
                 request_timeout_s: float = 300.0, default: str | None = None,
                 detector=None):
        from http.server import ThreadingHTTPServer

        batchers = {"default": batcher} if isinstance(batcher, MicroBatcher) else dict(batcher)
        if not batchers:
            raise ValueError("no batchers to serve")
        self.batchers = batchers
        self.batcher = next(iter(batchers.values()))
        default = default or next(iter(batchers))
        if default not in batchers:
            raise ValueError(f"default model {default!r} not in {sorted(batchers)}")
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_handler(batchers, default, request_timeout_s,
                                                       detector))
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for mb in self.batchers.values():
            mb.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="pose serving server (PyTorch)")
    parser.add_argument("--checkpoint", action="append", default=[], metavar="[NAME=]DIR",
                        help="checkpoint directory of the port's training CLI; repeat "
                        "with NAME=DIR to serve several models")
    parser.add_argument("--bundle", action="append", default=[], metavar="[NAME=]DIR",
                        help="exported serving bundle (serve.export); repeat with NAME=DIR "
                        "to serve several")
    parser.add_argument("--bottomup", action="append", default=[], metavar="[NAME=]DIR",
                        help="single-stage pose model (detect.train --keypoints run dir): "
                        "requests send whole frames, no 'boxes'; cost is per frame")
    parser.add_argument("--fused", action="append", default=[], metavar="[NAME=]DIR",
                        help="pose checkpoint composed with --detector into the fused "
                        "two-stage predictor: requests send whole frames, no 'boxes'; "
                        "detector -> crops -> pose in one dispatch, boxes kept on the card")
    parser.add_argument("--max-people", type=int, default=8,
                        help="pose slots per frame for --fused models")
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--frame-shape", type=str, default="1080,1920",
                        help="H,W all frames are padded to")
    parser.add_argument("--buckets", type=str, default=None,
                        help="comma-separated batch buckets (default: this card's recorded "
                        "ladder, else its serving batch; (1, 2, 4, 8) frames for "
                        "--bottomup, (1, 2, 4) for --fused)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--detector", type=Path, default=None,
                        help="person-detector run directory (detect.train output): "
                        "top-down requests may omit 'boxes' and the server detects people "
                        "itself (the reply carries the boxes used)")
    parser.add_argument("--detector-threshold", type=float, default=0.3)
    parser.add_argument("--ema", action="store_true")
    parser.add_argument("--warmup", action="store_true",
                        help="dispatch every (bucket, frame-count) batch once before "
                        "accepting traffic (builds the kernels; adds startup time)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not (args.checkpoint or args.bundle or args.bottomup or args.fused):
        parser.error("need at least one --checkpoint / --bundle / --bottomup / --fused")

    # Graceful stop on SIGTERM (what orchestrators send), installed before
    # the models load so a stop during startup also exits promptly.
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)

    from probpose_pytorch_tpu_torch.detect import (
        FusedTwoStagePredictor,
        load_bottomup,
        load_detector,
    )
    from probpose_pytorch_tpu_torch.inference import (
        load_predictor,
        tuned_bucket_ladder,
        tuned_serving_batch,
    )
    from probpose_pytorch_tpu_torch.serve.export import FusedBundle, ServingBundle

    frame_shape = tuple(int(v) for v in args.frame_shape.split(","))
    multi = len(args.checkpoint) + len(args.bundle) + len(args.bottomup) + len(args.fused) > 1
    batchers: dict[str, MicroBatcher] = {}

    def add(entry: str, prefix: str, i: int, make, buckets, indexed: bool,
            shape=lambda runner: frame_shape) -> None:
        name, _, path = entry.rpartition("=")
        name = name or (f"{prefix}{i}" if multi else "default")
        if name in batchers:
            raise ValueError(f"duplicate model name {name!r}")
        runner = make(Path(path))
        if args.buckets:
            buckets = tuple(int(b) for b in args.buckets.split(","))
        elif callable(buckets):
            buckets = buckets(runner)
        batchers[name] = MicroBatcher(runner, buckets, shape(runner),
                                      max_wait_ms=args.max_wait_ms, indexed=indexed)
        print(f"model {name!r}: buckets {tuple(batchers[name].buckets)}, frame "
              f"{batchers[name].frame_shape}, indexed={indexed}", flush=True)

    # Loaded first: live --fused models compose with it, and the handler's
    # top-down requests without boxes use it.
    detector = None
    if args.detector is not None:
        det_dir = args.detector
        if (det_dir / "checkpoints").exists():
            det_dir = det_dir / "checkpoints"
        detector = load_detector(det_dir, score_threshold=args.detector_threshold,
                                 max_detections=max(args.max_people, 64), device=args.device)
        print(f"detector: {det_dir} (threshold {args.detector_threshold})", flush=True)
    pose = lambda path: load_predictor(path, args.config, ema=args.ema,  # noqa: E731
                                       device=args.device)
    for i, entry in enumerate(args.bundle):
        bundle = ServingBundle.load(Path(entry.rpartition("=")[2]), device=args.device)
        add(entry, "bundle", i, lambda path: bundle, bundle.buckets, bool(bundle.indexed_buckets),
            shape=lambda runner: runner.frame_shape)
    ladder = tuned_bucket_ladder() or (tuned_serving_batch(),)
    for i, entry in enumerate(args.checkpoint):
        add(entry, "model", i, pose, ladder, True)
    # an exported bottom-up or fused bundle runs its own (batch, frame shape)
    # programs only; a live predictor takes any
    ladder_of = lambda default: lambda r: getattr(r.predictor, "batches", default)  # noqa: E731
    fit = lambda r: (r.predictor._fit_shape(*frame_shape)  # noqa: E731
                     if hasattr(r.predictor, "batches") else frame_shape)
    for i, entry in enumerate(args.bottomup):
        add(entry, "bottomup", i, lambda path: BottomUpRunner(load_bottomup(
            path, score_threshold=args.detector_threshold, device=args.device)),
            ladder_of((1, 2, 4, 8)), False, fit)

    def fused(path: Path) -> FusedRunner:
        if (path / "manifest.json").exists() and json.loads(
                (path / "manifest.json").read_text()).get("kind") == "fused":
            return FusedRunner(FusedBundle.load(path, device=args.device))
        if detector is None:
            parser.error(f"--fused {path}: not a fused bundle, so it must be a pose checkpoint "
                         "composed live: pass --detector too")
        if not hasattr(detector, "predict"):
            parser.error("live --fused composition needs a live --detector checkpoint "
                         "(exported detector bundles are already-traced programs)")
        return FusedRunner(FusedTwoStagePredictor(
            detector=detector, pose=pose(path), max_people=args.max_people,
            score_threshold=args.detector_threshold))

    for i, entry in enumerate(args.fused):
        add(entry, "fused", i, fused, ladder_of((1, 2, 4)), False, fit)

    if args.warmup:
        t0 = time.perf_counter()
        n = sum(mb.warmup(verbose=True) for mb in batchers.values())
        print(f"warmed {n} programs in {time.perf_counter() - t0:.1f}s", flush=True)
    server = PoseHTTPServer(batchers, args.host, args.port, detector=detector)
    print(f"serving {sorted(batchers)} on {args.host}:{server.port} "
          f"(wait {args.max_wait_ms} ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        t0 = time.perf_counter()
        server.shutdown()
        print(f"shut down in {time.perf_counter() - t0:.2f}s", flush=True)


if __name__ == "__main__":
    main()
