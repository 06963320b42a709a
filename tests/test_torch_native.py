"""The port's native data plane (probpose_pytorch_tpu_torch/native/) against
the JAX package's (probpose_pytorch_tpu/native/), on the CPU.

Both build the same dataplane.cpp source with the same g++ flags, so crops
and JPEG decodes are held bit for bit; the port's crop_resize
"bilinear_gather" is held to JAX's within 1e-5 (float32 sums of four taps
in one order on both sides; XLA may fuse a product into an FMA), and the
native crops to the device convention within one uint8 level, as JAX's
tests/test_native.py holds its own. The COCO and YOLO loaders with
resample="native" equal JAX's batch for batch.
"""

import functools
import io
import json
import time

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu import native as jax_native
from probpose_pytorch_tpu.data import YOLOPoseDataset as JaxYOLO
from probpose_pytorch_tpu.data.coco import COCOPoseDataset as JaxCOCO
from probpose_pytorch_tpu.ops.preprocess import crop_resize as jax_crop_resize
from probpose_pytorch_tpu_torch import native
from probpose_pytorch_tpu_torch.data import (
    CachedCropDataset,
    COCOPoseDataset,
    YOLOPoseDataset,
    build_crop_cache,
)
from probpose_pytorch_tpu_torch.ops.preprocess import crop_resize

torch.set_num_threads(2)

# Boxes partly outside the frame exercise the zero-padding border.
BOXES = np.asarray([[10, 5, 60, 70], [-8, -4, 50, 60], [70, 50, 60, 60],
                    [12.3, 7.7, 41.9, 55.1]], np.float32)


@functools.cache
def _jax_plane() -> bool:
    """Whether JAX's plane loads. JAX's `_build` writes its library in
    place, so a load may meet another test process's build in flight (the
    library "too short" or with an "invalid ELF header"); JAX's loader
    caches no failure, so such a load is tried again once the file is whole
    (at most 60 s). A host that cannot build it (no g++, no libjpeg) fails
    at once."""
    for _ in range(60):
        if jax_native.native_available():
            return True
        error = str(jax_native._build_error or "")
        if "too short" not in error and "invalid ELF header" not in error:
            return False
        time.sleep(1.0)
    return False


@pytest.fixture(autouse=True)
def _plane():
    """Skip only where JAX's tests/test_native.py skips: no plane built."""
    if not _jax_plane():
        pytest.skip("native data plane not built (no g++/libjpeg on this host)")


def _rand_frame(rng, h=80, w=100):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _jpeg_bytes(arr, quality=95):
    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_crop_resize_batch_equals_jax(threads):
    rng = np.random.default_rng(0)
    frames = np.stack([_rand_frame(rng) for _ in range(4)])
    got = native.crop_resize_batch(frames, BOXES, (64, 48), n_threads=threads)
    want = jax_native.crop_resize_batch(frames, BOXES, (64, 48), n_threads=threads)
    np.testing.assert_array_equal(got, want)


def test_decode_crop_resize_batch_equals_jax():
    """Good, truncated and corrupt JPEGs: the same crops and the same
    failure count (a corrupt buffer fails and yields a zero crop)."""
    rng = np.random.default_rng(2)
    good = [_jpeg_bytes(_rand_frame(rng, 64, 96), q) for q in (95, 70)]
    bufs = [good[0], good[1][: len(good[1]) // 3], b"not a jpeg at all", good[1]]
    boxes = np.asarray([[8, 4, 70, 50], [0, 0, 50, 50], [0, 0, 10, 10], [-5, 10, 80, 40]],
                       np.float32)
    got, failed = native.decode_crop_resize_batch(bufs, boxes, (40, 56))
    want, want_failed = jax_native.decode_crop_resize_batch(bufs, boxes, (40, 56))
    np.testing.assert_array_equal(got, want)
    assert failed == want_failed >= 1
    assert got[2].max() == 0


def test_jpeg_size_equals_jax():
    rng = np.random.default_rng(3)
    data = _jpeg_bytes(_rand_frame(rng, 33, 57))
    assert native.jpeg_size(data) == jax_native.jpeg_size(data) == (33, 57)
    assert native.jpeg_size(b"junk") is None


def test_build_report():
    report = native.build_report()
    assert report["available"] and report["jpeg"]
    assert "torch_native" in report["path"] and "-DPROBPOSE_NO_JPEG" not in report["flags"]


def test_without_jpeglib_the_crop_half_builds_and_decode_raises(monkeypatch):
    """A host without jpeglib.h: the plane builds its crop-resize half alone
    (-DPROBPOSE_NO_JPEG), says so, crops as before, and the JPEG entry
    points raise naming the header."""
    monkeypatch.setattr(native, "_has_jpeg_header", lambda: False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_report", {})
    report = native.build_report()
    assert report["available"] and not report["jpeg"]
    assert "-DPROBPOSE_NO_JPEG" in report["flags"] and "jpeglib.h" in report["jpeg_missing"]
    rng = np.random.default_rng(0)
    frames = np.stack([_rand_frame(rng) for _ in range(4)])
    np.testing.assert_array_equal(native.crop_resize_batch(frames, BOXES, (64, 48)),
                                  jax_native.crop_resize_batch(frames, BOXES, (64, 48)))
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.decode_crop_resize_batch([_jpeg_bytes(frames[0])], BOXES[:1], (8, 8))
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.jpeg_size(_jpeg_bytes(frames[0]))
    from probpose_pytorch_tpu_torch import doctor

    with pytest.raises(RuntimeError, match="crop-resize half only"):
        doctor.native()


@pytest.mark.parametrize("as_float", [False, True], ids=["uint8", "float01"])
def test_bilinear_gather_matches_jax(as_float):
    rng = np.random.default_rng(0)
    frames = np.stack([_rand_frame(rng) for _ in range(4)])
    inp = frames.astype(np.float32) / 255.0 if as_float else frames
    got = crop_resize(torch.from_numpy(inp), torch.from_numpy(BOXES), (64, 48),
                      "bilinear_gather").numpy()
    want = np.asarray(jax_crop_resize(inp, BOXES, (64, 48), "bilinear_gather"))
    assert got.shape == want.shape == (4, 64, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_native_crops_match_the_device_convention():
    """Identical sampling convention: only uint8 rounding can differ."""
    rng = np.random.default_rng(0)
    frames = np.stack([_rand_frame(rng) for _ in range(4)])
    got = native.crop_resize_batch(frames, BOXES, (64, 48))
    dev = crop_resize(torch.from_numpy(frames).float(), torch.from_numpy(BOXES), (64, 48),
                      "bilinear_gather").numpy()
    want = np.clip(np.round(dev), 0, 255).astype(np.uint8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# --------------------------------------------------------------------------
# the loaders


@pytest.fixture(scope="module")
def yolo_root(tmp_path_factory):
    """JAX's tests/test_native.py YOLO set: mixed JPEG and PNG frames."""
    import PIL.Image

    root = tmp_path_factory.mktemp("yolo")
    rng = np.random.default_rng(5)
    (root / "train" / "images").mkdir(parents=True)
    (root / "train" / "labels").mkdir(parents=True)
    for i in range(4):
        ext = "jpg" if i % 2 == 0 else "png"
        PIL.Image.fromarray(_rand_frame(rng)).save(root / "train" / "images" / f"{i}.{ext}")
        parts = ["0", "0.5", "0.5", "0.6", "0.7"]
        for _ in range(5):
            parts += [f"{rng.uniform(0.2, 0.8):.4f}", f"{rng.uniform(0.2, 0.8):.4f}", "2"]
        (root / "train" / "labels" / f"{i}.txt").write_text(" ".join(parts) + "\n")
    return root


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """JAX's tests/test_native.py COCO set: mixed JPEG and PNG frames."""
    import PIL.Image

    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(9)
    img_dir = root / "images"
    img_dir.mkdir()
    images, annotations = [], []
    for i in range(4):
        ext = "jpg" if i % 2 == 0 else "png"
        PIL.Image.fromarray(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.{ext}")
        images.append(dict(id=i, file_name=f"{i}.{ext}", width=160, height=120))
        kps = rng.uniform([30, 30], [120, 100], (17, 2))
        flat = np.concatenate([kps, np.full((17, 1), 2.0)], 1).reshape(-1).tolist()
        annotations.append(dict(id=100 + i, image_id=i, category_id=1, keypoints=flat,
                                num_keypoints=17, bbox=[25.0, 25.0, 100.0, 80.0],
                                area=8000.0, iscrowd=0))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=annotations)))
    return ann, img_dir


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_yolo_get_batch_native_equals_jax(yolo_root):
    ds = YOLOPoseDataset(yolo_root, "train", (64, 48), resample="native")
    ref = JaxYOLO(yolo_root, "train", (64, 48), resample="native")
    b = ds.get_batch(range(4))
    _same_batch(b, ref.get_batch(range(4)))
    assert b["image"].shape == (4, 64, 48, 3) and b["image"].std() > 10
    # __getitem__ goes through get_batch
    _same_batch(ds[1], {k: v[1] for k, v in b.items()})


def test_coco_get_batch_native_equals_jax(coco_root):
    ann, img_dir = coco_root
    ds = COCOPoseDataset(ann, img_dir, (64, 48), resample="native")
    ref = JaxCOCO(ann, img_dir, (64, 48), resample="native")
    b = ds.get_batch(range(4))
    _same_batch(b, ref.get_batch(range(4)))
    assert set(b) >= {"bbox", "image_id", "area", "keypoints_frame", "bbox_frame"}
    _same_batch(ds[2], {k: v[2] for k, v in b.items()})
    # labels are the PIL path's; only the pixels' resampler differs
    pil = COCOPoseDataset(ann, img_dir, (64, 48)).get_batch(range(4))
    for k in ("keypoints", "bbox", "image_id", "area"):
        np.testing.assert_array_equal(b[k], pil[k], err_msg=k)


def test_png_record_matches_the_device_crop(coco_root):
    """A PNG decodes losslessly: the native crop equals the device crop of
    the same frame and expanded box within one uint8 level."""
    import PIL.Image

    from probpose_pytorch_tpu_torch.data.coco import expand_bbox

    ann, img_dir = coco_root
    ds = COCOPoseDataset(ann, img_dir, (64, 48), resample="native")
    rec = ds.records[1]
    assert str(rec["image_path"]).endswith(".png")
    with PIL.Image.open(rec["image_path"]) as im:
        frame = np.asarray(im.convert("RGB"), np.float32)
    box = expand_bbox(rec["bbox"], ds.bbox_scale, 48 / 64)
    dev = crop_resize(torch.from_numpy(frame)[None], torch.from_numpy(box[None]), (64, 48),
                      "bilinear_gather").numpy()[0]
    want = np.clip(np.round(dev), 0, 255).astype(np.uint8)
    assert np.abs(ds[1]["image"].astype(int) - want.astype(int)).max() <= 1


def test_cache_ingestion_goes_through_the_plane(yolo_root, tmp_path, monkeypatch):
    """build_crop_cache ingests in get_batch chunks, which reach the native
    plane: every crop of the cache comes from one native call per chunk."""
    from probpose_pytorch_tpu_torch.data import coco as coco_mod

    calls = []
    real = coco_mod.native_crops
    monkeypatch.setattr(coco_mod, "native_crops",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    import probpose_pytorch_tpu_torch.data.yolo as yolo_mod

    monkeypatch.setattr(yolo_mod, "native_crops", coco_mod.native_crops)
    ds = YOLOPoseDataset(yolo_root, "train", (64, 48), resample="native")
    cds = CachedCropDataset(build_crop_cache(ds, tmp_path / "cache"))
    assert len(cds) == 4 and 4 in calls
    np.testing.assert_array_equal(cds[2]["image"], ds[2]["image"])
    np.testing.assert_allclose(cds[2]["keypoints"], ds[2]["keypoints"], rtol=1e-6)


def test_train_cli_with_native_resample(tmp_path):
    """The training CLI on a synthetic COCO set (JPEG frames) with
    resample="native", on the CPU: two steps and a checkpoint."""
    from probpose_pytorch_tpu_torch.data import generate_coco_synth
    from probpose_pytorch_tpu_torch.train import cli

    from test_torch_eval import CFG17

    root = generate_coco_synth(tmp_path / "coco", n_train_images=4, n_val_images=2,
                               frame_hw=(160, 200), seed=3)
    raw = dict(model=CFG17, train_batch_size=2, val_batch_size=2, log_every=1, val_every=100,
               num_workers=1, epochs=1, resample="native")
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    cli.main([str(tmp_path / "run"), "--config", str(tmp_path / "cfg.json"), "--data-root",
              str(root), "--dataset-format", "coco", "--max-steps", "2", "--device", "cpu"])
    assert (tmp_path / "run" / "checkpoints" / "2").is_file()
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert lines and all(np.isfinite(json.loads(x).get("loss", 0.0)) for x in lines)
