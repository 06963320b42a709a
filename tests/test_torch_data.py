"""The port's loaders (data/coco.py, yolo.py, synth_coco.py, cache.py) against
the JAX package's, and the training CLI (train/cli.py), on the CPU.

On-disk fixtures are written into tmp_path: small JPEGs and annotations as
tests/test_data_conventions.py writes them, and a small COCO-format set by
each package's `generate_coco_synth`. Loader outputs are compared exactly;
both sides read the same files through the same PIL calls.
"""

import json

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.data import cache as jax_cache
from probpose_pytorch_tpu.data import coco as jax_coco
from probpose_pytorch_tpu.data import pipeline as jax_pipeline
from probpose_pytorch_tpu.data import synth_coco as jax_synth
from probpose_pytorch_tpu.data import yolo as jax_yolo
from probpose_pytorch_tpu_torch.data import (
    CachedCropDataset,
    COCOPoseDataset,
    YOLOPoseDataset,
    batch_iterator,
    build_crop_cache,
    generate_coco_synth,
    parse_yolo_annotations,
)
from probpose_pytorch_tpu_torch.data.coco import COCO_SIGMAS, expand_bbox, parse_coco_annotations
from probpose_pytorch_tpu_torch.train import cli
from test_torch_models import TINY_CFG

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

SYNTH = dict(n_train_images=4, n_val_images=2, frame_hw=(160, 200), seed=3)


def _write_image(path, w, h):
    import PIL.Image

    arr = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
    PIL.Image.fromarray(arr).save(path)


@pytest.fixture
def raw_v():
    # one keypoint per raw flag: 0 unlabeled, 1 labeled and occluded, 2 visible
    return np.array([0, 1, 2, 2])


@pytest.fixture
def yolo_root(tmp_path, raw_v):
    for split in ("train", "valid"):
        d = tmp_path / split
        (d / "images").mkdir(parents=True)
        (d / "labels").mkdir()
        _write_image(d / "images" / "a.jpg", 160, 120)
        _write_image(d / "images" / "b.png", 96, 128)
        kps = [(0.3, 0.3), (0.5, 0.5), (0.6, 0.4), (0.4, 0.6)]
        row = "0 0.5 0.5 0.8 0.8 " + " ".join(f"{x} {y} {v}" for (x, y), v in zip(kps, raw_v))
        (d / "labels" / "a.txt").write_text(row + "\n" + row.replace("0.8 0.8", "0.4 0.6") + "\n")
        (d / "labels" / "b.txt").write_text("1 0.4 0.6 0.5 0.5 " + " ".join(
            f"{x} {y} {v}" for (x, y), v in zip(kps, raw_v[::-1])) + "\n")
    return tmp_path


@pytest.fixture(scope="module")
def synth_roots(tmp_path_factory):
    ours = generate_coco_synth(tmp_path_factory.mktemp("ours"), **SYNTH)
    ref = jax_synth.generate_coco_synth(tmp_path_factory.mktemp("ref"), **SYNTH)
    return ours, ref


def _same_samples(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_generate_coco_synth_writes_the_same_files(synth_roots):
    ours, ref = synth_roots
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file()) == files
    assert len([f for f in files if f.suffix == ".jpg"]) == 6
    for f in files:
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f  # JSON and JPEG bytes


def test_coco_dataset_matches_jax(synth_roots):
    root, _ = synth_roots
    ann = root / "annotations/person_keypoints_train2017.json"
    ours = COCOPoseDataset(ann, root / "train2017", (64, 48))
    ref = jax_coco.COCOPoseDataset(ann, root / "train2017", (64, 48))
    assert len(ours) == len(ref) > 4
    assert sorted(ours.ignores_by_image) == sorted(ref.ignores_by_image)
    for i in range(len(ref)):
        _same_samples(ours[i], ref[i])
    for a, b in zip(batch_iterator(ours, 3, shuffle=True, seed=1),
                    jax_pipeline.batch_iterator(ref, 3, shuffle=True, seed=1)):
        _same_samples(a, b)
    recs, ignores = parse_coco_annotations(ann, root / "train2017", include_ignore=True)
    rrecs, rignores = jax_coco.parse_coco_annotations(ann, root / "train2017",
                                                      include_ignore=True)
    assert len(ignores) == len(rignores) and [r["ann_id"] for r in recs] == [
        r["ann_id"] for r in rrecs]
    np.testing.assert_array_equal(COCO_SIGMAS, jax_coco.COCO_SIGMAS)
    box = np.asarray([3.0, 4.0, 50.0, 20.0], np.float32)
    np.testing.assert_array_equal(expand_bbox(box), jax_coco.expand_bbox(box))


def test_coco_keeps_occlusion(tmp_path, raw_v):
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    _write_image(img_dir / "000000.jpg", 160, 120)
    kps = np.array([[40, 40], [80, 60], [100, 50], [60, 70]], np.float32)
    flat = np.concatenate([kps, raw_v[:, None]], 1).reshape(-1).tolist()
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(dict(
        images=[dict(id=0, file_name="000000.jpg", width=160, height=120)],
        annotations=[dict(id=1, image_id=0, category_id=1, keypoints=flat,
                          num_keypoints=int((raw_v > 0).sum()), bbox=[30.0, 30.0, 90.0, 60.0],
                          area=5400.0, iscrowd=0)])))
    for resample in ("bilinear", "lanczos"):
        s = COCOPoseDataset(ann_file, img_dir, (64, 48), resample=resample)[0]
        _same_samples(s, jax_coco.COCOPoseDataset(ann_file, img_dir, (64, 48),
                                                  resample=resample)[0])
        # visible = labeled (v >= 1); visibility = unoccluded (v == 2)
        np.testing.assert_array_equal(s["keypoints_visible"], raw_v >= 1)
        np.testing.assert_array_equal(s["keypoints_visibility"], raw_v == 2)


def test_yolo_dataset_matches_jax_and_promotes_v1(yolo_root):
    recs = parse_yolo_annotations(yolo_root / "train")
    rrecs = jax_yolo.parse_yolo_annotations(yolo_root / "train")
    assert len(recs) == len(rrecs) == 3
    for a, b in zip(recs, rrecs):
        _same_samples({k: np.asarray(v) for k, v in a.items()},
                      {k: np.asarray(v) for k, v in b.items()})
    np.testing.assert_array_equal(recs[0]["keypoints"][:, 2], [0, 2, 2, 2])
    assert len(parse_yolo_annotations(yolo_root / "train", target_single_class=1)) == 1
    for resample in ("lanczos", "bilinear"):
        ours = YOLOPoseDataset(yolo_root, "train", (64, 48), resample=resample)
        ref = jax_yolo.YOLOPoseDataset(yolo_root, "train", (64, 48), resample=resample)
        for i in range(len(ref)):
            _same_samples(ours[i], ref[i])
        _same_samples(ours.get_batch([2, 0]), ref.get_batch([2, 0]))
    s = YOLOPoseDataset(yolo_root, "train", (64, 48))[0]
    # post-promotion: visible == labeled == visibility
    np.testing.assert_array_equal(s["keypoints_visible"], [0, 1, 1, 1])
    np.testing.assert_array_equal(s["keypoints_visibility"], [0, 1, 1, 1])


def test_native_resample_raises(yolo_root, synth_roots, monkeypatch):
    """resample="native" reads through the C++ data plane; where the plane
    is unavailable the loaders raise JAX's RuntimeError, never a PIL path."""
    from probpose_pytorch_tpu_torch import native

    monkeypatch.setattr(native, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="requires the C\\+\\+ data plane"):
        YOLOPoseDataset(yolo_root, "train", (64, 48), resample="native").get_batch([0])
    root, _ = synth_roots
    with pytest.raises(RuntimeError, match="requires the C\\+\\+ data plane"):
        COCOPoseDataset(root / "annotations/person_keypoints_val2017.json", root / "val2017",
                        (64, 48), resample="native")[0]


def test_crop_cache_round_trips(tmp_path, synth_roots):
    root, _ = synth_roots
    ds = COCOPoseDataset(root / "annotations/person_keypoints_val2017.json", root / "val2017",
                         (64, 48))
    cache_dir = build_crop_cache(ds, tmp_path / "cache", num_workers=2)
    cached = CachedCropDataset(cache_dir)
    ref = jax_cache.CachedCropDataset(cache_dir)  # the JAX reader takes the port's files
    keys = ("image", "keypoints", "keypoints_visible", "keypoints_visibility")
    assert len(cached) == len(ds) == len(ref)
    for i in range(len(ds)):
        _same_samples(cached[i], {k: ds[i][k] for k in keys})
        _same_samples(cached[i], ref[i])
    _same_samples(cached.get_batch([1, 0]), ref.get_batch([1, 0]))
    # built once: a second build returns the directory as it is
    before = (cache_dir / "crops.u8").stat().st_mtime_ns
    assert build_crop_cache(ds, tmp_path / "cache") == cache_dir
    assert (cache_dir / "crops.u8").stat().st_mtime_ns == before


def _cli_config(tmp_path, **over):
    raw = dict(model=dict(TINY_CFG, num_keypoints=17), train_batch_size=2, val_batch_size=2, log_every=1,
               val_every=100, num_workers=2, epochs=3,
               augment=dict(flip_prob=0.5, rotation_deg=20.0), **over)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    return path


def test_cli_trains_checkpoints_and_resumes(tmp_path, synth_roots, capsys):
    root, _ = synth_roots
    cfg = _cli_config(tmp_path, cache_dir=str(tmp_path / "cache"))
    out = tmp_path / "run"
    args = [str(out), "--config", str(cfg), "--data-root", str(root), "--dataset-format",
            "coco", "--max-steps", "2", "--device", "cpu"]
    cli.main(args)
    saved = json.loads((out / "config.json").read_text())
    assert saved["out_dir"] == str(out) and saved["dataset_format"] == "coco"
    assert saved["data_root"] == str(root)
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines if "training/loss" in r] == [0, 1]
    assert any("validation/acc/kpt" in r for r in lines)
    assert (out / "checkpoints" / "2").is_file()
    assert (tmp_path / "cache" / "train" / "meta.json").is_file()
    cli.main(args)
    assert "resumed from step 2" in capsys.readouterr().out
    assert (out / "checkpoints" / "4").is_file()
    cli.main(args + ["--no-resume"])  # starts over and overwrites step 2
    assert "resumed" not in capsys.readouterr().out


def test_cli_trains_on_mixed_datasets(tmp_path, synth_roots, capsys):
    """dataset_format "mixed" through the CLI (--device cpu): the COCO-format
    set (repeat 1) and its coco2yolo copy (repeat 2), 2 steps, validation
    on the first member's val split; the datasets are JAX's CLI's."""
    from probpose_pytorch_tpu.data.mixed import build_mixed_datasets as jax_build_mixed
    from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
    from probpose_pytorch_tpu_torch.data.convert_format import coco_to_yolo
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    root, _ = synth_roots
    for split, src in (("train", "train2017"), ("valid", "val2017")):
        coco_to_yolo(root / f"annotations/person_keypoints_{src}.json", root / src,
                     tmp_path / "yolo", split)
    members = [{"root": str(root), "format": "coco"},
               {"root": str(tmp_path / "yolo"), "format": "yolo", "repeat": 2}]
    cfg = _cli_config(tmp_path, dataset_format="mixed", mixed_datasets=members)
    out = tmp_path / "run"
    cli.main([str(out), "--config", str(cfg), "--max-steps", "2", "--device", "cpu"])
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines if "training/loss" in r] == [0, 1]
    assert any("validation/acc/kpt" in r for r in lines)
    assert (out / "checkpoints" / "2").is_file()
    saved = TrainConfig.load(out / "config.json")
    train, val = cli.build_datasets(saved)
    jtrain, jval = jax_build_mixed(JaxTrainConfig.load(out / "config.json"))
    assert len(train) == len(jtrain) > 0 and len(val) == len(jval) > 0
    for i in (0, len(train) - 1):
        for k, v in train[i].items():  # the fields both formats have
            np.testing.assert_array_equal(v, jtrain[i][k])


@pytest.mark.parametrize("what", ["processes", "no card"])
def test_cli_refusals(tmp_path, what, monkeypatch):
    cfg = _cli_config(tmp_path, dataset_format="synthetic")
    args = [str(tmp_path / "run"), "--config", str(cfg), "--max-steps", "1"]
    if what == "processes":
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            cli.main(args + ["--device", "cpu"])
    else:  # the card is the default, and there is none here: no CPU fallback
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(args)


def test_prefetcher_order_errors_and_close():
    from probpose_pytorch_tpu_torch.data import Prefetcher

    assert list(Prefetcher(iter(range(10)), depth=2)) == list(range(10))

    def failing():
        yield from range(3)
        raise ValueError("bad sample")

    got = []
    with pytest.raises(ValueError, match="bad sample"):
        for item in Prefetcher(failing(), depth=2):
            got.append(item)
    assert got == [0, 1, 2]

    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    pre = Prefetcher(endless(), depth=2)
    it = iter(pre)
    assert [next(it), next(it)] == [0, 1]
    pre.close(timeout=10)
    assert not pre._thread.is_alive() and closed == [True]
