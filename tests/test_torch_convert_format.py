"""The port's YOLO <-> COCO converter (data/convert_format.py) and mixed
datasets (data/mixed.py) against the JAX package's, on the CPU.

The converter is a copy: on the same input files both packages must write
the same bytes, through the functions and through the CLIs. The mixed
datasets are held to JAX's sample for sample. Fixtures are small images
and label files written into tmp_path from a seed.
"""

import json

import numpy as np
import PIL.Image
import pytest

from probpose_pytorch_tpu.data import convert_format as jax_convert
from probpose_pytorch_tpu.data import mixed as jax_mixed
from probpose_pytorch_tpu.data.pipeline import SyntheticPoseDataset as JaxSynthetic
from probpose_pytorch_tpu_torch.data import (
    COCOPoseDataset,
    SyntheticPoseDataset,
    YOLOPoseDataset,
    generate_coco_synth,
)
from probpose_pytorch_tpu_torch.data import convert_format, mixed

SYNTH = dict(n_train_images=4, n_val_images=2, frame_hw=(160, 200), seed=3)


def write_yolo_split(root, split, n_images=3, K=20, seed=0, flags=(0, 1, 2), exact=False):
    """A YOLO-pose split of `n_images` noise images with one or two people
    of K keypoints each, visibility flags drawn from `flags`. With `exact`,
    every box is a square of even side and every coordinate a whole pixel
    of a frame whose width and height divide 10^6 / 2, so the 6-decimal
    normalised labels and COCO's 2-decimal pixels hold the same values."""
    rng = np.random.default_rng(seed)
    d = root / split
    (d / "images").mkdir(parents=True)
    (d / "labels").mkdir()
    for i in range(n_images):
        if exact:
            w, h = ((200, 160), (250, 200), (160, 250))[i % 3]
        else:
            w, h = int(rng.integers(120, 200)), int(rng.integers(100, 180))
        PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            d / "images" / f"{i:03d}.png")
        rows = []
        for _ in range(int(rng.integers(1, 3))):
            if exact:
                side = 2 * int(rng.integers(20, 60))
                x0, y0 = int(rng.integers(0, w - side)), int(rng.integers(0, h - side))
                xc, yc, bw, bh = (x0 + side / 2) / w, (y0 + side / 2) / h, side / w, side / h
                kps = rng.integers(0, (w, h), (K, 2)) / np.array([w, h])
            else:
                xc, yc = rng.uniform(0.3, 0.7, 2)
                bw, bh = rng.uniform(0.2, 0.5, 2)
                kps = rng.uniform(0.05, 0.95, (K, 2))
            v = rng.choice(flags, K)
            row = ["0"] + [f"{c:.6f}" for c in (xc, yc, bw, bh)]
            for (x, y), f in zip(kps, v):
                row += [f"{x:.6f}", f"{y:.6f}", str(int(f))]
            rows.append(" ".join(row))
        (d / "labels" / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("K,class_id", [(20, None), (17, None), (17, 0)])
def test_yolo_to_coco_writes_jax_bytes(tmp_path, K, class_id):
    root = write_yolo_split(tmp_path / "yolo", "valid", K=K)
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    coco = convert_format.yolo_to_coco(root, "valid", ours, target_single_class=class_id)
    jax_convert.yolo_to_coco(root, "valid", ref, target_single_class=class_id)
    assert ours.read_bytes() == ref.read_bytes()
    names = coco["categories"][0]["keypoints"]
    assert len(names) == K and (names[0] == "nose") == (K == 17)


@pytest.mark.parametrize("link", [True, False])
def test_coco_to_yolo_writes_jax_bytes(tmp_path, link):
    root = generate_coco_synth(tmp_path / "coco", **SYNTH)
    args = (root / "annotations/person_keypoints_val2017.json", root / "val2017")
    counts = convert_format.coco_to_yolo(*args, tmp_path / "ours", "valid", link=link)
    ref = jax_convert.coco_to_yolo(*args, tmp_path / "ref", "valid", link=link)
    assert counts == ref and counts["images"] > 0
    for sub in ("labels", "images"):
        ours = sorted((tmp_path / "ours" / "valid" / sub).iterdir())
        theirs = sorted((tmp_path / "ref" / "valid" / sub).iterdir())
        assert [p.name for p in ours] == [p.name for p in theirs]
        for a, b in zip(ours, theirs):
            assert a.is_symlink() == b.is_symlink() == (link and sub == "images")
            assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("cmd", ["yolo2coco", "coco2yolo"])
def test_converter_cli_matches_jax(tmp_path, cmd, capsys):
    """`python -m probpose_pytorch_tpu_torch.data.convert_format` with each
    subcommand: the JAX CLI's files and printed line."""
    if cmd == "yolo2coco":
        root = write_yolo_split(tmp_path / "yolo", "valid")
        argv = lambda out: ["yolo2coco", "--root", str(root), "--split", "valid",
                            "--out", str(out / "ann.json")]
    else:
        root = generate_coco_synth(tmp_path / "coco", **SYNTH)
        argv = lambda out: ["coco2yolo", "--annotations",
                            str(root / "annotations/person_keypoints_val2017.json"),
                            "--images", str(root / "val2017"), "--out", str(out),
                            "--split", "valid", "--copy"]
    convert_format.main(argv(tmp_path / "ours"))
    printed = capsys.readouterr().out
    jax_convert.main(argv(tmp_path / "ref"))
    assert printed.replace(str(tmp_path / "ours"), "@") == capsys.readouterr().out.replace(
        str(tmp_path / "ref"), "@")
    ours = sorted(p for p in (tmp_path / "ours").rglob("*") if p.is_file())
    theirs = sorted(p for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert [p.relative_to(tmp_path / "ours") for p in ours] == [
        p.relative_to(tmp_path / "ref") for p in theirs] and ours
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a


def test_converted_set_loads_as_the_yolo_set(tmp_path):
    """yolo2coco on a 20-keypoint split with flags 0 and 2 (the YOLO
    loader promotes 1 to 2; COCO keeps 1 as occluded, so the two
    conventions meet only without it), whole-pixel square boxes, then
    COCOPoseDataset on the result with the YOLO loader's crop (the box as
    it is, Lanczos): YOLOPoseDataset's samples (crops, keypoints and both
    flags), bit for bit."""
    root = write_yolo_split(tmp_path / "yolo", "valid", n_images=4, flags=(0, 2), seed=5,
                            exact=True)
    ann = tmp_path / "ann.json"
    convert_format.yolo_to_coco(root, "valid", ann)
    # the YOLO loader crops the label's box as it is, with Lanczos
    coco = COCOPoseDataset(ann, root / "valid" / "images", (96, 96), bbox_scale=1.0,
                           resample="lanczos")
    yolo = YOLOPoseDataset(str(root), "valid", (96, 96))
    assert len(coco) == len(yolo) > 4
    for i in range(len(yolo)):
        a, b = coco[i], yolo[i]
        assert set(b) <= set(a)  # COCO's samples also carry the record's ids and box
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"sample {i}: {k}")


# --------------------------------------------------------------------------
# mixed datasets


@pytest.mark.parametrize("repeats", [None, [1, 3]])
def test_mixed_dataset_matches_jax(repeats):
    a, b = SyntheticPoseDataset(3, (64, 48), 5, seed=1), SyntheticPoseDataset(2, (64, 48), 5, seed=2)
    ja, jb = JaxSynthetic(3, (64, 48), 5, seed=1), JaxSynthetic(2, (64, 48), 5, seed=2)
    ours = mixed.MixedPoseDataset([a, b], repeats)
    ref = jax_mixed.MixedPoseDataset([ja, jb], repeats)
    assert len(ours) == len(ref) == (5 if repeats is None else 9)
    for i in range(len(ref)):
        for k, v in ref[i].items():
            np.testing.assert_array_equal(ours[i][k], v)


@pytest.mark.parametrize("bad,match", [
    (dict(datasets=[]), "no datasets"),
    (dict(repeats=[1]), "repeats"),
    (dict(repeats=[1, 0]), "repeats must be >= 1"),
    (dict(keypoints=7), "keypoint counts differ"),
])
def test_mixed_dataset_refuses_like_jax(bad, match):
    def build(pkg, Synthetic):
        ds = [Synthetic(2, (64, 48), 5, seed=1),
              Synthetic(2, (64, 48), bad.get("keypoints", 5), seed=2)]
        return pkg.MixedPoseDataset(bad.get("datasets", ds), bad.get("repeats"))

    with pytest.raises(ValueError, match=match) as ours:
        build(mixed, SyntheticPoseDataset)
    with pytest.raises(ValueError) as ref:
        build(jax_mixed, JaxSynthetic)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("second", ["yolo", "coco"])
def test_build_mixed_datasets_matches_jax(tmp_path, second):
    """A COCO-format member (repeat 1) and its coco2yolo copy (or a second
    COCO-format set) at repeat 2: the train mix and the first member's val
    split, sample for sample. Mixed with YOLO, a sample keeps the fields
    both formats have (JAX's keeps COCO's extras, which its collate cannot
    stack beside YOLO samples); with COCO alone, all of JAX's fields."""
    from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
    from probpose_pytorch_tpu_torch.train.config import TrainConfig

    root = generate_coco_synth(tmp_path / "coco", **SYNTH)
    if second == "yolo":
        for split, src in (("train", "train2017"), ("valid", "val2017")):
            convert_format.coco_to_yolo(root / f"annotations/person_keypoints_{src}.json",
                                        root / src, tmp_path / "yolo", split)
        member = {"root": str(tmp_path / "yolo"), "format": "yolo", "repeat": 2}
    else:
        member = {"root": str(generate_coco_synth(tmp_path / "b", **dict(SYNTH, seed=4))),
                  "format": "coco", "repeat": 2}
    raw = dict(model=dict(img_size=(64, 48)), dataset_format="mixed",
               mixed_datasets=[{"root": str(root), "format": "coco"}, member])
    train, val = mixed.build_mixed_datasets(TrainConfig.from_dict(raw))
    jtrain, jval = jax_mixed.build_mixed_datasets(JaxTrainConfig.from_dict(raw))
    assert train.repeats == [1, 2] and len(train) == len(jtrain)
    contract = {"image", "keypoints", "keypoints_visible", "keypoints_visibility"}
    for ours, ref in ((train, jtrain), (val, jval)):
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            got = ours[i]
            assert set(got) == (contract if ours is train and second == "yolo" else set(ref[i]))
            for k, v in got.items():
                np.testing.assert_array_equal(v, ref[i][k], err_msg=f"{i}: {k}")
    with pytest.raises(ValueError, match="expected 'coco' or 'yolo'"):
        mixed.build_mixed_datasets(TrainConfig.from_dict(dict(raw, mixed_datasets=[
            {"root": str(root), "format": "voc"}])))
    assert json.loads(json.dumps(raw))["mixed_datasets"][1]["repeat"] == 2
