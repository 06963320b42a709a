"""configs/reference_parity_fieldsynth.json, the reference's own recipe, on
the CPU: 384 x 384 crops, vit-s-timm (12 heads of 32 at N = 576), 20
keypoints, YOLO labels, augmentation and EMA off, no non-finite guard, a
fixed sigma of 2 with decode_sigma -1.

Its trunk is cut to depth 1 and its batch to 2 crops to keep the CPU run
small; every other value is the file's. The recipe trains through the
training CLI on a YOLO set the test writes and resumes; then one float32
step of the same configuration is held to JAX's make_train_step.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_train_state
from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.train import cli
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer
from test_torch_convert_format import write_yolo_split
from test_torch_train import REPO, STEPS_PER_EPOCH, _by_name, _check_grads, _jax_grads
from test_torch_train import build_jax_side

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

CONFIG = REPO / "configs" / "reference_parity_fieldsynth.json"
B = 2


@pytest.fixture
def depth1(monkeypatch):
    for presets in (ViTConfig.PRESETS, JaxViTConfig.PRESETS):
        monkeypatch.setitem(presets, "vit-s-timm", dict(presets["vit-s-timm"], depth=1))


def _recipe(**over) -> dict:
    raw = json.loads(CONFIG.read_text())
    raw.update(train_batch_size=B, val_batch_size=B, num_workers=1, **over)
    return raw


def test_recipe_values_survive_the_cli(tmp_path, depth1, capsys):
    """The recipe through `python -m probpose_pytorch_tpu_torch.train.cli`
    (--device cpu) on a 20-keypoint YOLO set: 2 steps, then a resume to 4.
    The saved config keeps augment null, ema_decay null,
    max_nonfinite_skips 0, sigma 2 and decode_sigma -1; the loader
    promotes v = 1 to 2; the logged losses are finite; validation reads
    the `valid` split."""
    root = tmp_path / "field"
    write_yolo_split(root, "train", n_images=3, K=20, seed=1)
    write_yolo_split(root, "valid", n_images=2, K=20, seed=2)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_recipe(val_every=2)))
    out = tmp_path / "run"
    args = [str(out), "--config", str(cfg), "--data-root", str(root), "--max-steps", "2",
            "--device", "cpu"]
    cli.main(args)
    saved = json.loads((out / "config.json").read_text())
    assert saved["augment"] is None and saved["optim"]["ema_decay"] is None
    assert saved["optim"]["max_nonfinite_skips"] == 0
    assert saved["sigma"] == 2.0 and saved["decode_sigma"] == -1.0
    assert saved["model"]["num_keypoints"] == 20 and saved["dataset_format"] == "yolo"
    cli.main(args)
    assert "resumed from step 2" in capsys.readouterr().out
    assert (out / "checkpoints" / "4").is_file()
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    train = [x for x in lines if "training/loss" in x]
    assert [x["step"] for x in train] == [0]  # log_every 10
    assert all(np.isfinite(v) for x in train for v in x.values())
    val = [x for x in lines if "validation/loss" in x]
    assert [x["step"] for x in val] == [0, 2] and all(np.isfinite(x["validation/loss"])
                                                      for x in val)
    train_ds, val_ds = cli.build_datasets(TrainConfig.load(out / "config.json"))
    assert val_ds.split == "valid" and len(val_ds) > 0
    flags = np.concatenate([r["keypoints"][:, 2] for r in train_ds.records])
    assert set(np.unique(flags)) <= {0.0, 2.0}  # v = 1 promoted


def test_recipe_step_matches_jax(depth1):
    """One float32 step of the recipe (depth 1, B = 2, 384 x 384, 20
    keypoints) against JAX's make_train_step from the same weights: each
    loss term within 1e-5 relative, gradients per leaf within 1e-4 of the
    leaf's largest (test_torch_train.py's bar) but the scalar branches'
    convs (bounds below), grad_norm 1e-4 relative."""
    raw = _recipe(model=dict(json.loads(CONFIG.read_text())["model"],
                             compute_dtype="float32"))
    js = build_jax_side(raw)
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(js["state"]))
    ds = SyntheticPoseDataset(B, (384, 384), 20, seed=4)
    batch = next(iter(batch_iterator(ds, B, num_workers=1)))
    captured = []
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rlosses, rgrads, _ = _jax_grads(js, jbatch)
    _, jm = js["step"](js["state"], jbatch)
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
    for k, v in rlosses.items():
        np.testing.assert_allclose(float(metrics[f"loss/{k}"]), float(v), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = _by_name(rgrads, js["state"].batch_stats, trainer.state.names)
    gmax = max(float(np.abs(g).max()) for g in ref.values())
    branch = re.compile(r"head\.branches\.\w+\.convs\.\d+\.(bias|weight)")
    own = {n: g.numpy() for n, g in zip(trainer.state.names, captured[0])}
    for n in [n for n in own if branch.fullmatch(n)]:
        if n.endswith("bias"):
            # A conv bias feeding a train-mode BatchNorm has an exact
            # gradient of 0 (the batch mean takes it out): both sides hold
            # rounding noise, held to 1e-5 of the largest gradient anywhere.
            np.testing.assert_allclose(own.pop(n), ref[n], rtol=0, atol=1e-5 * gmax, err_msg=n)
        else:
            # The scalar branches' 4 x 4 max-pools over the 24 x 24 grid:
            # where two window values lie closer than the trunk's 1e-5
            # forward differences the winner can swap (0.2 % of a first
            # conv's weights move); on the same features the branches agree
            # to 3e-6. Held normwise within 2e-3 relative.
            g = own.pop(n)
            if not ref[n].any():  # the visibility branch: loss weight 0
                assert not g.any(), n
                continue
            d = np.linalg.norm(g - ref[n]) / np.linalg.norm(ref[n])
            assert d <= 2e-3, (n, d)
    _check_grads(list(own), [torch.from_numpy(g) for g in own.values()],
                 {n: ref[n] for n in own})
    assert dataclasses.asdict(trainer.cfg)["augment"] is None
