"""Checkpoint averaging in the port against the JAX package, on the CPU:
`average_trees` on the same numpy state dicts (uniform, weighted, bf16 and
int leaves), its refusals, and the `train.average` CLI over checkpoints of
the port's training written at known steps.
"""

import json

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.train.average import average_trees as jax_average_trees
from probpose_pytorch_tpu_torch.inference import load_predictor
from probpose_pytorch_tpu_torch.train.average import average_trees, main
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer
from test_torch_train import RAW, STEPS_PER_EPOCH, _batch

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests


def _trees(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(3, 5)).astype(np.float32),
             "s": np.float32(rng.normal()),
             "count": np.asarray(rng.integers(0, 10), np.int64)} for _ in range(n)]


@pytest.mark.parametrize("n,weights", [(2, None), (3, None), (3, [0.2, 0.3, 0.5]),
                                       (4, [0.1, 0.2, 0.3, 0.4])])
def test_average_trees_matches_jax(n, weights):
    """The same numpy state dicts give JAX's average bit for bit: float64
    accumulation in the same order, cast back to each entry's dtype."""
    trees = _trees(n, n)
    ref = jax_average_trees(trees, weights)
    ours = average_trees([{k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
                          for t in trees], weights)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert ours[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_average_trees_keeps_bf16():
    """101 bf16 entries of 1.0 and one of 2.0 average, in float64, to the
    bf16 value nearest the true mean, as JAX's does."""
    trees = [{"x": torch.full((4,), 1.0, dtype=torch.bfloat16)} for _ in range(100)]
    trees.append({"x": torch.full((4,), 2.0, dtype=torch.bfloat16)})
    out = average_trees(trees)["x"]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.full((4,), (100 + 2.0) / 101).to(torch.bfloat16))


def test_average_trees_refusals():
    with pytest.raises(ValueError, match="no trees"):
        average_trees([])
    one = {"x": torch.ones(2)}
    with pytest.raises(ValueError, match="weights"):
        average_trees([one, one], weights=[1.0])
    with pytest.raises(ValueError, match="sum"):
        average_trees([one, one], weights=[0.9, 0.9])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port run with checkpoints at steps 1, 2 and 3 (EMA on) and its
    config.json; returns (run dir, {step: state payload})."""
    root = tmp_path_factory.mktemp("avg") / "run"
    cfg = TrainConfig.from_dict(dict(RAW, out_dir=str(root)))
    trainer = Trainer.create(cfg, STEPS_PER_EPOCH, device="cpu")
    mgr = CheckpointManager(root / "checkpoints", keep=5)
    for i in range(3):
        trainer.train_step(trainer.state, trainer.device_batch(_batch(10 + i)))
        mgr.save(trainer.state.host_step, trainer.state)
    cfg.save(root / "config.json")
    return root, {s: mgr.read(s) for s in (1, 2, 3)}


@pytest.mark.parametrize("flags,steps,weights", [
    (["--last", "2"], (2, 3), None),
    (["--steps", "1,3", "--weights", "0.25,0.75"], (1, 3), [0.25, 0.75]),
    ([], (1, 2, 3), None),
])
def test_average_cli(tmp_path, run, flags, steps, weights):
    """`train.average --device cpu`: the written checkpoint holds the
    average of the chosen checkpoints' params, EMA and BN statistics, at
    the last step, with a fresh optimizer state, and the predictor and
    the training config load it."""
    root, payloads = run
    out = tmp_path / "avg"
    main(["--checkpoint", str(root / "checkpoints"), "--out", str(out), "--device", "cpu"]
         + flags)
    got = CheckpointManager(out / "checkpoints").read()
    assert got["step"] == max(steps)
    assert int(got["opt_state"]["count"]) == 0
    chosen = [payloads[s] for s in steps]
    for key in ("params", "buffers", "ema"):
        want = average_trees([p[key] for p in chosen], weights)
        for k, v in want.items():
            assert torch.equal(got[key][k], v), (key, k)
    assert json.loads((out / "config.json").read_text())["resume"] is False
    pred = load_predictor(out / "checkpoints", device="cpu")
    assert torch.equal(pred.model.head.final.weight, got["params"]["head.final.weight"])


def test_average_cli_refusals(tmp_path, run):
    root, _ = run
    base = ["--checkpoint", str(root / "checkpoints"), "--out", str(tmp_path / "x"),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="need >= 2"):
        main(base + ["--last", "1"])
    with pytest.raises(ValueError, match=r"steps \[7\] not in"):
        main(base + ["--steps", "3,7"])
    with pytest.raises(FileNotFoundError):
        main(["--checkpoint", str(tmp_path / "empty"), "--out", str(tmp_path / "y"),
              "--device", "cpu"])
