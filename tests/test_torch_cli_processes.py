"""The port's training CLI in two processes on the CPU (a gloo world through
JAX's launcher variables, a file rendezvous) against the same CLI in one:
each rank loads its data slice of every global batch, the augmentation
draws are the global batch's, so the two runs log the same losses (rtol
1e-5: sums over other row splits) and rank 0's checkpoint holds the same
step. Imports no JAX; the processes run the port alone."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parents[1]
TINY = dict(img_size=[64, 48], num_keypoints=5, backbone="vit-nano", compute_dtype="float32",
            deconv_out_channels=[32, 32], deconv_kernel_sizes=[4, 4],
            pool_sizes=[[2, 2], [2, 2]], normalize=1.0)


def _start(out: Path, cfg: Path, world: int, tmp: Path) -> tuple:
    """The CLI started in `world` processes."""
    args = [sys.executable, "-m", "probpose_pytorch_tpu_torch.train.cli", str(out), "--config",
            str(cfg), "--dataset-format", "synthetic", "--max-steps", "2", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "RANK",
              "WORLD_SIZE"):
        env.pop(k, None)
    logs = [open(tmp / f"{out.name}{r}.log", "w+") for r in range(world)]
    procs = []
    for r in range(world):
        if world > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"file://{tmp / (out.name + '.rdv')}",
                       JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(args, env=dict(env), stdout=logs[r],
                                      stderr=subprocess.STDOUT, cwd=tmp))
    return procs, logs


def _wait(handle: tuple, deadline: float) -> list[str]:
    """Each process's output, once all have ended (killed at `deadline`)."""
    procs, logs = handle
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    texts = []
    for p, f in zip(procs, logs):
        if p.poll() is None:
            p.kill()
            p.wait()
        f.seek(0)
        texts.append(f.read())
        f.close()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-3000:]
    return texts


def test_training_cli_in_two_processes_matches_one(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(model=TINY, train_batch_size=4, val_batch_size=4,
                                   log_every=1, val_every=100, num_workers=1, epochs=1,
                                   augment=dict(flip_prob=0.5, rotation_deg=20.0))))
    deadline = time.monotonic() + 240.0
    runs = _start(tmp_path / "two", cfg, 2, tmp_path), _start(tmp_path / "one", cfg, 1, tmp_path)
    two, _ = (_wait(h, deadline) for h in runs)
    assert "[distributed] 2 processes, backend gloo" in two[0]
    assert "[training]" not in two[1]  # rank 0 alone logs

    def losses(out):
        lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
        return [r["training/loss"] for r in lines if "training/loss" in r]

    one_l, two_l = losses(tmp_path / "one"), losses(tmp_path / "two")
    assert len(one_l) == len(two_l) == 2
    np.testing.assert_allclose(two_l, one_l, rtol=1e-5)
    a = CheckpointManager(tmp_path / "one" / "checkpoints").read()
    b = CheckpointManager(tmp_path / "two" / "checkpoints").read()
    assert a["step"] == b["step"] == 2 and sorted(a["params"]) == sorted(b["params"])
    for k in a["params"]:
        assert a["params"][k].shape == b["params"][k].shape, k
        assert torch.isfinite(b["params"][k]).all(), k
