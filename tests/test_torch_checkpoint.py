"""The port's checkpoints (train/checkpoint.py) and what `Trainer.fit` does
with them, on the CPU at the tiny geometry of test_torch_models.py: exact
round trips, keep-N, overwrite, refusal of non-finite states, recovery,
best-metric tracking, asynchronous saves, and a resumed run that equals an
uninterrupted one bit for bit.

Batches are the synthetic dataset's numpy samples, made from a seed; every
comparison of states here is exact (zero tolerance, NaN equal to NaN).
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu_torch.train import checkpoint as ckpt_mod
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager, state_is_finite
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer, layout_metadata
from test_torch_train import RAW, STEPS_PER_EPOCH, _batch

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

AUG = dict(flip_prob=0.5, scale_jitter=0.15, shift_jitter=0.05, rotation_deg=30.0,
           brightness=0.2, contrast=0.2, flip_pairs=((1, 2), (3, 4)))


def _trainer(tmp_path, **over) -> Trainer:
    raw = {**RAW, "out_dir": str(tmp_path), "augment": AUG, **over}
    return Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")


def _tensors(trainer: Trainer) -> dict[str, torch.Tensor]:
    """Every tensor of the train state by a name: parameters, buffers,
    optimizer state, EMA and step."""
    state = trainer.state
    out = {f"param/{n}": p for n, p in zip(state.names, state.params)}
    out.update({f"buffer/{n}": b for n, b in trainer.model.named_buffers()})
    out.update({f"ema/{n}": e for n, e in zip(state.names, state.ema_params or [])})

    def walk(prefix, x):
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(f"{prefix}.{f.name}", getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}[{i}]", v)
        else:
            out[prefix] = x

    walk("opt", state.opt_state)
    out["step"] = state.step
    return out


def _assert_same(a: Trainer, b: Trainer) -> None:
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        # exact, NaN where NaN
        torch.testing.assert_close(ta[k], tb[k], rtol=0, atol=0, equal_nan=True, msg=k)
    assert a.state.host_step == b.state.host_step == int(a.state.step)


def _steps(trainer: Trainer, n: int, seed: int = 0) -> None:
    for i in range(n):
        trainer.train_step(trainer.state, trainer.device_batch(_batch(seed + i)))


def test_round_trip_is_exact(tmp_path):
    """A state mid-accumulation (accum_steps 2, one micro-step taken after
    an update) saves and restores into a fresh trainer bit for bit."""
    a = _trainer(tmp_path, optim={**RAW["optim"], "accum_steps": 2})
    _steps(a, 3)
    assert int(a.state.opt_state.mini_step) == 1  # the accumulator holds a gradient
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, a.state, metadata={"note": "x"})
    b = _trainer(tmp_path, optim={**RAW["optim"], "accum_steps": 2})
    assert not torch.equal(_tensors(a)["step"], _tensors(b)["step"])
    mgr.restore(b.state)
    _assert_same(a, b)
    assert mgr.read_metadata() == {"note": "x"} and mgr.latest_step() == 3
    # the restored trainer goes on exactly as the saved one
    _steps(a, 2, seed=10)
    _steps(b, 2, seed=10)
    _assert_same(a, b)


@pytest.mark.parametrize("family", ["lion", "adafactor"])
def test_lion_and_adafactor_states_round_trip(tmp_path, family):
    """A Lion or Adafactor state with the cosine schedule (and, for
    Adafactor, factored and unfactored leaves of a width-128 model) saves
    and restores bit for bit, and the restored trainer goes on exactly as
    the saved one."""
    over = dict(optim={**RAW["optim"], "optimizer": family, "schedule": "cosine"})
    if family == "adafactor":
        from test_torch_train import OPT_VIT  # registers the width-128 preset

        assert OPT_VIT["embed_dim"] == 128
        over["model"] = dict(RAW["model"], backbone="vit-opt-port")
    a = _trainer(tmp_path, **over)
    _steps(a, 2)
    if family == "adafactor":
        assert any(tuple(v.shape) == (1,) for v in a.state.opt_state.v)  # factored leaves
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(2, a.state)
    b = _trainer(tmp_path, **over)
    mgr.restore(b.state)
    _assert_same(a, b)
    _steps(a, 1, seed=10)
    _steps(b, 1, seed=10)
    _assert_same(a, b)


def test_keep_n_and_overwrite(tmp_path):
    t = _trainer(tmp_path)
    mgr = CheckpointManager(tmp_path / "ck", keep=2)
    for step in (1, 2, 3):
        mgr.save(step, t.state, metadata={"step": step})
    assert mgr.all_steps() == [2, 3]
    assert sorted(p.name for p in mgr.directory.iterdir()) == ["2", "3", "meta_2.json",
                                                               "meta_3.json"]
    # the same step again overwrites it
    _steps(t, 1)
    mgr.save(3, t.state, metadata={"step": "again"})
    assert mgr.read_metadata(3) == {"step": "again"} and mgr.all_steps() == [2, 3]
    fresh = _trainer(tmp_path)
    mgr.restore(fresh.state, step=3)
    _assert_same(t, fresh)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(t.state)


def test_async_save_joins_before_restore(tmp_path, monkeypatch):
    t = _trainer(tmp_path)
    _steps(t, 1)
    save = torch.save

    def slow_save(obj, path):  # the write is still in flight when restore starts
        time.sleep(0.5)
        save(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", slow_save)
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    mgr.save(1, t.state)
    expected = {k: v.clone() for k, v in _tensors(t).items()}
    _steps(t, 1)  # training goes on in place while the write runs
    assert mgr.latest_step() is None  # not committed yet
    fresh = _trainer(tmp_path)
    mgr.restore(fresh.state)  # joins the write first
    got = _tensors(fresh)
    assert all(torch.equal(got[k], v) for k, v in expected.items())
    mgr.close()
    # fit with async_checkpoint: its final save is committed when fit returns
    t = _trainer(tmp_path / "fit", async_checkpoint=True)
    t.fit(lambda: iter([_batch(0), _batch(1)]), max_steps=2)
    assert CheckpointManager(tmp_path / "fit" / "checkpoints").all_steps() == [2]


def test_sigterm_checkpoints_and_returns(tmp_path, capsys):
    """SIGTERM (handle_preemption) before step 1: that step still runs, the
    state is saved at its step, fit returns, and the handler is restored.
    Batches are made in turn (device_prefetch 1), so the signal comes
    between steps 0 and 1."""
    import os
    import signal

    t = _trainer(tmp_path, device_prefetch=1)
    before = signal.getsignal(signal.SIGTERM)

    def batches():
        yield _batch(0)
        os.kill(os.getpid(), signal.SIGTERM)
        yield _batch(1)
        yield _batch(2)

    t.fit(batches, max_steps=3)
    assert int(t.state.step) == 2
    assert CheckpointManager(tmp_path / "checkpoints").latest_step() == 2
    assert "preempted: latest checkpoint at step 2" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before


def _nan_batch(seed):
    b = _batch(seed)
    return dict(b, image=np.full_like(b["image"], 0).astype(np.float32) * np.nan)


def test_non_finite_states_are_not_saved(tmp_path, capsys):
    """Two non-finite losses before any checkpoint: logged and carried on
    (the optimizer's guard skips the updates), and the state, whose
    BatchNorm statistics went NaN, is never saved."""
    t = _trainer(tmp_path, epochs=2, checkpoint_every_epochs=1)
    batches = iter([_nan_batch(0), _nan_batch(1)])
    t.fit(lambda: iter([next(batches)]), max_steps=2)
    out = capsys.readouterr().out
    assert "non-finite loss with no checkpoint yet" in out
    assert "NOT saving" in out
    assert not state_is_finite(t.state)
    assert CheckpointManager(tmp_path / "checkpoints").latest_step() is None


def test_recovery_rewinds_and_labels_follow_the_step(tmp_path, capsys):
    """good, good, bad, bad, good, good, one step an epoch, a checkpoint
    every epoch: the second bad loss restores step 2, the loop rewinds to
    it (then counts on from 3, as the JAX loop does), and every later
    checkpoint is labelled by the state's own step."""
    t = _trainer(tmp_path, epochs=6, checkpoint_every_epochs=1, keep_checkpoints=10)
    stream = iter([_batch(0), _batch(1), _nan_batch(2), _nan_batch(3), _batch(4), _batch(5)])
    t.fit(lambda: iter([next(stream)]))
    out = capsys.readouterr().out
    assert "restored checkpoint step 2 (recovery 1/3)" in out
    assert "NOT saving a checkpoint at step 3" in out
    logged = [s for p, s, _ in t.history if p == "training"]
    assert logged == [0, 1, 2, 3, 3, 4]
    assert int(t.state.step) == t.state.host_step == 4
    mgr = CheckpointManager(tmp_path / "checkpoints")
    assert mgr.all_steps() == [1, 2, 3, 4]
    for step in mgr.all_steps():
        fresh = _trainer(tmp_path)
        mgr.restore(fresh.state, step=step)
        assert int(fresh.state.step) == step and state_is_finite(fresh.state)
    _assert_same(t, fresh)


def test_track_best_metric(tmp_path):
    t = _trainer(tmp_path, val_every=1, track_best_metric="loss", log_every=1)
    batches = [_batch(i) for i in range(3)]
    t.fit(lambda: iter(batches), val_batches=lambda: iter([_batch(9)]), max_steps=3)
    vals = [(s, m["loss"]) for p, s, m in t.history if p == "validation"]
    best_step, best = min(vals, key=lambda v: v[1])
    mgr = CheckpointManager(tmp_path / "checkpoints_best")
    # validation after step s logs step s; the state saved then is at s + 1
    assert mgr.all_steps() == [best_step + 1]
    # JAX's best checkpoint carries the layouts' metadata too (layout_metadata)
    assert mgr.read_metadata() == {**layout_metadata(t.cfg), "best_value": best,
                                   "best_metric": "loss"}
    # A resumed run reads the prior best from the metadata: nothing beats -1.
    meta = mgr.directory / f"meta_{best_step + 1}.json"
    meta.write_text(json.dumps({"best_value": -1.0, "best_metric": "loss"}))
    t.cfg = dataclasses.replace(t.cfg, resume=True)
    t.fit(lambda: iter(batches), val_batches=lambda: iter([_batch(9)]), max_steps=2)
    assert mgr.all_steps() == [best_step + 1]
    with pytest.raises(ValueError, match="not among"):
        t.cfg = dataclasses.replace(t.cfg, track_best_metric="acc/nothing")
        t.fit(lambda: iter(batches), val_batches=lambda: iter([_batch(9)]), max_steps=1)


@pytest.mark.parametrize("mode", ["crop", "frame"])
def test_resumed_run_equals_uninterrupted(tmp_path, mode):
    """4 augmented f32 steps in one run against 2 steps, the final
    checkpoint, a fresh trainer that resumes, and 2 more: bit for bit.
    The draws follow the restored step; one batch an epoch, so both runs
    see the same batch at every step."""
    if mode == "crop":
        batch = _batch(7)
        over = {}
    else:
        rng = np.random.default_rng(8)
        batch = dict(frame=rng.integers(0, 256, (4, 96, 80, 3), dtype=np.uint8),
                     box=rng.uniform([0, 0, 40, 50], [20, 20, 60, 70], (4, 4)).astype(np.float32),
                     keypoints=rng.uniform(5, 70, (4, 5, 2)).astype(np.float32),
                     keypoints_visible=np.ones((4, 5), np.float32),
                     keypoints_visibility=np.ones((4, 5), np.float32))
        over = {"augment": dict(AUG, half_body_prob=0.5, half_body_min_total=2,
                                half_body_min_half=1, upper_body_ids=(0, 1, 2))}
    over["epochs"] = 10
    whole = _trainer(tmp_path / "whole", **over)
    whole.fit(lambda: iter([batch]), max_steps=4)
    first = _trainer(tmp_path / "split", **over)
    first.fit(lambda: iter([batch]), max_steps=2)
    assert CheckpointManager(tmp_path / "split" / "checkpoints").latest_step() == 2
    second = _trainer(tmp_path / "split", **over, resume=True)
    second.fit(lambda: iter([batch]), max_steps=2)
    _assert_same(whole, second)
    assert [s for p, s, _ in second.history if p == "training"] == [2, 3]
    assert ([m["loss"] for p, _, m in whole.history if p == "training"][2:]
            == [m["loss"] for p, _, m in second.history if p == "training"])


def test_save_and_restore_bind_like_jax(tmp_path):
    """JAX's CheckpointManager.save(step, state, force=True, metadata=None)
    and restore(target_state, step=None): the same names in the same
    places; `force` either way overwrites (the port always does)."""
    import inspect

    from probpose_pytorch_tpu.train.checkpoint import CheckpointManager as JaxManager

    for name in ("save", "restore"):
        ours = inspect.signature(getattr(CheckpointManager, name)).parameters
        theirs = inspect.signature(getattr(JaxManager, name)).parameters
        assert list(ours) == list(theirs), name
        assert [p.default for p in ours.values()] == [p.default for p in theirs.values()]
    a = _trainer(tmp_path)
    _steps(a, 1)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, a.state, False, {"k": 1})
    mgr.save(1, a.state, force=True, metadata={"k": 2})
    b = _trainer(tmp_path)
    assert mgr.restore(target_state=b.state, step=1) is b.state
    _assert_same(a, b)
    assert mgr.read_metadata(1) == {"k": 2} and mgr.all_steps() == [1]
