"""Distillation in the port against the JAX package, on the CPU at the tiny
geometry of test_torch_models.py: two float32 steps with a teacher of
another width against JAX's make_train_step with the same teacher, the
teacher loaded from a port checkpoint and kept outside the train state,
the geometry checks, and `distill` in TrainConfig's JSON. Every tolerance
is stated beside its assertion.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu.train import loop as jax_loop
from probpose_pytorch_tpu.train import state as jax_state
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables, state_dict_from_jax
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.config import DistillConfig, TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer, load_teacher, make_train_step
from test_torch_lora import _close_params
from test_torch_models import TINY_CFG, peaked_variables
from test_torch_train import RAW, STEPS_PER_EPOCH, _batch, _port, build_jax_side

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

TEACHER = dict(embed_dim=48, depth=1, num_heads=2, mlp_ratio=2.0)
JaxViTConfig.PRESETS.setdefault("vit-tiny-teacher", TEACHER)
ViTConfig.PRESETS.setdefault("vit-tiny-teacher", TEACHER)
TEACHER_CFG = dict(TINY_CFG, backbone="vit-tiny-teacher")
DISTILL = dict(teacher_checkpoint="", ema_teacher=True, weight=0.5, heatmap_weight=1.0,
               scalar_weight=0.1)


@pytest.fixture(scope="module")
def teachers():
    """(JAX teacher model, its numpy variables, the port teacher with the
    same weights in eval mode)."""
    jm = jax_model.build_model(jax_model.ModelConfig(**TEACHER_CFG))
    x = jnp.zeros((1, 64, 48, 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(7), x, train=False), 5)
    pm = build_model(ModelConfig(**TEACHER_CFG), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm.eval().requires_grad_(False)


def test_distill_step_matches_jax(teachers):
    """Two f32 steps: loss/distill_heatmap, loss/distill_scalar, the total
    and grad_norm within 1e-5 relative; params within 1e-5 where the
    gradient is above 1e-4 of its leaf's largest (else Adam's 2 lr)."""
    jm, tvars, teacher = teachers
    raw = dict(RAW, distill=DISTILL)
    js = build_jax_side(raw)
    jstep = jax.jit(jax_loop.make_train_step(
        js["model"], js["enc"], js["loss_fn"], js["tx"], js["cfg"],
        teacher=(jm, jax.tree_util.tree_map(jnp.asarray, tvars))))
    trainer = _port(js, raw)
    assert trainer.teacher is None  # no checkpoint named: the step is given the teacher
    step = make_train_step(trainer.model, trainer.encode_codec, trainer.loss_fn, trainer.tx,
                           trainer.cfg, teacher)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = js["state"]
    lrs = []
    rgrads = _jax_grads(js, jm, tvars, jbatch)
    for i in range(2):
        lrs.append(float(jax_state.onecycle_schedule(js["cfg"].optim, STEPS_PER_EPOCH)(i)))
        jstate, jmetrics = jstep(jstate, jbatch)
        _, metrics = step(trainer.state, trainer.device_batch(batch))
        assert {"loss/distill_heatmap", "loss/distill_scalar"} <= set(metrics)
        for k in ("loss/distill_heatmap", "loss/distill_scalar", "loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5,
                                       err_msg=f"step {i}: {k}")
    assert not teacher.training and all(not p.requires_grad for p in teacher.parameters())
    names = trainer.state.names
    grads_ref = {n: v for n, v in state_dict_from_jax(rgrads, jstate.batch_stats).items()
                 if n in names}
    _close_params(trainer, jstate.params, jstate.batch_stats, grads_ref, lrs)


def _jax_grads(js, tmodel, tvars, batch):
    """The gradients of the JAX step's loss with distillation at its
    initial state, written out as JAX's compute_loss computes them."""
    cfg, state = js["cfg"], js["state"]
    d = cfg.distill
    key = jax.random.PRNGKey(cfg.seed)
    images, gt = jax_loop._augment_encode(cfg, js["enc"], key, key, state.step, batch)
    tpred = tmodel.apply(tvars, images, train=False)
    mse = lambda a, b: jnp.mean((a.astype(jnp.float32) - b.astype(jnp.float32)) ** 2)

    def compute_loss(params):
        pred, _ = js["model"].apply({"params": params, "batch_stats": state.batch_stats},
                                    images, train=True, mutable=["batch_stats"])
        losses = js["loss_fn"](gt, pred)
        total = sum(losses[k] * w for k, w in cfg.loss_weights.as_dict().items())
        d_sc = (mse(pred[1], tpred[1]) + mse(pred[2], tpred[2]) + mse(pred[3], tpred[3])) / 3.0
        return total + d.weight * (d.heatmap_weight * mse(pred[0], tpred[0])
                                   + d.scalar_weight * d_sc)

    return jax.jit(jax.grad(compute_loss))(state.params)


def _save_teacher_run(root, cfg_kw=TEACHER_CFG, ema=True):
    """A port run directory with a teacher checkpoint (params unlike its
    EMA) and its config.json; returns (run dir, the trainer saved)."""
    raw = dict(RAW, model=cfg_kw, optim=dict(RAW["optim"], ema_decay=0.99 if ema else None),
               out_dir=str(root))
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    trainer.train_step(trainer.state, trainer.device_batch(_batch(8)))
    root.mkdir(parents=True, exist_ok=True)
    trainer.cfg.save(root / "config.json")
    CheckpointManager(root / "checkpoints").save(trainer.state.host_step, trainer.state)
    return root, trainer


@pytest.mark.parametrize("ema_teacher", [True, False])
def test_teacher_loads_from_a_port_checkpoint(tmp_path, ema_teacher):
    """Trainer.create builds the teacher of `teacher_config` (default
    beside the checkpoint) with the checkpoint's EMA (or params) and BN
    statistics, in eval mode with no gradients, outside the student's
    state; fit's model.train() leaves it in eval mode and its tensors as
    they were, and metrics.jsonl logs both distillation terms."""
    run, saved = _save_teacher_run(tmp_path / "teacher")
    raw = dict(RAW, distill=dict(DISTILL, teacher_checkpoint=str(run / "checkpoints"),
                                 ema_teacher=ema_teacher), out_dir=str(tmp_path / "student"))
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    teacher = trainer.teacher
    assert teacher is not None and not teacher.training
    assert all(not p.requires_grad for p in teacher.parameters())
    want = saved.state.ema_params if ema_teacher else saved.state.params
    tparams = dict(teacher.named_parameters())
    for n, w in zip(saved.state.names, want):
        assert torch.equal(tparams[n], w), n
    for n, b in saved.model.named_buffers():
        assert torch.equal(dict(teacher.named_buffers())[n], b), n
    student = {id(p) for p in trainer.state.params}
    assert not any(id(p) in student for p in teacher.parameters())
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    trainer.fit(lambda: iter([_batch(3), _batch(4)]), max_steps=2)
    assert not teacher.training
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    lines = [json.loads(x) for x in (tmp_path / "student" / "metrics.jsonl").read_text()
             .splitlines()]
    assert all(np.isfinite(x["training/loss/distill_heatmap"])
               and np.isfinite(x["training/loss/distill_scalar"]) for x in lines)
    payload = CheckpointManager(tmp_path / "student" / "checkpoints").read()
    assert sorted(payload["params"]) == sorted(trainer.state.names)  # no teacher tensors


def test_teacher_config_path_is_explicit_or_beside_the_checkpoint(tmp_path):
    run, _ = _save_teacher_run(tmp_path / "teacher")
    moved = tmp_path / "elsewhere.json"
    (run / "config.json").rename(moved)
    cfg = TrainConfig.from_dict(dict(RAW, distill=dict(
        DISTILL, teacher_checkpoint=str(run / "checkpoints"))))
    with pytest.raises(FileNotFoundError):
        load_teacher(cfg, "cpu")
    cfg = dataclasses.replace(cfg, distill=dataclasses.replace(cfg.distill,
                                                               teacher_config=str(moved)))
    assert load_teacher(cfg, "cpu").backbone.embed_dim == TEACHER["embed_dim"]


@pytest.mark.parametrize("over", [
    dict(img_size=(32, 48)),
    dict(num_keypoints=4),
    dict(head_type="simcc"),
], ids=["img_size", "keypoints", "head_type"])
def test_teacher_mismatch_raises_like_jax(tmp_path, over):
    """A teacher whose crop size, keypoint count or head family differs
    from the student's: the port raises JAX's ValueError, word for word,
    before any checkpoint is read."""
    raw = dict(RAW, model=dict(TEACHER_CFG, **over))
    teacher_cfg = tmp_path / "teacher.json"
    TrainConfig.from_dict(raw).save(teacher_cfg)
    distill = dict(DISTILL, teacher_checkpoint=str(tmp_path / "missing"),
                   teacher_config=str(teacher_cfg))
    with pytest.raises(ValueError) as ref:
        jax_loop._load_teacher(JaxTrainConfig.from_dict(dict(RAW, distill=distill)))
    with pytest.raises(ValueError) as ours:
        Trainer.create(TrainConfig.from_dict(dict(RAW, distill=distill)), STEPS_PER_EPOCH,
                       device="cpu")
    assert str(ours.value) == str(ref.value)


def test_distill_config_round_trips_like_jax(tmp_path):
    """TrainConfig with `distill` through JSON and back, and the JAX
    config of the same JSON, field for field."""
    cfg = TrainConfig.from_dict(dict(RAW, distill=dict(DISTILL, teacher_checkpoint="t/c")))
    assert cfg.distill == DistillConfig(**dict(DISTILL, teacher_checkpoint="t/c"))
    assert TrainConfig.from_json(cfg.to_json()) == cfg
    cfg.save(tmp_path / "c.json")
    ref = JaxTrainConfig.load(tmp_path / "c.json")
    assert dataclasses.asdict(ref.distill) == dataclasses.asdict(cfg.distill)
    assert TrainConfig.from_json(TrainConfig.from_dict(RAW).to_json()).distill is None
