"""The port's training step against the JAX package, on the CPU at the tiny
geometry of test_torch_models.py: configs, schedule, optimizer, the head
and trunk in train mode, the carry of a JAX train state, and the whole step.

Both sides start from the same weights (the JAX init with peaked head
kernels, carried by compat/from_jax.py) and see the same numpy batch from
the synthetic dataset, which is the same in both packages. Everything runs
in float32 unless a test says otherwise; each tolerance is stated beside
its assertion.
"""

import dataclasses
import pathlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from probpose_pytorch_tpu.data import pipeline as jax_pipeline
from probpose_pytorch_tpu.losses import ProbPoseLoss as JaxLoss
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu.train import loop as jax_loop
from probpose_pytorch_tpu.train import state as jax_state
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch.compat.from_jax import (
    load_jax_train_state,
    load_jax_variables,
    state_dict_from_jax,
)
from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.train import loop
from probpose_pytorch_tpu_torch.train.config import OptimConfig, TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer
from probpose_pytorch_tpu_torch.train.state import (
    cosine_schedule,
    factored_dims,
    make_optimizer,
    onecycle_schedule,
    param_layouts,
)
from test_torch_models import TINY_CFG, peaked_variables

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 4
STEPS_PER_EPOCH = 20
RAW = dict(
    model=dict(TINY_CFG),
    optim=dict(peak_lr=1e-3, weight_decay=0.1, pct_start=0.1, clip_grad_norm=1.0,
               ema_decay=0.999, max_nonfinite_skips=5),
    augment=None,
    epochs=1,
    train_batch_size=B,
    val_batch_size=B,
    log_every=1,
    val_every=2,
    freeze_error=True,
    freeze_oks=False,
    resume=False,
)


def _n(t):
    return t.detach().cpu().numpy()


def _batch(seed=0, n=B):
    ds = SyntheticPoseDataset(n, TINY_CFG["img_size"], TINY_CFG["num_keypoints"], seed=seed)
    return next(iter(batch_iterator(ds, n, num_workers=1)))


@pytest.fixture(scope="module")
def jax_side():
    return build_jax_side(RAW)


def build_jax_side(raw):
    """The JAX model, optimizer, codecs, loss, jitted steps and initial
    state of the config `raw` (the tiny geometry)."""
    cfg = JaxTrainConfig.from_dict(raw)
    model = jax_model.build_model(cfg.model)
    x = jnp.zeros((1, *cfg.model.img_size, 3), jnp.float32)
    variables = peaked_variables(model.init(jax.random.PRNGKey(0), x, train=False))
    tx = jax_state.make_optimizer(cfg.optim, STEPS_PER_EPOCH * cfg.epochs)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=jax.tree_util.tree_map(jnp.copy, params))
    enc, fast = jax_loop.build_codecs(cfg)
    loss_fn = JaxLoss(fast, freeze_error=cfg.freeze_error, freeze_oks=cfg.freeze_oks)
    step = jax.jit(jax_loop.make_train_step(model, enc, loss_fn, tx, cfg))
    eval_step = jax.jit(jax_loop.make_eval_step(model, enc, loss_fn, cfg))
    return dict(cfg=cfg, model=model, variables=variables, tx=tx, state=state, enc=enc,
                fast=fast, loss_fn=loss_fn, step=step, eval_step=eval_step)


def _port(js, raw=RAW) -> Trainer:
    """A port Trainer of the config `raw` carrying the JAX side's initial
    state."""
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(js["state"]))
    return trainer


def _by_name(tree, batch_stats, names):
    """A JAX param-shaped tree as {port name: array}, in the port's layout."""
    sd = state_dict_from_jax(tree, batch_stats)
    return {n: sd[n] for n in names}


def _jax_grads(js, batch):
    """(losses, grads, pred) of the JAX step's compute_loss at its state."""
    cfg, state = js["cfg"], js["state"]
    key = jax.random.PRNGKey(cfg.seed)
    images, gt = jax_loop._augment_encode(cfg, js["enc"], key, key, state.step, batch)

    def compute_loss(params):
        pred, _ = js["model"].apply({"params": params, "batch_stats": state.batch_stats},
                                    images, train=True, mutable=["batch_stats"])
        losses = js["loss_fn"](gt, pred)
        total = sum(losses[k] * w for k, w in cfg.loss_weights.as_dict().items())
        return total, (losses, pred)

    (_, (losses, pred)), grads = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))(
        state.params)
    return losses, grads, pred


# --------------------------------------------------------------------------
# configs and data


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_config_loads_like_jax(path):
    ours = dataclasses.asdict(TrainConfig.load(path))
    ref = dataclasses.asdict(JaxTrainConfig.load(path))
    assert ours == ref


def test_synthetic_data_matches_jax():
    ds = SyntheticPoseDataset(6, (32, 24), 5, seed=3)
    jds = jax_pipeline.SyntheticPoseDataset(6, (32, 24), 5, seed=3)
    for ours, ref in zip(batch_iterator(ds, 4, shuffle=True, seed=1, drop_last=False),
                         jax_pipeline.batch_iterator(jds, 4, shuffle=True, seed=1,
                                                     drop_last=False)):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("over", [pytest.param(dict(pipeline_parallel=2), id="over0-item 13")])
def test_unported_training_options_raise(over):
    """The training option that raised citing ROADMAP item 13b builds as
    JAX's does: pipeline_parallel=2 with no mesh is one device's run, the
    trunk per-block (pp_stages stays 1: the pipe axis of a mesh stages it,
    tests/test_torch_pipeline.py), and the parameters' names and shapes are
    those of the run without the option."""
    cfg = TrainConfig.from_dict({**RAW, **over})
    theirs = jax_loop.Trainer.create(JaxTrainConfig.from_dict({**RAW, **over}), STEPS_PER_EPOCH)
    ours = Trainer.create(cfg, STEPS_PER_EPOCH, device="cpu")
    plain = Trainer.create(TrainConfig.from_dict(RAW), STEPS_PER_EPOCH, device="cpu")
    assert ours.cfg.model.pp_stages == theirs.cfg.model.pp_stages == 1
    assert ours.mesh is None and theirs.mesh is None
    assert [(n, p.shape) for n, p in ours.model.named_parameters()] == \
        [(n, p.shape) for n, p in plain.model.named_parameters()]


def test_train_lora_only_needs_a_rank():
    """train_lora_only without model.lora_rank > 0 raises JAX's ValueError."""
    with pytest.raises(ValueError, match="train_lora_only requires model.lora_rank > 0"):
        Trainer.create(TrainConfig.from_dict({**RAW, "train_lora_only": True}),
                       STEPS_PER_EPOCH, device="cpu")


@pytest.mark.parametrize("name", ["flagship_coco_vits", "vitb_coco", "vitl_coco",
                                  "lora_finetune_vits", "radio_frozen_vitb",
                                  "reference_parity_fieldsynth", "distill_vits_from_vitl",
                                  "simcc_coco_vits"])
def test_shipped_configs_create(name, monkeypatch, tmp_path):
    """The shipped recipes build a Trainer as they are, at full width
    (augmentation as the file sets it; vitl_coco with accum_steps 4; LoRA
    and the frozen RADIO trunk with their optimizer masks); the trunk's
    preset is cut to depth 1 to keep the CPU build small. The distillation
    recipe runs where its relative `./runs/vitl` paths find a depth-1
    ViT-L teacher checkpoint of vitl_coco.json."""
    import json

    from probpose_pytorch_tpu_torch.models.vit import ViTConfig
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.loop import frozen_labels
    from probpose_pytorch_tpu_torch.train.state import MultiSteps

    path = REPO / "configs" / f"{name}.json"
    cfg = TrainConfig.load(path)
    if json.loads(path.read_text()).get("augment") is not None:
        assert cfg.augment is not None and cfg.augment.enabled
    else:
        assert cfg.augment is None
    for preset in ViTConfig.PRESETS:
        monkeypatch.setitem(ViTConfig.PRESETS, preset, dict(ViTConfig.PRESETS[preset], depth=1))
    if cfg.distill is not None:
        monkeypatch.chdir(tmp_path)
        tcfg = TrainConfig.load(REPO / "configs" / "vitl_coco.json")
        teacher = Trainer.create(tcfg, STEPS_PER_EPOCH, device="cpu")
        Path("runs/vitl").mkdir(parents=True)
        tcfg.save("runs/vitl/config.json")
        CheckpointManager("runs/vitl/checkpoints").save(0, teacher.state)
    trainer = Trainer.create(cfg, STEPS_PER_EPOCH, device="cpu")
    assert len(trainer.model.backbone.blocks) == 1
    assert isinstance(trainer.tx, MultiSteps) == (cfg.optim.accum_steps > 1)
    names = trainer.state.names
    labels = frozen_labels(cfg, names)
    assert (labels is not None) == (cfg.train_lora_only or cfg.model.frozen_backbone)
    opt = trainer.state.opt_state.inner if cfg.optim.accum_steps > 1 else trainer.state.opt_state
    assert len(opt.mu) == (len(names) if labels is None else labels.count("trainable"))
    assert (trainer.teacher is not None) == (cfg.distill is not None)
    if trainer.teacher is not None:
        assert trainer.teacher.backbone.embed_dim == 1024 and not trainer.teacher.training


# --------------------------------------------------------------------------
# schedule and optimizer


@pytest.mark.parametrize("kw,total", [
    (dict(), 50),
    (dict(pct_start=0.3, div_factor=10.0, final_div_factor=100.0), 37),
    (dict(pct_start=0.25), 3),  # below the min_total floor
])
def test_onecycle_schedule_matches_optax(kw, total):
    cfg = OptimConfig(**kw)
    ours = onecycle_schedule(cfg, total)
    # jitted, as the JAX train step runs it: XLA fuses its float32 ops
    # (eager op-by-op execution rounds differently, up to 6e-6 apart).
    ref = jax.jit(jax_state.onecycle_schedule(cfg, total))
    for count in range(max(total, 10) + 5):
        o = float(ours(torch.tensor(count, dtype=torch.int32)))
        r = float(ref(jnp.int32(count)))
        # 1e-7 relative at every step, phase boundaries included
        assert abs(o - r) <= 1e-7 * abs(r), (count, o, r)


def _opt_params(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("skips,bad_steps", [
    (5, (1,)),       # the flagship guard: step 1 is skipped
    (0, ()),         # no guard
    (1, (0, 1)),     # two in a row: the second goes through
])
def test_optimizer_matches_optax(skips, bad_steps):
    cfg = OptimConfig(peak_lr=1e-2, weight_decay=0.1, clip_grad_norm=1.0,
                      max_nonfinite_skips=skips)
    rng = np.random.default_rng(skips)
    params = _opt_params(rng)
    tx = jax_state.make_optimizer(cfg, 10)
    jstate = tx.init(params)
    jparams = params
    ours_tx = make_optimizer(cfg, 10)
    names = sorted(params)
    tparams = [torch.from_numpy(params[k].copy()) for k in names]
    tstate = ours_tx.init(tparams)
    for i in range(3):
        grads = {k: (rng.normal(size=v.shape) * 3).astype(np.float32) for k, v in params.items()}
        if i in bad_steps:
            grads["b"][2] = np.nan
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = ours_tx.update([torch.from_numpy(grads[k]) for k in names], tstate,
                                      tparams)
        with torch.no_grad():
            torch._foreach_add_(tparams, tupd)
        for k, t in zip(names, tparams):
            # f32 update arithmetic in optax's order
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    adam = [s for s in jax.tree_util.tree_leaves(jstate, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")][0]
    assert int(tstate.count) == int(adam.count)
    for k, mu, nu in zip(names, tstate.mu, tstate.nu):
        np.testing.assert_allclose(mu.numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-7)
    if skips:
        assert int(tstate.notfinite_count) == int(jstate.notfinite_count)
        assert int(tstate.total_notfinite) == int(jstate.total_notfinite)
        assert bool(tstate.last_finite) == bool(jstate.last_finite)


@pytest.mark.parametrize("k,skips", [(2, 5), (4, 5), (2, 0)])
def test_accum_steps_match_optax_multisteps(k, skips):
    """accum_steps = k over 8 micro-steps, micro-step 3's gradients
    non-finite, against optax.MultiSteps(apply_if_finite(chain)) (or the
    bare chain without the guard): the averaged gradients, the inner AdamW
    on every k-th micro-step with its own counts, and the NaN that stays in
    the accumulator as in optax."""
    cfg = OptimConfig(peak_lr=1e-2, weight_decay=0.1, clip_grad_norm=1.0,
                      max_nonfinite_skips=skips, accum_steps=k)
    rng = np.random.default_rng(10 + k)
    params = _opt_params(rng)
    tx = jax_state.make_optimizer(cfg, 10)
    jstate, jparams = tx.init(params), params
    ours_tx = make_optimizer(cfg, 10)
    names = sorted(params)
    tparams = [torch.from_numpy(params[key].copy()) for key in names]
    tstate = ours_tx.init(tparams)
    for i in range(8):
        grads = {key: (rng.normal(size=v.shape) * 3).astype(np.float32)
                 for key, v in params.items()}
        if i == 3:
            grads["a"][1, 2] = np.inf
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = ours_tx.update([torch.from_numpy(grads[key]) for key in names], tstate,
                                      tparams)
        with torch.no_grad():
            torch._foreach_add_(tparams, tupd)
        for key, t in zip(names, tparams):
            # f32 update arithmetic in optax's order, as test_optimizer_matches_optax
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[key]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"micro-step {i}")
        assert int(tstate.mini_step) == int(jstate.mini_step)
        assert int(tstate.gradient_step) == int(jstate.gradient_step)
        for key, acc in zip(names, tstate.acc):
            np.testing.assert_allclose(acc.numpy(), np.asarray(jstate.acc_grads[key]),
                                       rtol=1e-6, atol=1e-7)
    assert int(tstate.gradient_step) == 8 // k
    inner = tstate.inner
    if skips:
        finite = jstate.inner_opt_state  # apply_if_finite(chain(clip, chain(adam, wd, lr)))
        adam = finite.inner_state[1][0]
        assert int(inner.count) == int(adam.count) and int(inner.count) < 8 // k  # one skipped
        assert int(inner.notfinite_count) == int(finite.notfinite_count) > 0
        assert int(inner.total_notfinite) == int(finite.total_notfinite)
    else:
        adam = jstate.inner_opt_state[1][0]  # chain(clip, chain(adam, wd, lr))
        assert int(inner.count) == int(adam.count) == 8 // k
        assert not all(np.isfinite(t.numpy()).all() for t in tparams)  # no guard: NaN lands
    for key, mu, nu in zip(names, inner.mu, inner.nu):
        np.testing.assert_allclose(mu.numpy(), np.asarray(adam.mu[key]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[key]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw,total", [
    (dict(), 50),
    (dict(pct_start=0.3, div_factor=10.0, final_div_factor=100.0), 37),
    (dict(pct_start=0.1), 3),  # warm-up floored at 1 step; decay_steps = total
    (dict(pct_start=0.5), 1),  # decay_steps floored at warm-up + 1
])
def test_cosine_schedule_matches_optax(kw, total):
    """optax.warmup_cosine_decay_schedule as the JAX package builds it,
    jitted, at every step to past the end: 1e-6 relative (float32 cos and
    products that XLA may fuse)."""
    cfg = OptimConfig(schedule="cosine", **kw)
    ours = cosine_schedule(cfg, total)
    ref = jax.jit(jax_state.build_schedule(cfg, total))
    for count in range(total + 6):
        o = float(ours(torch.tensor(count, dtype=torch.int32)))
        r = float(ref(jnp.int32(count)))
        assert abs(o - r) <= 1e-6 * abs(r), (count, o, r)


# The JAX layout of each leaf of the optimizer tree, and the port's: a
# factored Dense kernel, a square one, a conv and a deconv (factored over
# their channel axes), a plain factored tensor (pos_embed's shape), and
# unfactored ones (a bias, a plain matrix whose smaller axis is < 128).
OPT_TREE = {"bias": ((130,), "plain"), "conv": ((3, 3, 144, 136), "conv"),
            "deconv": ((4, 4, 130, 128), "deconv"), "dense": ((160, 130), "dense"),
            "pos": ((1, 140, 129), "plain"), "small": ((5, 200), "plain"),
            "square": ((128, 128), "dense")}


def _to_port(a, kind):
    """A JAX-layout array in the port's layout (compat/from_jax.py's maps)."""
    if kind == "dense":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "deconv":
        return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return a


def _optimizer_pair(cfg, labels=None):
    """(optax transformation, port optimizer, names, JAX params, port
    params) over OPT_TREE, with `labels` {name: label} masking both."""
    rng = np.random.default_rng(cfg.accum_steps + len(cfg.optimizer))
    params = {k: rng.normal(size=shape).astype(np.float32) * 0.1
              for k, (shape, _) in OPT_TREE.items()}
    names = sorted(params)
    tx = jax_state.make_optimizer(cfg, 10, labels)
    ours = make_optimizer(cfg, 10, None if labels is None else [labels[k] for k in names],
                          [OPT_TREE[k][1] for k in names])
    tparams = [torch.from_numpy(np.ascontiguousarray(_to_port(params[k], OPT_TREE[k][1])))
               for k in names]
    return tx, ours, names, params, tparams


def test_factored_dims_follow_the_jax_layout():
    """optax factors each leaf over the two largest axes of its JAX shape;
    the port finds the same physical axes in its own layout (for the
    square Dense kernel the transposed pair)."""
    from optax._src.factorized import _factored_dims

    for name, (shape, kind) in OPT_TREE.items():
        ref = _factored_dims(shape, True, 128)
        port_shape = _to_port(np.zeros(shape), kind).shape
        ours = factored_dims(port_shape, kind)
        assert (ours is None) == (ref is None), name
        if ref is not None:
            axes = {"dense": (1, 0), "conv": (3, 2, 0, 1), "deconv": (2, 3, 0, 1)}.get(
                kind, tuple(range(len(shape))))
            assert (axes[ours[0]], axes[ours[1]]) == ref, name
    assert factored_dims((128, 128), "dense") == (1, 0)  # JAX's (0, 1), transposed


@pytest.mark.parametrize("family", ["lion", "adafactor"])
@pytest.mark.parametrize("case", ["wd, guard", "masks, MultiSteps", "no wd"])
def test_optimizer_family_matches_optax(family, case):
    """optax.lion and optax.adafactor (with cosine) as the JAX package
    builds them, over 5 steps on OPT_TREE's leaves in each package's
    layout: with weight decay and apply_if_finite (step 2's gradient
    non-finite, skipped), with frozen masks under MultiSteps(2) (10
    micro-steps), and with no weight decay (adafactor drops the term).
    Params within 1e-5 relative and 1e-7 absolute (factored means and the
    block rms summed in another order, pow in float32), frozen leaves
    bit-equal, and the families' moments (in the port's layout) and counts
    as optax's."""
    over = {"wd, guard": dict(weight_decay=0.1, max_nonfinite_skips=5),
            "masks, MultiSteps": dict(weight_decay=0.1, accum_steps=2),
            "no wd": dict(weight_decay=0.0)}[case]
    cfg = OptimConfig(optimizer=family, schedule="cosine", peak_lr=1e-2, clip_grad_norm=1.0,
                      b2=0.99 if family == "lion" else 0.999, **over)
    labels = None
    if case == "masks, MultiSteps":
        labels = {k: "frozen" if k in ("bias", "square") else "trainable" for k in OPT_TREE}
    tx, ours, names, params, tparams = _optimizer_pair(cfg, labels)
    jstate, jparams = tx.init(params), params
    tstate = ours.init(tparams)
    rng = np.random.default_rng(7)
    for i in range(5 * cfg.accum_steps):
        grads = {k: (rng.normal(size=v.shape) * 0.02).astype(np.float32)
                 for k, v in params.items()}
        if i == 2 and cfg.max_nonfinite_skips:
            grads["conv"][0, 0, 1, 2] = np.nan
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = ours.update([torch.from_numpy(np.ascontiguousarray(
            _to_port(grads[k], OPT_TREE[k][1]))) for k in names], tstate, tparams)
        with torch.no_grad():
            torch._foreach_add_(tparams, tupd)
        for k, t in zip(names, tparams):
            np.testing.assert_allclose(t.numpy(), _to_port(np.asarray(jparams[k]), OPT_TREE[k][1]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"micro-step {i}, {k}")
    for k, t in zip(names, tparams):
        if labels is not None and labels[k] == "frozen":
            np.testing.assert_array_equal(t.numpy(), _to_port(params[k], OPT_TREE[k][1]))
    inner = tstate.inner if cfg.accum_steps > 1 else tstate
    fields = {"lion": ("count", "mu"), "adafactor": ("count", "v_row", "v_col", "v")}[family]
    fam = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: getattr(s, "_fields", None) == fields)
        if getattr(s, "_fields", None) == fields]
    assert len(fam) == 1
    assert int(inner.count) == int(fam[0].count) == 5 - (cfg.max_nonfinite_skips > 0)
    trainable = [k for k in names if labels is None or labels[k] == "trainable"]
    if family == "lion":
        for k, mu in zip(trainable, inner.mu):
            np.testing.assert_allclose(mu.numpy(), _to_port(np.asarray(fam[0].mu[k]),
                                                            OPT_TREE[k][1]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    else:
        for k, v in zip(trainable, inner.v):
            if factored_dims(tparams[names.index(k)].shape, OPT_TREE[k][1]) is None:
                np.testing.assert_allclose(v.numpy(), _to_port(np.asarray(fam[0].v[k]),
                                                               OPT_TREE[k][1]),
                                           rtol=1e-5, atol=0, err_msg=k)
            else:
                assert tuple(v.shape) == (1,) and not v.any()


# Width 128 everywhere, so that adafactor factors the trunk's Dense kernels,
# the first deconv and the scalar branches' 3x3 convs.
OPT_VIT = dict(embed_dim=128, depth=1, num_heads=2, mlp_ratio=2.0)
JaxViTConfig.PRESETS.setdefault("vit-opt-port", OPT_VIT)
ViTConfig.PRESETS.setdefault("vit-opt-port", OPT_VIT)


@pytest.mark.parametrize("family", ["lion", "adafactor"])
def test_load_jax_train_state_carries_lion_and_adafactor(family):
    """Two JAX steps with lion (or adafactor) and cosine on a width-128
    model, carried into a port Trainer (adafactor's factored v_row and
    v_col onto the port's layout of the axes it factors, for Dense, conv
    and deconv leaves), then one more step on each side: the loss within
    1e-5 relative and the params within 1e-5 where the gradient (lion:
    the momentum-mixed gradient it takes the sign of) is above 1e-4 of its
    leaf's largest and the leaf's gradient is not all rounding noise;
    elsewhere within 2 lr (a sign that flips on rounding noise moves an
    element by 2 lr; adafactor normalises noise to steps below that)."""
    model = dict(TINY_CFG, backbone="vit-opt-port", deconv_out_channels=(128, 16))
    raw = dict(RAW, model=model, optim=dict(RAW["optim"], optimizer=family, schedule="cosine"))
    js = build_jax_side(raw)
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    jstate, _ = js["step"](js["state"], batch)
    jstate, _ = js["step"](jstate, batch)
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(jstate))
    opt = trainer.state.opt_state
    assert int(opt.count) == int(opt.schedule_count) == 2
    if family == "adafactor":
        kinds = {kind for p, kind in zip(trainer.state.params, param_layouts(trainer.model))
                 if factored_dims(p.shape, kind) is not None}
        assert kinds == {"dense", "conv", "deconv"}
        assert all(tuple(v.shape) == (1,) for v, p, kind in zip(
            opt.v, trainer.state.params, param_layouts(trainer.model))
            if factored_dims(p.shape, kind) is not None)
    mu = None if family == "adafactor" else [_n(m) for m in opt.mu]
    jstate2, jm = js["step"](jstate, batch)
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(_batch(1)))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    _, rgrads, _ = _jax_grads(dict(js, state=jstate), batch)
    names = trainer.state.names
    grads_ref = _by_name(rgrads, jstate.batch_stats, names)
    noise, _ = _noise_leaves(grads_ref)
    if mu is not None:  # lion steps by the sign of (1 - b1) g + b1 m, g clipped
        g_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads_ref.values()))
        clip = min(1.0, trainer.cfg.optim.clip_grad_norm / g_norm)
        b1 = trainer.cfg.optim.b1
        grads_ref = {n: (1 - b1) * grads_ref[n] * clip + b1 * m for n, m in zip(names, mu)}
    lr = float(jax.jit(jax_state.build_schedule(js["cfg"].optim, STEPS_PER_EPOCH))(2))
    ref = _by_name(jstate2.params, jstate2.batch_stats, names)
    for n, p in zip(names, trainer.state.params):
        d = np.abs(_n(p) - ref[n])
        g = np.abs(grads_ref[n])
        small = (g < 1e-4 * g.max()) | (n in noise)
        assert (d[~small] <= 1e-5 * np.abs(ref[n][~small]) + 1e-7).all(), (n, d[~small].max())
        assert (d[small] <= 2 * lr * (1 + 1e-5)).all(), (n, d[small].max())


# --------------------------------------------------------------------------
# the model in train mode


def _pair(js, dtype="float32"):
    """(JAX model, numpy variables, port model) sharing the JAX side's
    initial weights, at the given compute dtype."""
    kw = dict(TINY_CFG, compute_dtype=dtype)
    pm = build_model(ModelConfig(**kw), device="cpu")
    v = js["variables"]
    load_jax_variables(pm, v["params"], v["batch_stats"])
    return jax_model.build_model(jax_model.ModelConfig(**kw)), v, pm


def test_head_train_mode_matches_jax(jax_side):
    """Batch statistics normalise, the running ones move 0.9 / 0.1 with the
    biased variance, as flax's BatchNorm(use_running_average=False)."""
    jm, variables, pm = _pair(jax_side)
    feats = np.random.default_rng(3).normal(size=(3, 4, 3, 32)).astype(np.float32)
    ref, updates = jm.head.apply(
        {"params": variables["params"]["head"], "batch_stats": variables["batch_stats"]["head"]},
        jnp.asarray(feats), train=True, mutable=["batch_stats"])
    pm.train()
    out = pm.head(torch.from_numpy(feats))
    for o, r in zip(out, ref):
        # f32 batch statistics summed in another order
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-4, atol=1e-5)
    new = state_dict_from_jax(variables["params"], {"head": updates["batch_stats"]})
    sd = pm.state_dict()
    keys = [k for k in new if k.startswith("head.") and k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(_n(sd[k]), new[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_grads_reach_float32_masters(jax_side, dtype):
    """Gradients flow through the per-call casts into the float32 trunk
    parameters, as through flax's f32 param_dtype, and match JAX's."""
    jm, variables, pm = _pair(jax_side, dtype)
    x = np.random.default_rng(4).random((2, 64, 48, 3), dtype=np.float32)
    w = np.random.default_rng(5).normal(size=(2, 4, 3, 32)).astype(np.float32)
    pm.train()
    loss = (pm.backbone(torch.from_numpy(x)).float() * torch.from_numpy(w)).sum()
    names = [n for n, _ in pm.named_parameters() if n.startswith("backbone.")]
    grads = torch.autograd.grad(loss, [dict(pm.named_parameters())[n] for n in names])
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.backbone.apply({"params": p}, jnp.asarray(x))
                                            .astype(jnp.float32) * w)))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]["backbone"]))
    ref = _by_name({"backbone": jg, "head": variables["params"]["head"]},
                   variables["batch_stats"], names)
    # f32: sums in another order; bf16: the compute dtype's rounding at
    # other places in the two frameworks (2^-8 relative) through 2 blocks.
    tol = 1e-4 if dtype == "float32" else 3e-2
    for n, g in zip(names, grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n
        scale = float(np.abs(ref[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(_n(g), ref[n], rtol=0, atol=tol * scale, err_msg=n)


# --------------------------------------------------------------------------
# the whole train step


def _noise_leaves(grads_ref):
    """Leaves whose whole JAX gradient is rounding noise, below 1e-6 of the
    largest gradient anywhere: head.final.bias, whose exact gradient is 0
    because sparsemax is shift invariant along each heatmap."""
    gmax = max(float(np.abs(g).max()) for g in grads_ref.values())
    return {n for n, g in grads_ref.items() if np.abs(g).max() < 1e-6 * gmax}, gmax


def _check_grads(names, grads, grads_ref):
    """Per leaf within 1e-4 of its largest JAX entry; noise leaves within
    1e-6 of the largest gradient anywhere, as their JAX counterparts are."""
    noise, gmax = _noise_leaves(grads_ref)
    for n, g in zip(names, grads):
        tol = 1e-6 * gmax if n in noise else 1e-4 * float(np.abs(grads_ref[n]).max())
        np.testing.assert_allclose(_n(g), grads_ref[n], rtol=0, atol=tol, err_msg=n)


def _close_params(trainer, jparams, jbs, grads_ref, lrs):
    """Params within 1e-6, except elements whose JAX gradient is below the
    grad tolerance (1e-4 of the leaf's max, or in a noise leaf): Adam's
    first steps move those by up to lr whatever their size, so they may
    differ by up to 2 lr per step. Returns the count of such elements."""
    ref = _by_name(jparams, jbs, trainer.state.names)
    noise, _ = _noise_leaves(grads_ref)
    loose = 0
    for n, p in zip(trainer.state.names, trainer.state.params):
        d = np.abs(_n(p) - ref[n])
        g = np.abs(grads_ref[n])
        small = (g < 1e-4 * g.max()) | (n in noise)
        assert (d[~small] <= 1e-6).all(), (n, d[~small].max())
        assert (d[small] <= 2 * sum(lrs)).all(), (n, d[small].max())
        loose += int((small & (d > 1e-6)).sum())
    return loose


def test_train_step_matches_jax(jax_side):
    js = jax_side
    trainer = _port(js)
    batch = _batch()
    preds, captured = [], []
    trainer.model.register_forward_hook(lambda m, i, o: preds.append(o))
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]

    rlosses, rgrads, rpred = _jax_grads(js, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate = js["state"]
    schedule = jax_state.onecycle_schedule(js["cfg"].optim, STEPS_PER_EPOCH)
    lrs = []
    for i in range(2):
        lrs.append(float(schedule(i)))
        jstate, jm = js["step"](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
        if i == 0:
            # Both sides decode the same coordinates from their heatmaps (the
            # in-step OKS targets), to 1e-3 input-space px.
            dt, _ = trainer.fast_codec.decode_heatmap(preds[0][0].detach())
            rdt, _ = js["fast"].decode_heatmap(rpred[0])
            np.testing.assert_allclose(_n(dt), np.asarray(rdt), rtol=0, atol=1e-3)
            for k, v in rlosses.items():
                # each loss term within 1e-5 relative
                np.testing.assert_allclose(float(metrics[f"loss/{k}"]), float(v), rtol=1e-5,
                                           atol=1e-8, err_msg=k)
            _check_grads(trainer.state.names, captured[0],
                         _by_name(rgrads, jstate.batch_stats, trainer.state.names))
        # pre-clip global norm and the total, 1e-4 and 1e-5 relative
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)

    grads_ref = _by_name(rgrads, jstate.batch_stats, trainer.state.names)
    loose = _close_params(trainer, jstate.params, jstate.batch_stats, grads_ref, lrs)
    print(f"elements under the grad tolerance that moved by more than 1e-6: {loose}")
    sd = trainer.model.state_dict()
    ref_bs = state_dict_from_jax(jstate.params, jstate.batch_stats)
    for k, v in ref_bs.items():
        if k.endswith(("running_mean", "running_var")):
            # batch statistics after 2 steps within 1e-5
            np.testing.assert_allclose(_n(sd[k]), v, rtol=1e-5, atol=1e-5, err_msg=k)
    ema = _by_name(jstate.ema_params, jstate.batch_stats, trainer.state.names)
    for n, e in zip(trainer.state.names, trainer.state.ema_params):
        np.testing.assert_allclose(_n(e), ema[n], rtol=0, atol=1e-6, err_msg=n)
    assert int(trainer.state.step) == int(jstate.step) == 2


def test_load_jax_train_state_continues_a_jax_run(jax_side):
    """One JAX step, then the carry, then one step on each side."""
    js = jax_side
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    jstate, _ = js["step"](js["state"], batch)
    trainer = Trainer.create(TrainConfig.from_dict(RAW), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(jstate))
    assert int(trainer.state.step) == 1 and int(trainer.state.opt_state.count) == 1
    jstate2, jm = js["step"](jstate, batch)
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(_batch(1)))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    _, rgrads, _ = _jax_grads(dict(js, state=jstate), batch)
    grads_ref = _by_name(rgrads, jstate.batch_stats, trainer.state.names)
    lr = float(jax_state.onecycle_schedule(js["cfg"].optim, STEPS_PER_EPOCH)(1))
    _close_params(trainer, jstate2.params, jstate2.batch_stats, grads_ref, [lr])
    adam = jstate2.opt_state.inner_state[1][0]
    # first moments, (1 - b1) g + b1 mu: the gradients' bound
    _check_grads(trainer.state.names, trainer.state.opt_state.mu,
                 _by_name(adam.mu, jstate2.batch_stats, trainer.state.names))
    assert int(trainer.state.opt_state.schedule_count) == int(jstate2.opt_state.inner_state[1][2].count)


def test_eval_step_matches_jax(jax_side):
    js = jax_side
    trainer = _port(js)
    batch = _batch(2)
    ref = js["eval_step"](js["state"], {k: jnp.asarray(v) for k, v in batch.items()})
    ours = trainer.eval_step(trainer.state, trainer.device_batch(batch))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        # 1e-4 relative: acc/* read decoded coordinates (test_torch_losses.py)
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)


def test_frame_mode_encode_matches_jax(jax_side):
    js = jax_side
    rng = np.random.default_rng(6)
    batch = dict(frame=rng.integers(0, 256, (B, 80, 60, 3), dtype=np.uint8),
                 box=rng.uniform([0, 0, 30, 40], [20, 20, 50, 60], (B, 4)).astype(np.float32),
                 keypoints=rng.uniform(0, 60, (B, 5, 2)).astype(np.float32),
                 keypoints_visible=np.ones((B, 5), np.float32),
                 keypoints_visibility=np.ones((B, 5), np.float32))
    key = jax.random.PRNGKey(0)
    rimages, rgt = jax_loop._augment_encode(js["cfg"], js["enc"], key, key, jnp.int32(0),
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = _port(js)
    images, gt = loop._augment_encode(trainer.cfg, trainer.encode_codec,
                                      trainer.device_batch(batch))
    # crops: bf16-rounded operands, f32 sums (test_torch_ops.py's bar)
    np.testing.assert_allclose(_n(images), np.asarray(rimages), rtol=1e-5, atol=1e-5)
    assert sorted(gt) == sorted(rgt)
    for k in rgt:
        np.testing.assert_allclose(_n(gt[k]).astype(np.float32),
                                   np.asarray(rgt[k]).astype(np.float32), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_fit_logs_steps_and_validation(jax_side, tmp_path):
    trainer = _port(jax_side)
    trainer.cfg = dataclasses.replace(trainer.cfg, out_dir=str(tmp_path))
    batches = lambda: iter([_batch(3), _batch(4), _batch(5)])
    state = trainer.fit(batches, val_batches=lambda: iter([_batch(6)]), max_steps=3)
    assert int(state.step) == 3
    train_lines = [m for p, _, m in trainer.history if p == "training"]
    val_lines = [(s, m) for p, s, m in trainer.history if p == "validation"]
    assert len(train_lines) == 3 and all(np.isfinite(m["loss"]) for m in train_lines)
    assert [s for s, _ in val_lines] == [0, 2] and "acc/kpt" in val_lines[0][1]
    # metrics.jsonl holds every logged line; the run ends with a checkpoint
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 5 and '"training/loss"' in lines[0]
    assert (tmp_path / "checkpoints" / "3").is_file()
    # and resumes from it
    trainer.cfg = dataclasses.replace(trainer.cfg, resume=True)
    assert int(trainer.fit(batches, max_steps=1).step) == 4
    assert (tmp_path / "checkpoints" / "4").is_file()
