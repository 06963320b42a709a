"""LoRA and frozen-parameter masks in the port against the JAX package, on
the CPU at the tiny geometry of test_torch_models.py: the LoRA model and
its merge, the frozen labels, the masked optimizer against optax
`multi_transform`, whole float32 steps with `train_lora_only` and
`frozen_backbone` against JAX's `make_train_step` with `Trainer.create`'s
optimizer, a masked JAX train state carried into the port, and the merge
CLI. Weights move between the packages through compat/from_jax.py; every
tolerance is stated beside its assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from probpose_pytorch_tpu.losses import ProbPoseLoss as JaxLoss
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models.head import ProbMapHead as JaxHead
from probpose_pytorch_tpu.models.lora import lora_frozen_labels as jax_lora_labels
from probpose_pytorch_tpu.models.lora import merge_lora_params
from probpose_pytorch_tpu.train import loop as jax_loop
from probpose_pytorch_tpu.train import state as jax_state
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch.compat.from_jax import (
    load_jax_train_state,
    load_jax_variables,
    state_dict_from_jax,
)
from probpose_pytorch_tpu_torch.inference import load_predictor
from probpose_pytorch_tpu_torch.models.head import ProbMapHead
from probpose_pytorch_tpu_torch.models.lora import lora_frozen_labels, merge_lora_state_dict
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.config import OptimConfig, TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer, frozen_labels
from probpose_pytorch_tpu_torch.train.state import make_optimizer
from test_torch_models import TINY_CFG, peaked_variables
from test_torch_train import (
    RAW,
    STEPS_PER_EPOCH,
    _batch,
    _by_name,
    _check_grads,
    _n,
    _noise_leaves,
)

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

LORA_CFG = dict(TINY_CFG, lora_rank=2, lora_alpha=8.0)
FROZEN_CFG = dict(TINY_CFG, frozen_backbone=True, adapter_hidden=(24,), num_prefix_tokens=1,
                  exact_gelu=True)


def _images(seed, B=2):
    return np.random.default_rng(seed).random((B, 64, 48, 3), dtype=np.float32)


def _jax_variables(cfg_kw, seed=0, lora_scale=0.0):
    """The JAX model of `cfg_kw` and its numpy variables (peaked head);
    with `lora_scale`, every LoRA factor redrawn N(0, lora_scale)."""
    jm = jax_model.build_model(jax_model.ModelConfig(**cfg_kw))
    x = jnp.zeros((1, *cfg_kw["img_size"], 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(seed), x, train=False), seed)
    if lora_scale:
        rng = np.random.default_rng(seed + 100)
        variables["params"] = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.normal(0, lora_scale, v.shape).astype(np.float32)
                          if any("lora" in str(getattr(k, "key", k)) for k in p) else v),
            variables["params"])
    return jm, variables


def _port_model(cfg_kw, variables):
    pm = build_model(ModelConfig(**cfg_kw), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return pm


def _labels_by_name(tree, batch_stats, names):
    """A JAX label tree as {port name: label}."""
    frozen = jax.tree_util.tree_map(lambda lab, v: np.full(np.shape(v), lab == "frozen"),
                                    tree[0], tree[1])
    sd = state_dict_from_jax(frozen, batch_stats)
    out = {}
    for n in names:
        assert sd[n].all() or not sd[n].any(), n  # one label per leaf
        out[n] = "frozen" if sd[n].all() else "trainable"
    return out


# --------------------------------------------------------------------------
# the LoRA model


@pytest.mark.parametrize("attn_impl", ["fused", "einsum"])
def test_lora_forward_matches_jax(attn_impl):
    """Nonzero deltas at all four sites: the port's model against JAX's
    LoRA model, f32 within 1e-5."""
    kw = dict(LORA_CFG, attn_impl=attn_impl)
    jm, variables = _jax_variables(kw, lora_scale=0.05)
    pm = _port_model(kw, variables)
    names = [n for n, _ in pm.named_parameters() if "_lora." in n]
    assert len(names) == 2 * 4 * 2  # a and b at four sites in each of the 2 blocks
    x = _images(1)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_lora_at_init_equals_base_model():
    """`b` is zero at init, so the LoRA model gives the base model's
    outputs exactly; the seeded base weights are those of the model
    without LoRA, and `a` is drawn N(0, 0.02) in the JAX orientation."""
    lora = build_model(ModelConfig(**LORA_CFG), device="cpu", seed=3)
    base = build_model(ModelConfig(**TINY_CFG), device="cpu", seed=3)
    sd = lora.state_dict()
    for k, v in base.state_dict().items():
        assert torch.equal(sd[k], v), k
    qkv = dict(lora.named_parameters())
    a, b = qkv["backbone.blocks.0.attn.qkv_lora.a"], qkv["backbone.blocks.0.attn.qkv_lora.b"]
    assert a.shape == (32, 2) and b.shape == (2, 96) and not b.any()
    assert 0.005 < float(a.detach().std()) < 0.05
    x = torch.from_numpy(_images(2))
    with torch.no_grad():
        for o, r in zip(lora(x), base(x)):
            assert torch.equal(o, r)


def test_lora_at_init_matches_jax_base():
    """JAX's LoRA init (b = 0) carried into the port equals JAX's base
    model on the stripped tree, f32 within 1e-5."""
    jm, variables = _jax_variables(LORA_CFG)
    pm = _port_model(LORA_CFG, variables)
    strip = lambda t: ({k: strip(v) for k, v in t.items() if not k.endswith("_lora")}
                       if isinstance(t, dict) else t)
    base = jax_model.build_model(jax_model.ModelConfig(**TINY_CFG))
    x = _images(3)
    ref = base.apply({"params": strip(variables["params"]),
                      "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_merge_matches_jax_exactly():
    """merge_lora_state_dict on the carried tree gives JAX's
    merge_lora_params bit for bit (both fold in float32 numpy)."""
    _, variables = _jax_variables(LORA_CFG, lora_scale=0.05)
    params, stats = variables["params"], variables["batch_stats"]
    merged = merge_lora_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict_from_jax(params, stats).items()}, 8.0)
    ref = state_dict_from_jax(jax.device_get(merge_lora_params(params, alpha=8.0)), stats)
    assert sorted(merged) == sorted(ref)
    assert not any("_lora" in k for k in merged)
    for k, v in ref.items():
        np.testing.assert_array_equal(_n(merged[k]), v, err_msg=k)


def test_merged_model_matches_unmerged():
    """The merged base model against the LoRA model it came from, f32
    within 1e-4 (the delta moves from two activation-side products into
    the weight), as JAX's own merge test bounds it."""
    _, variables = _jax_variables(LORA_CFG, lora_scale=0.05)
    pm = _port_model(LORA_CFG, variables)
    base = build_model(ModelConfig(**TINY_CFG), device="cpu")
    base.load_state_dict(merge_lora_state_dict(pm.state_dict(), 8.0), strict=True)
    x = torch.from_numpy(_images(4))
    with torch.no_grad():
        for o, r in zip(base(x), pm(x)):
            np.testing.assert_allclose(_n(o), _n(r), rtol=1e-4, atol=1e-4)


def test_merge_rejects_orphan_lora():
    with pytest.raises(ValueError, match="sibling"):
        merge_lora_state_dict({"x_lora.a": torch.zeros(4, 2), "x_lora.b": torch.zeros(2, 8)},
                              alpha=16.0)


def test_lora_validations_match_jax():
    """LoRA on a conv trunk raises JAX's ValueError; with the fused MLP
    (test_torch_mlp.py) too."""
    with pytest.raises(ValueError, match="ViT backbones only"):
        build_model(ModelConfig(**dict(TINY_CFG, backbone="conv-t", lora_rank=2)),
                    device="cpu")


# --------------------------------------------------------------------------
# labels


def test_lora_frozen_labels_match_jax():
    _, variables = _jax_variables(LORA_CFG)
    pm = _port_model(LORA_CFG, variables)
    names = [n for n, _ in pm.named_parameters()]
    ref = _labels_by_name((jax_lora_labels(variables["params"]), variables["params"]),
                          variables["batch_stats"], names)
    ours = dict(zip(names, lora_frozen_labels(names)))
    assert ours == ref
    assert {n for n, lab in ours.items() if lab == "trainable"} == {
        n for n in names if "_lora." in n or n.startswith("head.")}


@pytest.mark.parametrize("flags", [
    dict(),
    dict(freeze_heatmaps=True),
    dict(freeze_probability=True, freeze_oks=True),
    dict(freeze_visibility=True, freeze_error=True, freeze_heatmaps=True),
])
def test_head_frozen_param_labels_match_jax(flags):
    """ProbMapHead.frozen_param_labels on the port's names against the JAX
    head's labels of the same tree (a conv stage included)."""
    kw = dict(TINY_CFG, conv_out_channels=(8,), conv_kernel_sizes=(3,))
    _, variables = _jax_variables(kw)
    pm = _port_model(kw, variables)
    names = [n for n, _ in pm.named_parameters()]
    ref = _labels_by_name((JaxHead.frozen_param_labels(variables["params"], **flags),
                           variables["params"]), variables["batch_stats"], names)
    assert dict(zip(names, ProbMapHead.frozen_param_labels(names, **flags))) == ref


def test_frozen_backbone_labels_match_jax_trainer():
    """frozen_backbone freezes the trunk but its adapters, as the labels of
    JAX's Trainer.create; train_lora_only wins when both are set and needs
    a rank."""
    raw = dict(RAW, model=FROZEN_CFG)
    names = [n for n, _ in build_model(ModelConfig(**FROZEN_CFG), device="cpu")
             .named_parameters()]
    labels = dict(zip(names, frozen_labels(TrainConfig.from_dict(raw), names)))
    assert {n for n, lab in labels.items() if lab == "trainable"} == {
        n for n in names if n.startswith(("head.", "backbone.adapters."))}
    both = TrainConfig.from_dict(dict(RAW, model=dict(LORA_CFG, frozen_backbone=True),
                                      train_lora_only=True))
    lora_names = [n for n, _ in build_model(both.model, device="cpu").named_parameters()]
    assert frozen_labels(both, lora_names) == lora_frozen_labels(lora_names)
    with pytest.raises(ValueError, match="lora_rank > 0"):
        frozen_labels(TrainConfig.from_dict(dict(RAW, train_lora_only=True)), names)


# --------------------------------------------------------------------------
# the masked optimizer


def _opt_params(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "c": rng.normal(size=(2, 3)).astype(np.float32)}


@pytest.mark.parametrize("accum", [1, 2])
def test_masked_optimizer_matches_optax(accum):
    """"b" frozen, "a" and "c" trainable, 5 steps (10 micro-steps with
    accum_steps 2) against optax's MultiSteps(apply_if_finite(
    multi_transform(...))): step 1's trainable gradients are under the
    clip while all leaves' norm is over it; step 3's frozen gradient is
    NaN, which skips the step as optax does. Parameters within 1e-6
    relative (1e-7 absolute), moments within 1e-6 relative: the global
    norm is summed in another order than optax's, and one ulp of it moves
    each clipped gradient by up to ~5e-7 relative (as in
    test_torch_train.py's optimizer tests). The frozen leaf is bit-equal
    to its start."""
    cfg = OptimConfig(peak_lr=1e-2, weight_decay=0.1, clip_grad_norm=1.0,
                      max_nonfinite_skips=5, accum_steps=accum)
    rng = np.random.default_rng(20 + accum)
    params = _opt_params(rng)
    labels = {"a": "trainable", "b": "frozen", "c": "trainable"}
    tx = jax_state.make_optimizer(cfg, 10, labels)
    jstate, jparams = tx.init(params), params
    names = sorted(params)
    ours = make_optimizer(cfg, 10, [labels[k] for k in names])
    tparams = [torch.from_numpy(params[k].copy()) for k in names]
    tstate = ours.init(tparams)
    for i in range(5 * accum):
        step = i // accum
        grads = {k: (rng.normal(size=v.shape) * 3).astype(np.float32) for k, v in params.items()}
        if step == 1:
            grads["a"] *= 0.05
            grads["c"] *= 0.05
            grads["b"] *= 10.0
            tn = np.sqrt(sum(float((grads[k] ** 2).sum()) for k in "ac"))
            an = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
            assert tn < cfg.clip_grad_norm < an
        if step == 3:
            grads["b"][1] = np.nan
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = ours.update([torch.from_numpy(grads[k]) for k in names], tstate, tparams)
        with torch.no_grad():
            torch._foreach_add_(tparams, tupd)
        for k, t in zip(names, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"micro-step {i}, {k}")
    np.testing.assert_array_equal(tparams[names.index("b")].numpy(), params["b"])
    inner = tstate.inner if accum > 1 else tstate
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(adam) == 1
    adam = adam[0]
    assert isinstance(adam.mu["b"], optax.MaskedNode)  # optax keeps no moments for it
    assert len(inner.mu) == len(inner.nu) == 2  # nor does the port
    for k, mu, nu in zip(["a", "c"], inner.mu, inner.nu):
        np.testing.assert_allclose(mu.numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(nu.numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=0)
    finite = jstate.inner_opt_state if accum > 1 else jstate  # apply_if_finite's state
    # step 3 is skipped (with accum_steps 2 its NaN stays in the
    # accumulator, as in optax, and step 4 is skipped too)
    assert int(inner.count) == int(adam.count) < 5
    assert int(inner.total_notfinite) == int(finite.total_notfinite) >= 1


# --------------------------------------------------------------------------
# whole float32 steps


def _close_params(trainer, jparams, jbs, grads_ref, lrs, tol=1e-5):
    """Params within `tol` of JAX's, except elements whose JAX gradient is
    below the grad tolerance (1e-4 of the leaf's max, or in a noise leaf):
    Adam's first steps move those by up to lr whatever their size, so they
    may differ by up to 2 lr per step (test_torch_train.py's rule at this
    file's 1e-5)."""
    ref = _by_name(jparams, jbs, trainer.state.names)
    noise, _ = _noise_leaves(grads_ref)
    for n, p in zip(trainer.state.names, trainer.state.params):
        d = np.abs(_n(p) - ref[n])
        g = np.abs(grads_ref[n])
        small = (g < 1e-4 * g.max()) | (n in noise)
        assert (d[~small] <= tol).all(), (n, d[~small].max())
        assert (d[small] <= 2 * sum(lrs)).all(), (n, d[small].max())


def _masked_sides(raw):
    """(JAX side, port Trainer) for the config `raw`: the JAX model and
    Trainer.create's optimizer with a peaked head and (LoRA) nonzero
    deltas, the jitted make_train_step, and a port Trainer carrying the
    same initial state."""
    cfg = JaxTrainConfig.from_dict(raw)
    jtrainer = jax_loop.Trainer.create(cfg, STEPS_PER_EPOCH)
    model, tx = jtrainer.model, jtrainer.tx
    _, variables = _jax_variables(dict(raw["model"]), lora_scale=0.02)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=jax.tree_util.tree_map(jnp.copy, params))
    enc, fast = jax_loop.build_codecs(cfg)
    loss_fn = JaxLoss(fast, freeze_error=cfg.freeze_error, freeze_oks=cfg.freeze_oks)
    js = dict(cfg=cfg, model=model, variables=variables, tx=tx, state=state, enc=enc,
              fast=fast, loss_fn=loss_fn,
              step=jax.jit(jax_loop.make_train_step(model, enc, loss_fn, tx, cfg)))
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(state))
    return js, trainer


def _jax_grads(js, state, batch):
    """(losses, grads) of the JAX step's loss at `state`."""
    cfg = js["cfg"]
    key = jax.random.PRNGKey(cfg.seed)
    images, gt = jax_loop._augment_encode(cfg, js["enc"], key, key, state.step, batch)

    def compute_loss(params):
        pred, _ = js["model"].apply({"params": params, "batch_stats": state.batch_stats},
                                    images, train=True, mutable=["batch_stats"])
        losses = js["loss_fn"](gt, pred)
        return sum(losses[k] * w for k, w in cfg.loss_weights.as_dict().items()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))(state.params)
    return losses, grads


@pytest.mark.parametrize("over", [
    dict(model=LORA_CFG, train_lora_only=True),
    dict(model=FROZEN_CFG),
], ids=["train_lora_only", "frozen_backbone"])
def test_masked_step_matches_jax(over):
    """Two f32 steps against JAX's make_train_step with Trainer.create's
    masked optimizer: grad_norm (all leaves, frozen ones included) and the
    loss within 1e-5 relative, step 1's gradients within 1e-4 of each
    leaf's largest, trainable params within 1e-5 where the gradient is
    above that tolerance (else Adam's 2 lr), frozen params bit-equal to
    their start and to JAX's, the EMA within 1e-5."""
    raw = dict(RAW, **over)
    js, trainer = _masked_sides(raw)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    names = trainer.state.names
    start = {n: _n(p).copy() for n, p in zip(names, trainer.state.params)}
    labels = dict(zip(names, frozen_labels(trainer.cfg, names)))
    captured = []
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]
    _, rgrads = _jax_grads(js, js["state"], jbatch)
    jstate = js["state"]
    lrs = []
    for i in range(2):
        lrs.append(float(jax_state.build_schedule(js["cfg"].optim, STEPS_PER_EPOCH)(i)))
        jstate, jm = js["step"](jstate, jbatch)
        _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    grads_ref = {n: v for n, v in state_dict_from_jax(rgrads, jstate.batch_stats).items()
                 if n in names}
    _check_grads(names, captured[0], grads_ref)
    _close_params(trainer, jstate.params, jstate.batch_stats, grads_ref, lrs)
    ref = state_dict_from_jax(jstate.params, jstate.batch_stats)
    frozen = [n for n in names if labels[n] == "frozen"]
    assert frozen and len(trainer.state.opt_state.mu) == len(names) - len(frozen)
    for n, p in zip(names, trainer.state.params):
        if labels[n] == "frozen":
            np.testing.assert_array_equal(_n(p), start[n], err_msg=n)
            np.testing.assert_array_equal(_n(p), ref[n], err_msg=n)
        else:
            assert not np.array_equal(_n(p), start[n]) or not start[n].any(), n
    ema = state_dict_from_jax(jstate.ema_params, jstate.batch_stats)
    for n, e in zip(names, trainer.state.ema_params):
        np.testing.assert_allclose(_n(e), ema[n], rtol=0, atol=1e-5, err_msg=n)


def test_load_jax_train_state_carries_a_masked_lora_state():
    """One masked JAX step, the carry (moments for the trainable leaves
    only, MaskedNode for the rest), then one more step on each side."""
    raw = dict(RAW, model=LORA_CFG, train_lora_only=True)
    js, _ = _masked_sides(raw)
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, _ = js["step"](js["state"], jbatch)
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(jstate))
    opt = trainer.state.opt_state
    names = trainer.state.names
    trainable = [n for n, lab in zip(names, lora_frozen_labels(names)) if lab == "trainable"]
    assert len(opt.mu) == len(trainable) and int(opt.count) == 1
    _, rgrads = _jax_grads(js, jstate, jbatch)
    jstate2, jm = js["step"](jstate, jbatch)
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    grads_ref = {n: v for n, v in state_dict_from_jax(rgrads, jstate.batch_stats).items()
                 if n in names}
    lr = float(jax_state.build_schedule(js["cfg"].optim, STEPS_PER_EPOCH)(1))
    _close_params(trainer, jstate2.params, jstate2.batch_stats, grads_ref, [lr])
    with pytest.raises(ValueError, match="frozen labels differ"):
        load_jax_train_state(Trainer.create(TrainConfig.from_dict(dict(RAW, model=LORA_CFG)),
                                            STEPS_PER_EPOCH, device="cpu").state,
                             jax.device_get(jstate))


@pytest.mark.parametrize("accum", [1, 2])
def test_masked_state_checkpoint_round_trip(tmp_path, accum):
    """A train_lora_only state after a step (moments for the trainable
    leaves only; with accum_steps 2, MultiSteps' accumulator over every
    leaf) saved and restored into a fresh Trainer bit for bit."""
    raw = dict(RAW, model=LORA_CFG, train_lora_only=True,
               optim=dict(RAW["optim"], accum_steps=accum))
    cfg = TrainConfig.from_dict(raw)
    trainer = Trainer.create(cfg, STEPS_PER_EPOCH, device="cpu")
    trainer.train_step(trainer.state, trainer.device_batch(_batch(2)))
    CheckpointManager(tmp_path).save(1, trainer.state)
    fresh = Trainer.create(cfg, STEPS_PER_EPOCH, device="cpu")
    CheckpointManager(tmp_path).restore(fresh.state)
    a, b = trainer.state, fresh.state
    opt_a, opt_b = (a.opt_state.inner, b.opt_state.inner) if accum > 1 else (a.opt_state,
                                                                              b.opt_state)
    n_trainable = lora_frozen_labels(a.names).count("trainable")
    assert len(opt_b.mu) == len(opt_b.nu) == n_trainable < len(a.names)
    pairs = list(zip(a.params, b.params)) + list(zip(a.ema_params, b.ema_params))
    pairs += list(zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu))
    pairs += [(opt_a.count, opt_b.count), (a.step, b.step)]
    if accum > 1:
        pairs += list(zip(a.opt_state.acc, b.opt_state.acc))
        assert len(b.opt_state.acc) == len(a.names)
    assert all(torch.equal(x, y) for x, y in pairs)


# --------------------------------------------------------------------------
# the merge CLI


def test_merge_lora_cli(tmp_path):
    """A LoRA run's checkpoint through `compat.merge_lora --device cpu`: the
    config loses its rank and train_lora_only, the step and the BN
    statistics carry, the optimizer state is fresh, and the merged
    predictor matches the unmerged one (params and EMA) within 1e-4."""
    from probpose_pytorch_tpu_torch.compat import merge_lora

    raw = dict(RAW, model=LORA_CFG, train_lora_only=True, out_dir=str(tmp_path / "lora"))
    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    batches = lambda: iter([_batch(3), _batch(4)])
    trainer.fit(batches, max_steps=2)
    run = tmp_path / "lora"
    assert (run / "checkpoints" / "2").is_file()
    (run / "config.json").write_text(trainer.cfg.to_json())
    with pytest.raises(ValueError, match="lora_rank == 0"):
        plain = tmp_path / "plain.json"
        TrainConfig.from_dict(RAW).save(plain)
        merge_lora.main(["--checkpoint", str(run / "checkpoints"), "--config", str(plain),
                         "--out", str(tmp_path / "x"), "--device", "cpu"])
    out = tmp_path / "merged"
    merge_lora.main(["--checkpoint", str(run / "checkpoints"), "--out", str(out),
                     "--device", "cpu"])
    cfg = TrainConfig.load(out / "config.json")
    assert cfg.model.lora_rank == 0 and not cfg.train_lora_only
    payload = CheckpointManager(out / "checkpoints").read()
    assert payload["step"] == 2 and not any("_lora" in k for k in payload["params"])
    assert int(payload["opt_state"]["count"]) == 0
    src = CheckpointManager(run / "checkpoints").read()
    for k, v in src["buffers"].items():
        assert torch.equal(payload["buffers"][k], v), k
    frames = (np.random.default_rng(5).random((3, 80, 60, 3)) * 255).astype(np.uint8)
    boxes = np.tile(np.array([5, 5, 45, 60], np.float32), (3, 1))
    for ema in (False, True):
        merged = load_predictor(out / "checkpoints", ema=ema, device="cpu")
        lora = load_predictor(run / "checkpoints", ema=ema, device="cpu")
        merged.return_heatmaps = lora.return_heatmaps = True
        a, b = merged(frames, boxes), lora(frames, boxes)
        for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)
